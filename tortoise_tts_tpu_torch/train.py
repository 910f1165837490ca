"""Training entry point (port of ``tortoise_tts_tpu/train.py``).

    python -m tortoise_tts_tpu_torch.train --yaml config.yaml [--iterations N]

Builds the engines of ``cfg.models`` (``engine/factory.load_engines``),
the resumable datasets and runs ``utils/trainer.train_engines`` with
checkpoint, export and eval scheduling.  Training runs on the CUDA
device unless the config (``device: cpu``) or the caller
(``main(device="cpu")``) asks for the CPU.  ``main(cfg=...)`` takes a
built ``Config`` in place of the YAML (no PyYAML needed).

``run_eval`` is the generative round trip on a split: AR decode with
the engine's current parameters, conditioned on the sample's own
latents, the 30-step P sampler without conditioning-free guidance,
BigVGAN, then the mel L1 between the hypothesis and the reference
decoded from the sample's DVAE codes (reference run_eval,
train.py:65-256); wavs go under ``<log_dir>/<step>/``.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import numpy as np

_logger = logging.getLogger(__name__)


def run_eval(cfg, state, val_ds, log_dir: Path, lora_cfg=None,
             base_params=None, max_samples: int = 4, prefix: str = "eval",
             device=None) -> dict:
    """``{"<prefix>.mel_distance": mean L1}`` over up to ``max_samples``
    samples of ``val_ds``; a hypothesis of 4 mel frames or fewer is left
    out of the mean."""
    import torch
    from .inference import TTS
    from .models import LoadedModel, load_mel_norms, load_model
    from .models.lora import apply_lora
    from .ops.stft import mel_ar, resample
    from .tokenizer import default_tokenizer
    from .utils.io import write_wav

    step = int(state.step)
    out_dir = Path(log_dir) / str(step)
    out_dir.mkdir(parents=True, exist_ok=True)
    params = state.params
    if lora_cfg is not None:
        params = apply_lora(base_params, params, lora_cfg.alpha,
                            lora_cfg.rank)
    dtype = cfg.trainer.weight_dtype
    device = device or cfg.train_device
    tts = TTS(cfg, dtype=dtype, device=device)
    ar = load_model("autoregressive", dtype, device=tts.device)
    tts._models["autoregressive"] = LoadedModel(
        "autoregressive", ar.module, ar.config, params, True)
    dvae = load_model("dvae", dtype, device=tts.device)
    tok = default_tokenizer()
    # DVAE codes come from mel_norms-divided mels: the hypothesis' mel is
    # taken with the same norms
    norms = load_mel_norms(tts.device)
    ek = cfg.evaluation.kwargs or {}
    dists = []
    it = val_ds.batches(batch_size=1)
    for i in range(min(max_samples, len(val_ds))):
        batch = next(it)
        n = int(batch["wav_lengths"][0]) // 1024
        codes = torch.as_tensor(batch["codes"][:, :max(n, 4)],
                                device=tts.device)
        with torch.no_grad():
            ref_mel = dvae.module.decode(dvae.params, codes,
                                         dvae.config).float()
        text = tok.decode(batch["text"][0][:int(batch["text_lengths"][0])])
        # a failure propagates (the JAX package logs it and leaves the
        # sample out): a kernel or device error must not turn into a
        # metric over fewer samples
        hyp_wav, _ = tts.inference(
            text or "evaluation sample", None,
            conditioning_latents=(batch["latents"][:1],
                                  batch["diffusion_latents"][:1]),
            max_ar_steps=int(ek.get("max_steps", min(200, n * 2 + 16))),
            ar_temp=float(ek.get("ar_temp", 0.8)),
            top_p=float(ek.get("top_p", 1.0)),
            top_k=int(ek.get("top_k", 0)),
            max_diffusion_steps=30, diffusion_sampler="p",
            cond_free=False, seed=step + i)
        write_wav(out_dir / f"{prefix}_{i}_hyp.wav", hyp_wav, 24_000)
        hyp22 = resample(torch.as_tensor(hyp_wav[None], device=tts.device),
                         24_000, 22_050)
        hyp_mel = mel_ar(hyp22, norms)
        t = min(hyp_mel.shape[-1], ref_mel.shape[-1])
        if t > 4:
            dists.append(float((hyp_mel[..., :t] - ref_mel[..., :t])
                               .abs().mean()))
    metric = float(np.mean(dists)) if dists else float("nan")
    _logger.info("%s@%d: mel_distance=%.4f (%d samples)", prefix, step,
                 metric, len(dists))
    return {f"{prefix}.mel_distance": metric}


def main(argv=None, cfg=None, device=None):
    """Train from ``--yaml`` (or ``cfg``); returns the Engines."""
    import os
    parser = argparse.ArgumentParser("tortoise_tts_tpu_torch.train")
    parser.add_argument("--yaml", type=Path,
                        default=os.environ.get("TORTOISE_YAML"),
                        required=cfg is None
                        and "TORTOISE_YAML" not in os.environ)
    parser.add_argument("--iterations", type=int, default=None)
    args = parser.parse_args([] if argv is None and cfg is not None
                             else argv)
    logging.basicConfig(level=logging.INFO)

    import torch
    from .config import Config
    from .data import Dataset, create_train_val_dataloader
    from .engine.factory import load_engines
    from .models import load_model
    from .utils.trainer import train_engines

    if cfg is None:
        cfg = Config.load(args.yaml)
    if cfg.trainer.detect_grad_anomaly:
        # fail at the op that first makes a NaN instead of training on
        torch.autograd.set_detect_anomaly(True)

    train_ds, val_ds = create_train_val_dataloader(cfg)
    engines = load_engines(cfg, training=True, device=device)
    _logger.info("engines: %s (resumed at step %d)", engines.names(),
                 engines.global_step)
    sampler_state = cfg.ckpt_dir / "sampler.0.state"
    train_ds.load_state(sampler_state)

    def save_fn(es, step):
        es.save_checkpoint(cfg.ckpt_dir,
                           keep_last=cfg.trainer.keep_last_checkpoints,
                           mode=("async" if cfg.trainer.async_checkpoint
                                 else "sync"))
        train_ds.save_state(sampler_state)

    lora_cfg = cfg.lora if cfg.lora is not None and cfg.lora.training \
        else None
    ar_name = lora_cfg.full_name if lora_cfg else "autoregressive"
    # the subtrain split (the reference's overfitting probe), built at the
    # first eval so the training sampler is left alone
    subtrain: list = []

    def eval_fn(es):
        if ar_name not in es:
            return
        if not subtrain:
            subtrain.append(Dataset(cfg, cfg.dataset.training,
                                    training=False))
        base = (load_model("autoregressive", cfg.trainer.weight_dtype,
                           device=device or cfg.train_device).params
                if lora_cfg else None)
        for name, ds in (("subtrain", subtrain[0]), ("val", val_ds)):
            run_eval(cfg, es[ar_name], ds, log_dir, lora_cfg=lora_cfg,
                     base_params=base, max_samples=cfg.evaluation.size,
                     prefix=name, device=device)

    log_dir = cfg.log_dir / time.strftime("%Y%m%d_%H%M%S")
    log_dir.mkdir(parents=True, exist_ok=True)
    return train_engines(cfg, train_ds, engines, eval_fn=eval_fn,
                         save_fn=save_fn, log_path=log_dir / "log.txt",
                         max_iterations=args.iterations)


if __name__ == "__main__":
    main()
