"""Config-driven engine factory (port of
``tortoise_tts_tpu/engine/factory.py``, reference load_engines,
engines/__init__.py:40-338).

One engine per ``cfg.models`` entry with ``training: true``: the weights
(a checkpoint under ``ckpt_dir`` > the entry's ``path`` > the registry's
weights > random from seed 0, with the leading-dimension resize of
``resize_modules``), an optimizer from the global hyperparameters with
the entry's overrides, the train step and a feeder that maps the global
batch onto the engine's inputs on its device.  ``cfg.loras`` turns the
AR engine into adapter training; a ``teacher: true`` entry is loaded
frozen for the AR step's distillation term.

The diffusion engine's feeder computes the AR hidden states with the AR
engine's current parameters when the AR model co-trains (the adapted
model under LoRA), else with the loaded AR model (the TorToiSe recipe:
the denoiser conditions on AR latents).

The BigVGAN engine trains the generator against a random-initialised
MultiPeriod + MultiResolution discriminator, each with its own optimizer
from the same hyperparameters; its feeder takes ``wav`` segments, which
the Dataset does not yield (as in the JAX package): it runs from a
caller's batches through ``Engines.step``.  The CLVP engine trains on the
batch's text and codes.  A mesh of more than one device is not ported
and raises (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict

import torch

from ..config import Config, Hyperparameters, ModelConfig
from ..models import LoadedModel, load_model, resolve_device
from . import optim
from . import state as st
from . import train_step as ts
from .engines import Engines

_logger = logging.getLogger(__name__)

TRAINABLE = ("autoregressive", "diffusion", "dvae", "clvp", "bigvgan")
# the discriminator's seed (the JAX package's PRNGKey(1))
DISC_SEED = 1


def _merged_hp(cfg: Config, m: ModelConfig) -> Hyperparameters:
    if not m.hyperparameters:
        return cfg.hyperparameters
    known = {f.name for f in dataclasses.fields(Hyperparameters)}
    for k in m.hyperparameters:
        if k not in known:
            _logger.warning("models.%s.hyperparameters: unknown key %s",
                            m.name, k)
    return dataclasses.replace(cfg.hyperparameters, **{
        k: v for k, v in m.hyperparameters.items() if k in known})


def _resize_like(loaded, template, resize: bool = True):
    """Each leaf in the template's type and device; with ``resize`` a leaf
    whose leading dimension differs (a vocabulary-size change) is cut or
    zero-padded to the template's (reference resize_modules +
    ml.resize_weight)."""
    def leaf(l, t):
        l = torch.as_tensor(l)
        if tuple(l.shape) != tuple(t.shape):
            if (not resize or l.dim() != t.dim()
                    or l.shape[1:] != t.shape[1:]):
                raise ValueError(f"shape mismatch {tuple(l.shape)} vs "
                                 f"{tuple(t.shape)}")
            n, m = l.shape[0], t.shape[0]
            l = l[:m] if n > m else torch.cat(
                [l, torch.zeros((m - n,) + tuple(t.shape[1:]),
                                dtype=l.dtype)])
            _logger.warning("resized %s -> %s on load", (n,), (m,))
        return l.to(dtype=t.dtype, device=t.device)

    def walk(a, b):
        if isinstance(b, dict):
            return {k: walk(a[k], v) for k, v in b.items()}
        if isinstance(b, (list, tuple)):
            return type(b)(walk(x, y) for x, y in zip(a, b))
        return leaf(a, b)
    return walk(loaded, template)


def _load_path(lm: LoadedModel, m: ModelConfig, cfg: Config) -> LoadedModel:
    """The entry's ``path`` weights: the port's '/'-keyed export or a
    reference torch-layout state dict (``models/convert.py``)."""
    from ..models import convert_torch_sd
    from ..utils.io import load_state_dict
    from ..utils.state import unflatten_like
    sd = load_state_dict(m.path)
    if any("/" in k for k in sd):
        params = unflatten_like(lm.params, sd, strict=False)
    elif any("." in k for k in sd):
        params = convert_torch_sd(m.name, sd, lm.config)
    else:
        params = sd
    params = _resize_like(params, lm.params, cfg.trainer.resize_modules)
    return LoadedModel(lm.name, lm.module, lm.config, params, True)


def load_engines(cfg: Config, training: bool = True,
                 device=None) -> Engines:
    """Engines from ``cfg.models`` (reference load_engines), resumed from
    ``cfg.ckpt_dir`` where it holds checkpoints.  ``device``: None reads
    ``cfg.device``, and then the CUDA device."""
    from ..models.lora import apply_lora, init_lora

    if any(n > 1 for n in cfg.trainer.mesh_shape):
        raise NotImplementedError(
            f"trainer.mesh_shape={cfg.trainer.mesh_shape}: training over "
            "more than one device is not ported yet (ROADMAP.md)")
    device = resolve_device(device or cfg.train_device, "load_engines")
    dtype = (cfg.trainer.weight_dtype if training
             else cfg.inference.weight_dtype)
    engines = Engines()
    loaded: Dict[str, LoadedModel] = {}
    teacher_params = None
    for m in cfg.models:
        lm = load_model(m.name, dtype, device=device)
        if m.path:
            lm = _load_path(lm, m, cfg)
        if m.teacher:
            # its own tensors: the student's updates never reach them
            teacher_params = lm.params
        else:
            loaded[m.name] = lm

    lora = cfg.lora
    ar_engine: Dict[str, Any] = {}

    def ar_params():
        """The AR parameters the diffusion feeder runs: the AR engine's
        live ones when it co-trains (adapted under LoRA), else the loaded
        model's."""
        name = ar_engine.get("name")
        if name is not None and name in engines:
            p = engines[name].params
            if ar_engine.get("lora"):
                p = apply_lora(loaded["autoregressive"].params, p,
                               lora.alpha, lora.rank)
            return p
        return ar_model().params

    def ar_model() -> LoadedModel:
        if "autoregressive" not in loaded:
            loaded["autoregressive"] = load_model("autoregressive", dtype,
                                                  device=device)
        return loaded["autoregressive"]

    for m in cfg.models:
        if not (training and m.training) or m.teacher:
            continue
        if m.name not in TRAINABLE:
            _logger.warning("model %s has no train step; skipping", m.name)
            continue
        hp = _merged_hp(cfg, m)
        tx = optim.make_optimizer(hp)
        lm = loaded[m.name]
        conf = {"model": m.name, "base_lr": hp.learning_rate}

        if m.name == "autoregressive":
            kw = dict(remat=cfg.trainer.gradient_checkpointing,
                      teacher_params=teacher_params,
                      teacher_alpha=hp.teacher_alpha,
                      teacher_temperature=hp.teacher_temperature)
            if lora is not None and lora.training:
                g = torch.Generator(device=device).manual_seed(0)
                state = st.init_state(init_lora(g, lm.params,
                                                rank=lora.rank), tx)
                step_fn = ts.make_ar_train_step(
                    lm.config, tx, lora_cfg=lora, base_params=lm.params,
                    **kw)
                name = lora.full_name
            else:
                state = st.init_state(lm.params, tx)
                step_fn = ts.make_ar_train_step(lm.config, tx, **kw)
                name = m.full_name
            ar_engine.update(name=name, lora=name != m.full_name)
            engines.add(name, state, step_fn,
                        batch_selector=_selector(device, _AR_KEYS),
                        config=conf)

        elif m.name == "diffusion":
            from ..models import gaussian
            # training samples over the full original schedule
            sched = gaussian.get_schedule(steps=4000, cond_free=False)
            step_fn = ts.make_diffusion_train_step(lm.config, tx, sched,
                                                   seed=cfg.trainer.seed)
            engines.add(m.full_name, st.init_state(lm.params, tx), step_fn,
                        batch_selector=_diffusion_selector(
                            device, ar_params, ar_model),
                        config=conf)

        elif m.name == "dvae":
            step_fn = ts.make_dvae_train_step(lm.config, tx)
            engines.add(m.full_name, st.init_state(lm.params, tx), step_fn,
                        batch_selector=_dvae_selector(device), config=conf)

        elif m.name == "clvp":
            step_fn = ts.make_clvp_train_step(lm.config, tx)
            engines.add(m.full_name, st.init_state(lm.params, tx), step_fn,
                        batch_selector=_selector(device, ("text", "codes")),
                        config=conf)

        elif m.name == "bigvgan":
            from ..models import bigvgan_disc as bvd
            tx_d = optim.make_optimizer(hp)
            g = torch.Generator(device=device).manual_seed(DISC_SEED)
            dcfg = bvd.DiscriminatorConfig()
            disc = bvd.init(g, dcfg)
            params = {"generator": lm.params, "discriminator": disc}
            state = st.TrainState(params, {"g": tx.init(lm.params),
                                           "d": tx_d.init(disc)})
            step_fn = ts.make_vocoder_train_step(lm.config, tx, tx_d, dcfg)
            engines.add(m.full_name, state, step_fn,
                        batch_selector=_vocoder_selector(device),
                        config=conf, export_params=vocoder_export_params)

    if not engines.names() and training:
        raise RuntimeError("training, but no model set to train "
                           "(reference trainer.py:140-147 behavior)")
    engines.load_checkpoint(cfg.ckpt_dir, strict=cfg.trainer.strict_loading)
    return engines


def vocoder_export_params(state: st.TrainState) -> Dict[str, Any]:
    """The bigvgan engine's export: the generator's and the
    discriminator's weights, each under its own optimizer's state
    (``optim.eval_params``)."""
    return {"generator": optim.eval_params(state.params["generator"],
                                           state.opt_state["g"]),
            "discriminator": optim.eval_params(
                state.params["discriminator"], state.opt_state["d"])}


_AR_KEYS = ("latents", "text", "text_lengths", "codes", "wav_lengths")


def _selector(device, keys):
    def select(batch):
        return ts.to_device({k: batch[k] for k in keys}, device)
    return select


def _diffusion_selector(device, ar_params, ar_model):
    def select(batch):
        if "mel_diff" not in batch:
            raise KeyError(
                "diffusion training needs 'mel_diff' targets: re-run "
                "emb.process with store_mels and set dataset.load_mels: "
                "true")
        b = ts.to_device({k: batch[k] for k in _AR_KEYS
                          + ("mel_diff", "diffusion_latents")}, device)
        lat = ts.ar_latents(ar_params(), ar_model().config, b)
        return {"mel": b["mel_diff"], "latents": lat,
                "conditioning_latents": b["diffusion_latents"]}
    return select


def _dvae_selector(device):
    def select(batch):
        if "mel" not in batch:
            raise KeyError(
                "dvae training needs 'mel' targets: re-run emb.process with "
                "store_mels and set dataset.load_mels: true")
        return ts.to_device({"mel": batch["mel"]}, device)
    return select


def _vocoder_selector(device):
    def select(batch):
        if "wav" not in batch:
            raise KeyError(
                "bigvgan training needs 'wav' segments (B, T) at 24 kHz: "
                "the Dataset yields none, so step the engine with batches "
                "of your own through Engines.step")
        return ts.to_device({"wav": batch["wav"]}, device)
    return select


def tokens_of(batch, mel_length_compression: int = 1024) -> int:
    """Tokens of a host batch, as the AR step counts them: the text
    lengths plus the mel codes the wav lengths cover."""
    return int(batch["text_lengths"].sum()
               + (batch["wav_lengths"] // mel_length_compression).sum())
