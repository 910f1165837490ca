#!/usr/bin/env python3
"""Time the routes whose fp32 convolutions cuDNN would run in TF32, for the
port in a checkout, on a CUDA card.

    python3 tools/tf32_cost.py [--repo DIR] [--reps N]

Imports ``tortoise_tts_tpu_torch`` from DIR (default: this checkout) and
this checkout's ``chip_smoke.py`` for its inputs, and times, with random
weights at the shipped widths:

- ``final_head``: the denoiser's fp32 output conv (1024 -> 200, k=3) at
  the default route's (2, 1024, 896), by CUDA events over back-to-back
  calls (50 DDIM steps run it once each);
- ``default``: ``TTS.inference`` with chip_smoke's budgets (AR-200,
  DDIM-50, BigVGAN), warm;
- ``univnet`` and ``univnet_batch8``: ``vocoder_type="vocoder"`` alone and
  over 8 texts, warm;
- ``process``: ``emb.process``'s CLI over chip_smoke's 4 clips, float32;
- ``vocoder_gan``: one step of the BigVGAN GAN engine (fp32
  discriminators) on chip_smoke's batch of 8 x 8192 samples.

Each prints one JSON line: the wall seconds of each repetition (the
first call of every route is a warm-up, not printed) and their median.
Where the checkout's ``models.common`` runs fp32 convolutions with TF32
off (``_fp32_flags``), every route is also timed with that switched back
to torch's default, in turns (off, default, default, off), as the
``tf32`` mode, so the cost shows inside one process.  Then the card's
name and power limit.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402  (this checkout's inputs and helpers)


def _arg(name, default):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv \
        else default


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tf32_cost: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(_arg("--repo", str(HERE))).resolve()
    reps = int(_arg("--reps", "3"))
    sys.path.insert(0, str(repo))
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.config import Config
    from tortoise_tts_tpu_torch.emb import process
    from tortoise_tts_tpu_torch.engine.factory import load_engines
    from tortoise_tts_tpu_torch.inference import TTS
    from tortoise_tts_tpu_torch.models import common
    from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer
    assert Path(common.__file__).resolve().is_relative_to(repo), \
        common.__file__
    kernels.build_all()
    dev = torch.device("cuda")
    modes = ["fp32", "tf32"] if hasattr(common, "_fp32_flags") else [
        "as_is"]
    strict = getattr(common, "_fp32_flags", None)

    @contextlib.contextmanager
    def mode(m):
        if m == "tf32":
            common._fp32_flags = contextlib.nullcontext
        try:
            yield
        finally:
            if strict is not None:
                common._fp32_flags = strict

    def report(route, fn, n=reps):
        order = modes if len(modes) == 1 else ["fp32", "tf32", "tf32",
                                               "fp32"]
        times = {m: [] for m in modes}
        for m in order:
            with mode(m):
                fn()                     # warm-up: captures, caches
                torch.cuda.synchronize()
                for _ in range(max(1, n // 2) if len(modes) > 1 else n):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[m].append(time.perf_counter() - t0)
        for m, ts in times.items():
            print(json.dumps({"route": route, "mode": m, "repo": str(repo),
                              "s": ts, "median_s": sorted(ts)[len(ts) // 2]}),
                  flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["TORTOISE_TPU_TOKENIZER"] = str(
            write_char_tokenizer(Path(tmp) / "tokenizer.json"))
        g = torch.Generator(device=dev).manual_seed(0)
        head = {"w": torch.randn(200, 1024, 3, generator=g, device=dev)
                * 0.02, "b": torch.zeros(200, device=dev)}
        h = torch.randn(2, 1024, 896, generator=g, device=dev)
        for m in modes:
            with mode(m):
                ms = cs.call_ms(torch, lambda i: common.conv1d(head, h,
                                                               padding=1))
            print(json.dumps({"route": "final_head", "mode": m,
                              "repo": str(repo), "call_ms": ms}), flush=True)
        del head, h
        ref = cs.reference_wav(Path(tmp) / "reference.wav")
        tts = TTS(device="cuda")
        report("default", lambda: tts.inference(cs.TEXT, ref, seed=0,
                                                **cs.ROUTE_KW))
        report("univnet", lambda: tts.inference(
            cs.TEXT, ref, seed=0, vocoder_type="vocoder", **cs.ROUTE_KW))
        report("univnet_batch8", lambda: tts.batch_inference(
            [cs.TEXT] * cs.BATCH_ROWS, ref, seed=1, top_p=0.9,
            vocoder_type="vocoder", **cs.ROUTE_KW))
        del tts
        cs._free(torch)
        voices = cs._voices(Path(tmp) / "prep")
        runs = iter(range(1000))
        report("process", lambda: process.main([
            "--input-audio", str(voices), "--output-dataset",
            str(Path(tmp) / f"data{next(runs)}")]))
        cfg = Config.from_dict({
            "models": [{"name": "bigvgan", "training": True}],
            "hyperparameters": {"optimizer": "AdamW",
                                "learning_rate": cs.VOC_LR,
                                "warmup_steps": 0,
                                "gradient_accumulation_steps": 1},
            "trainer": {"weight_dtype": "bfloat16"}},
            yaml_path=str(Path(tmp) / "voc" / "cfg.yaml"))
        signal = cs.reference_signal(seconds=4.0, sr=24000, seed=5)
        hop = (signal.size - cs.VOC_T) // (cs.VOC_B - 1)
        batch = {"wav": np.stack(
            [signal[i * hop:i * hop + cs.VOC_T] for i in range(cs.VOC_B)])}
        engines = load_engines(cfg, device=dev)
        report("vocoder_gan", lambda: engines.step(batch), n=2 * reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
