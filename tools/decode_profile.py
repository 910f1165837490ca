#!/usr/bin/env python3
"""Profile the AR decode (``decode_chunk``, which runs it as a CUDA graph
on the card where the checkout captures it) at every decode shape.

    python3 tools/decode_profile.py [--repo DIR] [--out FILE]

Imports ``tortoise_tts_tpu_torch`` from ``--repo`` (default: this
checkout), so one call can profile two checkouts of the port on one card.
On a full-width ``TTS`` with random weights it starts the decode of the
44-character sentence at each shape the routes use (the single route, 1
row; the batch, 8 rows; candidates, 1 text fanned out to 16 rows through
the shared prefix; the batch with 4 candidates a text, 32 rows), in the
int8 (K2) and the W8A8 (K8) decode, and prints one JSON line each: wall ms
a token over 32 tokens, then from torch.profiler over 8 tokens the CUDA
kernels a token (a graph's replay launches them all from one host call),
the device ms a token, the GEMV kernels' share of it
(every kernel whose name holds ``qgemv`` or ``w8a8``), K3's (``fd_``)
and the device's busy share.  Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

TEXT = "The quick brown fox jumps over the lazy dog."
# (quant_mode, prefill rows, candidates a row; 0: no fan-out)
SHAPES = [("int8", 1, 0), ("w8a8", 1, 0), ("int8", 8, 0), ("w8a8", 8, 0),
          ("int8", 1, 16), ("w8a8", 1, 16), ("int8", 8, 4), ("w8a8", 8, 4)]
BUDGET = 200


def reference_wav(path: Path, write_wav, seconds=4.0, sr=22050) -> str:
    """chip_smoke's synthetic voice: a gliding harmonic tone."""
    rng = np.random.RandomState(0)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6))
    wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) \
        + 0.01 * rng.randn(t.size)
    write_wav(path, wav.astype(np.float32), sr)
    return str(path)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.inference import TTS
    from tortoise_tts_tpu_torch.models.unified_voice import (decode_chunk,
                                                             decode_start)
    from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
    from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer
    from tortoise_tts_tpu_torch.utils.io import write_wav
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = open(args.out, "w") if args.out else None
    kernels.build_all()
    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        os.environ["TORTOISE_TPU_TOKENIZER"] = str(
            write_char_tokenizer(Path(tmp) / "tokenizer.json"))
        ref = reference_wav(Path(tmp) / "reference.wav", write_wav)
        tts = TTS(device="cuda")
        ar = tts._model("autoregressive")
        qgpt = tts._ar_qgpt()
        dev = tts.device
        lat0 = tts.encode_audio(ref, seed=0)["latent"][0].reshape(1, -1)
        toks = tts.encode_text(TEXT)
        for mode, rows, fan in SHAPES:
            tokens = torch.as_tensor(tts._bucket_text(toks)[None],
                                     device=dev).repeat(rows, 1)
            lengths = torch.tensor([len(toks)] * rows, device=dev)
            lat = lat0.repeat(rows, 1)
            m = rows * (fan or 1)

            def start():
                gens = [torch.Generator(device=dev).manual_seed(i)
                        for i in range(m)]
                st = decode_start(ar.params, lat, tokens, lengths, gens,
                                  ar.config, BUDGET, shared_rows=fan)
                return st if fan else (st, None)

            def chunk(state, prefix, n):
                return decode_chunk(ar.params, state, ar.config,
                                    SamplingConfig(), chunk=n, qgpt=qgpt,
                                    quant_mode=mode, prefix=prefix)
            state, prefix = start()
            state = chunk(state, prefix, 8)
            torch.cuda.synchronize()
            t0 = time.time()
            state = chunk(state, prefix, 32)
            torch.cuda.synchronize()
            ms_tok = (time.time() - t0) * 1e3 / 32
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(0.05)   # the profiler drops a window's first
                for _ in range(16):   # kernels: spin first
                    torch.cuda._sleep(200_000)
                torch.cuda.synchronize()
                chunk(state, prefix, 8)
                torch.cuda.synchronize()
            ev = [e for e in prof.events() if "CUDA" in str(e.device_type)
                  and "spin_kernel" not in e.name]
            busy = sum(e.device_time for e in ev) / 1e3 / 8
            gemv = sum(e.device_time for e in ev
                       if "qgemv" in e.name or "w8a8" in e.name) / 1e3 / 8
            n_gemv = sum("qgemv" in e.name or "w8a8" in e.name for e in ev)
            # K3's kernels: fd_cluster, or the two-kernel design's fd_split
            # and fd_merge in older checkouts
            attn = sum(e.device_time for e in ev
                       if "fd_" in e.name) / 1e3 / 8
            n_attn = sum("fd_" in e.name for e in ev)
            row = dict(repo=args.repo, quant_mode=mode, rows=m,
                       fan_out=fan, ms_per_token=ms_tok,
                       cuda_launches_per_token=len(ev) / 8,
                       device_ms_per_token=busy,
                       gemv_device_ms_per_token=gemv,
                       gemv_kernels_per_token=n_gemv / 8,
                       attn_device_ms_per_token=attn,
                       attn_kernels_per_token=n_attn / 8,
                       device_busy_share=busy / ms_tok)
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
    print(smi)
    if out:
        out.write(json.dumps({"nvidia_smi": smi}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
