#!/usr/bin/env python3
"""Time K2's and K8's K split and their fused row work on a CUDA card.

    python3 tools/qgemv_tiles.py [--out FILE]

For each of the decode's four GEMVs (the LayerNorm where the decode fuses
it) and M = 1, 8, 16 and 32 rows in bf16, runs K2 (``kernels.qgemv``) and
K8 (``kernels.qgemv_w8a8``) with every K split that gives slices of 64 to
512 rows; up to 16 rows both with the row kernel's work (K2's LN, K8's
quantizer) in its own kernel and in the GEMM's prologue (``fused``).
Each call cycles over 30 layers of int8 weights (378 MB, more than the
50 MB L2), as the decode does.  It checks each variant against
its plain version and prints one JSON line a (kernel, GEMV, M): for each
variant the device ms per call by torch.profiler (``ms``), split into the
row kernel (``row_ms``: K2's LN rows, K8's quantize) and the GEMM
(``gemm_ms``); and the split that ``ksplit`` picks.  Then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tortoise_tts_tpu_torch.kernels import qgemv as k2  # noqa: E402
from tortoise_tts_tpu_torch.kernels import qgemv_w8a8 as k8  # noqa: E402

SHAPES = [("attn_qkv", 1024, 3072, True), ("attn_proj", 1024, 1024, False),
          ("mlp_fc", 1024, 4096, True), ("mlp_proj", 4096, 1024, False)]
LAYERS = 30
TOL = 3e-2     # chip_smoke's K2 tolerance (bf16 outputs, |y| <~ 1.5)


def device_ms(fn, n=LAYERS):
    """Device ms per call: (all kernels, the row kernel, the GEMM)."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)   # the profiler drops a window's first kernels
        for _ in range(16):
            torch.cuda._sleep(200_000)
        torch.cuda.synchronize()
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    row = gemm = other = 0.0
    for e in prof.events():
        if "spin_kernel" in e.name or "CUDA" not in str(e.device_type):
            continue
        if "qgemv_ln_rows" in e.name or "w8a8_quantize" in e.name:
            row += e.device_time
        elif "qgemv_gemm" in e.name or "w8a8_gemm" in e.name:
            gemm += e.device_time
        else:
            other += e.device_time
    return (row + gemm + other) / 1e3 / n, row / 1e3 / n, gemm / 1e3 / n


def splits(k):
    ks = 1
    while k // ks >= 32:
        if k % ks == 0 and (k // ks) % 32 == 0 and 64 <= k // ks <= 512:
            yield ks
        ks *= 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("qgemv_tiles: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out = open(args.out, "w") if args.out else None
    g = torch.Generator(device=dev).manual_seed(11)
    with torch.inference_mode():
        for name, kd, nd, ln in SHAPES:
            wq = torch.randint(-127, 128, (LAYERS, kd, nd), generator=g,
                               device=dev, dtype=torch.int8)
            s = torch.rand(LAYERS, nd, generator=g, device=dev) * 2e-4
            b = torch.randn(LAYERS, nd, generator=g, device=dev) * 0.1
            gam = 1 + 0.1 * torch.randn(LAYERS, kd, generator=g, device=dev)
            bet = 0.1 * torch.randn(LAYERS, kd, generator=g, device=dev)

            def lnp(i):
                return (gam[i % LAYERS], bet[i % LAYERS]) if ln else None
            for m in (1, 8, 16, 32):
                x = torch.randn(m, kd, generator=g, device=dev) \
                    .to(torch.bfloat16)
                for kern in ("k2", "k8"):
                    mod = k2 if kern == "k2" else k8
                    plain = (k2.qgemv_plain if kern == "k2"
                             else k8.qgemv_w8a8_plain)
                    want = plain(x, wq[0], s[0], b[0], ln=lnp(0)).float()
                    row = {"kernel": kern, "gemv": name, "m": m, "k": kd,
                           "n": nd, "ln": ln,
                           "ksplit": k2.ksplit(kd, nd, m), "variants": []}
                    two = (kern == "k8" or ln) and m <= k2.FUSED_ROWS
                    opt = "ln_fused" if kern == "k2" else "fused"
                    for ks in splits(kd):
                        for lf in ((False, True) if two else (None,)):
                            kw = {"ks": ks}
                            if lf is not None:
                                kw[opt] = lf

                            def run(i, kw=kw):
                                r = mod._launch(x, wq[i % LAYERS],
                                                s[i % LAYERS], b[i % LAYERS],
                                                lnp(i), **kw)
                                return r if kern == "k2" else r[0]
                            v = {"ks": ks, "kc": kd // ks}
                            if lf is not None:
                                v["fused"] = lf
                            try:
                                got = run(0).float()
                                torch.cuda.synchronize()
                            except RuntimeError as e:   # shared memory
                                v["error"] = str(e)[:120]
                                row["variants"].append(v)
                                continue
                            err = float((got - want).abs().max())
                            v["max_abs_err"] = err
                            v["ok"] = err <= (TOL if kern == "k2" else 0.1)
                            v["ms"], v["row_ms"], v["gemm_ms"] = \
                                device_ms(run)
                            row["variants"].append(v)
                    line = json.dumps(row)
                    print(line, flush=True)
                    if out:
                        out.write(line + "\n")
            del wq
            torch.cuda.empty_cache()
    print(smi)
    if out:
        out.write(json.dumps({"nvidia_smi": smi}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
