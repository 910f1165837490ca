#!/usr/bin/env python3
"""Time the bf16 K4/K5 GEMM's tile widths on a CUDA card.

    python3 tools/resblock_tiles.py

For each shape the denoiser's routes give K4 (``gn_conv1x1``) and K5
(``ts_res_block_out``), runs the kernel with 64- and 128-wide time tiles
(the choice ``kernels.gn_conv.plan`` makes by grid size), checks each
against its plain version within chip_smoke's ``RESBLOCK_TOL`` and prints
one JSON line: the time per call by CUDA events over back-to-back calls
(``ms``), the device time per call of the normalise kernel and of the GEMM
by torch.profiler (``norm_ms``, ``gemm_ms``), the tile width ``plan``
picks; then the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tortoise_tts_tpu_torch.kernels import gn_conv as k4  # noqa: E402
from tortoise_tts_tpu_torch.kernels import ts_res_block as k5  # noqa: E402

TOL = dict(atol=3e-2, rtol=2e-2)   # chip_smoke.RESBLOCK_TOL
# (kernel, B, C, M, T, act)
SHAPES = [("k4", 2, 1024, 1024, 896, True), ("k4", 2, 1024, 3072, 896, False),
          ("k4", 1, 1024, 1024, 896, True), ("k4", 1, 1024, 3072, 896, False),
          ("k4", 16, 1024, 1024, 896, True),
          ("k4", 16, 1024, 3072, 896, False),
          ("k4", 8, 1024, 1024, 896, True), ("k4", 1, 1024, 3072, 517, False),
          ("k4", 1, 2048, 6144, 101, False),
          ("k4", 16, 512, 1536, 218, False),   # the classifier's heads
          ("k5", 2, 1024, 1024, 896, True), ("k5", 1, 1024, 1024, 896, True),
          ("k5", 16, 1024, 1024, 896, True), ("k5", 8, 1024, 1024, 896, True)]


def per_call_ms(fn, n=50):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_split(fn, n=30):
    """Device ms per call of the normalise kernel and of the GEMM."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    norm = gemm = 0.0
    for e in prof.events():
        if "group_norm_act" in e.name:
            norm += e.device_time
        elif "_wgmma" in e.name:
            gemm += e.device_time
    return norm / 1e3 / n, gemm / 1e3 / n


def main() -> int:
    if not torch.cuda.is_available():
        print("resblock_tiles: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    plan = k4.plan
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with torch.inference_mode():
        for i, (kern, b, c, m, t, act) in enumerate(SHAPES):
            g = torch.Generator(device=dev).manual_seed(i)
            x = (torch.randn(b, c, t, generator=g, device=dev) * 2 + 0.5) \
                .to(torch.bfloat16)
            norm = {"scale": 1 + 0.1 * torch.randn(c, generator=g, device=dev),
                    "bias": 0.1 * torch.randn(c, generator=g, device=dev)}
            k = 1 if kern == "k4" else 3
            bound = (c * k) ** -0.5
            conv = {"w": ((torch.rand(m, c, k, generator=g, device=dev) * 2
                           - 1) * bound).to(torch.bfloat16),
                    "b": (torch.rand(m, generator=g, device=dev) * 2 - 1)
                    * bound}
            if kern == "k4":
                def run(x=x, norm=norm, conv=conv, act=act):
                    return k4.gn_conv1x1(x, norm, conv, 32, act)
                want = k4.gn_conv1x1_plain(x, norm, conv, 32, act)
            else:
                res = torch.randn(b, c, t, generator=g, device=dev) \
                    .to(torch.bfloat16)
                emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=dev)) \
                    .to(torch.bfloat16)
                prepared = k5.prepare_conv(conv)

                def run(x=x, res=res, emb=emb, norm=norm, conv=prepared):
                    return k5.ts_res_block_out(x, res, emb, norm, conv, 32)
                want = k5.ts_res_block_out_plain(x, res, emb, norm, conv, 32)
            row = {"kernel": kern, "b": b, "c": c, "m": m, "t": t,
                   "plan_bn": plan(b, c, t, m, 32, torch.bfloat16)}
            for bn in (64, 128):
                def forced(*a, bn=bn, **kw):
                    plan(*a, **kw)
                    return bn
                k4.plan = k5.plan = forced
                try:
                    got = run()
                    d = (got.float() - want.float()).abs()
                    bad = int((d > TOL["atol"] + TOL["rtol"]
                               * want.float().abs()).sum())
                    row[f"bn{bn}_max_abs_err"] = float(d.max())
                    row[f"bn{bn}_bad"] = bad
                    row[f"bn{bn}_ms"] = per_call_ms(run)
                    (row[f"bn{bn}_norm_ms"],
                     row[f"bn{bn}_gemm_ms"]) = device_split(run)
                finally:
                    k4.plan = k5.plan = plan
            print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
