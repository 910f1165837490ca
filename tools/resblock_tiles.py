#!/usr/bin/env python3
"""Time the K4/K5 GEMM's launch plans on a CUDA card.

    python3 tools/resblock_tiles.py [--dtype bf16|fp32|both]

For each shape the routes give K4 (``gn_conv1x1``) and K5
(``ts_res_block_out``), runs the kernel under each candidate plan of the
GEMM (bf16: 64- and 128-wide time tiles, the choice
``kernels.gn_conv.plan`` makes by grid size; fp32: every tile width of
``gn_conv.F32_TILES`` with K splits of 1 to 8 that keep
``gn_conv.MIN_SLICE_STEPS`` steps a slice: the data ``gn_conv``'s cost
model is fitted to), checks each against its plain
version (bf16: chip_smoke's ``RESBLOCK_TOL``; fp32: ``F32_TOL``) and, in
fp32, that two calls give the same bits, and prints one JSON line a shape:
the time per call by CUDA events over back-to-back calls (``ms``), the
device time per call of the normalise kernel and of the GEMM by
torch.profiler (``norm_ms``, ``gemm_ms``), the plan ``plan`` picks; then
the card's name and power limit.
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

TOL = {torch.bfloat16: dict(atol=3e-2, rtol=2e-2),   # chip_smoke's
       torch.float32: dict(atol=1e-4, rtol=1e-4)}     # RESBLOCK_/F32_TOL
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
# fp32: emb.process's heads, TTS(dtype="float32")'s denoiser
F32_SHAPES = [("k4", 1, 1024, 3072, 517, False),
              ("k4", 1, 2048, 6144, 101, False),
              ("k4", 2, 1024, 1024, 896, True), ("k4", 2, 1024, 3072, 896, False),
              ("k4", 1, 1024, 1024, 896, True),
              ("k5", 2, 1024, 1024, 896, True), ("k5", 1, 1024, 1024, 896, True)]


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
        elif "_wgmma" in e.name or "_tf32" in e.name:
            gemm += e.device_time
    return norm / 1e3 / n, gemm / 1e3 / n


def candidates(kern, b, c, m, t, dtype):
    """The plans to time: bf16 the two tile widths; fp32 every tile width
    and every split the kernel takes at this K (1 to 8, clusters of any
    size, where the plan keeps to ``F32_SPLITS``)."""
    if dtype == torch.bfloat16:
        return [k4.Plan(64, 1), k4.Plan(128, 1)]
    steps = -(-(c * (3 if kern == "k5" else 1)) // k4.F32_K_STEP)
    return [k4.Plan(bn, s) for bn in k4.F32_TILES for s in range(1, 9)
            if s == 1 or steps // s >= k4.MIN_SLICE_STEPS]


def main() -> int:
    if not torch.cuda.is_available():
        print("resblock_tiles: no CUDA device", file=sys.stderr)
        return 2
    arg = sys.argv[sys.argv.index("--dtype") + 1] if "--dtype" in sys.argv \
        else "both"
    cases = ([(sh, torch.bfloat16) for sh in SHAPES] if arg != "fp32" else []) \
        + ([(sh, torch.float32) for sh in F32_SHAPES] if arg != "bf16"
           else [])
    dev = torch.device("cuda")
    plan = k4.plan
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with torch.inference_mode():
        for i, ((kern, b, c, m, t, act), dtype) in enumerate(cases):
            g = torch.Generator(device=dev).manual_seed(i)
            x = (torch.randn(b, c, t, generator=g, device=dev) * 2 + 0.5) \
                .to(dtype)
            norm = {"scale": 1 + 0.1 * torch.randn(c, generator=g, device=dev),
                    "bias": 0.1 * torch.randn(c, generator=g, device=dev)}
            k = 1 if kern == "k4" else 3
            bound = (c * k) ** -0.5
            conv = {"w": ((torch.rand(m, c, k, generator=g, device=dev) * 2
                           - 1) * bound).to(dtype),
                    "b": (torch.rand(m, generator=g, device=dev) * 2 - 1)
                    * bound}
            if kern == "k4":
                def run(x=x, norm=norm, conv=conv, act=act):
                    return k4.gn_conv1x1(x, norm, conv, 32, act)
                want = k4.gn_conv1x1_plain(x, norm, conv, 32, act)
            else:
                res = torch.randn(b, c, t, generator=g, device=dev) \
                    .to(dtype)
                emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=dev)) \
                    .to(dtype)
                prepared = k5.prepare_conv(conv)

                def run(x=x, res=res, emb=emb, norm=norm, conv=prepared):
                    return k5.ts_res_block_out(x, res, emb, norm, conv, 32)
                want = k5.ts_res_block_out_plain(x, res, emb, norm, conv, 32)
            tol = TOL[dtype]
            row = {"kernel": kern, "dtype": str(dtype), "b": b, "c": c,
                   "m": m, "t": t,
                   "plan": list(plan(b, c, t, m, 32, dtype, taps=k)),
                   "plans": {}}
            for p in candidates(kern, b, c, m, t, dtype):
                def forced(*a, p=p, **kw):
                    plan(*a, **kw)
                    return p
                k4.plan = k5.plan = forced
                try:
                    got = run()
                    d = (got.float() - want.float()).abs()
                    bad = int((d > tol["atol"] + tol["rtol"]
                               * want.float().abs()).sum())
                    r = {"max_abs_err": float(d.max()), "bad": bad}
                    if dtype == torch.float32:
                        r["same_bits"] = bool(torch.equal(got, run()))
                    r["ms"] = per_call_ms(run)
                    r["norm_ms"], r["gemm_ms"] = device_split(run)
                    row["plans"][f"{p.bn}x{p.split}"] = r
                finally:
                    k4.plan = k5.plan = plan
            print(json.dumps(row), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
