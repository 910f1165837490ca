#!/usr/bin/env python3
"""Time the biased attention kernels' fp32 form of the port in a checkout
on a CUDA card.

    python3 tools/fp32_attention.py [--repo DIR]

Imports ``tortoise_tts_tpu_torch`` from DIR (default: this checkout) and
this checkout's ``chip_smoke.py`` for its inputs and timers, then at
chip_smoke's fp32 shapes, K6 at the batch route's trunk (16, 16, 896) and
K9a and K9b's fused entry at the default route's trunk (2, 16, 896),
checks the kernel against its plain version (chip_smoke's ``F32_TOL``)
and prints one JSON line each: the device ms a call of the kernel, of its
plain version and of the library call (SDPA in fp32 with TF32 off, the
bias as a float mask, the output copied back to channels-major), and
chip_smoke's bounds (``f32_bounds``: 3xTF32 and the FFMA rate).  Then
chip_smoke's ``fp32_denoiser`` line on the checkout's denoiser (one
full-width fp32 forward at B=16 through K6, at B=2 through K9a and K9b:
what the kernels move on the route), and the card's name and power
limit.  For A/B calls: run it on two checkouts in one call, in turns.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402  (this checkout's inputs and timers)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fp32_attention: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(sys.argv[sys.argv.index("--repo") + 1]).resolve() \
        if "--repo" in sys.argv else HERE
    sys.path.insert(0, str(repo))
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias as k6
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias_cm as k9b
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias_kq as k9a
    assert Path(k6.__file__).resolve().is_relative_to(repo), k6.__file__
    kernels.build_all()
    F = torch.nn.functional
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # the library in fp32
    h, t = 16, 896
    with torch.inference_mode():
        for name, b, kernel, plain, transposed in (
                ("flash_attention_bias", 16, k6.flash_attention_bias,
                 k6.flash_attention_bias_plain, False),
                ("flash_attention_bias_kq", 2, k9a.flash_attention_bias_kq,
                 k9a.flash_attention_bias_kq_plain, True),
                ("flash_attention_bias_cm", 2, k9b.flash_attention_bias_qkv,
                 k9b.flash_attention_bias_qkv_plain, False)):
            qkv, (bias,) = cs._bias_attn_inputs(torch, dev, b, h, t,
                                                torch.float32, 80 + b)
            qv, kv, vv = qkv.view(b, h, 3, 64, t).unbind(2)
            # K9a takes the (key, query) bias, SDPA the view of its transpose
            given = bias.transpose(1, 2).contiguous() if transposed else bias
            mask = given.transpose(1, 2) if transposed else bias

            def run(i):
                return kernel(qkv, given, h)

            def reference(i):
                return plain(qkv, given, h)

            def library(i):
                return cs._sdpa_cm(F, qv, kv, vv, mask)
            err = cs.bf16_err(torch, run(0), reference(0), name=name,
                              **cs.F32_TOL)
            ms = cs.device_ms(torch, run)
            bounds = cs.f32_bounds(4 * b * h * 64 * t * 4 + h * t * t * 4,
                                   2 * 2 * b * h * t * t * 64)
            print(json.dumps({
                "kernel": name, "shape": [b, h, t], "repo": str(repo),
                "max_abs_err": err, "ms": ms,
                "plain_ms": cs.device_ms(torch, reference),
                "library_ms": cs.device_ms(torch, library),
                "bound_share": bounds["bound_ms"] / ms,
                "ffma_share": bounds["ffma_bound_ms"] / ms,
                **bounds}), flush=True)
        cs.fp32_denoiser(torch, dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
