#!/usr/bin/env python3
"""Time K4's and K5's fp32 form of the port in a checkout on a CUDA card.

    python3 tools/fp32_resblock.py [--repo DIR]

Imports ``tortoise_tts_tpu_torch`` from DIR (default: this checkout) and
this checkout's ``chip_smoke.py`` for its inputs and timers, then at
``emb.process``'s two conditioning heads, (1, 1024, 517) -> 3072 and
(1, 2048, 101) -> 6144, and K5 at TTS(dtype="float32")'s trunk, (2, 1024,
896), checks the kernel against its plain version (chip_smoke's
``F32_TOL``) and prints one JSON line each: the device ms a call of the
kernel (all its CUDA kernels, by torch.profiler), of its plain version
and of the library call (F.group_norm + F.conv1d in fp32, TF32 off), and
chip_smoke's bounds (``f32_bounds``).  Then the card's name and power
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
        print("fp32_resblock: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(sys.argv[sys.argv.index("--repo") + 1]).resolve() \
        if "--repo" in sys.argv else HERE
    sys.path.insert(0, str(repo))
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.kernels import gn_conv as k4
    from tortoise_tts_tpu_torch.kernels import ts_res_block as k5
    assert Path(k4.__file__).resolve().is_relative_to(repo), k4.__file__
    kernels.build_all()
    F = torch.nn.functional
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False   # the library call in fp32
    f32 = torch.float32
    with torch.inference_mode():
        for kern, b, c, t, m in (("gn_conv", 1, 1024, 517, 3072),
                                 ("gn_conv", 1, 2048, 101, 6144),
                                 ("ts_res_block", 2, 1024, 896, 1024)):
            taps = 1 if kern == "gn_conv" else 3
            x, norm, conv = cs._gn_conv_inputs(torch, dev, b, c, t, m, taps,
                                               70 + c, f32)
            gn = (norm["scale"], norm["bias"])
            if kern == "gn_conv":
                def run(i):
                    return k4.gn_conv1x1(x, norm, conv, 32, False)

                def plain(i):
                    return k4.gn_conv1x1_plain(x, norm, conv, 32, False)

                def library(i):
                    return F.conv1d(F.group_norm(x, 32, *gn, 1e-5),
                                    conv["w"], conv["b"])
                nbytes = 4 * (b * c * t + 2 * c + m * c + m + b * m * t)
            else:
                res = torch.randn(b, c, t, device=dev)
                emb = 0.3 * torch.randn(b, 2 * c, device=dev)
                prepared = k5.prepare_conv(conv)

                def run(i):
                    return k5.ts_res_block_out(x, res, emb, norm, prepared,
                                               32)

                def plain(i):
                    return k5.ts_res_block_out_plain(x, res, emb, norm, conv,
                                                     32)

                def library(i):
                    return F.conv1d(F.group_norm(x, 32, *gn, 1e-5),
                                    conv["w"], conv["b"], padding=1)
                nbytes = 4 * (3 * b * c * t + 3 * c * c + 2 * b * c + 3 * c)
            err = cs.bf16_err(torch, run(0), plain(0), name=kern, **cs.F32_TOL)
            flops = 2 * b * m * taps * c * t
            print(json.dumps({
                "kernel": kern, "shape": [b, c, t, m], "repo": str(repo),
                "max_abs_err": err, "ms": cs.device_ms(torch, run),
                "plain_ms": cs.device_ms(torch, plain),
                "library_ms": cs.device_ms(torch, library),
                **cs.f32_bounds(nbytes, flops)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
