"""Hand-written Hopper kernels of the port, one module per TPU kernel.

| module | replaces (JAX package) | CUDA source |
| --- | --- | --- |
| ``flash_attention`` | ``ops/pallas_attention.py`` ``flash_attention`` | ``csrc/flash_attention.cu`` |
| ``qgemv`` | ``ops/pallas_gemv.py`` ``qgemv_stacked`` | ``csrc/qgemv.cu`` |
| ``flash_decode`` | ``ops/pallas_decode_attn.py`` ``flash_decode_stacked`` | ``csrc/flash_decode.cu`` |
| ``gn_conv`` | ``ops/pallas_resblock.py`` ``fused_gn_conv1x1`` | ``csrc/resblock.cu`` |
| ``ts_res_block`` | ``ops/pallas_resblock.py`` ``fused_ts_res_block`` | ``csrc/resblock.cu`` |
| ``snake`` | ``ops/pallas_snake.py`` ``snake_resample2`` | ``csrc/snake.cu`` |

Each module holds the plain PyTorch version, the wrapper (plain version
for CPU tensors, the kernel for CUDA tensors) and ``KERNEL``, whose
``launches`` counts the wrapper's launches.
"""

from __future__ import annotations

from typing import Dict

from . import flash_attention, flash_decode, gn_conv, qgemv, snake
from . import ts_res_block
from ._build import build

MODULES = {"flash_attention": flash_attention, "qgemv": qgemv,
           "flash_decode": flash_decode, "gn_conv": gn_conv,
           "ts_res_block": ts_res_block, "snake": snake}


def build_all() -> Dict[str, str]:
    """Compile every kernel source not built yet, all at once; returns the
    compiler output of each source built by this call."""
    return build([m.KERNEL.source for m in MODULES.values()])


def reset_launches() -> None:
    for m in MODULES.values():
        m.KERNEL.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: m.KERNEL.launches for name, m in MODULES.items()}
