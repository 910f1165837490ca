"""Hand-written Hopper kernels of the port, one module per TPU kernel.

| module | replaces (JAX package) | CUDA source |
| --- | --- | --- |
| ``flash_attention`` | ``ops/pallas_attention.py`` ``flash_attention`` | ``csrc/flash_attention.cu`` |
| ``qgemv`` | ``ops/pallas_gemv.py`` ``qgemv_stacked`` | ``csrc/qgemv.cu`` |
| ``qgemv_w8a8`` | ``ops/pallas_gemv.py`` ``qgemv_stacked_w8a8`` | ``csrc/qgemv_w8a8.cu`` |
| ``flash_decode`` | ``ops/pallas_decode_attn.py`` ``flash_decode_stacked``, and its shared-prefix form | ``csrc/flash_decode.cu`` |
| ``gn_conv`` | ``ops/pallas_resblock.py`` ``fused_gn_conv1x1`` | ``csrc/resblock.cu`` |
| ``ts_res_block`` | ``ops/pallas_resblock.py`` ``fused_ts_res_block`` | ``csrc/resblock.cu`` |
| ``flash_attention_bias`` | ``ops/pallas_attention.py`` ``flash_attention_bias_qkv_vt`` | ``csrc/flash_attention_bias.cu`` |
| ``snake`` | ``ops/pallas_snake.py`` ``snake_resample2`` | ``csrc/snake.cu`` |

Each module holds the plain PyTorch version, the wrapper (plain version
for CPU tensors, the kernel for CUDA tensors) and its ``Kernel`` objects,
whose ``launches`` count the wrapper's launches.
"""

from __future__ import annotations

from typing import Dict

from . import (flash_attention, flash_attention_bias, flash_decode, gn_conv,
               qgemv, qgemv_w8a8, snake, ts_res_block)
from ._build import build

KERNELS = {"flash_attention": flash_attention.KERNEL, "qgemv": qgemv.KERNEL,
           "qgemv_w8a8": qgemv_w8a8.KERNEL,
           "flash_decode": flash_decode.KERNEL,
           "flash_decode_shared": flash_decode.KERNEL_SHARED,
           "gn_conv": gn_conv.KERNEL, "ts_res_block": ts_res_block.KERNEL,
           "flash_attention_bias": flash_attention_bias.KERNEL,
           "snake": snake.KERNEL}


def build_all() -> Dict[str, str]:
    """Compile every kernel source not built yet, all at once; returns the
    compiler output of each source built by this call."""
    return build([k.source for k in KERNELS.values()])


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
