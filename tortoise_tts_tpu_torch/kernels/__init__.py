"""Hand-written Hopper kernels of the port, one module per TPU kernel.

| module | replaces (JAX package) | CUDA source |
| --- | --- | --- |
| ``flash_attention`` | ``ops/pallas_attention.py`` ``flash_attention`` | ``csrc/flash_attention.cu`` |
| ``flash_attention`` (``KERNEL_BWD``) | no Pallas kernel: the backward of ``models/unified_voice.py``'s ``custom_vjp`` (XLA's ``jax.vjp`` of ``mha``) | ``csrc/flash_attention_bwd.cu`` |
| ``qgemv`` | ``ops/pallas_gemv.py`` ``qgemv_stacked`` | ``csrc/qgemv.cu`` |
| ``qgemv_w8a8`` | ``ops/pallas_gemv.py`` ``qgemv_stacked_w8a8`` | ``csrc/qgemv_w8a8.cu`` |
| ``flash_decode`` | ``ops/pallas_decode_attn.py`` ``flash_decode_stacked``, and its shared-prefix form | ``csrc/flash_decode.cu`` |
| ``gn_conv`` | ``ops/pallas_resblock.py`` ``fused_gn_conv1x1`` | ``csrc/resblock.cu`` |
| ``ts_res_block`` | ``ops/pallas_resblock.py`` ``fused_ts_res_block`` | ``csrc/resblock.cu`` |
| ``gn_conv`` and ``ts_res_block`` (``KERNEL_BWD``) | no Pallas kernel: the backwards of ``models/arch.py``'s and ``models/diffusion.py``'s ``custom_vjp`` (``jax.vjp`` of their XLA formulations) | ``csrc/resblock.cu`` |
| ``flash_attention_bias`` | ``ops/pallas_attention.py`` ``flash_attention_bias_qkv_vt`` | ``csrc/flash_attention_bias.cu`` |
| ``flash_attention_bias_kq`` | ``ops/pallas_attention.py`` ``flash_attention_bias_qkv_kq`` | ``csrc/flash_attention_bias_kq.cu`` |
| ``flash_attention_bias_cm`` | ``ops/pallas_attention.py`` ``flash_attention_bias_cm`` and ``flash_attention_bias_qkv`` | ``csrc/flash_attention_bias_cm.cu`` |
| ``snake`` | ``ops/pallas_snake.py`` ``snake_resample2`` | ``csrc/snake.cu`` |

Each module holds the plain PyTorch version, the wrapper (plain version
for CPU tensors, the kernel for CUDA tensors) and its ``Kernel`` objects,
whose ``launches`` count the wrapper's launches.  The three biased
attention kernels share their device code (``csrc/attention_bias.cuh``).
"""

from __future__ import annotations

from typing import Dict

from . import (flash_attention, flash_attention_bias, flash_attention_bias_cm,
               flash_attention_bias_kq, flash_decode, gn_conv, qgemv,
               qgemv_w8a8, snake, ts_res_block)
from ._build import build

KERNELS = {"flash_attention": flash_attention.KERNEL,
           "flash_attention_bwd": flash_attention.KERNEL_BWD,
           "qgemv": qgemv.KERNEL,
           "qgemv_w8a8": qgemv_w8a8.KERNEL,
           "flash_decode": flash_decode.KERNEL,
           "flash_decode_shared": flash_decode.KERNEL_SHARED,
           "gn_conv": gn_conv.KERNEL, "ts_res_block": ts_res_block.KERNEL,
           "gn_conv_bwd": gn_conv.KERNEL_BWD,
           "ts_res_block_bwd": ts_res_block.KERNEL_BWD,
           "flash_attention_bias": flash_attention_bias.KERNEL,
           "snake": snake.KERNEL,
           "flash_attention_bias_kq": flash_attention_bias_kq.KERNEL,
           "flash_attention_bias_cm": flash_attention_bias_cm.KERNEL}


def build_all() -> Dict[str, str]:
    """Compile every kernel source not built yet, all at once; returns the
    compiler output of each source built by this call."""
    return build([k.source for k in KERNELS.values()])


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
