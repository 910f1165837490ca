"""K9b: non-causal flash attention with a per-head additive bias over
channels-major q, k and v, the diffusion denoiser's rel-pos attention
below batch 8 under ``Inference.denoise_attention = "flash_bias"``.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_attention.py``
``flash_attention_bias_cm`` and ``flash_attention_bias_qkv``
(``_attn_bias_kernel`` through ``_bias_cm_call``): one kernel with two
entries, split q, k, v (each (B, H, D, T)) or the fused (B, H*3*D, T)
qkv, each read in place by base pointer and (batch, head) stride.  The
CUDA source is ``csrc/flash_attention_bias_cm.cu`` (K6's body in
``csrc/attention_bias.cuh``: the fused entry computes K6's function bit for
bit); its header gives the bound on an H100 and
the design.  The TPU kernel padded T to a multiple of 128; the CUDA
kernel masks the ragged end, so that is not ported.

The wrappers run the plain PyTorch version for CPU tensors and the
kernel for CUDA tensors (they raise on what the kernel does not take).
Only the fused entry lies on a route (``ops/attention.qkv_attention``);
the split one, as in the JAX package, has no caller there.
"""

from __future__ import annotations

import math

import torch

from ._build import F, I, P, Kernel
from .flash_attention_bias import DTYPES, launch

# one kernel, one launch count, two entries: split q, k, v and fused qkv
KERNEL = Kernel("flash_attention_bias_cm", "tts_flash_attention_bias_cm",
                [P, P, P, P, P, I, I, I, F, I, I, I, I, I, P],
                tts_flash_attention_bias_qkv=[P, P, P, I, I, I, F, I, I, I, I,
                                              I, P])


def flash_attention_bias_cm_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, bias: torch.Tensor
                                  ) -> torch.Tensor:
    """The TPU kernel's arithmetic: fp32 scores ``q·k/√d + bias``, a full
    fp32 softmax over the keys, the weights rounded to v's type, then
    ``v·p`` with fp32 sums.  q, k, v: (B, H, D, T); bias: (H, T, T),
    (query, key) per head -> (B, H, D, T) in q's type."""
    d = q.shape[2]
    dots = (torch.einsum("bhct,bhcs->bhts", q.float(), k.float())
            * (1.0 / math.sqrt(d)) + bias.float()[None])
    p = torch.softmax(dots, dim=-1).to(v.dtype).float()
    return torch.einsum("bhcs,bhts->bhct", v.float(), p).to(q.dtype)


def flash_attention_bias_qkv_plain(qkv: torch.Tensor, bias: torch.Tensor,
                                   n_heads: int) -> torch.Tensor:
    """The same on the fused qkv (B, H*3*D, T) -> (B, H*D, T)."""
    b, width, t = qkv.shape
    d = width // (3 * n_heads)
    q, k, v = qkv.reshape(b, n_heads, 3 * d, t).split(d, dim=2)
    return flash_attention_bias_cm_plain(q, k, v, bias).reshape(
        b, n_heads * d, t)


def _check(x: torch.Tensor, bias: torch.Tensor, h: int, t: int, d: int,
           name: str) -> None:
    if d != 64:
        raise ValueError(f"{name} kernel takes head dim 64, got {d}")
    if x.dtype not in DTYPES or bias.dtype != x.dtype:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 inputs and "
                        f"bias of one type, got {x.dtype}/{bias.dtype}")
    if bias.shape != (h, t, t) or bias.device != x.device:
        raise ValueError(f"bias must be ({h}, {t}, {t}) on {x.device}, got "
                         f"{tuple(bias.shape)}")


def flash_attention_bias_cm(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor
                            ) -> torch.Tensor:
    """softmax(q·k/√d + bias[h]) v over split channels-major q, k, v
    (B, H, D, T) and an (H, T, T) bias, already scaled -> (B, H, D, T)."""
    if q.device.type == "cpu":
        return flash_attention_bias_cm_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bias_cm: no kernel for {q.device}")
    b, h, d, t = q.shape
    _check(q, bias, h, t, d, "flash_attention_bias_cm")
    if any(x.shape != q.shape or x.dtype != q.dtype or x.device != q.device
           for x in (k, v)):
        raise ValueError("flash_attention_bias_cm: q, k and v must share "
                         "shape, type and device")
    if not all(x.is_contiguous() for x in (q, k, v, bias)):
        raise ValueError("flash_attention_bias_cm kernel takes contiguous "
                         "q, k, v and bias")
    out = torch.empty_like(q)
    launch(KERNEL, (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    bias.data_ptr(), out.data_ptr()),
           (q, k, v, bias, out), b, h, t, q.dtype)
    return out


def flash_attention_bias_qkv(qkv: torch.Tensor, bias: torch.Tensor,
                             n_heads: int) -> torch.Tensor:
    """The same kernel fed the fused channels-major qkv (B, H*3*D, T) with
    per-head [q;k;v] channel blocks, read in place -> (B, H*D, T)."""
    if qkv.device.type == "cpu":
        return flash_attention_bias_qkv_plain(qkv, bias, n_heads)
    if qkv.device.type != "cuda":
        raise ValueError(
            f"flash_attention_bias_qkv: no kernel for {qkv.device}")
    b, width, t = qkv.shape
    if width % (3 * n_heads):
        raise ValueError(f"width {width} is no multiple of 3 x {n_heads}")
    _check(qkv, bias, n_heads, t, width // (3 * n_heads),
           "flash_attention_bias_qkv")
    if not (qkv.is_contiguous() and bias.is_contiguous()):
        raise ValueError("flash_attention_bias_qkv kernel takes contiguous "
                         "qkv and bias")
    out = torch.empty((b, width // 3, t), dtype=qkv.dtype, device=qkv.device)
    launch(KERNEL, (qkv.data_ptr(), bias.data_ptr(), out.data_ptr()),
           (qkv, bias, out), b, n_heads, t, qkv.dtype,
           entry="tts_flash_attention_bias_qkv")
    return out
