"""K6: non-causal flash attention with a per-head additive bias, the
diffusion denoiser's rel-pos attention at batch >= 8.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_attention.py``
``flash_attention_bias_qkv_vt`` (``_attn_bias_vt_kernel``, and the
head-group ``_attn_bias_vt_hg_kernel`` its default path takes).  The CUDA
source is ``csrc/flash_attention_bias.cu``; its header gives the bound on
an H100 and the design.  The TPU kernel padded T to a multiple of 128,
pre-transposed V and appended a ones column for the softmax normaliser;
the CUDA kernel reads the fused channels-major qkv as it is, masks the
ragged end and keeps the normaliser in registers, so none of that is
ported.

``flash_attention_bias`` runs the plain PyTorch version for CPU tensors
and the kernel for CUDA tensors (it raises on what the kernel does not
take).  The JAX function has no gradient, and neither has this one.
"""

from __future__ import annotations

import math

import torch

from ._build import F, I, P, Kernel

KERNEL = Kernel("flash_attention_bias", "tts_flash_attention_bias",
                [P, P, P, I, I, I, F, I, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_bias_plain(qkv: torch.Tensor, bias: torch.Tensor,
                               n_heads: int) -> torch.Tensor:
    """The TPU kernel's arithmetic: fp32 scores ``q·k/√d + bias``, ``exp``
    against the row max rounded to qkv's type, then ``(Σ p·v) / Σ p`` with
    fp32 sums.  qkv: (B, H*3*D, T) with per-head [q;k;v] channel blocks;
    bias: (H, T, T) -> (B, H*D, T) in qkv's type."""
    b, width, t = qkv.shape
    d = width // (3 * n_heads)
    q, k, v = qkv.reshape(b, n_heads, 3 * d, t).float().split(d, dim=2)
    dots = (torch.einsum("bhct,bhcs->bhts", q, k) * (1.0 / math.sqrt(d))
            + bias.float()[None])
    p = torch.exp(dots - dots.amax(dim=-1, keepdim=True)).to(qkv.dtype)
    p = p.float()
    acc = torch.einsum("bhts,bhcs->bhct", p, v)
    out = acc / p.sum(dim=-1)[:, :, None, :]
    return out.to(qkv.dtype).reshape(b, n_heads * d, t)


def _launch(qkv: torch.Tensor, bias: torch.Tensor, n_heads: int):
    b, width, t = qkv.shape
    if width % (3 * n_heads) or width // (3 * n_heads) != 64:
        raise ValueError("flash_attention_bias kernel takes head dim 64, got "
                         f"width {width} for {n_heads} heads")
    if qkv.dtype not in _DTYPES or bias.dtype != qkv.dtype:
        raise TypeError("flash_attention_bias kernel takes float32 or "
                        f"bfloat16 qkv and bias of one type, got "
                        f"{qkv.dtype}/{bias.dtype}")
    if bias.shape != (n_heads, t, t) or bias.device != qkv.device:
        raise ValueError(f"bias must be ({n_heads}, {t}, {t}) on "
                         f"{qkv.device}, got {tuple(bias.shape)}")
    if not (qkv.is_contiguous() and bias.is_contiguous()):
        raise ValueError("flash_attention_bias kernel takes contiguous qkv "
                         "and bias")
    out = torch.empty((b, width // 3, t), dtype=qkv.dtype, device=qkv.device)
    per16 = 16 // qkv.element_size()
    vec = int(t % per16 == 0 and all(
        x.data_ptr() % 16 == 0 for x in (qkv, bias, out)))
    KERNEL.launch(qkv.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
                  n_heads, t, 1.0 / math.sqrt(64), vec, _DTYPES[qkv.dtype],
                  torch.cuda.current_stream(qkv.device).cuda_stream)
    return out


def flash_attention_bias(qkv: torch.Tensor, bias: torch.Tensor,
                         n_heads: int) -> torch.Tensor:
    """softmax(q·k/√d + bias[h]) v over channels-major qkv (B, H*3*D, T)
    and an (H, T, T) bias, already scaled -> (B, H*D, T)."""
    if qkv.device.type == "cpu":
        return flash_attention_bias_plain(qkv, bias, n_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_bias: no kernel for {qkv.device}")
    return _launch(qkv, bias, n_heads)
