"""K9a: non-causal flash attention with a per-head additive bias given
transposed, the diffusion denoiser's rel-pos attention under
``Inference.denoise_attention = "kq"``.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_attention.py``
``flash_attention_bias_qkv_kq`` (``_attn_bias_kq_kernel``), whose bias is
``bias_t`` (H, S, Tq): ``bias_t[h, s, t]`` is the bias of query t and key
s.  The CUDA source is ``csrc/flash_attention_bias_kq.cu`` (K6's body in
``csrc/attention_bias.cuh``, the bias tile read in place by
``ldmatrix.trans``); its header gives the bound on an H100 and the
design.  The TPU kernel padded T to a multiple of 128; the CUDA kernel
masks the ragged end, so that is not ported.

``flash_attention_bias_kq`` runs the plain PyTorch version for CPU
tensors and the kernel for CUDA tensors (it raises on what the kernel
does not take).  The JAX function has no gradient, and neither has this
one.
"""

from __future__ import annotations

import math

import torch

from ._build import F, I, P, Kernel
from .flash_attention_bias import DTYPES, Plan, launch

KERNEL = Kernel("flash_attention_bias_kq", "tts_flash_attention_bias_kq",
                [P, P, P, I, I, I, F, I, I, I, I, I, P])


def flash_attention_bias_kq_plain(qkv: torch.Tensor, bias_t: torch.Tensor,
                                  n_heads: int) -> torch.Tensor:
    """The TPU kernel's arithmetic: fp32 scores ``k·q/√d + bias_t`` as
    (S, Tq), a full fp32 softmax over the keys, the weights rounded to
    qkv's type, then ``v·p`` with fp32 sums.  qkv: (B, H*3*D, T) with
    per-head [q;k;v] channel blocks; bias_t: (H, T, T), (key, query) per
    head -> (B, H*D, T) in qkv's type."""
    b, width, t = qkv.shape
    d = width // (3 * n_heads)
    q, k, v = qkv.reshape(b, n_heads, 3 * d, t).float().split(d, dim=2)
    dots = (torch.einsum("bhcs,bhct->bhst", k, q) * (1.0 / math.sqrt(d))
            + bias_t.float()[None])
    e = torch.exp(dots - dots.amax(dim=2, keepdim=True))
    p = (e / e.sum(dim=2, keepdim=True)).to(qkv.dtype).float()
    out = torch.einsum("bhcs,bhst->bhct", v, p)
    return out.to(qkv.dtype).reshape(b, n_heads * d, t)


def _launch(qkv: torch.Tensor, bias_t: torch.Tensor, n_heads: int,
            plan_: Plan = None):
    b, width, t = qkv.shape
    if width % (3 * n_heads) or width // (3 * n_heads) != 64:
        raise ValueError("flash_attention_bias_kq kernel takes head dim 64, "
                         f"got width {width} for {n_heads} heads")
    if qkv.dtype not in DTYPES or bias_t.dtype != qkv.dtype:
        raise TypeError("flash_attention_bias_kq kernel takes float32 or "
                        "bfloat16 qkv and bias of one type, got "
                        f"{qkv.dtype}/{bias_t.dtype}")
    if bias_t.shape != (n_heads, t, t) or bias_t.device != qkv.device:
        raise ValueError(f"bias_t must be ({n_heads}, {t}, {t}) on "
                         f"{qkv.device}, got {tuple(bias_t.shape)}")
    if not (qkv.is_contiguous() and bias_t.is_contiguous()):
        raise ValueError("flash_attention_bias_kq kernel takes contiguous "
                         "qkv and bias_t")
    out = torch.empty((b, width // 3, t), dtype=qkv.dtype, device=qkv.device)
    launch(KERNEL, (qkv.data_ptr(), bias_t.data_ptr(), out.data_ptr()),
           (qkv, bias_t, out), b, n_heads, t, qkv.dtype, plan_=plan_)
    return out


def flash_attention_bias_kq(qkv: torch.Tensor, bias_t: torch.Tensor,
                            n_heads: int) -> torch.Tensor:
    """softmax over the keys of ``k·q/√d + bias_t[h]``, then v, over
    channels-major qkv (B, H*3*D, T) and the transposed (H, S, Tq) bias,
    already scaled -> (B, H*D, T)."""
    if qkv.device.type == "cpu":
        return flash_attention_bias_kq_plain(qkv, bias_t, n_heads)
    if qkv.device.type != "cuda":
        raise ValueError(
            f"flash_attention_bias_kq: no kernel for {qkv.device}")
    return _launch(qkv, bias_t, n_heads)
