"""K1: causal flash attention for the UnifiedVoice trunk (the AR prefill
and the latent pass).

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_attention.py``
``flash_attention`` (``_attn_kernel``).  The CUDA source is
``csrc/flash_attention.cu``; its header gives the bound on an H100 and
the design: in bf16 one ``flash_attn_mma`` launch (tensor cores), in fp32
one ``flash_attn_f32`` launch (CUDA cores).  ``plan`` is the bf16
kernel's launch plan.

``flash_attention`` runs the plain PyTorch version for CPU tensors and
the kernel for CUDA tensors (it raises on what the kernel does not
take).  On CUDA the call is a ``torch.autograd.Function`` whose backward
recomputes the plain version, as the JAX package's ``custom_vjp`` does
(``unified_voice.py:44-64``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..ops.attention import mha
from ._build import F, I, LL, P, Kernel

KERNEL = Kernel("flash_attention", "tts_flash_attention_fwd",
                [P] * 5 + [I] * 4 + [LL] * 12 + [I, F, I, I, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132           # streaming multiprocessors of an H100 SXM
KEY_TILE = 64       # keys a shared-memory tile (KT in the source)
MAX_TILES = 8       # key tiles resident at once: 8 x 16 KB of K and V
MAX_WAVES = 3       # blocks an SM that a key split may cost (see plan)
SMEM_MAX = 232448   # dynamic shared memory a block may use on an H100
MERGE_BYTES = 4 * 36 * 32 * 4   # 4 warps' partial softmax states


def plan(b: int, h: int, s: int) -> Tuple[int, int, int]:
    """Launch plan of the bf16 kernel for (B, H, S): (wk, query blocks a
    (batch, head), key-tile buffers).  A block is 4 warps; ``wk`` of them
    (4, 2 or 1) share the keys of one 16-query tile, so a block holds 4 /
    wk query tiles.  Splitting the keys shortens the heaviest (diagonal)
    block's chain of tiles, but every query block loads its own K/V prefix:
    ``wk`` is the widest split whose grid stays within MAX_WAVES blocks an
    SM (the prefill and latent pass at B=1 split 4 ways, the batch's
    prefill 2, its latent pass not; ``tools/attention_profile.py``'s
    shapes).  Every key tile of the heaviest (last) query block stays
    resident up to MAX_TILES; beyond that they stream through a ring of
    MAX_TILES."""
    for wk in (4, 2, 1):
        tiles = -(-s // (16 * 4 // wk))
        if tiles * b * h <= MAX_WAVES * SMS:
            break
    return wk, tiles, min(-(-s // KEY_TILE), MAX_TILES)


def smem_bytes(s: int, nbuf: int, masked: bool) -> int:
    """Dynamic shared memory of a bf16 launch: nbuf K and V tiles (or the
    warps' partial states after the key loop, MERGE_BYTES), and the key
    mask's S bytes rounded up to 16."""
    tiles = max(2 * nbuf * KEY_TILE * 64 * 2, MERGE_BYTES)
    return tiles + (-(-s // 16) * 16 if masked else 0)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: Optional[torch.Tensor] = None,
                          causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, S, D); key_mask: (B, S) bool, True = valid key."""
    mask = key_mask[:, None, None, :] if key_mask is not None else None
    return mha(q, k, v, mask=mask, causal=causal)


def _aligned(t: torch.Tensor, elems: int) -> bool:
    """Base pointer and the three outer strides on ``elems`` elements."""
    return t.data_ptr() % (elems * t.element_size()) == 0 \
        and all(st % elems == 0 for st in t.stride()[:3])


def _launch(q, k, v, key_mask, causal):
    b, h, s, d = q.shape
    if d != 64:
        raise ValueError(f"flash_attention kernel takes head dim 64, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q/k/v of one type, got {q.dtype}/{k.dtype}/{v.dtype}")
    for t in (k, v):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError("q, k, v must share shape and device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v need a unit head-dim stride")
    bf16 = q.dtype == torch.bfloat16
    # bf16: 16-byte copies of k and v rows, 4-byte reads of q; fp32: pairs
    kv_elems, q_elems = (8, 2) if bf16 else (2, 1)
    if not all(_aligned(t, kv_elems) for t in (k, v)) \
            or not _aligned(q, q_elems):
        raise ValueError(
            f"flash_attention kernel needs k, v rows aligned to "
            f"{kv_elems * q.element_size()} bytes and q to "
            f"{q_elems * q.element_size()} (base pointers and strides)")
    mask = None
    if key_mask is not None:
        if key_mask.shape != (b, s) or key_mask.device != q.device:
            raise ValueError(f"key_mask must be ({b}, {s}) on {q.device}")
        mask = key_mask.to(torch.bool).contiguous().view(torch.uint8)
    wk, tiles, nbuf = plan(b, h, s)
    if bf16 and smem_bytes(s, nbuf, mask is not None) > SMEM_MAX:
        raise ValueError(f"flash_attention kernel: S={s} key mask does not "
                         f"fit in shared memory")
    # (B, S, H, D) memory returned as a (B, H, S, D) view: the caller's
    # transpose back to (B, S, H*D) is then free
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  mask.data_ptr() if mask is not None else None,
                  out.data_ptr(), b, h, s, _DTYPES[q.dtype],
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], int(causal), 1.0 / math.sqrt(d),
                  wk, tiles, nbuf,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        ctx.save_for_backward(q, k, v)
        ctx.key_mask, ctx.causal = key_mask, causal
        return _launch(q, k, v, key_mask, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_plain(q, k, v, ctx.key_mask, ctx.causal)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q kᵀ/√D + key mask [+ causal]) v.  q, k, v: (B, H, S, D)
    -> (B, H, S, D); key_mask: (B, S) bool, True = valid key."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    return _FlashAttention.apply(q, k, v, key_mask, causal)
