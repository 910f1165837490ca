"""Attention ops (port of ``tortoise_tts_tpu/ops/attention.py``).

- ``qkv_attention``: the conv-style fused-QKV attention of the
  conditioning encoder's AttentionBlock on channels-major (B, 3*H*C, T)
  tensors with the per-head [q;k;v] interleave; the 1/sqrt(sqrt(ch))
  scale goes on both q and k, with an optional T5 relative-position
  bias (``rel_pos_w``, a precomputed ``bias``, or the same transposed,
  ``bias_kq``).  A precomputed bias at T >= 256 takes one of three
  kernels, chosen as the JAX package chooses its Pallas kernels, by the
  denoiser's ``Inference.denoise_attention`` mode
  (``diffusion.precompute_rel_biases``): K6
  (``kernels/flash_attention_bias``) from batch 8 up in every mode; K9a
  (``kernels/flash_attention_bias_kq``) for a transposed bias ("kq") at
  any batch; K9b's fused entry (``kernels/flash_attention_bias_cm``)
  below batch 8 with ``flash_bias`` ("flash_bias").  Everything else,
  the single-utterance denoiser in the default "auto" mode included,
  takes plain matmuls.
- ``mha``: batched multi-head attention on (B, H, T, D) with causal and
  padding masks.  It is the plain version of the trunk and decode
  attention kernels (kernels/flash_attention.py, kernels/flash_decode.py).

Masks use a finite ``NEG_INF`` so a row whose keys are partly masked
never produces NaN.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e9


def t5_rel_pos_bucket(n_query: int, n_key: int, num_buckets: int = 32,
                      max_distance: int = 64) -> np.ndarray:
    """Non-causal T5 relative-position buckets (xtransformers.py:157-177),
    int32 (n_query, n_key), built with numpy."""
    rel = np.arange(n_key)[None, :] - np.arange(n_query)[:, None]
    n = -rel
    nb = num_buckets // 2
    ret = (n < 0).astype(np.int64) * nb
    n = np.abs(n)
    max_exact = nb // 2
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1).astype(np.float64) / max_exact)
        / math.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, nb - 1)
    ret = ret + np.where(n < max_exact, n, val_if_large)
    return ret.astype(np.int32)


@lru_cache(maxsize=16)
def _bucket_tensors(n: int, num_buckets: int, max_distance: int, device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (n, n) bucket matrix on the device and its (2n - 1,) buckets by
    relative position k - q + n - 1, made once per size and device (the
    numpy build takes tens of ms at the training T of 2240)."""
    b = t5_rel_pos_bucket(n, n, num_buckets, max_distance)
    rel = np.concatenate([b[1:, 0][::-1], b[0, :]])
    # normal tensors even when first made under inference_mode: training
    # saves them for the backward
    with torch.inference_mode(False):
        return tuple(torch.as_tensor(np.ascontiguousarray(a),
                                     dtype=torch.long, device=device)
                     for a in (b, rel))


class _RelPosBias(torch.autograd.Function):
    """The (H, T, T) bias gathered from a (buckets, H) table.  Its backward
    sums the gradient along each diagonal (one relative position: a pad,
    a view and a column sum) and adds the 2T - 1 sums into the table:
    the gather's own backward accumulates T^2 rows into 32, which on the
    card serialises on the few rows (seconds a step at T = 2240)."""

    @staticmethod
    def forward(ctx, w, n, num_buckets, max_distance):
        bucket, rel = _bucket_tensors(n, num_buckets, max_distance, w.device)
        ctx.save_for_backward(rel)
        ctx.shape = w.shape
        return w[bucket].permute(2, 0, 1)

    @staticmethod
    def backward(ctx, g):
        (rel,) = ctx.saved_tensors
        h, n = g.shape[0], g.shape[-1]
        # row q of the skewed view holds g[q, k] at column n-1 - (k - q)
        acc = torch.promote_types(g.dtype, torch.float32)
        skew = torch.nn.functional.pad(g.to(acc).flip(-1), (0, n))
        skew = skew.reshape(h, -1)[:, :n * (2 * n - 1)].reshape(h, n,
                                                                2 * n - 1)
        diag = skew.sum(1).flip(-1)            # (H, 2n - 1) by k - q + n - 1
        gw = torch.zeros(ctx.shape, dtype=acc, device=g.device)
        gw.index_add_(0, rel, diag.t())
        return gw.to(g.dtype), None, None, None


def rel_pos_bias_from_table(emb_w: torch.Tensor, n_q: int, n_k: int,
                            num_buckets: int = 32,
                            max_distance: int = 64) -> torch.Tensor:
    """(num_buckets, heads) table -> (heads, n_q, n_k) bias (unscaled), by
    a plain gather (every call site is square: n_q == n_k)."""
    if n_q != n_k:
        raise ValueError(f"rel-pos bias of a square block, got {n_q}x{n_k}")
    return _RelPosBias.apply(emb_w, n_q, num_buckets, max_distance)


def qkv_attention(qkv: torch.Tensor, n_heads: int,
                  rel_pos_w: Optional[torch.Tensor] = None,
                  rel_pos_scale: float = 1.0,
                  bias: Optional[torch.Tensor] = None,
                  bias_kq: Optional[torch.Tensor] = None,
                  flash_bias: bool = False) -> torch.Tensor:
    """qkv: (B, H*3*C, T) -> (B, H*C, T), non-causal, unmasked (every
    call site passes no mask).  ``bias``: a precomputed (H, T, T) bias,
    already scaled; ``bias_kq``: the same transposed, (H, S, Tq); else
    ``rel_pos_w``: a (buckets, H) T5 table, scaled by ``rel_pos_scale``.

    The JAX package's dispatch (``ops/attention.py:85-119``), kernel for
    kernel: ``bias_kq`` at T >= 256 goes through K9a, below that it is
    transposed back and takes the path of ``bias``; ``bias`` at T >= 256
    goes through K6 from batch 8 up and, with ``flash_bias``, through
    K9b's fused entry below batch 8.  The rest takes plain matmuls:
    fp32 scores for fp32 inputs, bf16 scores for bf16 inputs, as the JAX
    package's reduced-precision score path does."""
    b, width, t = qkv.shape
    # imported here: the kernels package imports this module
    if bias_kq is not None:
        if t >= 256:
            from ..kernels import flash_attention_bias_kq as k9a
            return k9a.flash_attention_bias_kq(qkv, bias_kq, n_heads)
        bias = bias_kq.transpose(1, 2)
    if bias is not None and t >= 256:
        if b >= 8:
            from ..kernels import flash_attention_bias as k6
            return k6.flash_attention_bias(qkv, bias, n_heads)
        if flash_bias:
            from ..kernels import flash_attention_bias_cm as k9b
            return k9b.flash_attention_bias_qkv(qkv, bias, n_heads)
    ch = width // (3 * n_heads)
    q, k, v = qkv.reshape(b, n_heads, 3 * ch, t).split(ch, dim=2)
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    dots = torch.einsum("bhct,bhcs->bhts", q * scale, k * scale)
    if bias is not None:
        dots = dots + bias[None].to(dots.dtype)
    elif rel_pos_w is not None:
        rel = rel_pos_bias_from_table(rel_pos_w, t, t)
        dots = dots + rel[None].to(dots.dtype) * rel_pos_scale
    if qkv.dtype == torch.bfloat16:
        w = torch.softmax(dots, dim=-1)
    else:
        w = torch.softmax(dots.float(), dim=-1).to(qkv.dtype)
    out = torch.einsum("bhts,bhcs->bhct", w, v)
    return out.reshape(b, n_heads * ch, t)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None, causal: bool = False,
        scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, H, T, D); mask: bool broadcastable to (B, H, Tq, Tk),
    True = attend.  fp32 scores and softmax; the weights are cast to the
    query dtype before the AV product.  Returns (B, H, Tq, D)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dots = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = dots.shape[-2:]
        cm = torch.ones(tq, tk, dtype=torch.bool,
                        device=dots.device).tril(tk - tq)
        dots = dots.masked_fill(~cm, NEG_INF)
    if mask is not None:
        dots = dots.masked_fill(~mask, NEG_INF)
    w = torch.softmax(dots, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)
