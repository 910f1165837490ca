"""Shared attention building blocks (port of the slice of
``tortoise_tts_tpu/models/arch.py`` the inference path runs): the
AttentionBlock with its optional T5 relative-position bias, and the
UnifiedVoice conditioning encoder.

Every ``attention_block`` runs its [GroupNorm32 + qkv conv1x1] head
through K4 (``kernels/gn_conv``) on the card, at every T: the TPU
kernel's ``t % 128`` guard was a Mosaic tiling limit, so the AR
conditioning encoder (517 frames) takes the kernel too.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels.gn_conv import gn_conv1x1
from ..ops.attention import qkv_attention
from .common import conv1d, conv1d_init, norm_groups, norm_init, normal

Params = Dict[str, Any]

REL_POS_NUM_BUCKETS = 32


def attention_block_init(g: torch.Generator, channels: int,
                         num_heads: int = 1,
                         relative_pos_embeddings: bool = False) -> Params:
    p = {
        "norm": norm_init(channels, g.device),
        "qkv": conv1d_init(g, channels, channels * 3, 1),
        # proj_out is zero-initialised in the reference (zero_module)
        "proj_out": {"w": torch.zeros(channels, channels, 1, device=g.device),
                     "b": torch.zeros(channels, device=g.device)},
    }
    if relative_pos_embeddings:
        p["rel_pos"] = {"w": normal(g, (REL_POS_NUM_BUCKETS, num_heads), 1.0)}
    return p


def conditioning_encoder_init(g: torch.Generator, spec_dim: int,
                              embedding_dim: int,
                              attn_blocks: int = 6) -> Params:
    return {"init": conv1d_init(g, spec_dim, embedding_dim, 1),
            "attn": [attention_block_init(g, embedding_dim)
                     for _ in range(attn_blocks)]}


def attention_block(p: Params, x: torch.Tensor, num_heads: int,
                    bias: Optional[torch.Tensor] = None,
                    bias_kq: Optional[torch.Tensor] = None,
                    flash_bias: bool = False) -> torch.Tensor:
    """x: (B, C, T) -> (B, C, T).  ``bias``: a precomputed (H, T, T)
    rel-pos bias, already scaled (``diffusion.precompute_rel_biases``),
    or ``bias_kq``: the same transposed, (H, S, Tq); without either a
    block that has a rel-pos table builds its bias here.  ``flash_bias``
    lets a small batch take K9b (``ops/attention.qkv_attention``)."""
    c = x.shape[1]
    qkv = gn_conv1x1(x, p["norm"], p["qkv"], norm_groups(c), act=False)
    if bias_kq is not None:
        a = qkv_attention(qkv, num_heads, bias_kq=bias_kq)
    elif bias is not None:
        a = qkv_attention(qkv, num_heads, bias=bias, flash_bias=flash_bias)
    else:
        rel_w = p.get("rel_pos", {}).get("w")
        # the reference scales the rel-pos embedding by sqrt(head_dim)
        # (arch_utils.py:174)
        scale = math.sqrt(c // num_heads) if rel_w is not None else 1.0
        a = qkv_attention(qkv, num_heads, rel_pos_w=rel_w,
                          rel_pos_scale=scale)
    return x + conv1d(p["proj_out"], a)


def conditioning_encoder(p: Params, x: torch.Tensor, num_attn_heads: int,
                         mean: bool = False) -> torch.Tensor:
    """x: (B, spec_dim, T) -> (B, embedding_dim)."""
    h = conv1d(p["init"], x)
    for a in p["attn"]:
        h = attention_block(a, h, num_attn_heads)
    return h.mean(dim=2) if mean else h[:, :, 0]
