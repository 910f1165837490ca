"""Shared building blocks (port of ``tortoise_tts_tpu/models/arch.py``):
the AttentionBlock with its optional T5 relative-position bias, the
UnifiedVoice conditioning encoder, and the classifier's pieces: Upsample,
Downsample, the ResBlock and the AudioMiniEncoder.

Every ``attention_block`` runs its [GroupNorm32 + qkv conv1x1] head
through K4 (``kernels/gn_conv``) on the card, at every T: the TPU
kernel's ``t % 128`` guard was a Mosaic tiling limit, so the AR
conditioning encoder (517 frames) and the classifier (C = 512, T about
218) take the kernel too.  The ResBlock's GroupNorms are plain library
ops, as in the JAX package (no Pallas kernel there).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from ..kernels.gn_conv import gn_conv1x1
from ..ops.attention import qkv_attention
from .common import (conv1d, conv1d_init, group_norm, norm_groups,
                     norm_init, normal, silu)

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


# Up/Downsample (arch_utils.py:193-245)

def upsample_init(g: torch.Generator, channels: int, use_conv: bool,
                  out_channels: Optional[int] = None) -> Params:
    out_channels = out_channels or channels
    return ({"conv": conv1d_init(g, channels, out_channels, 5)}
            if use_conv else {})


def upsample(p: Params, x: torch.Tensor, factor: int = 4) -> torch.Tensor:
    """Nearest-neighbour up-sampling by ``factor``, then the k=5 conv."""
    x = x.repeat_interleave(factor, dim=-1)
    return conv1d(p["conv"], x, padding=2) if "conv" in p else x


def downsample_init(g: torch.Generator, channels: int, use_conv: bool,
                    out_channels: Optional[int] = None,
                    ksize: int = 5) -> Params:
    out_channels = out_channels or channels
    return ({"op": conv1d_init(g, channels, out_channels, ksize)}
            if use_conv else {})


def downsample(p: Params, x: torch.Tensor, factor: int = 4,
               use_conv: bool = True, pad: int = 2) -> torch.Tensor:
    """The strided conv, or AvgPool1d(factor) without one."""
    if use_conv:
        return conv1d(p["op"], x, stride=factor, padding=pad)
    t = (x.shape[-1] // factor) * factor
    return x[..., :t].reshape(*x.shape[:-1], -1, factor).mean(-1)


# ResBlock (arch_utils.py:248-313)

def res_block_init(g: torch.Generator, channels: int,
                   out_channels: Optional[int] = None,
                   use_conv: bool = False, kernel_size: int = 3) -> Params:
    out_channels = out_channels or channels
    dev = g.device
    p = {"in_norm": norm_init(channels, dev),
         "in_conv": conv1d_init(g, channels, out_channels, kernel_size),
         "out_norm": norm_init(out_channels, dev),
         # the reference zero-initialises the out conv (zero_module)
         "out_conv": {"w": torch.zeros(out_channels, out_channels,
                                       kernel_size, device=dev),
                      "b": torch.zeros(out_channels, device=dev)}}
    if out_channels != channels:
        p["skip"] = conv1d_init(g, channels, out_channels,
                                kernel_size if use_conv else 1)
    return p


def res_block(p: Params, x: torch.Tensor, kernel_size: int = 3
              ) -> torch.Tensor:
    pad = 1 if kernel_size == 3 else 2
    h = silu(group_norm(p["in_norm"], x, norm_groups(x.shape[1])))
    h = conv1d(p["in_conv"], h, padding=pad)
    h = silu(group_norm(p["out_norm"], h, norm_groups(h.shape[1])))
    h = conv1d(p["out_conv"], h, padding=pad)
    if "skip" in p:
        k = p["skip"]["w"].shape[-1]
        x = conv1d(p["skip"], x, padding={3: 1, 5: 2}.get(k, 0))
    return x + h


# AudioMiniEncoder (arch_utils.py:316-356)

def audio_mini_encoder_init(g: torch.Generator, spec_dim: int,
                            embedding_dim: int, base_channels: int = 128,
                            depth: int = 2, resnet_blocks: int = 2,
                            attn_blocks: int = 4, num_attn_heads: int = 4,
                            downsample_factor: int = 2,
                            kernel_size: int = 3) -> Params:
    """``num_attn_heads`` and ``downsample_factor`` shape no parameter;
    they are kept for the JAX package's signature."""
    del num_attn_heads, downsample_factor
    p: Params = {"init": conv1d_init(g, spec_dim, base_channels, 3)}
    ch, res = base_channels, []
    for _ in range(depth):
        for _ in range(resnet_blocks):
            res.append({"res": res_block_init(g, ch,
                                              kernel_size=kernel_size)})
        res.append({"down": downsample_init(g, ch, True, ch * 2)})
        ch *= 2
    p["res"] = res
    p["final_norm"] = norm_init(ch, g.device)
    p["final_conv"] = conv1d_init(g, ch, embedding_dim, 1)
    p["attn"] = [attention_block_init(g, embedding_dim)
                 for _ in range(attn_blocks)]
    return p


def audio_mini_encoder(p: Params, x: torch.Tensor, num_attn_heads: int = 4,
                       kernel_size: int = 3,
                       downsample_factor: int = 2) -> torch.Tensor:
    """x: (B, spec_dim, T) -> (B, embedding_dim), position 0 of the
    attention stack's output.  Each attention block's head is one K4 call
    on the card."""
    h = conv1d(p["init"], x, padding=1)
    for blk in p["res"]:
        if "res" in blk:
            h = res_block(blk["res"], h, kernel_size=kernel_size)
        else:
            h = downsample(blk["down"], h, factor=downsample_factor)
    h = silu(group_norm(p["final_norm"], h, norm_groups(h.shape[1])))
    h = conv1d(p["final_conv"], h)
    for a in p["attn"]:
        h = attention_block(a, h, num_attn_heads)
    return h[:, :, 0]
