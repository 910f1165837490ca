"""DiffusionTTS denoiser (port of ``tortoise_tts_tpu/models/diffusion.py``).

The 10-layer DiffusionLayer trunk (+3 timestep resblocks) over 100-bin
mel frames, with the latent conditioner (AR hidden states -> code
embedding), the code converter, the contextual embedder that makes the
2048-d diffusion conditioning latent, FiLM scale/shift from that latent
and the classifier-free ``unconditioned_embedding``.

What runs where on the card: each timestep resblock is K4 (``act=True``,
the GroupNorm + silu + 1x1 conv input half) then K5 (the scale-shift
output half with the k=3 conv and the residual), which reads its weight
tap-major, so a forward on the card takes ``prepare(params)`` (``TTS``
prepares once per model); each attention block's [GroupNorm + qkv conv]
head is K4 (``act=False``).  The biased attention
of the integrator's and the trunk's blocks (``ops/attention.qkv_attention``)
takes one of three kernels at T >= 256, by the mode that
``precompute_rel_biases`` builds its biases for
(``Inference.denoise_attention``):
- "auto" (the default): K6 from batch 8 up, plain matmuls below (the
  single route's trunk at B=2 and integrator at B=1);
- "kq" (``transposed=True``, the JAX package's ``TTS_DENOISE_KQ=1``): the
  biases built transposed, (H, S, Tq), and every block through K9a at any
  batch;
- "flash_bias" (``flash_bias=True``, the JAX package's
  ``TTS_FLASH_BIAS=1``): K6 from batch 8 up, K9b's fused entry below.
Below T 256 every mode takes plain matmuls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..kernels.gn_conv import gn_conv1x1
from ..kernels.ts_res_block import prepare_conv, ts_res_block_out
from ..ops.attention import t5_rel_pos_bucket
from .arch import attention_block, attention_block_init
from .common import (conv1d, conv1d_init, embedding, embedding_init,
                     group_norm, group_norm_init, interpolate_nearest,
                     linear, linear_init, norm_groups, normal, silu,
                     sinusoidal_timestep_embedding)

Params = Dict[str, Any]


@dataclass(frozen=True)
class DiffusionConfig:
    """Reference defaults: diffusion.py:1390-1403."""
    model_channels: int = 1024
    num_layers: int = 10
    in_channels: int = 100
    in_latent_channels: int = 1024
    in_tokens: int = 8193
    out_channels: int = 200
    num_heads: int = 16


# timestep-conditioned ResBlock (diffusion.py:1316-1376, scale-shift norm)

def _ts_res_block_init(g: torch.Generator, channels: int, emb_channels: int,
                       kernel_size: int = 3) -> Params:
    return {
        "in_norm": group_norm_init(channels, g.device),
        "in_conv": conv1d_init(g, channels, channels, 1),
        "emb": linear_init(g, emb_channels, 2 * channels),
        "out_norm": group_norm_init(channels, g.device),
        "out_conv": conv1d_init(g, channels, channels, kernel_size),
    }


def _ts_res_block(p: Params, x: torch.Tensor, emb: torch.Tensor
                  ) -> torch.Tensor:
    """x: (B, C, T); emb: (B, C) -> (B, C, T): K4 (act) then K5."""
    groups = norm_groups(x.shape[1])
    emb_out = linear(p["emb"], silu(emb))                  # (B, 2C)
    h = gn_conv1x1(x, p["in_norm"], p["in_conv"], groups, act=True)
    return ts_res_block_out(h, x, emb_out, p["out_norm"], p["out_conv"],
                            groups)


def _diffusion_layer_init(g: torch.Generator, channels: int,
                          num_heads: int) -> Params:
    return {"resblk": _ts_res_block_init(g, channels, channels),
            "attn": attention_block_init(g, channels, num_heads,
                                         relative_pos_embeddings=True)}


def _diffusion_layer(p: Params, x: torch.Tensor, time_emb: torch.Tensor,
                     num_heads: int, bias: Optional[torch.Tensor] = None,
                     bias_kq: bool = False, flash_bias: bool = False
                     ) -> torch.Tensor:
    """``bias_kq``: ``bias`` is transposed, (H, S, Tq)."""
    y = _ts_res_block(p["resblk"], x, time_emb)
    if bias_kq:
        return attention_block(p["attn"], y, num_heads, bias_kq=bias)
    return attention_block(p["attn"], y, num_heads, bias=bias,
                           flash_bias=flash_bias)


def init(g: torch.Generator, cfg: DiffusionConfig = DiffusionConfig()
         ) -> Params:
    """Random parameters with the JAX package's structure and init
    scales, made on the generator's device."""
    C, H = cfg.model_channels, cfg.num_heads
    return {
        "inp_block": conv1d_init(g, cfg.in_channels, C, 3),
        "time_embed_0": linear_init(g, C, C),
        "time_embed_2": linear_init(g, C, C),
        "code_embedding": embedding_init(g, cfg.in_tokens, C, std=1.0),
        "code_converter": [attention_block_init(g, C, H, True)
                           for _ in range(3)],
        "code_norm": group_norm_init(C, g.device),
        "latent_conditioner_conv": conv1d_init(g, cfg.in_latent_channels,
                                               C, 3),
        "latent_conditioner_attn": [attention_block_init(g, C, H, True)
                                    for _ in range(4)],
        "contextual_embedder_conv0": conv1d_init(g, cfg.in_channels, C, 3),
        "contextual_embedder_conv1": conv1d_init(g, C, 2 * C, 3),
        "contextual_embedder_attn": [attention_block_init(g, 2 * C, H, True)
                                     for _ in range(5)],
        "unconditioned_embedding": normal(g, (1, C, 1), 1.0),
        "conditioning_timestep_integrator": [
            _diffusion_layer_init(g, C, H) for _ in range(3)],
        "integrating_conv": conv1d_init(g, 2 * C, C, 1),
        "mel_head": conv1d_init(g, C, cfg.in_channels, 3),
        "layers": [_diffusion_layer_init(g, C, H)
                   for _ in range(cfg.num_layers)],
        "final_res": [_ts_res_block_init(g, C, C) for _ in range(3)],
        "out_norm": group_norm_init(C, g.device),
        "out_conv": conv1d_init(g, C, cfg.out_channels, 3),
    }


def prepare(params: Params) -> Params:
    """The params with every timestep resblock's k=3 ``out_conv`` also in
    K5's tap-major layout (``ts_res_block.prepare_conv``), as a CUDA call
    of K5 needs it: made once per weight (``TTS`` keeps the prepared
    params); every other leaf is shared."""
    def resblock(p):
        return {**p, "out_conv": prepare_conv(p["out_conv"])}

    def layer(p):
        return {**p, "resblk": resblock(p["resblk"])}
    return {**params,
            "conditioning_timestep_integrator": [
                layer(p) for p in params["conditioning_timestep_integrator"]],
            "layers": [layer(p) for p in params["layers"]],
            "final_res": [resblock(p) for p in params["final_res"]]}


# conditioning paths

def get_conditioning(p: Params, cond_mels: torch.Tensor,
                     cfg: DiffusionConfig = DiffusionConfig()
                     ) -> torch.Tensor:
    """Contextual embedder over 100-bin mels (diffusion.py:1477-1485).
    cond_mels: (B, N, 100, T) or (B, 100, T) -> (B, 2C); the N clips are
    concatenated along time, then mean-pooled."""
    if cond_mels.dim() == 3:
        cond_mels = cond_mels[:, None]
    b, n = cond_mels.shape[:2]
    flat = cond_mels.reshape((b * n,) + tuple(cond_mels.shape[2:]))
    h = conv1d(p["contextual_embedder_conv0"], flat, stride=2, padding=1)
    h = conv1d(p["contextual_embedder_conv1"], h, stride=2, padding=1)
    for a in p["contextual_embedder_attn"]:
        h = attention_block(a, h, cfg.num_heads)
    h = h.reshape(b, n, h.shape[1], h.shape[2])
    h = h.permute(0, 2, 1, 3).reshape(b, h.shape[2], -1)
    return h.mean(dim=-1)


def timestep_independent(p: Params, aligned: torch.Tensor,
                         conditioning_latent: torch.Tensor,
                         expected_seq_len: int,
                         cfg: DiffusionConfig = DiffusionConfig(),
                         is_latent: bool = True) -> torch.Tensor:
    """The timestep-independent code embedding (diffusion.py:1487-1515).
    aligned: (B, T, 1024) AR latents (``is_latent``) or (B, T) codes;
    conditioning_latent: (B, 2C) -> (B, C, expected_seq_len)."""
    if is_latent:
        h = conv1d(p["latent_conditioner_conv"], aligned.transpose(1, 2),
                   padding=1)
        for a in p["latent_conditioner_attn"]:
            h = attention_block(a, h, cfg.num_heads)
    else:
        h = embedding(p["code_embedding"], aligned).transpose(1, 2)
        for a in p["code_converter"]:
            h = attention_block(a, h, cfg.num_heads)
    scale, shift = conditioning_latent.chunk(2, dim=1)
    h = group_norm(p["code_norm"], h, norm_groups(h.shape[1]))
    h = h * (1 + scale[..., None]) + shift[..., None]
    return interpolate_nearest(h, expected_seq_len)


def unconditioned_embedding(p: Params, batch: int, seq_len: int
                            ) -> torch.Tensor:
    """The cond-free branch's code embedding (diffusion.py:1533-1536)."""
    u = p["unconditioned_embedding"]
    return u.expand(batch, u.shape[1], seq_len)


def precompute_rel_biases(p: Params, t: int,
                          cfg: DiffusionConfig = DiffusionConfig(),
                          dtype: Optional[torch.dtype] = None,
                          transposed: bool = False,
                          flash_bias: bool = False) -> Dict[str, Any]:
    """The timestep-invariant (H, T, T) rel-pos biases of the integrator
    and trunk attention blocks, built once per sampling loop by a plain
    gather of each table at the shared bucket matrix, scaled by
    sqrt(head_dim) in fp32 and cast to ``dtype``, as the JAX package's
    one-hot build computes them.

    ``transposed``: gather at the transposed bucket matrix, so each bias
    is (H, S, Tq) and every block takes K9a; ``flash_bias``: the blocks
    below batch 8 take K9b.  The result carries the mode as the flags
    ``kq`` and ``flash_bias``, as the JAX package's ``RelBiases`` carries
    ``kq``."""
    if transposed and flash_bias:
        raise ValueError("transposed and flash_bias are two modes; pass one")
    C, H = cfg.model_channels, cfg.num_heads
    blocks = list(p["conditioning_timestep_integrator"]) + list(p["layers"])
    w0 = blocks[0]["attn"]["rel_pos"]["w"]
    bucket = t5_rel_pos_bucket(t, t, w0.shape[0])
    if transposed:
        # (key, query): transposing the static bucket matrix is free
        bucket = bucket.T
    bucket = torch.as_tensor(bucket, dtype=torch.long, device=w0.device)
    cdt = dtype or torch.float32
    per = []
    for blk in blocks:
        w = blk["attn"]["rel_pos"]["w"]
        vals = w.to(cdt)[bucket].float() * math.sqrt(C // H)
        per.append(vals.permute(2, 0, 1).to(cdt).contiguous())
    return {"integrator": per[:3], "layers": per[3:], "kq": transposed,
            "flash_bias": flash_bias}


def _attention_mode(rel_biases) -> Dict[str, bool]:
    """The ``_diffusion_layer`` flags of ``precompute_rel_biases``'s mode."""
    if not rel_biases:
        return {}
    return {"bias_kq": rel_biases["kq"],
            "flash_bias": rel_biases["flash_bias"]}


# denoiser forward

def embed_time(p: Params, timesteps: torch.Tensor,
               cfg: DiffusionConfig = DiffusionConfig(),
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Original-schedule timesteps (N,) -> time embeddings (N, C)
    (diffusion.py:1517-1524)."""
    emb = sinusoidal_timestep_embedding(timesteps, cfg.model_channels)
    return linear(p["time_embed_2"],
                  silu(linear(p["time_embed_0"], emb.to(dtype))))


def integrate_conditioning(p: Params, code_emb: torch.Tensor,
                           time_emb: torch.Tensor,
                           cfg: DiffusionConfig = DiffusionConfig(),
                           rel_biases=None) -> torch.Tensor:
    """The conditioning_timestep_integrator (diffusion.py:1449-1453): 3
    DiffusionLayers over code_emb, conditioned on the time embedding."""
    bi = rel_biases["integrator"] if rel_biases else [None] * 3
    mode = _attention_mode(rel_biases)
    h = code_emb
    for lyr, bias in zip(p["conditioning_timestep_integrator"], bi):
        h = _diffusion_layer(lyr, h, time_emb, cfg.num_heads, bias=bias,
                             **mode)
    return h


def forward_trunk(p: Params, x: torch.Tensor, time_emb: torch.Tensor,
                  h: torch.Tensor, cfg: DiffusionConfig = DiffusionConfig(),
                  rel_biases=None) -> torch.Tensor:
    """The denoiser after the integrator: x (B, 100, T), time_emb (B, C),
    h (B, C, T) -> (B, 200, T) [eps | variance values], fp32."""
    bl = rel_biases["layers"] if rel_biases else [None] * len(p["layers"])
    mode = _attention_mode(rel_biases)
    xh = conv1d(p["inp_block"], x, padding=1)
    xh = torch.cat([xh, h.to(xh.dtype)], dim=1)
    xh = conv1d(p["integrating_conv"], xh)
    for lyr, bias in zip(p["layers"], bl):
        xh = _diffusion_layer(lyr, xh, time_emb, cfg.num_heads, bias=bias,
                              **mode)
    for rb in p["final_res"]:
        xh = _ts_res_block(rb, xh, time_emb)
    out = group_norm(p["out_norm"], xh.float(),
                     norm_groups(cfg.model_channels))
    return conv1d(p["out_conv"], silu(out), padding=1)


def forward(p: Params, x: torch.Tensor, timesteps: torch.Tensor,
            code_emb: torch.Tensor, cfg: DiffusionConfig = DiffusionConfig(),
            rel_biases=None) -> torch.Tensor:
    """x: (B, 100, T); timesteps: (B,) original-schedule values;
    code_emb: (B, C, T) -> (B, 200, T)."""
    time_emb = embed_time(p, timesteps, cfg, x.dtype)
    h = integrate_conditioning(p, code_emb, time_emb, cfg, rel_biases)
    return forward_trunk(p, x, time_emb, h, cfg, rel_biases)
