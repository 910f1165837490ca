"""CLVP, the contrastive text/speech model that reranks the AR candidates
(port of ``tortoise_tts_tpu/models/clvp.py``, the inference forward).

Two 20-layer, 768-wide, 12-head encoders with RMSNorm pre-norm, rotary
positions (dim 32, applied to q, k and v, a quirk of the vendored
xtransformers) and a GEGLU feed-forward; ``forward`` returns one
similarity per (text, speech) row, or with ``return_loss`` the
symmetric InfoNCE loss of the batch (the training objective).  The
legacy DALLE-style encoder (``legacy_encoder``: LayerNorm pre-norm,
LayerScale, GEGLU, masked non-causal attention) is here too.  The JAX
package has no Pallas kernel in CLVP, so its matmuls and attention stay
plain PyTorch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF
from .common import (embedding, embedding_init, layer_norm, linear,
                     linear_init, norm_init, rms_norm)

Params = Dict[str, Any]


@dataclass(frozen=True)
class CLVPConfig:
    """Reference defaults: clvp.py:28-46."""
    dim_text: int = 768
    dim_speech: int = 768
    dim_latent: int = 768
    num_text_tokens: int = 256
    text_enc_depth: int = 20
    text_heads: int = 12
    num_speech_tokens: int = 8192
    speech_enc_depth: int = 20
    speech_heads: int = 12
    dim_head: int = 64
    ff_mult: int = 2
    rotary_dim: int = 32


def _encoder_init(g: torch.Generator, dim: int, depth: int, heads: int,
                  dim_head: int, ff_mult: int) -> Params:
    inner, ff_inner = dim_head * heads, dim * ff_mult
    layers = [{
        "attn_norm": {"scale": torch.ones(dim, device=g.device)},
        "to_q": linear_init(g, dim, inner, bias=False),
        "to_k": linear_init(g, dim, inner, bias=False),
        "to_v": linear_init(g, dim, inner, bias=False),
        "to_out": linear_init(g, inner, dim),
        "ff_norm": {"scale": torch.ones(dim, device=g.device)},
        "ff_proj": linear_init(g, dim, ff_inner * 2),
        "ff_out": linear_init(g, ff_inner, dim),
    } for _ in range(depth)]
    return {"layers": layers, "final_norm": norm_init(dim, g.device)}


def init(g: torch.Generator, cfg: CLVPConfig = CLVPConfig()) -> Params:
    """Random parameters with the JAX package's structure and init scales
    (the token embeddings are N(0, 1), as the reference's nn.Embedding)."""
    return {
        "text_emb": embedding_init(g, cfg.num_text_tokens, cfg.dim_text,
                                   std=1.0),
        "speech_emb": embedding_init(g, cfg.num_speech_tokens,
                                     cfg.dim_speech, std=1.0),
        "to_text_latent": linear_init(g, cfg.dim_text, cfg.dim_latent,
                                      bias=False),
        "to_speech_latent": linear_init(g, cfg.dim_speech, cfg.dim_latent,
                                        bias=False),
        "text_transformer": _encoder_init(g, cfg.dim_text,
                                          cfg.text_enc_depth, cfg.text_heads,
                                          cfg.dim_head, cfg.ff_mult),
        "speech_transformer": _encoder_init(g, cfg.dim_speech,
                                            cfg.speech_enc_depth,
                                            cfg.speech_heads, cfg.dim_head,
                                            cfg.ff_mult),
        "temperature": torch.ones((), device=g.device),
    }


def _rotary(t_len: int, rotary_dim: int, device
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xtransformers RotaryEmbedding (xtransformers.py:266-293), built in
    numpy as the JAX package builds it."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, rotary_dim, 2) / rotary_dim))
    freqs = np.arange(t_len)[:, None] * inv_freq[None]
    emb = np.concatenate([freqs, freqs], axis=-1).astype(np.float32)
    return (torch.from_numpy(np.cos(emb)).to(device),
            torch.from_numpy(np.sin(emb)).to(device))


def _apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                  rot: int) -> torch.Tensor:
    """x: (B, H, T, D); rotates the first ``rot`` dims."""
    xl, xr = x[..., :rot], x[..., rot:]
    x1, x2 = xl.chunk(2, dim=-1)
    xl = xl * cos + torch.cat([-x2, x1], dim=-1) * sin
    return torch.cat([xl.to(x.dtype), xr], dim=-1)


def _encoder(p: Params, x: torch.Tensor, mask: Optional[torch.Tensor],
             heads: int, dim_head: int, rotary_dim: int) -> torch.Tensor:
    """Pre-norm RMSNorm encoder.  x: (B, T, D); mask: (B, T), True =
    valid."""
    b, t, _ = x.shape
    cos, sin = _rotary(t, rotary_dim, x.device)
    scale = dim_head ** -0.5
    attn_mask = None
    if mask is not None:
        attn_mask = mask[:, None, :, None] & mask[:, None, None, :]

    def split(z):
        return z.reshape(b, t, heads, dim_head).transpose(1, 2)

    for lp in p["layers"]:
        h = rms_norm(lp["attn_norm"], x)
        q, k, v = (_apply_rotary(split(linear(lp[n], h)), cos, sin,
                                 rotary_dim)
                   for n in ("to_q", "to_k", "to_v"))
        dots = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        if attn_mask is not None:
            dots = dots.masked_fill(~attn_mask, NEG_INF)
        w = torch.softmax(dots, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", w, v)
        x = x + linear(lp["to_out"], o.transpose(1, 2).reshape(b, t, -1))
        # GEGLU feed-forward (xtransformers.py:432-480, exact gelu)
        a, gate = linear(lp["ff_proj"], rms_norm(lp["ff_norm"], x)).chunk(
            2, dim=-1)
        x = x + linear(lp["ff_out"], a * F.gelu(gate))
    return layer_norm(p["final_norm"], x)


# the legacy DALLE-style tower (reference transformer.py,
# use_xformers=False)

def _layer_scale_init(depth_ind: int, dim: int, device=None) -> torch.Tensor:
    """LayerScale's depth-dependent init (transformer.py)."""
    eps = 0.1 if depth_ind <= 18 else 1e-5 if depth_ind <= 24 else 1e-6
    return torch.full((1, 1, dim), eps, device=device)


def legacy_encoder_init(g: torch.Generator, dim: int, depth: int,
                        heads: int, dim_head: int = 64,
                        ff_mult: int = 4) -> Params:
    inner = dim_head * heads
    return {"layers": [{
        "attn_norm": norm_init(dim, g.device),
        "to_qkv": linear_init(g, dim, inner * 3, bias=False),
        "to_out": linear_init(g, inner, dim),
        "attn_scale": _layer_scale_init(ind + 1, dim, g.device),
        "ff_norm": norm_init(dim, g.device),
        "ff_in": linear_init(g, dim, dim * ff_mult * 2),
        "ff_out": linear_init(g, dim * ff_mult, dim),
        "ff_scale": _layer_scale_init(ind + 1, dim, g.device),
    } for ind in range(depth)]}


def legacy_encoder(p: Params, x: torch.Tensor, mask: Optional[torch.Tensor],
                   heads: int, dim_head: int = 64) -> torch.Tensor:
    """PreNorm + LayerScale stack, non-causal (transformer.py:99-220).
    x: (B, T, D); mask: (B, T), True = a key that may be attended."""
    b, t, _ = x.shape
    scale = dim_head ** -0.5

    def split(z):
        return z.reshape(b, t, heads, dim_head).transpose(1, 2)

    for lp in p["layers"]:
        q, k, v = linear(lp["to_qkv"], layer_norm(lp["attn_norm"], x)
                         ).chunk(3, dim=-1)
        q, k, v = split(q) * scale, split(k), split(v)
        dots = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
        if mask is not None:
            dots = dots.masked_fill(~mask[:, None, None, :], NEG_INF)
        w = torch.softmax(dots, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", w, v)
        x = x + linear(lp["to_out"], o.transpose(1, 2).reshape(b, t, -1)
                       ) * lp["attn_scale"]
        a, gate = linear(lp["ff_in"], layer_norm(lp["ff_norm"], x)).chunk(
            2, dim=-1)
        x = x + linear(lp["ff_out"], a * F.gelu(gate)) * lp["ff_scale"]
    return x


def _masked_mean(t: torch.Tensor, mask: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    if mask is None:
        return t.mean(dim=1)
    m = mask[..., None].to(t.dtype)
    return (t * m).sum(dim=1) / m.sum(dim=1)


def latents(params: Params, text: torch.Tensor, speech_tokens: torch.Tensor,
            cfg: CLVPConfig = CLVPConfig(),
            text_mask: Optional[torch.Tensor] = None,
            speech_mask: Optional[torch.Tensor] = None):
    """Unit-norm text and speech latents (clvp.py:100-130)."""
    enc_t = _encoder(params["text_transformer"],
                     embedding(params["text_emb"], text), text_mask,
                     cfg.text_heads, cfg.dim_head, cfg.rotary_dim)
    enc_s = _encoder(params["speech_transformer"],
                     embedding(params["speech_emb"], speech_tokens),
                     speech_mask, cfg.speech_heads, cfg.dim_head,
                     cfg.rotary_dim)
    tl = linear(params["to_text_latent"], _masked_mean(enc_t, text_mask))
    sl = linear(params["to_speech_latent"], _masked_mean(enc_s, speech_mask))
    return (tl / torch.linalg.vector_norm(tl, dim=-1, keepdim=True),
            sl / torch.linalg.vector_norm(sl, dim=-1, keepdim=True))


def forward(params: Params, text: torch.Tensor, speech_tokens: torch.Tensor,
            cfg: CLVPConfig = CLVPConfig(), return_loss: bool = False,
            text_mask: Optional[torch.Tensor] = None,
            speech_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Similarity scores (B,) of each text row with its speech row, or
    with ``return_loss`` the symmetric InfoNCE loss over the batch's
    (B, B) similarities, row r's match at column r (clvp.py:132-141)."""
    tl, sl = latents(params, text, speech_tokens, cfg, text_mask,
                     speech_mask)
    temp = torch.exp(params["temperature"])
    if not return_loss:
        return (tl * sl).sum(dim=-1) * temp
    sim = torch.einsum("id,jd->ij", tl, sl) * temp
    labels = torch.arange(sim.shape[0], device=sim.device)
    return (F.cross_entropy(sim, labels) + F.cross_entropy(sim.T, labels)) / 2
