"""DVAE, the discrete mel quantiser (port of
``tortoise_tts_tpu/models/dvae.py``, reference dvae.py:12-315).

Strided-conv encoder and decoder around an EMA-updated codebook (8192
codes of 512 dims).  ``get_codebook_indices`` gives the AR model's mel
codes, ``decode`` turns codes back into the normalised 80-bin mel
(train.py's ``run_eval`` compares against it), and ``forward(...,
training=True)`` returns the reconstruction and commitment losses with
the codebook's next EMA state, which the train step writes over the
codebook buffers out of the gradient.  Library ops only: the JAX module
reaches no Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .common import conv1d, conv1d_init, normal

Params = Dict[str, Any]


@dataclass(frozen=True)
class DVAEConfig:
    """Reference defaults (dvae.py:117-137 as instantiated with no kwargs)."""
    num_tokens: int = 8192
    codebook_dim: int = 512
    num_layers: int = 2
    num_resnet_blocks: int = 3
    hidden_dim: int = 512
    channels: int = 80
    stride: int = 2
    kernel_size: int = 3
    decay: float = 0.99
    eps: float = 1e-5


class VQState(NamedTuple):
    """EMA codebook state (dvae.py:24-27 buffers)."""
    embed: torch.Tensor         # (dim, n_embed)
    cluster_size: torch.Tensor  # (n_embed,)
    embed_avg: torch.Tensor     # (dim, n_embed)


def _res_init(g: torch.Generator, ch: int) -> Params:
    return {"c1": conv1d_init(g, ch, ch, 3), "c2": conv1d_init(g, ch, ch, 3),
            "c3": conv1d_init(g, ch, ch, 1)}


def init(g: torch.Generator, cfg: DVAEConfig = DVAEConfig()) -> Params:
    """Random parameters with the JAX package's structure and init
    scales, made on the generator's device."""
    h, c = cfg.hidden_dim, cfg.channels
    enc_chans = [h * 2 ** i for i in range(cfg.num_layers)]
    dec_chans = list(reversed(enc_chans))
    inner = dec_chans[0]
    chans = [c] + enc_chans
    p: Params = {
        "enc_convs": [conv1d_init(g, a, b, cfg.kernel_size)
                      for a, b in zip(chans[:-1], chans[1:])],
        "enc_res": [_res_init(g, inner)
                    for _ in range(cfg.num_resnet_blocks)],
        "enc_out": conv1d_init(g, inner, cfg.codebook_dim, 1),
        "dec_in": conv1d_init(g, cfg.codebook_dim, inner, 1),
        "dec_res": [_res_init(g, inner)
                    for _ in range(cfg.num_resnet_blocks)],
    }
    dchans = [inner] + dec_chans
    p["dec_convs"] = [conv1d_init(g, a, b, cfg.kernel_size)
                      for a, b in zip(dchans[:-1], dchans[1:])]
    p["dec_out"] = conv1d_init(g, dec_chans[-1], c, 1)
    embed = normal(g, (cfg.codebook_dim, cfg.num_tokens), 1.0)
    p["codebook"] = {"embed": embed,
                     "cluster_size": torch.zeros(cfg.num_tokens,
                                                 device=g.device),
                     "embed_avg": embed.clone()}
    return p


def _res(p: Params, x: torch.Tensor) -> torch.Tensor:
    """dvae ResBlock (dvae.py:89-101): conv-relu-conv-relu-conv1 + x."""
    h = F.relu(conv1d(p["c1"], x, padding=1))
    h = F.relu(conv1d(p["c2"], h, padding=1))
    return conv1d(p["c3"], h) + x


def encode_logits(p: Params, mel: torch.Tensor,
                  cfg: DVAEConfig = DVAEConfig()) -> torch.Tensor:
    """mel (B, 80, T) -> pre-VQ features (B, T / 4, codebook_dim)."""
    h = mel
    pad = (cfg.kernel_size - 1) // 2
    for conv in p["enc_convs"]:
        h = F.relu(conv1d(conv, h, stride=cfg.stride, padding=pad))
    for r in p["enc_res"]:
        h = _res(r, h)
    return conv1d(p["enc_out"], h).transpose(1, 2)


def _distances(x: torch.Tensor, embed: torch.Tensor) -> torch.Tensor:
    """Squared distances of rows x (N, D) to the codebook's columns."""
    return (x.pow(2).sum(-1, keepdim=True) - 2 * x @ embed
            + embed.pow(2).sum(0, keepdim=True))


def get_codebook_indices(p: Params, mel: torch.Tensor,
                         cfg: DVAEConfig = DVAEConfig()) -> torch.Tensor:
    """dvae.py:239-246.  mel (B, 80, T) -> codes (B, T / 4)."""
    flat = encode_logits(p, mel, cfg)
    return _distances(flat, p["codebook"]["embed"].to(flat.dtype)).argmin(-1)


def _decode_features(p: Params, feats: torch.Tensor,
                     cfg: DVAEConfig) -> torch.Tensor:
    """Decoder body of decode() and forward(): (B, T, D) features -> mel
    (B, 80, T * 4)."""
    h = conv1d(p["dec_in"], feats.transpose(1, 2))
    for r in p["dec_res"]:
        h = _res(r, h)
    pad = (cfg.kernel_size - 1) // 2
    for conv in p["dec_convs"]:
        h = h.repeat_interleave(cfg.stride, dim=-1)   # UpsampledConv
        h = F.relu(conv1d(conv, h, padding=pad))
    return conv1d(p["dec_out"], h)


def decode(p: Params, codes: torch.Tensor,
           cfg: DVAEConfig = DVAEConfig()) -> torch.Tensor:
    """codes (B, T) -> mel (B, 80, T * 4).  dvae.py:248-270."""
    emb = p["codebook"]["embed"].t()[codes.long()]
    return _decode_features(p, emb, cfg)


def quantize_ema(state: VQState, flat: torch.Tensor,
                 cfg: DVAEConfig = DVAEConfig(), training: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            VQState]:
    """EMA vector quantisation (dvae.py:29-69).  flat: (..., D).  Returns
    (quantized with the straight-through gradient, codes, commitment
    loss, the next codebook state); the state moves only in training, and
    carries no gradient."""
    d = flat.shape[-1]
    x = flat.reshape(-1, d)
    embed = state.embed
    idx = _distances(x, embed.to(x.dtype)).argmin(1)
    codes = idx.reshape(flat.shape[:-1])
    quant = embed.t()[idx].reshape(flat.shape).to(flat.dtype)
    new_state = state
    if training:
        with torch.no_grad():
            xs = x.detach()
            onehot = F.one_hot(idx, embed.shape[1]).to(xs.dtype)
            onehot_sum = onehot.sum(0)
            embed_sum = xs.t() @ onehot
            cluster = (state.cluster_size * cfg.decay
                       + onehot_sum * (1 - cfg.decay))
            embed_avg = (state.embed_avg * cfg.decay
                         + embed_sum * (1 - cfg.decay))
            n = cluster.sum()
            cs = (cluster + cfg.eps) / (n + embed.shape[1] * cfg.eps) * n
            new_state = VQState(embed_avg / cs[None], cluster, embed_avg)
    diff = ((quant.detach() - flat) ** 2).mean()
    quant_st = flat + (quant - flat).detach()
    return quant_st, codes, diff, new_state


def forward(p: Params, mel: torch.Tensor, cfg: DVAEConfig = DVAEConfig(),
            training: bool = False):
    """Full VAE pass (dvae.py:281-302): (recon loss per element,
    commitment loss, recon, codes, the next VQState)."""
    flat = encode_logits(p, mel, cfg)
    cb = p["codebook"]
    state = VQState(cb["embed"], cb["cluster_size"], cb["embed_avg"])
    quant, codes, commit, new_state = quantize_ema(state, flat, cfg,
                                                   training=training)
    recon = _decode_features(p, quant, cfg)
    return (mel - recon) ** 2, commit, recon, codes, new_state
