"""Logit processors and the token draw for the AR decode loop.

Port of ``tortoise_tts_tpu/ops/sampling.py``.  Application order
mirrors HF generate(): repetition penalty -> typical -> temperature ->
top-k -> top-p, then the draw.  All functions take and return (B, V)
fp32 logits.

The draw is Gumbel-max over uniforms: from one ``torch.Generator`` per
row (row r's tokens depend only on row r's generator), or from
uniforms the caller passes in (tests).  The JAX package draws from
threefry keys, so sampled tokens agree with it in distribution only;
greedy decoding agrees token for token.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

NEG_INF = -1e10


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.8
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0        # 1.0 = disabled
    typical_mass: float = 0.0  # 0 = disabled
    repetition_penalty: float = 1.0
    # stop-logit length penalty of the sampled path (stop /= len**factor)
    length_penalty_factor: float = 0.0
    greedy: bool = False
    # max-probability-sigmoid dynamic temperature, active when
    # 0 < min_temperature < temperature
    min_temperature: float = 0.0
    # mirostat v1, active when tau > 0
    mirostat_tau: float = 0.0
    mirostat_eta: float = 0.1


def apply_repetition_penalty(logits: torch.Tensor, token_counts: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor on a (B, V) count state."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_counts > 0, penalized, logits)


def apply_temperature(logits: torch.Tensor, temperature: float
                      ) -> torch.Tensor:
    if temperature == 1.0:
        return logits
    return logits / max(temperature, 1e-5)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """HF TopPLogitsWarper (min_tokens_to_keep=1): keep the tokens whose
    probability is at least that of the token where the ascending
    cumulative mass first exceeds 1-p.  The JAX package finds the same
    threshold by bisection; the keep-sets agree for distinct
    probabilities."""
    if p >= 1.0:
        return logits
    probs = torch.softmax(logits.float(), dim=-1)
    sp, _ = torch.sort(probs, dim=-1)
    cum = torch.cumsum(sp, dim=-1)
    # index of the first ascending entry whose cumulative mass > 1-p;
    # the last entry (the max) always qualifies
    first = torch.searchsorted(cum, torch.full_like(cum[:, :1], 1.0 - p),
                               right=True).clamp(max=sp.shape[-1] - 1)
    thresh = torch.gather(sp, -1, first)
    return torch.where(probs < thresh, NEG_INF, logits)


def apply_typical(logits: torch.Tensor, mass: float) -> torch.Tensor:
    """Typical sampling (reference TypicalLogitsWarper)."""
    if mass <= 0.0 or mass >= 1.0:
        return logits
    logp = torch.log_softmax(logits, dim=-1)
    p = logp.exp()
    ent = -torch.where(p > 0, logp * p, 0.0).sum(-1, keepdim=True)
    shifted = (-logp - ent).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, order)
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    last_ind = (cum < mass).sum(-1, keepdim=True)
    cutoff = torch.gather(torch.gather(shifted, -1, order), -1, last_ind)
    keep = shifted <= cutoff
    best = shifted.argmin(-1, keepdim=True)
    keep = keep | (torch.arange(logits.shape[-1], device=logits.device)[None]
                   == best)
    return torch.where(keep, logits, NEG_INF)


def apply_dynamic_temperature(logits: torch.Tensor, temperature: float,
                              min_temperature: float = 0.0, k: float = 10.0,
                              sigmoid_center: float = 0.5) -> torch.Tensor:
    """t = T - (T - T_min) / (1 + exp(-k (p_max - center))), per row."""
    if min_temperature >= temperature:
        return apply_temperature(logits, temperature)
    p_max = torch.softmax(logits.float(), dim=-1).amax(-1, keepdim=True)
    t = temperature - (temperature - min_temperature) \
        / (1.0 + torch.exp(-k * (p_max - sigmoid_center)))
    return logits / t.clamp(min=1e-5)


def apply_length_penalty(stop_logit: torch.Tensor, length: torch.Tensor,
                         factor: float) -> torch.Tensor:
    """stop_logit /= max(length, 1)**factor (reference samplers.py:35-40),
    in fp32 on the device as the JAX package computes it; ``length`` is
    the decode's 0-d step tensor, read by no host."""
    if factor == 0.0:
        return stop_logit
    scale = torch.pow(length.float().clamp(min=1.0), factor)
    return stop_logit / scale


def warp_logits(logits: torch.Tensor, cfg: SamplingConfig,
                token_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full warping chain in HF order."""
    x = logits.float()
    if token_counts is not None:
        x = apply_repetition_penalty(x, token_counts, cfg.repetition_penalty)
    x = apply_typical(x, cfg.typical_mass)
    if 0.0 < cfg.min_temperature < cfg.temperature:
        x = apply_dynamic_temperature(x, cfg.temperature, cfg.min_temperature)
    else:
        x = apply_temperature(x, cfg.temperature)
    x = apply_top_k(x, cfg.top_k)
    return apply_top_p(x, cfg.top_p)


def row_uniforms(generators: Sequence[torch.Generator], v: int,
                 device) -> torch.Tensor:
    """(B, V) uniforms in (0, 1), row r drawn from generators[r]."""
    return torch.stack([torch.rand(v, generator=g, device=device)
                        for g in generators]).clamp_(1e-20, 1.0 - 1e-7)


def categorical_rows(logits: torch.Tensor, uniforms: torch.Tensor
                     ) -> torch.Tensor:
    """Gumbel-max draw: argmax(logits - log(-log u)) per row."""
    gumbel = -torch.log(-torch.log(uniforms))
    return (logits + gumbel).argmax(-1)


def sample_token(logits: torch.Tensor, cfg: SamplingConfig,
                 token_counts: Optional[torch.Tensor] = None,
                 uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp + draw one token per row. logits (B, V) -> (B,) int64.

    Greedy applies the logits processors (repetition penalty, typical)
    and takes the argmax; the warpers cannot change an argmax."""
    if cfg.greedy:
        x = logits.float()
        if token_counts is not None:
            x = apply_repetition_penalty(x, token_counts,
                                         cfg.repetition_penalty)
        return apply_typical(x, cfg.typical_mass).argmax(-1)
    if uniforms is None:
        raise ValueError("sampled decoding needs uniforms (see row_uniforms)")
    return categorical_rows(warp_logits(logits, cfg, token_counts), uniforms)


def mirostat_step(logits: torch.Tensor, mu: torch.Tensor,
                  uniforms: torch.Tensor, tau: float = 5.0, eta: float = 0.1,
                  n_vocab: Optional[int] = None):
    """Mirostat v1 step (reference samplers.py:117-157).
    logits (B, V); mu (B,) running max-surprise -> (token (B,), new mu)."""
    v = logits.shape[-1]
    n = float(n_vocab or v)
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    m = 100
    top = sorted_logits[:, :m + 1]
    i = torch.arange(m, dtype=torch.float32, device=logits.device)
    logt = torch.log((i + 2) / (i + 1))
    logb = top[:, :-1] - top[:, 1:]
    s_hat = (logb * logt[None]).sum(-1) / (logt * logt).sum()
    eps = s_hat - 1.0
    k = torch.pow((eps * torch.pow(2.0, mu)) / (1 - torch.pow(n, -eps)),
                  1.0 / s_hat.clamp(min=1e-3))
    k = (torch.round(k) + 1).clamp(1, v).long()
    ranks = torch.argsort(torch.argsort(-logits, dim=-1), dim=-1)
    masked = torch.where(ranks < k[:, None], logits, NEG_INF)
    tok = categorical_rows(masked, uniforms)
    logp = torch.log_softmax(logits.float(), dim=-1)
    surprise = -torch.gather(logp, -1, tok[:, None])[:, 0] \
        / math.log(2.0)
    return tok, mu - eta * (surprise - tau)
