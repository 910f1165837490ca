"""Gaussian diffusion math: respaced schedules and the sampling loop
(port of ``tortoise_tts_tpu/models/gaussian.py``, inference slice).

- schedule tables are computed in float64 numpy and read as float32
  scalars, as the JAX package gathers them;
- ``sample_loop`` runs DDIM (eta 0, as the inference route calls it) or
  the ancestral P sampler as a Python loop over the respaced steps, with
  conditioning-free guidance (the reference's ramped k) batched into one
  model call;
- semantics of get_diffuser(trained_diffusion_steps=4000, linear betas,
  epsilon prediction, learned_range variance), diffusion.py:1576-1590.

DPM++, DDIM with eta > 0, the cosine schedule and the training losses
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Optional, Sequence

import numpy as np
import torch

TRAINED_DIFFUSION_STEPS = 4000
# conditioning-free guidance strength, ramped to 0 over the reverse process
COND_FREE_K = 2.0


def space_timesteps(num_timesteps: int, steps: int) -> list[int]:
    """Evenly respaced step subset (diffusion.py:1169-1222, one section)."""
    frac_stride = 1.0 if steps <= 1 else (num_timesteps - 1) / (steps - 1)
    cur, taken = 0.0, []
    for _ in range(steps):
        taken.append(round(cur))
        cur += frac_stride
    return sorted(set(taken))


@dataclass(frozen=True)
class DiffusionSchedule:
    """Respaced schedule tables (all (T,) float64 numpy)."""
    timestep_map: np.ndarray
    betas: np.ndarray
    alphas_cumprod: np.ndarray
    alphas_cumprod_prev: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray
    log_betas: np.ndarray
    conditioning_free: bool = True

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)


def linear_betas(n: int) -> np.ndarray:
    """Ho et al. linear schedule scaled to n steps (diffusion.py:116-124)."""
    scale = 1000 / n
    return np.linspace(scale * 1e-4, scale * 0.02, n, dtype=np.float64)


@lru_cache(maxsize=32)
def get_schedule(steps: int = 80,
                 cond_free: bool = True) -> DiffusionSchedule:
    """get_diffuser equivalent (diffusion.py:1576-1590), linear betas."""
    abar_base = np.cumprod(1.0 - linear_betas(TRAINED_DIFFUSION_STEPS))
    keep = space_timesteps(TRAINED_DIFFUSION_STEPS, steps)
    last, new_betas = 1.0, []
    for i in keep:
        new_betas.append(1 - abar_base[i] / last)
        last = abar_base[i]
    betas = np.array(new_betas, dtype=np.float64)
    alphas = 1.0 - betas
    abar = np.cumprod(alphas)
    abar_prev = np.append(1.0, abar[:-1])
    post_var = betas * (1.0 - abar_prev) / (1.0 - abar)
    return DiffusionSchedule(
        timestep_map=np.array(keep, dtype=np.int32),
        betas=betas,
        alphas_cumprod=abar,
        alphas_cumprod_prev=abar_prev,
        sqrt_alphas_cumprod=np.sqrt(abar),
        sqrt_one_minus_alphas_cumprod=np.sqrt(1 - abar),
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / abar),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / abar - 1),
        posterior_variance=post_var,
        # [post_var[1], post_var[1:]] like the reference; a 1-step
        # schedule has no t=1 entry, so floor t=0's zero
        posterior_log_variance_clipped=np.log(np.maximum(
            np.append(post_var[min(1, len(post_var) - 1)], post_var[1:]),
            1e-20)),
        posterior_mean_coef1=betas * np.sqrt(abar_prev) / (1.0 - abar),
        posterior_mean_coef2=(1.0 - abar_prev) * np.sqrt(alphas)
        / (1.0 - abar),
        log_betas=np.log(betas),
        conditioning_free=cond_free,
    )


# model_fn(x, t_original (B,), t_respaced int) -> (B, 2C, T): called with
# the stacked [cond; uncond] batch when the schedule is conditioning-free;
# t_respaced lets a model_fn look up per-step state made outside the loop
ModelFn = Callable[..., torch.Tensor]


def _tab(arr: np.ndarray, t: int) -> np.float32:
    """Entry t of a float64 table as the float32 the JAX package gathers."""
    return np.float32(arr[t])


def p_mean_variance(model_fn: ModelFn, x: torch.Tensor, t: int,
                    sched: DiffusionSchedule):
    """diffusion.py:325-431 for epsilon / learned_range, with batched
    cond-free guidance and x_0 clipped to [-1, 1].  x: (B, C, T) fp32; t:
    the respaced index.  Returns (mean, log variance, predicted x_0)."""
    b = x.shape[0]
    t_orig = int(sched.timestep_map[t])
    if sched.conditioning_free:
        out = model_fn(torch.cat([x, x]),
                       torch.full((2 * b,), t_orig, device=x.device), t)
        out_cond, out_uncond = out.float().chunk(2, dim=0)
        eps_cond, var_values = out_cond.chunk(2, dim=1)
        eps_uncond = out_uncond.chunk(2, dim=1)[0]
        cfk = np.float32(COND_FREE_K) * (
            np.float32(1.0) - np.float32(t) / np.float32(sched.num_timesteps))
        eps = float(1 + cfk) * eps_cond - float(cfk) * eps_uncond
    else:
        out = model_fn(x, torch.full((b,), t_orig, device=x.device), t)
        eps, var_values = out.float().chunk(2, dim=1)

    # learned_range variance (diffusion.py:365-373)
    min_log = float(_tab(sched.posterior_log_variance_clipped, t))
    max_log = float(_tab(sched.log_betas, t))
    frac = (var_values + 1) / 2
    model_log_variance = frac * max_log + (1 - frac) * min_log

    pred_xstart = (float(_tab(sched.sqrt_recip_alphas_cumprod, t)) * x
                   - float(_tab(sched.sqrt_recipm1_alphas_cumprod, t)) * eps
                   ).clamp(-1, 1)
    mean = (float(_tab(sched.posterior_mean_coef1, t)) * pred_xstart
            + float(_tab(sched.posterior_mean_coef2, t)) * x)
    return mean, model_log_variance, pred_xstart


def sample_loop(model_fn: ModelFn, noise: torch.Tensor,
                generators: Optional[Sequence[torch.Generator]],
                sched: DiffusionSchedule, sampler: str = "ddim"
                ) -> torch.Tensor:
    """The full reverse process from x_T = ``noise`` (B, 100, T).

    sampler: 'ddim' with eta 0 (diffusion.py:646-694) or 'p' (510-554).
    The P sampler draws row r's per-step noise from ``generators[r]``, so
    a row's draws depend on its own generator only (the JAX package's
    per-row keys); DDIM draws nothing."""
    if sampler == "dpm++":
        raise NotImplementedError(
            "diffusion_sampler='dpm++' is not ported yet (ROADMAP.md)")
    if sampler not in ("ddim", "p"):
        raise ValueError(f"unknown sampler {sampler!r}")

    x = noise.float()
    for t in range(sched.num_timesteps - 1, -1, -1):
        mean, logvar, xstart = p_mean_variance(model_fn, x, t, sched)
        if sampler == "p":
            if t != 0:
                z = torch.cat([torch.randn((1,) + x.shape[1:], generator=g,
                                           device=x.device)
                               for g in generators])
                mean = mean + torch.exp(0.5 * logvar) * z
            x = mean
            continue
        eps = ((float(_tab(sched.sqrt_recip_alphas_cumprod, t)) * x - xstart)
               / float(_tab(sched.sqrt_recipm1_alphas_cumprod, t)))
        abar_prev = _tab(sched.alphas_cumprod_prev, t)
        x = (xstart * float(np.sqrt(abar_prev))
             + float(np.sqrt(np.float32(1) - abar_prev)) * eps)
    return x
