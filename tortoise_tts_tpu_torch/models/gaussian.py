"""Gaussian diffusion math: respaced schedules and the sampling loop
and the training losses (port of ``tortoise_tts_tpu/models/gaussian.py``).

- schedule tables are computed in float64 numpy and read as float32, as
  the JAX package gathers them; ``step_tables`` puts every per-step
  number a sampler step reads (made on the host in numpy, as the eager
  loop made them) into device tables indexed by the step on the device;
- ``sample_loop`` runs DDIM (eta 0, as the inference route calls it),
  the ancestral P sampler or DPM-Solver++(2M) (``"dpm++"``, the JAX
  package's ``_dpmpp_2m_loop``), with conditioning-free guidance (the
  reference's ramped k) batched into one model call: one step
  (``sampler_step_fn``) reads no host value, and on CUDA tensors it is
  captured once as a CUDA graph (``utils/graphs.StepGraph``) and replayed
  for every respaced step, as the JAX package runs its ``lax.scan``; on
  CPU tensors the same step runs eagerly;
- semantics of get_diffuser(trained_diffusion_steps=4000, linear betas,
  epsilon prediction, learned_range variance), diffusion.py:1576-1590.

- ``q_sample`` and ``training_losses`` (diffusion.py:847-933): the MSE
  on epsilon plus the variational bound on a frozen mean, over the
  unspaced 4000-step schedule the train step uses.

DDIM with eta > 0 and the cosine schedule are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, Optional, Sequence

import math

import numpy as np
import torch

from ..utils.graphs import StepGraph

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


# model_fn(x, t_original (B,), t_respaced) -> (B, 2C, T): called with the
# stacked [cond; uncond] batch when the schedule is conditioning-free;
# t_respaced, a (1,) int64 tensor on x's device, lets a model_fn look up
# per-step state made outside the loop (``index_select`` it: no host read)
ModelFn = Callable[..., torch.Tensor]


def _tab(arr: np.ndarray, t: int) -> np.float32:
    """Entry t of a float64 table as the float32 the JAX package gathers."""
    return np.float32(arr[t])


def step_tables(sched: DiffusionSchedule, device) -> Dict[str, torch.Tensor]:
    """Every per-step number a sampler step reads, as (T,) device tables
    indexed by the respaced step: the float32 values the eager loop read
    with ``_tab``, made on the host in numpy (PyTorch on CUDA multiplies
    by the reciprocal where a division has a Python number for divisor, so
    nothing here is recomputed on the device).  ``timestep_map`` is int64,
    the rest float32; DPM++'s ``alpha``, ``sigma`` and ``lambda`` have one
    more entry, index n, for the clean state past t = 0."""
    n = sched.num_timesteps
    ts = range(n)
    # the ramped guidance strength, in float32
    cfk = [np.float32(COND_FREE_K) * (np.float32(1.0) - np.float32(t)
                                      / np.float32(n)) for t in ts]
    abar_prev = [_tab(sched.alphas_cumprod_prev, t) for t in ts]
    cols = {
        "cond_w": [np.float32(1) + k for k in cfk],
        "uncond_w": cfk,
        "min_log": [_tab(sched.posterior_log_variance_clipped, t)
                    for t in ts],
        "max_log": [_tab(sched.log_betas, t) for t in ts],
        "recip": [_tab(sched.sqrt_recip_alphas_cumprod, t) for t in ts],
        "recipm1": [_tab(sched.sqrt_recipm1_alphas_cumprod, t) for t in ts],
        "coef1": [_tab(sched.posterior_mean_coef1, t) for t in ts],
        "coef2": [_tab(sched.posterior_mean_coef2, t) for t in ts],
        "sqrt_abar_prev": [np.sqrt(a) for a in abar_prev],
        "sqrt_one_minus_abar_prev": [np.sqrt(np.float32(1) - a)
                                     for a in abar_prev],
        "nonzero": [np.float32(t != 0) for t in ts],
    }
    # DPM++'s alpha, sigma and lambda, with the extra index n for "t < 0"
    # (a clean state), in float64 and read as float32, as the JAX package
    # builds them
    abar = np.concatenate([sched.alphas_cumprod, [1.0 - 1e-8]])
    alpha = np.sqrt(abar)
    sigma = np.sqrt(np.maximum(1.0 - abar, 1e-12))
    cols.update(alpha=alpha, sigma=sigma,
                **{"lambda": np.log(alpha) - np.log(sigma)})
    out = {k: torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)
           for k, v in cols.items()}
    out["timestep_map"] = torch.as_tensor(
        sched.timestep_map.astype(np.int64), device=device)
    return out


def p_mean_variance(model_fn: ModelFn, x: torch.Tensor, t,
                    sched: DiffusionSchedule,
                    tabs: Optional[Dict[str, torch.Tensor]] = None):
    """diffusion.py:325-431 for epsilon / learned_range, with batched
    cond-free guidance and x_0 clipped to [-1, 1].  x: (B, C, T) fp32; t:
    the respaced index, a host int or a (1,) int64 tensor on x's device;
    ``tabs``: ``step_tables(sched, x.device)`` (made here if None).
    Returns (mean, log variance, predicted x_0)."""
    if tabs is None:
        tabs = step_tables(sched, x.device)
    if not isinstance(t, torch.Tensor):
        t = torch.tensor([t], device=x.device)

    def tab(name):
        return tabs[name].index_select(0, t)

    b = x.shape[0]
    t_orig = tab("timestep_map")
    if sched.conditioning_free:
        out = model_fn(torch.cat([x, x]), t_orig.expand(2 * b), t)
        out_cond, out_uncond = out.float().chunk(2, dim=0)
        eps_cond, var_values = out_cond.chunk(2, dim=1)
        eps_uncond = out_uncond.chunk(2, dim=1)[0]
        eps = tab("cond_w") * eps_cond - tab("uncond_w") * eps_uncond
    else:
        out = model_fn(x, t_orig.expand(b), t)
        eps, var_values = out.float().chunk(2, dim=1)

    # learned_range variance (diffusion.py:365-373)
    frac = (var_values + 1) / 2
    model_log_variance = frac * tab("max_log") + (1 - frac) * tab("min_log")

    pred_xstart = (tab("recip") * x - tab("recipm1") * eps).clamp(-1, 1)
    mean = tab("coef1") * pred_xstart + tab("coef2") * x
    return mean, model_log_variance, pred_xstart


def sampler_step_fn(model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
                    tabs: Dict[str, torch.Tensor],
                    generators: Optional[Sequence[torch.Generator]],
                    sched: DiffusionSchedule, sampler: str
                    ) -> Callable[[], None]:
    """One reverse step as a function of no arguments: x_{t-1} from the
    fp32 buffer ``x`` (B, C, T) at the respaced step ``t``, a (1,) int64
    device tensor, both updated in place (t counts down).  It reads no
    host value, so it can be captured and replayed.  The P sampler draws
    row r's noise from ``generators[r]`` at every step and adds it where
    t != 0, as the JAX package's ``p_step`` does.  DPM++ carries the last
    step's x_0 and log-SNR step h in device buffers of its own (h starts at
    1), and takes its second-order update where it has a last step and t >
    0, as ``_dpmpp_2m_loop`` does."""
    n = sched.num_timesteps
    if sampler == "dpm++":
        x0_prev = torch.zeros_like(x)
        h_prev = torch.ones(1, device=x.device)

    def tab(name, i):
        return tabs[name].index_select(0, i)

    def dpmpp(xstart) -> None:
        # the target index: t - 1, or the clean state n past t = 0
        tm = torch.where(t - 1 < 0, n, t - 1)
        h = tab("lambda", tm) - tab("lambda", t)
        r = h_prev / torch.clamp(h, min=1e-8)
        use_2m = (t < n - 1) & (t > 0)
        inv = 1 / (2 * torch.clamp(r, min=1e-8))
        d = torch.where(use_2m, (1 + inv) * xstart - inv * x0_prev, xstart)
        x.copy_((tab("sigma", tm) / tab("sigma", t)) * x
                - tab("alpha", tm) * torch.expm1(-h) * d)
        x0_prev.copy_(xstart)
        h_prev.copy_(h)

    def step() -> None:
        mean, logvar, xstart = p_mean_variance(model_fn, x, t, sched, tabs)
        if sampler == "p":
            z = torch.cat([torch.randn((1,) + x.shape[1:], generator=g,
                                       device=x.device)
                           for g in generators])
            x.copy_(mean + tab("nonzero", t) * torch.exp(0.5 * logvar) * z)
        elif sampler == "dpm++":
            dpmpp(xstart)
        else:
            eps = (tab("recip", t) * x - xstart) / tab("recipm1", t)
            x.copy_(xstart * tab("sqrt_abar_prev", t)
                    + tab("sqrt_one_minus_abar_prev", t) * eps)
        t.sub_(1)
    return step


def sample_loop(model_fn: ModelFn, noise: torch.Tensor,
                generators: Optional[Sequence[torch.Generator]],
                sched: DiffusionSchedule, sampler: str = "ddim"
                ) -> torch.Tensor:
    """The full reverse process from x_T = ``noise`` (B, 100, T).

    sampler: 'ddim' with eta 0 (diffusion.py:646-694), 'p' (510-554) or
    'dpm++' (DPM-Solver++(2M), arXiv:2211.01095, in x_0-prediction form).
    The P sampler draws row r's per-step noise from ``generators[r]``, so
    a row's draws depend on its own generator only (the JAX package's
    per-row keys); DDIM and DPM++ draw nothing.  On CUDA tensors the step is
    captured as a CUDA graph at the first step (which runs eagerly, as the
    capture's warm-up) and replayed for the others."""
    if sampler not in ("ddim", "p", "dpm++"):
        raise ValueError(f"unknown sampler {sampler!r}")

    dev = noise.device
    x = noise.float().clone()
    t = torch.tensor([sched.num_timesteps - 1], device=dev)
    tabs = step_tables(sched, dev)
    step = sampler_step_fn(model_fn, x, t, tabs, generators, sched, sampler)
    if dev.type != "cuda":
        for _ in range(sched.num_timesteps):
            step()
        return x
    graph = StepGraph(step, dev, generators if sampler == "p" else ())
    for _ in range(sched.num_timesteps - 1):
        graph.replay()
    return x


# training losses (diffusion.py:847-933)

def _gather(arr: np.ndarray, t: torch.Tensor) -> torch.Tensor:
    """The float32 entries of a schedule table at t (B,), as (B, 1, 1)."""
    tab = torch.as_tensor(np.asarray(arr, np.float32), device=t.device)
    return tab[t][:, None, None]


def q_sample(x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
             sched: DiffusionSchedule) -> torch.Tensor:
    """x_t for respaced steps t (B,): sqrt(abar) x_0 + sqrt(1 - abar) eps."""
    return (_gather(sched.sqrt_alphas_cumprod, t) * x_start
            + _gather(sched.sqrt_one_minus_alphas_cumprod, t) * noise)


def _normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def training_losses(model_out: torch.Tensor, x_start: torch.Tensor,
                    x_t: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                    sched: DiffusionSchedule) -> Dict[str, torch.Tensor]:
    """Per-sample losses of the model output (B, 200, T) on x_t: dict of
    ``mse``, ``vb`` and ``loss`` = mse + vb, each (B,), in fp32.  The VB
    term sees epsilon detached (the reference's frozen mean) and uses the
    KL at every t, as the JAX package does (the discretised decoder NLL
    of t = 0 is not taken)."""
    def tab(a):
        return _gather(a, t)

    eps, var_values = model_out.float().chunk(2, dim=1)
    mse = ((noise - eps) ** 2).mean(dim=(1, 2))
    eps_frozen = eps.detach()
    min_log = tab(sched.posterior_log_variance_clipped)
    max_log = tab(sched.log_betas)
    frac = (var_values + 1) / 2
    model_log_variance = frac * max_log + (1 - frac) * min_log
    pred_xstart = (tab(sched.sqrt_recip_alphas_cumprod) * x_t
                   - tab(sched.sqrt_recipm1_alphas_cumprod) * eps_frozen)
    model_mean = (tab(sched.posterior_mean_coef1) * pred_xstart
                  + tab(sched.posterior_mean_coef2) * x_t)
    true_mean = (tab(sched.posterior_mean_coef1) * x_start
                 + tab(sched.posterior_mean_coef2) * x_t)
    true_logvar = tab(sched.posterior_log_variance_clipped)
    kl = _normal_kl(true_mean, true_logvar, model_mean, model_log_variance)
    vb = kl.mean(dim=(1, 2)) / math.log(2.0)
    return {"mse": mse, "vb": vb, "loss": mse + vb}
