"""Optimizers and learning-rate schedules (port of
``tortoise_tts_tpu/engine/optim.py``).

``make_optimizer(hp)`` gives the JAX package's optax chain, step for
step and in its order, as a functional optimizer over the parameter
tree:

1. clip the gradients by their global norm (``gradient_clipping``);
2. the optimizer, at the schedule's learning rate for the count of
   optimizer updates (not micro-steps: ``optax.linear_schedule(0, lr,
   warmup)`` is 0 at the first update):
   - AdamW (b2 = 0.96, weight decay 0.01, added to the update before the
     -lr scale), Adam, SGD with momentum 0.9, Adagrad;
   - Adafactor, optax's defaults: second moments factored into a row and
     a column for leaves with two dimensions of 128 or more, decay
     1 - t^-0.8, the update's RMS clipped at 1 and scaled by the
     parameter's RMS;
   - Prodigy and DAdaptation (optax.contrib ``prodigy``, at a constant
     rate, and ``dadapt_adamw``, at ``learning_rate``): Adam whose step
     size is estimated from the gradients' correlation with the distance
     travelled;
   - Muon (optax.contrib ``muon``): a 2-D leaf's nesterov momentum
     orthogonalised by 5 Newton-Schulz steps; nesterov Adam on the rest;
   - APOLLO and apollo-mini (the JAX package's own ``apollo``): Adam
     moments of the gradient projected to rank 256 (1) by a random
     projector, the full gradient scaled by their norm ratio per channel
     (per tensor, x sqrt(128)), the Fira norm-growth limiter, weight
     decay 0.01;
3. the mutable LR scale the trainer's ``lr <x>`` command sets;
4. ``scheduler: schedulefree``: optax.contrib ``schedule_free`` around
   1-3 (the base optimizer's momentum off: b1 = 0 for AdamW and Adam,
   SGD without momentum); ``eval_params`` gives its x-average;
5. all inside ``MultiSteps``: the mean of k micro-steps' gradients makes
   one update (``gradient_accumulation_steps``).

The moments keep the parameters' type, as optax keeps them.  The state
is a tree of tensors (the counters 0-d CPU tensors), so it checkpoints
under '/'-joined keys.  APOLLO's projector comes from a
``torch.Generator`` seeded by (seed, leaf, refresh count)
(``apollo_projector``), where the JAX package folds the same three into
a threefry key: the streams differ, the law is the same.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Hyperparameters
from .state import tree_leaves, tree_unflatten_like

Schedule = Union[float, Callable[[int], float]]
OPTIMIZERS = ("adamw", "adam", "sgd", "adagrad", "adafactor", "prodigy",
              "muon", "dadaptation", "apollo", "apollo-mini")
# schedule_free's own interpolation momentum (optax.contrib's default)
SF_B1 = 0.9
# optax.contrib.muon's Newton-Schulz coefficients
NS_COEFFS = (3.4445, -4.7750, 2.0315)
# APOLLO's projector seed (the JAX package's ``apollo(seed=0)``)
APOLLO_SEED = 0


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init at count 0 to end at count ``steps``
    (constant init for steps <= 0, as optax)."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps)
                                         / steps) + end


def make_schedule(hp: Hyperparameters) -> Schedule:
    """The learning rate as a function of the optimizer-update count (or a
    constant), as the JAX package's ``make_schedule``."""
    name = (hp.scheduler or "").lower()
    lr = hp.learning_rate
    decay_steps = max(1, getattr(hp, "decay_steps", 0) or 1_000_000)
    if name in ("", "constant"):
        return _linear(0.0, lr, hp.warmup_steps) if hp.warmup_steps > 0 \
            else lr
    if name == "warmup":
        return _linear(0.0, lr, hp.warmup_steps)
    if name in ("cosine", "cosine_annealing"):
        warm = _linear(0.0, lr, hp.warmup_steps)
        span = decay_steps - hp.warmup_steps

        def cosine(count):
            if count < hp.warmup_steps:
                return warm(count)
            c = min(float(count - hp.warmup_steps), span)
            return lr * 0.5 * (1 + math.cos(math.pi * c / span))
        return cosine
    if name == "noam":
        # NoamLR (ml.py:29-41)
        def noam(count):
            s = count + 1.0
            return lr * hp.warmup_steps ** 0.5 * min(
                s ** -0.5, s * hp.warmup_steps ** -1.5)
        return noam
    if name == "onecycle":
        # optax.cosine_onecycle_schedule(decay_steps, lr): cosine from
        # lr/25 up to lr over 30%, then down to lr/25e4
        bounds = [0, int(0.3 * decay_steps), int(decay_steps)]
        values = [lr / 25.0, lr, lr / 25.0 / 1e4]

        def onecycle(count):
            if count >= bounds[-1]:
                return values[-1]
            i = 0 if count < bounds[1] else 1
            pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
                math.cos(math.pi * pct) + 1)
        return onecycle
    if name == "schedulefree":
        # the schedule-free wrapper replaces the schedule
        return lr
    raise ValueError(f"unknown scheduler {hp.scheduler}")


def _zeros(params):
    return tree_unflatten_like(params, [torch.zeros_like(p)
                                        for p in tree_leaves(params)])


def _count(n: int = 0) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int64)


def _f32(x) -> torch.Tensor:
    """A 0-d float32 CPU tensor: the float32 scalar optax computes with."""
    return torch.tensor(x, dtype=torch.float32)


def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    """Adafactor's two largest axes (second, first), or None when the
    second is under 128 (optax ``_factored_dims``)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < 128:
        return None
    return int(order[-2]), int(order[-1])


def _orthogonalize(x: torch.Tensor, steps: int = 5) -> torch.Tensor:
    """optax.contrib ``orthogonalize_via_newton_schulz`` of a 2-D x."""
    transposed = x.shape[0] > x.shape[1]
    if transposed:
        x = x.T
    x = x / (torch.linalg.vector_norm(x) + 1e-8)
    c0, c1, c2 = NS_COEFFS
    for _ in range(steps):
        a = x @ x.T
        x = c0 * x + (c1 * a + c2 * a @ a) @ x
    return x.T if transposed else x


def apollo_projector(seed: int, leaf: int, refresh: int, shape,
                     rank: int, device) -> torch.Tensor:
    """APOLLO's random projector of the ``leaf``-th projected leaf (from
    1) at its ``refresh``-th draw: N(0, 1/rank) of ``shape``, fp32."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, leaf, refresh])
                      .generate_state(1, np.uint64)[0]))
    return torch.randn(shape, generator=g, device=device) / math.sqrt(rank)


def _apollo_right(shape) -> bool:
    """'std' orientation: the projector acts on the columns of a matrix
    with at least as many rows as columns (low = g Pᵀ), else on its rows
    (low = Pᵀ g)."""
    return shape[0] >= shape[1]


class Optimizer:
    """clip -> optimizer -> LR scale (-> schedule-free) inside
    MultiSteps(k), functional over the parameter tree: ``init(params)``
    makes the state, ``step(params, grads, state)`` applies one
    micro-step's gradients in place.  ``schedule_free`` is the wrapper's
    learning rate (None: no wrapper)."""

    def __init__(self, name: str, schedule: Schedule, clip: float,
                 every_k: int, schedule_free: Optional[float] = None):
        self.name = name
        self.schedule = schedule
        self.clip = clip
        self.every_k = max(1, every_k)
        self.schedule_free = schedule_free
        # AdamW's / Adam's b1 and SGD's momentum, off under schedule-free,
        # which averages the iterates itself
        self.momentum = 0.9 if schedule_free is None else 0.0

    def lr(self, count: int) -> float:
        s = self.schedule
        return float(s(count) if callable(s) else s)

    def _neg_lr(self, count: int) -> float:
        # the update's factor as the float32 number optax multiplies by
        return float(_f32(-self.lr(count)))

    def init(self, params) -> Dict[str, Any]:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None

        def like(fn):
            return tree_unflatten_like(params, [fn(p) for p in leaves])

        inner: Dict[str, Any] = {"count": _count()}
        if self.name in ("adamw", "adam", "muon"):
            inner["mu"] = _zeros(params)
            # Muon's 2-D leaves keep no second moment: a placeholder
            inner["nu"] = like(lambda p: torch.zeros_like(p)
                               if self.name != "muon" or p.dim() != 2
                               else p.new_zeros(1))
        elif self.name == "sgd":
            inner["trace"] = _zeros(params)
        elif self.name == "adagrad":
            inner["sum_of_squares"] = like(lambda p: torch.full_like(p, 0.1))
        elif self.name == "adafactor":
            def rows(p, drop):
                dims = _factored_dims(tuple(p.shape))
                if dims is None:
                    return p.new_zeros(1)
                return p.new_zeros(tuple(np.delete(p.shape, dims[drop])))
            inner["v_row"] = like(lambda p: rows(p, 1))
            inner["v_col"] = like(lambda p: rows(p, 0))
            inner["v"] = like(lambda p: p.new_zeros(1) if _factored_dims(
                tuple(p.shape)) is not None else torch.zeros_like(p))
        elif self.name in ("prodigy", "dadaptation"):
            inner.update(exp_avg=_zeros(params), exp_avg_sq=_zeros(params),
                         grad_sum=_zeros(params),
                         estim_lr=torch.tensor(1e-6, device=dev),
                         numerator_weighted=torch.zeros((), device=dev))
            if self.name == "prodigy":
                inner["params0"] = like(lambda p: p.detach().clone())
        elif self.name in ("apollo", "apollo-mini"):
            rank = self._apollo_cfg()[0]

            def leaf(p):
                if p.dim() == 2:
                    right = _apollo_right(p.shape)
                    low = (p.shape[0], rank) if right else (rank, p.shape[1])
                    proj = (rank, p.shape[1]) if right else (p.shape[0], rank)
                else:
                    low, proj = tuple(p.shape), (1,)
                z = dict(device=p.device, dtype=torch.float32)
                return {"proj": torch.zeros(proj, **z),
                        "exp_avg": torch.zeros(low, **z),
                        "exp_avg_sq": torch.zeros(low, **z),
                        "scaling_norm": torch.full((), -1.0, **z),
                        "seed": _count()}
            inner["leaves"] = like(leaf)
        state = {"inner": inner,
                 "lr_scale": torch.tensor(1.0, dtype=torch.float32)}
        if self.schedule_free is not None:
            state["sf"] = {"z": like(lambda p: p.detach().clone()),
                           "weight_sum": _f32(0.0), "step_count": _count(1),
                           "max_lr": _f32(0.0)}
        if self.every_k > 1:
            state.update(mini_step=_count(), gradient_step=_count(),
                         acc_grads=_zeros(params))
        return state

    @torch.no_grad()
    def step(self, params, grads: List[torch.Tensor], state,
             norm: Optional[torch.Tensor] = None) -> bool:
        """One micro-step: ``grads`` in ``tree_leaves(params)`` order;
        ``norm``, their global norm where the caller has it (the clip
        takes it when no micro-steps are accumulated).  Returns whether
        the parameters were updated (every k-th micro-step under
        MultiSteps)."""
        ps = tree_leaves(params)
        if self.every_k > 1:
            acc = tree_leaves(state["acc_grads"])
            n = int(state["mini_step"])
            for a, g in zip(acc, grads):
                a.add_((g - a) / (n + 1))
            if n < self.every_k - 1:
                state["mini_step"].fill_(n + 1)
                return False
            self._update(ps, [a.clone() for a in acc], state)
            for a in acc:
                a.zero_()
            state["mini_step"].fill_(0)
            state["gradient_step"].add_(1)
            return True
        self._update(ps, list(grads), state, norm)
        return True

    def _update(self, ps, gs, state, norm=None) -> None:
        if self.clip and self.clip > 0:
            norm = global_norm(gs) if norm is None else norm
            trigger = norm < self.clip
            gs = [torch.where(trigger, g,
                              (g / norm.to(g.dtype)) * self.clip)
                  for g in gs]
        inner = state["inner"]
        count = int(inner["count"])
        kind = {"adamw": "adam", "apollo-mini": "apollo"}.get(self.name,
                                                              self.name)
        scale = float(state["lr_scale"])
        us = (u * scale for u in getattr(self, "_" + kind)(ps, gs, inner,
                                                            count))
        if self.schedule_free is None:
            for p, u in zip(ps, us):
                p.add_(u)
        else:
            self._schedule_free(ps, us, state["sf"])
        inner["count"].fill_(count + 1)

    def _schedule_free(self, ps, us, sf) -> None:
        """optax.contrib.schedule_free around the base updates ``us``: z
        takes the base step, x is the running average of z weighted by
        max_lr^2, and the parameters are the interpolation y = b1 x +
        (1 - b1) z."""
        b1 = SF_B1
        max_lr = torch.maximum(sf["max_lr"], _f32(self.schedule_free))
        weight = max_lr ** 2
        total = sf["weight_sum"] + weight
        ck = torch.nan_to_num(weight / total, nan=0.0, posinf=math.inf)
        if math.isnan(float(weight)) or math.isnan(float(total)):
            ck = _f32(math.nan)
        for p, u, z in zip(ps, us, tree_leaves(sf["z"])):
            z_new = (z + u).to(z.dtype)
            prev_x = (p - (1.0 - b1) * z) / b1
            x = (1.0 - ck) * prev_x + ck * z_new
            p.add_((b1 * x + (1.0 - b1) * z_new) - p)
            z.copy_(z_new)
        sf["max_lr"].copy_(max_lr)
        sf["weight_sum"].copy_(total)
        sf["step_count"].add_(1)

    # the base optimizers: each yields the update of every leaf, its
    # learning rate applied, in ``ps`` order, a leaf at a time (the caller
    # applies it before the next is made, so no second copy of the
    # parameters is held; a leaf's update reads its parameter before it
    # moves)

    def _adam(self, ps, gs, inner, count):
        b1, b2 = self.momentum, 0.96 if self.name == "adamw" else 0.999
        lr = self._neg_lr(count)
        bc1 = 1 - _f32(b1) ** (count + 1)
        bc2 = 1 - _f32(b2) ** (count + 1)
        for p, g, mu, nu in zip(ps, gs, tree_leaves(inner["mu"]),
                                tree_leaves(inner["nu"])):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * g ** 2 + b2 * nu)
            u = (mu / bc1.to(mu.dtype)) / (
                torch.sqrt(nu / bc2.to(nu.dtype)) + 1e-8)
            if self.name == "adamw":
                u = u + 0.01 * p
            yield u * lr

    def _sgd(self, ps, gs, inner, count):
        lr = self._neg_lr(count)
        for g, tr in zip(gs, tree_leaves(inner["trace"])):
            tr.copy_(g + self.momentum * tr)
            yield tr * lr

    def _adagrad(self, ps, gs, inner, count):
        lr = self._neg_lr(count)
        for g, ss in zip(gs, tree_leaves(inner["sum_of_squares"])):
            ss.copy_(g ** 2 + ss)
            inv = torch.where(ss > 0, torch.rsqrt(ss + 1e-7), 0.0)
            yield inv * g * lr

    def _adafactor(self, ps, gs, inner, count):
        lr = float(_f32(self.lr(count)))
        decay = 1.0 - _f32(count + 1) ** -0.8
        for p, g, vr, vc, v in zip(ps, gs, tree_leaves(inner["v_row"]),
                                   tree_leaves(inner["v_col"]),
                                   tree_leaves(inner["v"])):
            d = decay.to(g.dtype)
            sq = g * g + 1e-30
            dims = _factored_dims(tuple(p.shape))
            if dims is not None:
                d1, d0 = dims
                vr.copy_(d * vr + (1.0 - d) * sq.mean(dim=d0))
                vc.copy_(d * vc + (1.0 - d) * sq.mean(dim=d1))
                r1 = d1 - 1 if d1 > d0 else d1
                row = (vr / vr.mean(dim=r1, keepdim=True)) ** -0.5
                u = g * row.unsqueeze(d0) * (vc ** -0.5).unsqueeze(d1)
            else:
                v.copy_(d * v + (1.0 - d) * sq)
                u = g * v ** -0.5
            # clip_by_block_rms(1), the rate, the parameter's RMS, -1
            u = u / torch.clamp(torch.sqrt((u * u).mean()), min=1.0)
            u = u * lr
            u = u * torch.clamp(torch.sqrt((p * p).mean()), min=1e-3)
            yield -u

    def _prodigy(self, ps, gs, inner, count):
        b1, b2 = 0.9, 0.999
        b3 = b2 ** 0.5
        d0 = 1e-6
        ci = count + 1
        bc = (1 - _f32(b2) ** ci) ** 0.5 / (1 - _f32(b1) ** ci)
        d = inner["estim_lr"]
        dlr = d * self.lr(count) * bc.to(d.device)
        num = sum((g * (p0 - p)).sum() for g, p0, p in zip(
            gs, tree_leaves(inner["params0"]), ps))
        eas_l = tree_leaves(inner["exp_avg_sq"])
        for g, ea, eas, sk in zip(gs, tree_leaves(inner["exp_avg"]), eas_l,
                                  tree_leaves(inner["grad_sum"])):
            dg = d * g
            ea.copy_(b1 * ea + (1 - b1) * dg)
            eas.copy_(b2 * eas + (1 - b2) * dg * dg)
            sk.copy_(b3 * sk + dlr * dg / d0)
        nw = inner["numerator_weighted"]
        nw.copy_(b3 * nw + (d / d0) * dlr * num)
        den = sum(sk.abs().sum() for sk in tree_leaves(inner["grad_sum"]))
        d.copy_(torch.maximum(d, nw / den))
        for ea, eas in zip(tree_leaves(inner["exp_avg"]), eas_l):
            yield -(dlr * ea / (torch.sqrt(eas) + d * 1e-8))

    def _dadaptation(self, ps, gs, inner, count):
        b1, b2 = 0.9, 0.999
        sb2 = b2 ** 0.5
        ci = count + 1
        bc = (1 - _f32(b2) ** ci) ** 0.5 / (1 - _f32(b1) ** ci)
        d = inner["estim_lr"]
        dlr = d * self.lr(count) * bc.to(d.device)
        eas_l = tree_leaves(inner["exp_avg_sq"])
        sk_l = tree_leaves(inner["grad_sum"])
        num = sum((g * (sk / (torch.sqrt(eas) + 1e-8))).sum()
                  for g, sk, eas in zip(gs, sk_l, eas_l))
        for g, ea, eas, sk in zip(gs, tree_leaves(inner["exp_avg"]), eas_l,
                                  sk_l):
            ea.copy_(b1 * ea + (1 - b1) * dlr * g)
            eas.copy_(b2 * eas + (1 - b2) * g * g)
            sk.copy_(sb2 * sk + (1 - sb2) * dlr * g)
        l1 = sum(sk.abs().sum() for sk in sk_l)
        nw = inner["numerator_weighted"]
        nw.copy_(sb2 * nw + (1 - sb2) * dlr * num)
        d.copy_(torch.maximum(d, nw / ((1 - sb2) * l1)))
        for ea, eas in zip(tree_leaves(inner["exp_avg"]), eas_l):
            yield -(ea / (torch.sqrt(eas) + 1e-8))

    def _muon(self, ps, gs, inner, count):
        lr = self._neg_lr(count)
        ci = count + 1
        for p, g, mu, nu in zip(ps, gs, tree_leaves(inner["mu"]),
                                tree_leaves(inner["nu"])):
            # the 2-D leaves: scale_by_muon (beta 0.95); the rest: adamw
            # (0.9, 0.999, weight decay 0), both nesterov
            b = 0.95 if g.dim() == 2 else 0.9
            mu.copy_((1 - b) * g + b * mu)
            c1 = (1 - _f32(b) ** (ci + 1)).to(mu.dtype)
            c = (1 - _f32(b) ** ci).to(mu.dtype)
            mu_hat = b * (mu / c1) + (1 - b) * (g / c)
            if g.dim() == 2:
                u = _orthogonalize(mu_hat)
                u = math.sqrt(max(1.0, g.shape[1] / g.shape[0])) * u
            else:
                nu.copy_((1 - 0.999) * g ** 2 + 0.999 * nu)
                nu_hat = nu / (1 - _f32(0.999) ** ci).to(nu.dtype)
                u = mu_hat / (torch.sqrt(nu_hat) + 1e-8)
            yield u * lr

    def _apollo_cfg(self):
        """(rank, per-tensor scaling, scale) of the JAX parameterisation."""
        mini = self.name == "apollo-mini"
        return (1, True, 128.0) if mini else (256, False, 1.0)

    def _apollo(self, ps, gs, inner, count):
        rank, per_tensor, scale = self._apollo_cfg()
        b1, b2, eps, wd = 0.9, 0.999, 1e-6, 0.01
        c = count + 1
        # the JAX package's apollo reads its rate at the incremented count
        lr = float(_f32(self.lr(c)))
        bc1 = 1.0 - _f32(b1) ** c
        bc2 = 1.0 - _f32(b2) ** c
        step = float(lr * torch.sqrt(bc2) / bc1)
        ix = 0
        for p, g, ls in zip(ps, gs, _apollo_states(inner["leaves"])):
            g32 = g.float()
            ea, es = ls["exp_avg"], ls["exp_avg_sq"]
            if g.dim() != 2:
                ea.copy_(b1 * ea + (1 - b1) * g32)
                es.copy_(b2 * es + (1 - b2) * g32 * g32)
                u = -step * (ea / (torch.sqrt(es) + eps))
                yield (u - lr * wd * p.float()).to(g.dtype)
                continue
            ix += 1
            refresh = int(ls["seed"])
            proj = apollo_projector(APOLLO_SEED, ix, refresh,
                                    ls["proj"].shape, rank, g.device)
            ls["proj"].copy_(proj)
            ls["seed"].fill_(refresh + 1)
            right = _apollo_right(g.shape)
            low = g32 @ proj.T if right else proj.T @ g32
            ea.copy_(b1 * ea + (1 - b1) * low)
            es.copy_(b2 * es + (1 - b2) * low * low)
            ng = ea / (torch.sqrt(es) + eps)
            if per_tensor:
                sf = (torch.linalg.vector_norm(ng)
                      / (torch.linalg.vector_norm(low) + 1e-8))
            else:
                dim = 0 if g.shape[0] < g.shape[1] else 1
                sf = (torch.linalg.vector_norm(ng, dim=dim)
                      / (torch.linalg.vector_norm(low, dim=dim) + 1e-8))
                if dim == 1:
                    sf = sf[:, None]
            sg = g32 * sf
            # the Fira limiter, from the second update on
            sn = ls["scaling_norm"]
            sg_norm = torch.linalg.vector_norm(sg)
            limiter = torch.clamp(sg_norm / (sn + 1e-8), min=1.01) / 1.01
            on = sn >= 0
            sg = torch.where(on, sg / limiter, sg)
            sn.copy_(torch.where(on, sg_norm / limiter, sg_norm))
            u = -step * (sg * math.sqrt(scale))
            yield (u - lr * wd * p.float()).to(g.dtype)


def _apollo_states(tree) -> List[Dict[str, torch.Tensor]]:
    """APOLLO's per-leaf state dicts, in the parameters' leaf order."""
    if isinstance(tree, dict) and "exp_avg_sq" in tree:
        return [tree]
    if isinstance(tree, dict):
        return [d for v in tree.values() for d in _apollo_states(v)]
    return [d for v in tree for d in _apollo_states(v)]


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def make_optimizer(hp: Hyperparameters) -> Optimizer:
    name = hp.optimizer.lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {hp.optimizer}")
    sched = make_schedule(hp)
    sfree = (hp.scheduler or "").lower() == "schedulefree"
    if name == "prodigy" and callable(sched):
        sched = hp.learning_rate
    if name == "dadaptation":
        sched = hp.learning_rate
    return Optimizer(name, sched, hp.gradient_clipping,
                     hp.gradient_accumulation_steps,
                     schedule_free=hp.learning_rate if sfree else None)


def set_lr_scale(opt_state, scale: float) -> None:
    """Set the LR scale the trainer's ``lr <x>`` command changes (every
    optimizer's of a state that holds several)."""
    if "lr_scale" in opt_state:
        opt_state["lr_scale"].fill_(scale)
    else:
        for sub in opt_state.values():
            set_lr_scale(sub, scale)


def get_lr_scale(opt_state) -> Optional[float]:
    if not isinstance(opt_state, dict):
        return None
    s = opt_state.get("lr_scale")
    if s is not None:
        return float(s)
    for sub in opt_state.values():
        got = get_lr_scale(sub)
        if got is not None:
            return got
    return None


def eval_params(params, opt_state):
    """The weights to evaluate and export, from the parameters and their
    optimizer's state: under schedule-free the x-average (y - (1 - b1) z)
    / b1 (optax.contrib ``schedule_free_eval_params``), else the
    parameters."""
    if "sf" in opt_state:
        b1 = SF_B1
        return tree_unflatten_like(params, [
            (y - (1.0 - b1) * z) / b1 for y, z in
            zip(tree_leaves(params), tree_leaves(opt_state["sf"]["z"]))])
    return params
