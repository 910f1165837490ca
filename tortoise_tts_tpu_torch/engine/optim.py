"""Optimizers and learning-rate schedules (port of
``tortoise_tts_tpu/engine/optim.py``).

``make_optimizer(hp)`` gives the JAX package's optax chain, step for
step and in its order, as a functional optimizer over the parameter
tree:

1. clip the gradients by their global norm (``gradient_clipping``);
2. the optimizer: AdamW (b2 = 0.96, weight decay 0.01, added to the
   update before the -lr scale), Adam, SGD with momentum 0.9 or Adagrad,
   at the schedule's learning rate for the count of optimizer updates
   (not micro-steps: ``optax.linear_schedule(0, lr, warmup)`` is 0 at the
   first update);
3. the mutable LR scale the trainer's ``lr <x>`` command sets;
4. all inside ``MultiSteps``: the mean of k micro-steps' gradients makes
   one update (``gradient_accumulation_steps``).

The moments keep the parameters' type, as optax keeps them.  The state
is a tree of tensors (the counters 0-d CPU tensors), so it checkpoints
under '/'-joined keys.  Adafactor, Prodigy, Muon, DAdaptation, APOLLO and
schedule-free are not ported and raise (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from ..config import Hyperparameters
from .state import tree_leaves, tree_unflatten_like

Schedule = Union[float, Callable[[int], float]]
NOT_PORTED = ("adafactor", "prodigy", "muon", "dadaptation", "apollo",
              "apollo-mini")


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
        raise NotImplementedError(
            "scheduler 'schedulefree' is not ported yet (ROADMAP.md)")
    raise ValueError(f"unknown scheduler {hp.scheduler}")


def _zeros(params):
    return tree_unflatten_like(params, [torch.zeros_like(p)
                                        for p in tree_leaves(params)])


def _count(n: int = 0) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int64)


class Optimizer:
    """clip -> optimizer -> LR scale inside MultiSteps(k), functional over
    the parameter tree: ``init(params)`` makes the state, ``step(params,
    grads, state)`` applies one micro-step's gradients in place."""

    def __init__(self, name: str, schedule: Schedule, clip: float,
                 every_k: int):
        self.name = name
        self.schedule = schedule
        self.clip = clip
        self.every_k = max(1, every_k)

    def lr(self, count: int) -> float:
        s = self.schedule
        return float(s(count) if callable(s) else s)

    def init(self, params) -> Dict[str, Any]:
        inner: Dict[str, Any] = {"count": _count()}
        if self.name in ("adamw", "adam"):
            inner["mu"], inner["nu"] = _zeros(params), _zeros(params)
        elif self.name == "sgd":
            inner["trace"] = _zeros(params)
        elif self.name == "adagrad":
            inner["sum_of_squares"] = tree_unflatten_like(
                params, [torch.full_like(p, 0.1)
                         for p in tree_leaves(params)])
        state = {"inner": inner,
                 "lr_scale": torch.tensor(1.0, dtype=torch.float32)}
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
        # the update's two factors as the float32 numbers optax multiplies
        lr = float(torch.tensor(-self.lr(count), dtype=torch.float32))
        scale = float(state["lr_scale"])
        if self.name in ("adamw", "adam"):
            b1, b2 = 0.9, 0.96 if self.name == "adamw" else 0.999
            bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** (count + 1)
            bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** (count + 1)
            for p, g, mu, nu in zip(ps, gs, tree_leaves(inner["mu"]),
                                    tree_leaves(inner["nu"])):
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * g ** 2 + b2 * nu)
                u = (mu / bc1.to(mu.dtype)) / (
                    torch.sqrt(nu / bc2.to(nu.dtype)) + 1e-8)
                if self.name == "adamw":
                    u = u + 0.01 * p
                self._apply(p, u, lr, scale)
        elif self.name == "sgd":
            for p, g, tr in zip(ps, gs, tree_leaves(inner["trace"])):
                tr.copy_(g + 0.9 * tr)
                self._apply(p, tr, lr, scale)
        else:   # adagrad
            for p, g, ss in zip(ps, gs,
                                tree_leaves(inner["sum_of_squares"])):
                ss.copy_(g ** 2 + ss)
                inv = torch.where(ss > 0, torch.rsqrt(ss + 1e-7), 0.0)
                self._apply(p, inv * g, lr, scale)
        inner["count"].fill_(count + 1)

    @staticmethod
    def _apply(p, u, neg_lr: float, scale: float) -> None:
        p.add_((u * neg_lr) * scale)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def make_optimizer(hp: Hyperparameters) -> Optimizer:
    name = hp.optimizer.lower()
    if (hp.scheduler or "").lower() == "schedulefree" or name in NOT_PORTED:
        raise NotImplementedError(
            f"optimizer {hp.optimizer!r} (scheduler {hp.scheduler!r}) is not "
            "ported yet (ROADMAP.md); the port has AdamW, Adam, SGD and "
            "Adagrad")
    if name not in ("adamw", "adam", "sgd", "adagrad"):
        raise ValueError(f"unknown optimizer {hp.optimizer}")
    return Optimizer(name, make_schedule(hp), hp.gradient_clipping,
                     hp.gradient_accumulation_steps)


def set_lr_scale(opt_state, scale: float) -> None:
    """Set the LR scale the trainer's ``lr <x>`` command changes."""
    opt_state["lr_scale"].fill_(scale)


def get_lr_scale(opt_state) -> Optional[float]:
    s = opt_state.get("lr_scale") if isinstance(opt_state, dict) else None
    return None if s is None else float(s)


def eval_params(params, opt_state):
    """The weights to evaluate and export: the parameters themselves for
    every ported optimizer (schedule-free, whose x-average differs, is not
    ported)."""
    del opt_state
    return params
