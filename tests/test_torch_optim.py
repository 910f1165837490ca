"""The port's optimizer chain (``engine/optim.py``) against the JAX
package's optax chain: the parameters after 3 updates (6 micro-steps
under MultiSteps k=2, clipping at 0.5) for each ported optimizer and
schedule, fp32, within rtol 1e-5 / atol 1e-7; the LR scale of ``lr
<x>``; and the optimizers that are not ported raise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tortoise_tts_tpu.config import Hyperparameters as JHp
from tortoise_tts_tpu.engine import optim as joptim
from tortoise_tts_tpu_torch.config import Hyperparameters
from tortoise_tts_tpu_torch.engine import optim
from tortoise_tts_tpu_torch.engine.state import flatten_tree, tree_leaves

from tests.torch_train_util import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-5, atol=1e-7)
SHAPES = {"w": (6, 5), "b": (5,), "layers": [(3, 4), (4,)]}


def _tree(rng, scale=1.0):
    return {"w": (rng.randn(6, 5) * scale).astype(np.float32),
            "b": (rng.randn(5) * scale).astype(np.float32),
            "layers": [(rng.randn(3, 4) * scale).astype(np.float32),
                       (rng.randn(4) * scale).astype(np.float32)]}


def _run_both(hp: dict, micro_steps: int = 6, seed: int = 0):
    rng = np.random.RandomState(seed)
    p0 = _tree(rng)
    grads = [_tree(rng, 0.3 + i) for i in range(micro_steps)]
    jtx = joptim.make_optimizer(JHp(**hp))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jtx.init(jp)
    tx = optim.make_optimizer(Hyperparameters(**hp))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    ts = tx.init(tp)
    jupdate = jax.jit(lambda g, s, p: _apply(jtx, g, s, p))
    for g in grads:
        jp, js = jupdate(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tx.step(tp, [torch.from_numpy(a) for a in
                     jax.tree_util.tree_leaves(g)], ts)
    return jp, tp, ts, js


def _apply(jtx, g, s, p):
    u, s = jtx.update(g, s, p)
    return optax.apply_updates(p, u), s


def _assert_same(jp, tp):
    want = jax.tree_util.tree_leaves(jp)
    got = tree_leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("opt", ["AdamW", "Adam", "SGD", "Adagrad"])
@pytest.mark.parametrize("sched", ["", "warmup", "cosine", "noam",
                                   "onecycle"])
def test_params_after_three_updates_match_optax(opt, sched):
    hp = dict(optimizer=opt, scheduler=sched, learning_rate=1e-2,
              warmup_steps=2, gradient_accumulation_steps=2,
              gradient_clipping=0.5)
    jp, tp, ts, _ = _run_both(hp)
    _assert_same(jp, tp)
    assert int(ts["gradient_step"]) == 3 and int(ts["mini_step"]) == 0
    assert int(ts["inner"]["count"]) == 3


@pytest.mark.parametrize("k", [1, 3])
def test_accumulation_and_no_clip_match_optax(k):
    """No MultiSteps wrapper at k=1; the mean of 3 micro-steps at k=3; no
    clipping; no warmup (a constant rate)."""
    hp = dict(optimizer="AdamW", learning_rate=3e-3, warmup_steps=0,
              gradient_accumulation_steps=k, gradient_clipping=0.0)
    jp, tp, ts, _ = _run_both(hp, micro_steps=6)
    _assert_same(jp, tp)
    assert ("acc_grads" in ts) == (k > 1)


def test_schedules_match_optax_per_update():
    """Each ported schedule's rate against optax's at counts 0..40 (the
    schedule counts optimizer updates; linear warmup gives 0 at 0), within
    rtol 1e-5: optax computes the rate in float32, the port in float64."""
    for sched in ("", "warmup", "cosine", "noam", "onecycle"):
        for warm in (0, 4):
            hp = dict(scheduler=sched, learning_rate=2e-3,
                      warmup_steps=warm)
            jsched = joptim.make_schedule(JHp(**hp))
            tsched = optim.make_schedule(Hyperparameters(**hp))
            if sched == "noam" and warm == 0:   # both divide by zero
                for fn in (jsched, tsched):
                    with pytest.raises(ZeroDivisionError):
                        fn(0)
                continue
            for c in range(0, 41, 3):
                want = float(jsched(c)) if callable(jsched) else jsched
                got = tsched(c) if callable(tsched) else tsched
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12,
                                           err_msg=f"{sched} {warm} {c}")


def test_lr_scale_matches_optax():
    """``lr <x>``: the LR scale multiplies every later update, as the JAX
    package's mutable scale does; get/set round-trip."""
    hp = dict(optimizer="SGD", learning_rate=1e-2, warmup_steps=0,
              gradient_accumulation_steps=1, gradient_clipping=0.0)
    rng = np.random.RandomState(2)
    p0, g = _tree(rng), _tree(rng)
    jtx = joptim.make_optimizer(JHp(**hp))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = joptim.set_lr_scale(jtx.init(jp), 0.25)
    u, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
    jp = optax.apply_updates(jp, u)
    tx = optim.make_optimizer(Hyperparameters(**hp))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    ts = tx.init(tp)
    optim.set_lr_scale(ts, 0.25)
    assert optim.get_lr_scale(ts) == 0.25 == joptim.get_lr_scale(js)
    tx.step(tp, [torch.from_numpy(a) for a in
                 jax.tree_util.tree_leaves(g)], ts)
    _assert_same(jp, tp)


def test_state_keys_flatten_to_the_checkpoint_layout():
    tx = optim.make_optimizer(Hyperparameters(gradient_accumulation_steps=2))
    tp = {"a": {"w": torch.zeros(2, 3)}, "l": [torch.zeros(4)]}
    keys = set(flatten_tree(tx.init(tp)))
    assert {"inner/count", "inner/mu/a/w", "inner/nu/l/0", "lr_scale",
            "mini_step", "gradient_step", "acc_grads/a/w"} <= keys


@pytest.mark.parametrize("name", ["Adafactor", "Prodigy", "Muon",
                                  "DAdaptation", "Apollo", "apollo-mini"])
def test_optimizers_not_ported_say_so(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim.make_optimizer(Hyperparameters(optimizer=name))


def test_schedule_free_and_unknown_names():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        optim.make_optimizer(Hyperparameters(scheduler="schedulefree"))
    with pytest.raises(ValueError):
        optim.make_optimizer(Hyperparameters(optimizer="lamb"))
    with pytest.raises(ValueError):
        optim.make_schedule(dataclasses.replace(Hyperparameters(),
                                                scheduler="linear_decay"))
