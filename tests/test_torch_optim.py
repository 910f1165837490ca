"""The port's optimizer chain (``engine/optim.py``) against the JAX
package's optax chain: the parameters after 3 updates (6 micro-steps
under MultiSteps k=2, clipping at 0.5) for each schedule, fp32, within
rtol 1e-5 / atol 1e-7; every optimizer under a constant rate, warm-up
and schedule-free, without and with MultiSteps k=2, for 5 updates of
the quadratic loss 0.5 |p - target|^2 on a tree with a (256, 128)
matrix (the size at which Adafactor factors and APOLLO projects at
rank 256), a (64,) vector and a (3, 4, 5) tensor: the parameters within
rtol 1e-5 / atol 2e-6, and each leaf's move p - p0 within 2e-4 of the
JAX move's largest element (Muon's Newton-Schulz and APOLLO's
projections sum in another order); ``eval_params`` under schedule-free;
the LR scale of ``lr <x>``.  APOLLO's projector is the JAX package's
threefry draw, injected through ``optim.apollo_projector``."""

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


WIDE_TOL = dict(rtol=1e-5, atol=2e-6)
# a leaf's move against the JAX move, as a share of the latter's largest
# element
MOVE_RTOL = 2e-4


def _wide_tree(rng, scale=1.0):
    return {"m": (rng.randn(256, 128) * scale).astype(np.float32),
            "v": (rng.randn(64) * scale).astype(np.float32),
            "t": (rng.randn(3, 4, 5) * scale).astype(np.float32)}


def _jax_projector(seed, leaf, refresh, shape, rank, device):
    """The JAX package's APOLLO projector: threefry folded by leaf and
    refresh count."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                leaf), refresh)
    return torch.from_numpy(np.array(
        jax.random.normal(key, tuple(shape), jnp.float32))) / np.sqrt(rank)


def _run_wide(monkeypatch, hp: dict, micro_steps: int):
    """``micro_steps`` micro-steps of both chains on the loss 0.5 |p -
    target|^2, each side's gradient taken at its own parameters: the
    gradient keeps its direction across updates, so Prodigy's and
    DAdaptation's step-size estimates grow.  The parameters start at
    scale 0.01, so that their moves stand far above float32 rounding."""
    monkeypatch.setattr(optim, "apollo_projector", _jax_projector)
    rng = np.random.RandomState(3)
    p0 = _wide_tree(rng, 0.01)
    target = _wide_tree(rng)
    jtx = joptim.make_optimizer(JHp(**hp))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    js = jtx.init(jp)
    tx = optim.make_optimizer(Hyperparameters(**hp))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), p0)
    ts = tx.init(tp)
    jt = jax.tree_util.tree_map(jnp.asarray, target)
    tt = [torch.from_numpy(a) for a in jax.tree_util.tree_leaves(target)]
    jupdate = jax.jit(lambda s, p: _apply(
        jtx, jax.tree_util.tree_map(jnp.subtract, p, jt), s, p))
    for _ in range(micro_steps):
        jp, js = jupdate(js, jp)
        tx.step(tp, [p - t for p, t in zip(tree_leaves(tp), tt)], ts)
    return p0, jp, tp, js, ts


def _assert_wide(jp, tp, p0):
    """The parameters within WIDE_TOL, and each leaf's move within
    MOVE_RTOL of the JAX move's largest element: an update that is zero
    or of the wrong sign fails however small the step."""
    for g, w, q in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                       jax.tree_util.tree_leaves(p0)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, **WIDE_TOL)
        dw = w - q
        scale = float(np.abs(dw).max())
        assert scale > 0                       # the update moved it
        np.testing.assert_allclose(g.numpy() - q, dw, rtol=0,
                                   atol=MOVE_RTOL * scale)


def _jax_field(state, name):
    """The first ``name`` attribute in an optax state tree."""
    todo = [state]
    while todo:
        s = todo.pop(0)
        if hasattr(s, name):
            return getattr(s, name)
        if isinstance(s, (tuple, list)):
            todo.extend(s)
        elif isinstance(s, dict):
            todo.extend(s.values())
    raise KeyError(name)


ALL_OPTIMIZERS = ["AdamW", "Adam", "SGD", "Adagrad", "Adafactor", "Prodigy",
                  "Muon", "DAdaptation", "Apollo", "apollo-mini"]
SCHEDULES = {"constant": dict(scheduler="constant", warmup_steps=0),
             "warmup": dict(scheduler="warmup", warmup_steps=3),
             "schedulefree": dict(scheduler="schedulefree",
                                  warmup_steps=3)}
# Prodigy and DAdaptation scale ``learning_rate`` by their estimate,
# which starts at 1e-6: at 10 it grows a hundredfold in 5 updates here
ESTIMATED = {"Prodigy": 10.0, "DAdaptation": 10.0}


@pytest.mark.parametrize(
    "sched,k", [(s, k) for k in (1, 2) for s in SCHEDULES],
    ids=[s + ("-k2" if k > 1 else "") for k in (1, 2) for s in SCHEDULES])
@pytest.mark.parametrize("opt", ALL_OPTIMIZERS)
def test_every_optimizer_matches_optax(monkeypatch, opt, sched, k):
    """5 updates of every optimizer under a constant rate, warm-up and
    schedule-free (clip 0.5), from 5 micro-steps or, under MultiSteps
    k=2, 10: the parameters and their moves, and the step-size estimate
    of Prodigy and DAdaptation, which must have grown from 1e-6."""
    hp = dict(optimizer=opt, learning_rate=ESTIMATED.get(opt, 1e-2),
              gradient_accumulation_steps=k, gradient_clipping=0.5,
              **SCHEDULES[sched])
    p0, jp, tp, js, ts = _run_wide(monkeypatch, hp, 5 * k)
    _assert_wide(jp, tp, p0)
    assert int(ts["inner"]["count"]) == 5
    if k > 1:
        assert int(ts["gradient_step"]) == 5
    if opt in ESTIMATED:
        got = float(ts["inner"]["estim_lr"])
        assert got > 1e-5
        np.testing.assert_allclose(got, float(_jax_field(js, "estim_lr")),
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["Adafactor", "Prodigy", "Muon",
                                  "DAdaptation", "Apollo", "apollo-mini"])
def test_optimizers_not_ported_say_so(name):
    """The optimizers the port refused before slice 14 (the test keeps its
    name; their parity with optax is ``test_every_optimizer_matches_optax``):
    under MultiSteps k=2 and schedule-free, the state after an update is a
    tree of tensors that flattens to '/'-joined checkpoint keys, and a
    state loaded from those keys steps on to the same parameters."""
    hp = Hyperparameters(optimizer=name, scheduler="schedulefree",
                         learning_rate=1e-2, gradient_accumulation_steps=2,
                         gradient_clipping=0.5)
    rng = np.random.RandomState(4)
    tree = {k: torch.from_numpy(v) for k, v in _wide_tree(rng).items()}
    grads = [[torch.from_numpy(v) for v in _wide_tree(rng).values()]
             for _ in range(3)]
    tx = optim.make_optimizer(hp)
    ts = tx.init(tree)
    for g in grads[:2]:
        tx.step(tree, g, ts)
    flat = flatten_tree(ts)
    assert all(isinstance(v, torch.Tensor) for v in flat.values())
    assert {"inner/count", "sf/z/m", "acc_grads/m", "lr_scale"} <= set(flat)
    copy = {k: v.clone() for k, v in tree.items()}
    loaded = tx.init(copy)
    want = flatten_tree(loaded)
    assert set(want) == set(flat)
    for key, v in flat.items():
        want[key].copy_(v)
    for p, s in ((tree, ts), (copy, loaded)):
        for g in grads[2:] * 2:
            tx.step(p, g, s)
    for key in tree:
        assert torch.equal(tree[key], copy[key]), key


def test_schedule_free_and_unknown_names(monkeypatch):
    """schedule-free AdamW under MultiSteps k=2: the parameters (the
    y-iterates) and ``eval_params`` (the x-average) match optax's
    ``schedule_free_eval_params``; unknown names raise."""
    hp = dict(optimizer="AdamW", scheduler="schedulefree",
              learning_rate=1e-2, warmup_steps=0,
              gradient_accumulation_steps=2, gradient_clipping=0.5)
    p0, jp, tp, js, ts = _run_wide(monkeypatch, hp, 6)
    _assert_wide(jp, tp, p0)
    want = joptim.eval_params(jp, js)
    got = optim.eval_params(tp, ts)
    for g, w, y in zip(tree_leaves(got), jax.tree_util.tree_leaves(want),
                       tree_leaves(tp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **WIDE_TOL)
        assert not torch.equal(g, y)
    with pytest.raises(ValueError):
        optim.make_optimizer(Hyperparameters(optimizer="lamb"))
    with pytest.raises(ValueError):
        optim.make_schedule(dataclasses.replace(Hyperparameters(),
                                                scheduler="linear_decay"))
