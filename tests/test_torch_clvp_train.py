"""CLVP's training side in the port against the JAX package, on the CPU
in fp32 with TF32 off, at a tiny width (64 wide, 2 + 2 layers): the
legacy DALLE-style encoder with a key mask and its LayerScale init; the
symmetric InfoNCE loss and every gradient; one CLVP step built by
``load_engines`` (AdamW, clip 1.0) against the JAX package's
``make_clvp_train_step``.  Tolerances: 1e-5 on encoder outputs and the
loss (one fp32 expression, another summation order), 1e-4 relative to a
leaf's largest |value| on gradients and parameters after the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.config import Hyperparameters as JHp
from tortoise_tts_tpu.engine import optim as joptim
from tortoise_tts_tpu.engine import state as jst
from tortoise_tts_tpu.engine import train_step as jts
from tortoise_tts_tpu.models import clvp as jclvp
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.config import Config
from tortoise_tts_tpu_torch.engine import state as st
from tortoise_tts_tpu_torch.models import clvp as tclvp

from tests.torch_train_util import CFGS, one_thread  # noqa: F401
from tests.torch_train_util import tiny_load_model

pytestmark = pytest.mark.usefixtures("one_thread")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + 1e-7, f"{name}: {err} > {rel} x {scale}"


def _params():
    """The tiny CLVP's parameters from the port's init, as numpy (JAX's
    eager init costs more than the tests that use it)."""
    p = bridge.to_numpy(tclvp.init(torch.Generator().manual_seed(14),
                                   CFGS["clvp"][1]))
    # in the JAX package's leaf order (sorted keys)
    return jax.tree_util.tree_map(lambda a: a, p)


def _batch(b=4, tt=12, tm=20, seed=0):
    rng = np.random.RandomState(seed)
    return {"text": rng.randint(0, 256, (b, tt)).astype(np.int32),
            "codes": rng.randint(0, 8192, (b, tm)).astype(np.int32)}


@pytest.mark.parametrize("masked", [False, True])
def test_legacy_encoder_matches_jax(masked):
    """Three layers, 64 wide, 2 heads of 32, ff_mult 4; with a key mask
    whose rows keep 5 to 9 of 9 keys.  The port's init has the JAX tree
    and LayerScale's three depth regimes."""
    p = bridge.to_numpy(tclvp.legacy_encoder_init(
        torch.Generator().manual_seed(3), 64, 3, 2, dim_head=32))
    rng = np.random.RandomState(1)
    x = rng.randn(3, 9, 64).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(9)[None] < np.asarray([9, 5, 7])[:, None]
    got = tclvp.legacy_encoder(bridge.to_torch(p), _t(x),
                               None if mask is None else _t(mask), 2,
                               dim_head=32)
    want = jax.jit(lambda p, x, m: jclvp.legacy_encoder(
        p, x, m, 2, dim_head=32))(p, jnp.asarray(x),
                                  None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    own = bridge.to_numpy(tclvp.legacy_encoder_init(
        torch.Generator().manual_seed(0), 64, 26, 2, dim_head=32))
    shapes = jax.eval_shape(lambda k: jclvp.legacy_encoder_init(
        k, 64, 26, 2, dim_head=32), jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(own) == \
        jax.tree_util.tree_structure(shapes)
    for a, s in zip(jax.tree_util.tree_leaves(own),
                    jax.tree_util.tree_leaves(shapes)):
        assert a.shape == s.shape
    for ind, lp in enumerate(own["layers"]):
        want_scale = np.asarray(jclvp._layer_scale_init(ind + 1, 64))
        np.testing.assert_array_equal(lp["attn_scale"], want_scale)
        np.testing.assert_array_equal(lp["ff_scale"], want_scale)


def test_infonce_loss_and_gradients_match_jax():
    """The symmetric InfoNCE loss over a batch of 4 and its gradient in
    every parameter (the temperature included)."""
    jp = _params()
    jcfg, tcfg = CFGS["clvp"]
    b = _batch()
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jclvp.forward(
        p, jnp.asarray(b["text"]), jnp.asarray(b["codes"]), jcfg,
        return_loss=True)))(jax.tree_util.tree_map(jnp.asarray, jp))
    tp = bridge.to_torch(jp)
    leaves = [t.requires_grad_() for t in st.tree_leaves(tp)]
    loss = tclvp.forward(tp, _t(b["text"]).long(), _t(b["codes"]).long(),
                         tcfg, return_loss=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    want = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        if g is None:
            assert not np.asarray(w).any()
        else:
            _close(g.numpy(), w, 1e-4)
    # the scores are the diagonal of the loss's similarity matrix
    scores = tclvp.forward(tp, _t(b["text"]).long(), _t(b["codes"]).long(),
                           tcfg)
    assert scores.shape == (4,)


def test_clvp_step_through_load_engines_matches_jax(tmp_path, monkeypatch):
    """The factory's clvp engine (feeder: text and codes, no masks) and one
    ``Engines.step`` against the JAX package's step with its AdamW."""
    from tortoise_tts_tpu_torch import models as tmodels
    from tortoise_tts_tpu_torch.engine import factory as fac
    jp = _params()
    monkeypatch.setattr(tmodels, "load_model",
                        tiny_load_model({"clvp": jp}))
    monkeypatch.setattr(fac, "load_model", tiny_load_model({"clvp": jp}))
    hp = {"optimizer": "AdamW", "learning_rate": 1e-3, "warmup_steps": 0,
          "gradient_clipping": 1.0}
    cfg = Config.from_dict({"models": [{"name": "clvp", "training": True}],
                            "hyperparameters": hp,
                            "trainer": {"weight_dtype": "float32"}},
                           yaml_path=str(tmp_path / "cfg.yaml"))
    engines = fac.load_engines(cfg, device="cpu")
    assert engines.names() == ["clvp"]
    b = _batch(seed=2)
    # the feeder takes text and codes from the Dataset's wider batch
    m = engines.step({**b, "text_lengths": np.full(4, 12, np.int32)})

    jcfg = CFGS["clvp"][0]
    jtx = joptim.make_optimizer(JHp(**hp))
    jstep = jts.make_clvp_train_step(jcfg, jtx, donate=False)
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    jstate = jst.TrainState(params, jtx.init(params),
                            jnp.zeros((), jnp.int32),
                            jnp.zeros((), jnp.int32),
                            jnp.zeros((), jnp.int32))
    jstate, jm = jstep(jstate, jax.tree_util.tree_map(jnp.asarray, b))
    np.testing.assert_allclose(m["clvp.loss"], float(jm["loss"]), **TOL)
    got = st.flatten_tree(engines["clvp"].params)
    want = jst.flatten_tree(jstate.params)
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k].numpy() - np.asarray(jst.flatten_tree(params)[k]),
               np.asarray(w) - np.asarray(jst.flatten_tree(params)[k]),
               1e-4, k)
    assert engines["clvp"].step == 1
