"""BigVGAN's GAN training in the port against the JAX package, on the
CPU in fp32 with TF32 off: each DiscriminatorP period and DiscriminatorR
resolution (score and every feature map), the resolution spectrogram
with both windows, the training mel and the losses (values and
gradients), one vocoder step at the JAX package's own test sizes (the
only test that compiles the JAX step), and the engine's checkpoint
through ``load_engines``.

Tolerances: 1e-5 relative to a tensor's largest |value| (plus 1e-6)
where the two compute one fp32 expression in another summation order
(convs, FFTs); 1e-4 through the discriminators' five convs and the
losses; the step's parameter moves (SGD, so a move is the learning
rate times a gradient) within 2e-3 of the leaf's largest move.
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
from tortoise_tts_tpu.models import bigvgan as jbv
from tortoise_tts_tpu.models import bigvgan_disc as jbvd
from tests.torch_tiny import one_torch_thread  # noqa: F401
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.config import Config, Hyperparameters
from tortoise_tts_tpu_torch.engine import optim
from tortoise_tts_tpu_torch.engine import state as st
from tortoise_tts_tpu_torch.engine import train_step as ts
from tortoise_tts_tpu_torch.models import _bigvgan_random
from tortoise_tts_tpu_torch.models import bigvgan as tbv
from tortoise_tts_tpu_torch.models import bigvgan_disc as bvd
from tortoise_tts_tpu_torch.utils.io import load_state_dict

from tests.torch_train_util import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the JAX package's own vocoder test sizes (test_multi_engine.py)
GEN = dict(upsample_initial_channel=64)
PERIODS = (2, 3)
RESOLUTIONS = ((512, 128, 512),)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale + 1e-6, f"{name}: {err} > {rel} x {scale}"


def _numpy_disc(cfg, seed):
    """Discriminator params drawn with numpy into the JAX init's tree
    (``jax.eval_shape``: no eager JAX init): v ~ N(0, 0.01), g = |v| per
    output channel (the weight-norm init), b ~ U(+-1/sqrt(fan_in))."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jbvd.init(k, cfg),
                            jax.random.PRNGKey(0))

    def conv(s):
        v = rng.standard_normal(s["v"].shape, np.float32) * np.float32(0.01)
        bound = 1.0 / np.sqrt(np.prod(s["v"].shape[1:]))
        return {"v": v, "g": np.sqrt((v * v).sum(axis=(1, 2, 3))),
                "b": rng.uniform(-bound, bound, s["b"].shape
                                 ).astype(np.float32)}
    return {k: [{"convs": [conv(c) for c in d["convs"]],
                 "post": conv(d["post"])} for d in shapes[k]]
            for k in ("mpd", "mrd")}


def _wav(b, t, seed):
    rng = np.random.RandomState(seed)
    x = np.linspace(0, 1, t)
    return (0.4 * np.sin(2 * np.pi * (180 + 40 * np.arange(b)[:, None]) * x)
            + 0.05 * rng.randn(b, t)).astype(np.float32)


@pytest.fixture(scope="module")
def full_disc():
    """The shipped discriminator (every period and resolution), numpy."""
    return _numpy_disc(jbvd.DiscriminatorConfig(), 0)


@pytest.mark.parametrize("i", range(len(bvd.MPD_PERIODS)))
def test_discriminator_p_matches_jax(full_disc, i):
    """Each period at T = 1001 (a reflect pad to a multiple of every
    period), B = 2: the score and all six feature maps."""
    period = bvd.MPD_PERIODS[i]
    p = full_disc["mpd"][i]
    wav = _wav(2, 1001, i)[:, None]
    s, f = bvd._disc_p_apply(bridge.to_torch(p), _t(wav), period)
    js, jf = jax.jit(jbvd._disc_p_apply, static_argnums=2)(
        p, jnp.asarray(wav), period)
    _close(s.numpy(), js, 1e-4, "score")
    assert len(f) == len(jf) == 6
    for k, (a, b) in enumerate(zip(f, jf)):
        _close(a.numpy(), b, 1e-4, f"fmap {k}")


@pytest.mark.parametrize("i", range(len(bvd.MRD_RESOLUTIONS)))
def test_discriminator_r_matches_jax(full_disc, i):
    """Each resolution at T = 4000, B = 2: the score and all six feature
    maps."""
    res = bvd.MRD_RESOLUTIONS[i]
    p = full_disc["mrd"][i]
    wav = _wav(2, 4000, 10 + i)[:, None]
    s, f = bvd._disc_r_apply(bridge.to_torch(p), _t(wav), res)
    js, jf = jax.jit(jbvd._disc_r_apply, static_argnums=2)(
        p, jnp.asarray(wav), res)
    _close(s.numpy(), js, 1e-4, "score")
    assert len(f) == len(jf) == 6
    for k, (a, b) in enumerate(zip(f, jf)):
        _close(a.numpy(), b, 1e-4, f"fmap {k}")


@pytest.mark.parametrize("window", ["hann", "ones"])
def test_resolution_spectrogram_matches_jax(window):
    """|STFT| at the first MRD resolution (a 600-sample window centred in
    1024) at T = 3001 (reflect pad (n_fft - hop) / 2), with the training
    mel's periodic Hann window and the discriminator's rectangular one,
    and its gradient under a fixed upstream (the other resolutions run in
    the discriminator and training-mel tests)."""
    res = (1024, 120, 600)
    wav = _wav(2, 3001, 3)
    x = _t(wav).requires_grad_()
    got = bvd._resolution_spectrogram(x, *res, window=window)
    spec = jax.jit(lambda w: jbvd._resolution_spectrogram(
        w, *res, window=window))
    want = spec(jnp.asarray(wav))
    _close(got.detach().numpy(), want, 1e-5)
    up = np.random.RandomState(4).randn(*want.shape).astype(np.float32)
    (gx,) = torch.autograd.grad(got, x, _t(up))
    jg = jax.jit(jax.grad(lambda w: jnp.sum(spec(w) * up)))(
        jnp.asarray(wav))
    _close(gx.numpy(), jg, 1e-4)


@pytest.mark.parametrize("what", ["training_mel", "mel_loss",
                                  "discriminator_loss", "generator_loss",
                                  "feature_loss"])
def test_training_mel_and_losses_match_jax(what):
    """The training mel; the mel L1 and its gradient in the fake wav; the
    LSGAN losses and feature matching on random scores and maps, with
    their gradients (none reaches the real feature maps)."""
    rng = np.random.RandomState(7)
    if what in ("training_mel", "mel_loss"):
        real, fake = _wav(2, 4096, 1), _wav(2, 4096, 2) * 0.7
        if what == "training_mel":
            _close(bvd.training_mel(_t(real)).numpy(),
                   jax.jit(jbvd.training_mel)(jnp.asarray(real)), 1e-5)
            return
        x = _t(fake).requires_grad_()
        loss = bvd.mel_loss(_t(real), x)
        (g,) = torch.autograd.grad(loss, x)
        jl, jg = jax.jit(jax.value_and_grad(lambda f: jbvd.mel_loss(
            jnp.asarray(real), f)))(jnp.asarray(fake))
        _close(loss.detach().numpy(), jl, 1e-5)
        _close(g.numpy(), jg, 1e-4)
        return
    real = [rng.randn(2, 5 + i).astype(np.float32) for i in range(3)]
    fake = [rng.randn(2, 5 + i).astype(np.float32) for i in range(3)]
    if what == "feature_loss":
        real = [[rng.randn(2, 3, 4 + j).astype(np.float32)
                 for j in range(2)] for _ in range(2)]
        fake = [[rng.randn(2, 3, 4 + j).astype(np.float32)
                 for j in range(2)] for _ in range(2)]
    tr = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(), real)
    tf = jax.tree_util.tree_map(lambda a: _t(a).requires_grad_(), fake)
    fn = getattr(bvd, what)
    jfn = getattr(jbvd, what)
    if what == "generator_loss":
        loss = fn(tf)
        jl, (jgr, jgf) = jax.jit(jax.value_and_grad(
            lambda r, f: jfn(f), argnums=(0, 1)))(real, fake)
    else:
        loss = fn(tr, tf)
        jl, (jgr, jgf) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
            real, fake)
    _close(loss.detach().numpy(), jl, 1e-5)
    leaves_r = jax.tree_util.tree_leaves(tr)
    leaves_f = jax.tree_util.tree_leaves(tf)
    grads = torch.autograd.grad(loss, leaves_r + leaves_f, allow_unused=True)
    for g, want in zip(grads, jax.tree_util.tree_leaves(jgr)
                       + jax.tree_util.tree_leaves(jgf)):
        if g is None:
            assert not np.asarray(want).any()
        else:
            _close(g.numpy(), want, 1e-5)
    if what == "feature_loss":
        assert all(g is None for g in grads[:len(leaves_r)])


def _sgd():
    return dict(optimizer="SGD", learning_rate=1e-2, warmup_steps=0,
                gradient_accumulation_steps=1, gradient_clipping=0.0)


def test_vocoder_step_matches_jax(monkeypatch):
    """One GAN step at the JAX vocoder test's sizes (BigVGAN 64 wide, MPD
    periods 2 and 3, one MRD resolution, 4096 samples), SGD for both
    networks: the five metrics and the move of every generator and
    discriminator parameter.  The JAX step resamples through its "conv"
    resampler (``TTS_BV_RESAMPLE=conv``: one depthwise conv a resample,
    the same function as the CPU default's blocked FIR, whose hundreds of
    slices make the step's trace and compile much longer)."""
    monkeypatch.setattr(jbv, "_RESAMPLE", "conv")
    jcfg, tcfg = jbv.BigVGANConfig(**GEN), tbv.BigVGANConfig(**GEN)
    dcfg = jbvd.DiscriminatorConfig(periods=PERIODS, resolutions=RESOLUTIONS)
    tdcfg = bvd.DiscriminatorConfig(periods=PERIODS, resolutions=RESOLUTIONS)
    gen = bridge.to_numpy(_bigvgan_random(torch.Generator().manual_seed(0),
                                          tcfg))
    disc = _numpy_disc(dcfg, 1)
    wav = _wav(1, 4096, 0)
    jtx, jtx_d = (joptim.make_optimizer(JHp(**_sgd())) for _ in range(2))
    jstep = jts.make_vocoder_train_step(jcfg, jtx, jtx_d, dcfg, donate=False)
    jp = jax.tree_util.tree_map(jnp.asarray, {"generator": gen,
                                              "discriminator": disc})
    jstate = jst.TrainState(jp, {"g": jtx.init(jp["generator"]),
                                 "d": jtx_d.init(jp["discriminator"])},
                            jnp.zeros((), jnp.int32),
                            jnp.zeros((), jnp.int32),
                            jnp.zeros((), jnp.int32))
    jstate, jm = jstep(jstate, {"wav": jnp.asarray(wav)})

    tx, tx_d = (optim.make_optimizer(Hyperparameters(**_sgd()))
                for _ in range(2))
    params = {"generator": bridge.to_torch(gen),
              "discriminator": bridge.to_torch(disc)}
    state = st.TrainState(params, {"g": tx.init(params["generator"]),
                                   "d": tx_d.init(params["discriminator"])})
    step = ts.make_vocoder_train_step(tcfg, tx, tx_d, tdcfg)
    state, m = step(state, {"wav": _t(wav)})
    assert set(m) == set(jm) == {"loss", "loss.disc", "loss.adv",
                                 "loss.fm", "loss.mel"}
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    assert state.step == 1 and state.samples_processed == 1
    p0 = jax.tree_util.tree_leaves({"generator": gen, "discriminator": disc})
    got = st.flatten_tree(state.params)
    want = jst.flatten_tree(jstate.params)
    assert set(got) == set(want)
    moved = 0
    for (name, w), q in zip(want.items(), p0):
        g = got[name].numpy()
        dw, dg = np.asarray(w) - q, g - q
        _close(dg, dw, 2e-3, name)
        moved += bool(np.abs(dw).max() > 0)
    assert moved > len(want) // 2


def test_vocoder_engine_checkpoint_resumes(tmp_path, monkeypatch):
    """``load_engines`` builds the bigvgan engine (generator + a random
    discriminator, two schedule-free AdamW states); two steps through
    ``Engines.step``, a checkpoint, and a new ``load_engines`` resumes to
    the same parameters and optimizer states bit for bit (the JAX layout:
    ``generator/...``, ``discriminator/...``); the export holds each
    network's x-average under its own optimizer's state; the Dataset's
    batches have no wav, and the feeder says so; an OOM after the
    discriminator's update reloads the checkpoint."""
    from tortoise_tts_tpu_torch import models as tmodels
    from tortoise_tts_tpu_torch.engine import factory as fac
    from tortoise_tts_tpu_torch.models import DTYPES, LoadedModel

    tcfg = tbv.BigVGANConfig(**GEN)
    gen = bridge.to_numpy(_bigvgan_random(torch.Generator().manual_seed(0),
                                          tcfg))

    def load(name, dtype="float32", seed=0, device=None):
        assert name == "bigvgan"
        return LoadedModel(name, tbv, tcfg, bridge.to_torch(
            gen, device or "cpu", DTYPES[dtype]), False)
    monkeypatch.setattr(tmodels, "load_model", load)
    monkeypatch.setattr(fac, "load_model", load)
    small = bvd.DiscriminatorConfig(periods=(2,), resolutions=RESOLUTIONS)
    monkeypatch.setattr(bvd, "DiscriminatorConfig", lambda: small)
    cfg = Config.from_dict({
        "models": [{"name": "bigvgan", "training": True}],
        "hyperparameters": {"optimizer": "AdamW", "learning_rate": 1e-3,
                            "scheduler": "schedulefree", "warmup_steps": 0,
                            "gradient_accumulation_steps": 1},
        "trainer": {"weight_dtype": "float32"}},
        yaml_path=str(tmp_path / "cfg.yaml"))
    engines = fac.load_engines(cfg, device="cpu")
    assert engines.names() == ["bigvgan"]
    s = engines["bigvgan"]
    assert set(s.params) == {"generator", "discriminator"}
    assert set(s.opt_state) == {"g", "d"}
    batch = {"wav": _wav(1, 2048, 5)}
    for _ in range(2):
        m = engines.step(batch)
    assert np.isfinite(m["bigvgan.loss.mel"]) and "loss" in m
    engines.save_checkpoint(cfg.ckpt_dir)
    names = st.flatten_tree(s.params)
    assert any(k.startswith("discriminator/mpd/0/convs/0/") for k in names)
    resumed = fac.load_engines(cfg, device="cpu")
    assert resumed.global_step == 2
    r = resumed["bigvgan"]
    for tree in ("params", "opt_state"):
        a = st.flatten_tree(getattr(s, tree))
        b = st.flatten_tree(getattr(r, tree))
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (tree, k)
    engines.export(tmp_path / "export")
    out = load_state_dict(tmp_path / "export" / "bigvgan" / "fp32.sft")
    assert len(out) == len(names)
    for net, key in (("generator", "g"), ("discriminator", "d")):
        z = st.flatten_tree(s.opt_state[key]["sf"]["z"])
        for k, y in st.flatten_tree(s.params[net]).items():
            assert torch.equal(out[f"{net}/{k}"], (y - 0.1 * z[k]) / 0.9), k
    with pytest.raises(KeyError, match="wav"):
        engines.step({"text": np.zeros((1, 4), np.int32)})
    # an OOM in the generator's loss, after the discriminator's update:
    # the batch is skipped and the engine reloads its last checkpoint
    saved = {k: v.clone() for k, v in st.flatten_tree(s.params).items()}
    engines.step(batch)
    assert not all(torch.equal(saved[k], v)
                   for k, v in st.flatten_tree(s.params).items())

    def oom(*args):
        raise torch.cuda.OutOfMemoryError("simulated")
    monkeypatch.setattr(bvd, "generator_loss", oom)
    m = engines.step(batch)
    assert m["bigvgan.skipped"] == 1.0
    assert engines.global_step == 2
    for k, v in st.flatten_tree(engines["bigvgan"].params).items():
        assert torch.equal(v, saved[k]), k
