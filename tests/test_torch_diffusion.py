"""The port's diffusion modules against the JAX package, on the CPU in
fp32, at a tiny config (64 channels, 2 layers, 4 heads): K4's and K5's
plain versions against the Pallas kernels in interpret mode and the XLA
paths, the denoiser's functions, the schedule tables and a DDIM loop.

Tolerances: 1e-5 where the two compute the same fp32 expression (only
the summation order differs), 1e-4 through the attention blocks and the
denoiser (several normalisations and a softmax compound the order
differences), exact for the float64 schedule tables.  TF32 is off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models import diffusion as jdiff, gaussian as jgauss
from tortoise_tts_tpu.models.arch import _gn_qkv_xla
from tortoise_tts_tpu.models.common import (conv1d as jconv1d,
                                            group_norm as jgroup_norm,
                                            linear as jlinear,
                                            silu as jsilu)
from tortoise_tts_tpu.ops.pallas_resblock import (fused_gn_conv1x1,
                                                  fused_ts_res_block)
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.kernels import gn_conv as k4
from tortoise_tts_tpu_torch.kernels import ts_res_block as k5
from tortoise_tts_tpu_torch.models import diffusion as tdiff
from tortoise_tts_tpu_torch.models import gaussian as tgauss
from tortoise_tts_tpu_torch.models.common import linear, norm_groups, silu

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(model_channels=64, num_layers=2, num_heads=4,
            in_latent_channels=64)
TOL = dict(atol=1e-4, rtol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jcfg = jdiff.DiffusionConfig(**TINY)
    jp = jdiff.init(jax.random.PRNGKey(0), jcfg)
    # non-zero attention outputs (proj_out is zero-initialised), so every
    # attention block contributes
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    for name in ("code_converter", "latent_conditioner_attn",
                 "contextual_embedder_attn"):
        for a in jp[name]:
            a["proj_out"]["w"] = 0.1 * jax.random.normal(
                next(keys), a["proj_out"]["w"].shape)
    for lyr in jp["conditioning_timestep_integrator"] + jp["layers"]:
        lyr["attn"]["proj_out"]["w"] = 0.1 * jax.random.normal(
            next(keys), lyr["attn"]["proj_out"]["w"].shape)
    tp = bridge.diffusion_from_jax(_np(jp))
    return jcfg, jp, tdiff.DiffusionConfig(**TINY), tp


def _norm_conv(rng, c, m, k):
    norm = {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
            "bias": (0.1 * rng.randn(c)).astype(np.float32)}
    bound = (c * k) ** -0.5
    conv = {"w": rng.uniform(-bound, bound, (m, c, k)).astype(np.float32),
            "b": rng.uniform(-bound, bound, m).astype(np.float32)}
    return norm, conv


def _jx(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("m,act", [(128, True), (384, False)])
def test_gn_conv_plain_matches_pallas_interpret(m, act):
    """T % 128 == 0, where the TPU kernel runs."""
    rng = np.random.RandomState(m)
    x = (rng.randn(2, 128, 128) * 2 + 0.5).astype(np.float32)
    norm, conv = _norm_conv(rng, 128, m, 1)
    got = k4.gn_conv1x1(_t(x), bridge.to_torch(norm), bridge.to_torch(conv),
                        32, act).numpy()
    want = fused_gn_conv1x1(_jx(norm), _jx(conv), jnp.asarray(x), 32,
                            act=act, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", [True, False])
def test_gn_conv_plain_matches_xla_at_ragged_t(act):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 64, 45).astype(np.float32)
    norm, conv = _norm_conv(rng, 64, 192, 1)
    got = k4.gn_conv1x1(_t(x), bridge.to_torch(norm), bridge.to_torch(conv),
                        16, act).numpy()
    if act:
        want = jconv1d(_jx(conv), jsilu(jgroup_norm(_jx(norm),
                                                    jnp.asarray(x), 16)))
    else:
        want = _gn_qkv_xla(_jx(norm), _jx(conv), jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,c,t", [(2, 128, 128), (1, 64, 45)])
def test_ts_res_block_plain_matches_jax(b, c, t):
    """K4 (act) then K5's plain version: the whole resblock against the
    Pallas pair in interpret mode (T % 128 == 0) and the XLA block."""
    rng = np.random.RandomState(c + t)
    jp = jdiff._ts_res_block_init(jax.random.PRNGKey(c), c, c)
    x = rng.randn(b, c, t).astype(np.float32)
    emb = rng.randn(b, c).astype(np.float32)
    emb_out = jlinear(jp["emb"], jsilu(jnp.asarray(emb)))
    tp = bridge.to_torch(_np(jp))
    got = tdiff._ts_res_block(tp, _t(x), _t(emb)).numpy()
    g = norm_groups(c)
    h = k4.gn_conv1x1(_t(x), tp["in_norm"], tp["in_conv"], g, act=True)
    t_emb_out = linear(tp["emb"], silu(_t(emb)))
    half = k5.ts_res_block_out(h, _t(x), t_emb_out, tp["out_norm"],
                               tp["out_conv"], g)
    np.testing.assert_array_equal(half.numpy(), got)
    xla = jdiff._ts_res_block_xla(jp, jnp.asarray(x), emb_out)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5, rtol=1e-5)
    if t % 128 == 0:
        pallas = fused_ts_res_block(jp, jnp.asarray(x), emb_out, 32,
                                    interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), atol=3e-5,
                                   rtol=1e-5)


def test_precompute_rel_biases_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    got = tdiff.precompute_rel_biases(tp, 40, tcfg, torch.float32)
    want = jdiff.precompute_rel_biases(jp, 40, jcfg, jnp.float32)
    for part in ("integrator", "layers"):
        assert len(got[part]) == len(want[part])
        for g, w in zip(got[part], want[part]):
            assert g.shape == (4, 40, 40)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_embed_time_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    ts = np.array([0, 17, 999, 3999], np.int32)
    got = tdiff.embed_time(tp, _t(ts), tcfg).numpy()
    want = jdiff.embed_time(jp, jnp.asarray(ts), jcfg)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_integrate_conditioning_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.RandomState(3)
    code = rng.randn(2, 64, 37).astype(np.float32)
    temb = rng.randn(2, 64).astype(np.float32)
    got = tdiff.integrate_conditioning(
        tp, _t(code), _t(temb), tcfg,
        tdiff.precompute_rel_biases(tp, 37, tcfg)).numpy()
    want = jdiff.integrate_conditioning(
        jp, jnp.asarray(code), jnp.asarray(temb), jcfg,
        jdiff.precompute_rel_biases(jp, 37, jcfg))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("hoisted", [False, True])
def test_forward_matches_jax(models, hoisted):
    jcfg, jp, tcfg, tp = models
    rng = np.random.RandomState(4)
    x = rng.randn(2, 100, 37).astype(np.float32)
    code = rng.randn(2, 64, 37).astype(np.float32)
    ts = np.array([3, 2500], np.int32)
    got = tdiff.forward(
        tp, _t(x), _t(ts), _t(code), tcfg,
        tdiff.precompute_rel_biases(tp, 37, tcfg) if hoisted else None)
    want = jdiff.forward(
        jp, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(code), jcfg,
        jdiff.precompute_rel_biases(jp, 37, jcfg) if hoisted else None)
    assert got.shape == (2, 200, 37)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_get_conditioning_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    mels = np.random.RandomState(5).randn(1, 2, 100, 60).astype(np.float32)
    got = tdiff.get_conditioning(tp, _t(mels), tcfg).numpy()
    want = jdiff.get_conditioning(jp, jnp.asarray(mels), jcfg)
    assert got.shape == (1, 128)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("is_latent", [True, False])
def test_timestep_independent_matches_jax(models, is_latent):
    jcfg, jp, tcfg, tp = models
    rng = np.random.RandomState(6)
    aligned = (rng.randn(2, 23, 64).astype(np.float32) if is_latent
               else rng.randint(0, 8193, (2, 23)))
    cond = rng.randn(2, 128).astype(np.float32)
    got = tdiff.timestep_independent(tp, _t(aligned), _t(cond), 100, tcfg,
                                     is_latent=is_latent).numpy()
    want = jdiff.timestep_independent(jp, jnp.asarray(aligned),
                                      jnp.asarray(cond), 100, jcfg,
                                      is_latent=is_latent)
    assert got.shape == (2, 64, 100)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("steps", [1, 50, 80])
def test_schedule_tables_exact(steps):
    got = tgauss.get_schedule(steps=steps)
    want = jgauss.get_schedule(steps=steps)
    assert tgauss.space_timesteps(4000, steps) == \
        jgauss.space_timesteps(4000, steps)
    for name in got.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    # the guidance strength and its ramp are fixed in the port
    assert want.conditioning_free_k == tgauss.COND_FREE_K
    assert want.ramp_conditioning_free


def test_ddim_sample_loop_matches_jax(models):
    """Four DDIM steps with cond-free guidance through the denoiser, from
    the same noise."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.RandomState(8)
    noise = rng.randn(1, 100, 32).astype(np.float32)
    code = rng.randn(2, 64, 32).astype(np.float32)
    js, ts = jgauss.get_schedule(steps=4), tgauss.get_schedule(steps=4)

    def jfn(x, t, _):
        return jdiff.forward(jp, x, t, jnp.asarray(code), jcfg)

    def tfn(x, t, _):
        return tdiff.forward(tp, x, t, _t(code), tcfg)

    want = jgauss.sample_loop(jfn, jnp.asarray(noise),
                              jax.random.PRNGKey(0), js)
    got = tgauss.sample_loop(tfn, _t(noise), None, ts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # DPM++ raised before it was ported; it runs now
    # (tests/test_torch_dpmpp.py holds it against the JAX package)
    dpm = tgauss.sample_loop(tfn, _t(noise), None, ts, sampler="dpm++")
    assert dpm.shape == got.shape and torch.isfinite(dpm).all()
    with pytest.raises(ValueError, match="unknown sampler"):
        tgauss.sample_loop(tfn, _t(noise), None, ts, sampler="euler")


@pytest.mark.parametrize("steps", [1, 50, 80])
def test_cosine_schedule_tables_exact(steps):
    """The cosine beta schedule respaced (JAX ``get_schedule(schedule=
    "cosine")``), every table bit for bit."""
    got = tgauss.get_schedule(steps=steps, schedule="cosine")
    want = jgauss.get_schedule(steps=steps, schedule="cosine")
    for name in got.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert not np.array_equal(got.betas, tgauss.get_schedule(steps).betas)
    with pytest.raises(ValueError, match="beta schedule"):
        tgauss.get_schedule(steps, schedule="sigmoid")


@pytest.mark.parametrize("eta,schedule", [(0.8, "linear"), (0.0, "cosine")])
def test_ddim_eta_sample_loop_matches_jax(monkeypatch, eta, schedule):
    """DDIM at eta > 0 (sigma from the float32 tables, the noise added
    where t != 0) and on the cosine schedule: six guided steps of a linear
    stand-in for the denoiser (the sampler's math is under test; the
    denoiser's parity is the tests above), the JAX package's threefry draws
    injected through ``gaussian.row_noise`` (one a step, as its scan
    draws)."""
    rng = np.random.RandomState(11)
    noise = rng.randn(2, 100, 16).astype(np.float32)
    w = (rng.randn(200, 100) * 0.1).astype(np.float32)
    js = jgauss.get_schedule(steps=6, schedule=schedule)
    ts = tgauss.get_schedule(steps=6, schedule=schedule)
    key = jax.random.PRNGKey(3)
    draws, k = [], key
    for _ in range(6):
        k, sub = jax.random.split(k)
        draws.append(_t(jax.random.normal(sub, noise.shape, jnp.float32)))
    taken = []

    def injected(generators, x):
        taken.append(1)
        return draws[len(taken) - 1]
    monkeypatch.setattr(tgauss, "row_noise", injected)
    want = jgauss.sample_loop(
        lambda x, t, _: jnp.einsum("oc,bct->bot", w, x)
        + t.astype(jnp.float32)[:, None, None] / 4000.0,
        jnp.asarray(noise), key, js, eta=eta)
    got = tgauss.sample_loop(
        lambda x, t, _: torch.einsum("oc,bct->bot", _t(w), x)
        + t.float()[:, None, None] / 4000.0,
        _t(noise), [torch.Generator()] * 2, ts, eta=eta)
    assert len(taken) == (6 if eta else 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if eta:
        tabs = tgauss.step_tables(ts, "cpu", eta)
        assert float(tabs["ddim_sigma"][1]) > 0


@pytest.mark.parametrize("t", [0, 2])
def test_p_mean_variance_matches_jax(models, t):
    """The P sampler's step: mean, learned-range log variance and x_0,
    with cond-free guidance, at the last and a middle respaced step."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.RandomState(9)
    x = rng.randn(1, 100, 24).astype(np.float32)
    code = rng.randn(2, 64, 24).astype(np.float32)
    js, ts = jgauss.get_schedule(steps=4), tgauss.get_schedule(steps=4)
    want = jgauss.p_mean_variance(
        lambda xx, tt, _: jdiff.forward(jp, xx, tt, jnp.asarray(code), jcfg),
        jnp.asarray(x), jnp.asarray(t), js)
    got = tgauss.p_mean_variance(
        lambda xx, tt, _: tdiff.forward(tp, xx, tt, _t(code), tcfg),
        _t(x), t, ts)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
