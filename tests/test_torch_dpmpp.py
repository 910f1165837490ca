"""DPM-Solver++(2M), ``sample_loop(sampler="dpm++")``, against the JAX
package's ``_dpmpp_2m_loop`` on the CPU in fp32, and the default route
with ``diffusion_sampler="dpm++"`` against the JAX package's TTS.

Tolerances: the schedule tables bit for bit (both are float64 numpy cast
to float32); the loop 1e-4, as the DDIM loop's test (the denoiser's fp32
order differences, compounded over the steps); the route's wav within two
steps of the 16-bit output, as the DDIM route's test.  TF32 is off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pair import inject_jax_noise, make_pair
from tortoise_tts_tpu.models import diffusion as jdiff, gaussian as jgauss
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.models import diffusion as tdiff
from tortoise_tts_tpu_torch.models import gaussian as tgauss

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(model_channels=64, num_layers=2, num_heads=4,
            in_latent_channels=64)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("steps", [1, 30, 80])
def test_dpmpp_tables_bit_equal(steps):
    """alpha, sigma and lambda with the clean-state index T, as
    ``_dpmpp_2m_loop`` builds them."""
    sched = jgauss.get_schedule(steps=steps)
    abar = np.concatenate([sched.alphas_cumprod, [1.0 - 1e-8]])
    alpha = np.sqrt(abar)
    sigma = np.sqrt(np.maximum(1.0 - abar, 1e-12))
    want = {"alpha": alpha, "sigma": sigma,
            "lambda": np.log(alpha) - np.log(sigma)}
    tabs = tgauss.step_tables(tgauss.get_schedule(steps=steps), "cpu")
    for name, w in want.items():
        got = tabs[name].numpy()
        assert got.dtype == np.float32 and got.shape == (steps + 1,)
        np.testing.assert_array_equal(
            got, np.asarray(jnp.asarray(w, jnp.float32)), err_msg=name)


@pytest.fixture(scope="module")
def models():
    """The port's tiny denoiser, random from a seed, and the same weights
    in the JAX package (its eager init takes seconds)."""
    tcfg = tdiff.DiffusionConfig(**TINY)
    g = torch.Generator().manual_seed(0)
    tp = tdiff.init(g, tcfg)
    for lyr in tp["conditioning_timestep_integrator"] + tp["layers"]:
        w = lyr["attn"]["proj_out"]["w"]
        w.copy_(0.1 * torch.randn(w.shape, generator=g))
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tp))
    return jdiff.DiffusionConfig(**TINY), jp, tcfg, tp


@pytest.mark.parametrize("cond_free", [True, False])
def test_dpmpp_sample_loop_matches_jax(models, cond_free):
    """Six DPM++ steps through the denoiser from the same noise, with and
    without cond-free guidance (the first step first-order, then the
    multistep update, and the last step to the clean state)."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.RandomState(8)
    noise = rng.randn(2, 100, 32).astype(np.float32)
    rows = 4 if cond_free else 2
    code = rng.randn(rows, 64, 32).astype(np.float32)
    js = jgauss.get_schedule(steps=6, cond_free=cond_free)
    ts = tgauss.get_schedule(steps=6, cond_free=cond_free)

    def jfn(x, t, _):
        return jdiff.forward(jp, x, t, jnp.asarray(code), jcfg)

    def tfn(x, t, _):
        return tdiff.forward(tp, x, t, torch.from_numpy(code), tcfg)

    want = jgauss.sample_loop(jfn, jnp.asarray(noise), jax.random.PRNGKey(0),
                              js, sampler="dpm++")
    got = tgauss.sample_loop(tfn, torch.from_numpy(noise), None, ts,
                             sampler="dpm++")
    assert got.shape == (2, 100, 32) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    jtts, ttts, ref, _ = make_pair(tmp_path_factory.mktemp("dpmpp"), mp)
    yield jtts, ttts, ref
    mp.undo()


def test_inference_dpmpp_matches_jax(pair, monkeypatch):
    """The default route with ``diffusion_sampler="dpm++"``: greedy decode,
    the JAX package's diffusion noise, DPM++-5 with cond-free guidance,
    BigVGAN."""
    jtts, ttts, ref = pair
    drawn = inject_jax_noise(monkeypatch, [5])
    kw = dict(max_ar_steps=48, max_diffusion_steps=5, greedy=True, seed=5,
              diffusion_sampler="dpm++", mel_pad_multiple=128)
    jwav, _ = jtts.inference("hello world, a test.", ref, **kw)
    twav, sr = ttts.inference("hello world, a test.", ref, **kw)
    assert drawn["diffusion"] == [(1, 100, 256)] and sr == 24000
    assert twav.shape == jwav.shape and np.isfinite(twav).all()
    assert np.count_nonzero(twav) > 1000
    np.testing.assert_allclose(twav, jwav, rtol=0, atol=2 / 32767)
