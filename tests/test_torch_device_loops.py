"""The decode and sampler steps that read no host value (the bodies that
CUDA graphs capture on the card), on the CPU against the JAX package and
against the host-scalar formulas they replace: the length penalty on the
device step, the sampler's device tables, DDIM with and without
cond-free guidance, and ``TTS``'s ``amp``/``attention`` arguments.  CPU
tensors run the steps eagerly and never capture.

Tolerances: the tables and one sampler step are bit-equal (the same fp32
numbers and operations); the length penalty within 1 fp32 ulp (two
``pow`` implementations); decodes token-exact; the DDIM loop through the
denoiser within 1e-4, as ``test_torch_diffusion.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.config import Config as JConfig, Inference as JInference
from tortoise_tts_tpu.inference import TTS as JTTS
from tortoise_tts_tpu.models import diffusion as jdiff, gaussian as jgauss
from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu.ops import sampling as jsampling
from tortoise_tts_tpu.ops.sampling import SamplingConfig as JSampling
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.config import Config, Inference
from tortoise_tts_tpu_torch.inference import TTS
from tortoise_tts_tpu_torch.models import diffusion as tdiff
from tortoise_tts_tpu_torch.models import gaussian as tgauss
from tortoise_tts_tpu_torch.models import unified_voice as uv
from tortoise_tts_tpu_torch.ops.sampling import (SamplingConfig,
                                                 apply_length_penalty)
from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer
from tortoise_tts_tpu_torch.utils.graphs import STATS

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

UV_TINY = dict(layers=2, model_dim=128, heads=2, max_text_tokens=40,
               max_mel_tokens=40)
DIFF_TINY = dict(model_channels=64, num_layers=2, num_heads=4,
                 in_latent_channels=64)
MAX_LEN = 24


def test_tts_accepts_amp_and_attention_like_jax(tmp_path, monkeypatch):
    """``TTS(amp=..., attention=...)`` builds in both packages, and the
    port ignores both, as the JAX package does."""
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER",
                       str(write_char_tokenizer(tmp_path / "tok.json")))
    for amp, attention in ((True, "sdpa"), (False, None)):
        jtts = JTTS(config=JConfig(inference=JInference(
            weight_dtype="float32")), amp=amp, attention=attention)
        ttts = TTS(Config(inference=Inference(weight_dtype="float32")),
                   device="cpu", amp=amp, attention=attention)
        assert ttts.dtype == jtts.dtype == "float32"
        assert ttts.cfg.inference.denoise_attention == "auto"
    assert TTS(device="cpu", amp=True, attention="sdpa").dtype == "bfloat16"


@pytest.mark.parametrize("factor", [-0.5, 1.0, 2.0])
def test_length_penalty_on_the_device_step_matches_jax(factor):
    """stop / max(step, 1)**factor in fp32 at the steps 0..300, the step a
    0-d int32 tensor as the decode keeps it."""
    rng = np.random.RandomState(4)
    stop = rng.randn(3).astype(np.float32) * 5
    for step in (0, 1, 2, 7, 64, 300):
        want = np.asarray(jsampling.apply_length_penalty(
            jnp.asarray(stop), jnp.asarray(step, jnp.int32), factor))
        got = apply_length_penalty(torch.from_numpy(stop),
                                   torch.tensor(step, dtype=torch.int32),
                                   factor).numpy()
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


@pytest.fixture(scope="module")
def uv_models():
    jcfg = juv.UnifiedVoiceConfig(**UV_TINY)
    jp = juv.init(jax.random.PRNGKey(0), jcfg)
    jp["mel_head"]["w"] = jp["mel_head"]["w"] * 8.0
    tp = bridge.unified_voice_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, uv.UnifiedVoiceConfig(**UV_TINY), tp


def _greedy_decode(models, sampling_kw, stop_bias):
    jcfg, jp, tcfg, tp = models
    jp = dict(jp, mel_head=dict(jp["mel_head"]))
    jp["mel_head"]["b"] = jp["mel_head"]["b"].at[jcfg.stop_mel_token] \
        .add(stop_bias)
    tp = dict(tp, mel_head=dict(tp["mel_head"]))
    tp["mel_head"]["b"] = tp["mel_head"]["b"].clone()
    tp["mel_head"]["b"][tcfg.stop_mel_token] += stop_bias
    rng = np.random.RandomState(0)
    text = rng.randint(1, 200, size=(2, 12)).astype(np.int32)
    lengths = np.asarray([12, 7], np.int32)
    cond = rng.randn(2, 128).astype(np.float32)
    js = juv.decode_start(jp, jnp.asarray(cond), jnp.asarray(text),
                          jnp.asarray(lengths), jax.random.PRNGKey(0), jcfg,
                          MAX_LEN)
    js = juv.decode_chunk(jp, js, jcfg, JSampling(**sampling_kw),
                          collect_latents=True)
    ts = uv.decode_start(tp, torch.from_numpy(cond),
                         torch.from_numpy(text).long(),
                         torch.from_numpy(lengths).long(), None, tcfg,
                         MAX_LEN)
    captures = STATS.captures
    ts = uv.decode_chunk(tp, ts, tcfg, SamplingConfig(**sampling_kw),
                         collect_latents=True)
    assert STATS.captures == captures and ts.graph is None   # CPU: eager
    return js, ts


def test_greedy_decode_with_length_penalty_token_exact(uv_models):
    """A greedy decode whose stop logit is divided by the device step's
    power: token-exact against the JAX ``decode_chunk``, lengths and
    latents included, and the penalty changes where a row stops."""
    jcfg, jp = uv_models[:2]
    # a stop bias that makes row 0 stop part-way without the penalty (the
    # first step whose logit gap undercuts every earlier one)
    free_j, _ = _greedy_decode(uv_models, dict(greedy=True), 0.0)
    lat = np.asarray(free_j.latents)[0]
    logits = lat @ np.asarray(jp["mel_head"]["w"]) \
        + np.asarray(jp["mel_head"]["b"])
    gap = logits.max(-1) - logits[:, jcfg.stop_mel_token]
    j = next(i for i in range(3, MAX_LEN) if gap[i] < gap[:i].min())
    bias = 0.5 * (gap[j] + gap[:j].min())
    base_j, base_t = _greedy_decode(uv_models, dict(greedy=True), bias)
    assert int(base_t.lengths[0]) == j
    js, ts = _greedy_decode(uv_models, dict(greedy=True,
                                            length_penalty_factor=2.0), bias)
    for j, t in ((base_j, base_t), (js, ts)):
        np.testing.assert_array_equal(t.tokens.numpy(), np.asarray(j.tokens))
        np.testing.assert_array_equal(t.lengths.numpy(),
                                      np.asarray(j.lengths))
        for r, n in enumerate(np.asarray(j.lengths)):
            np.testing.assert_allclose(t.latents[r, :n + 1].numpy(),
                                       np.asarray(j.latents)[r, :n + 1],
                                       atol=1e-4, rtol=1e-4)
        assert int(t.step_dev) == t.step
    assert not np.array_equal(ts.lengths.numpy(), base_t.lengths.numpy())


def _host_tables_step(model_fn, x, t, sched, sampler, z):
    """One reverse step with the schedule read as host float32 scalars, as
    the eager loop of earlier versions computed it (``_tab``); ``z``: the
    P sampler's noise."""
    tab = tgauss._tab
    b = x.shape[0]
    t_orig = int(sched.timestep_map[t])
    if sched.conditioning_free:
        out = model_fn(torch.cat([x, x]), torch.full((2 * b,), t_orig), t)
        out_cond, out_uncond = out.float().chunk(2, dim=0)
        eps_cond, var_values = out_cond.chunk(2, dim=1)
        eps_uncond = out_uncond.chunk(2, dim=1)[0]
        cfk = np.float32(tgauss.COND_FREE_K) * (
            np.float32(1.0) - np.float32(t) / np.float32(sched.num_timesteps))
        eps = float(1 + cfk) * eps_cond - float(cfk) * eps_uncond
    else:
        out = model_fn(x, torch.full((b,), t_orig), t)
        eps, var_values = out.float().chunk(2, dim=1)
    min_log = float(tab(sched.posterior_log_variance_clipped, t))
    max_log = float(tab(sched.log_betas, t))
    frac = (var_values + 1) / 2
    logvar = frac * max_log + (1 - frac) * min_log
    xstart = (float(tab(sched.sqrt_recip_alphas_cumprod, t)) * x
              - float(tab(sched.sqrt_recipm1_alphas_cumprod, t)) * eps
              ).clamp(-1, 1)
    mean = (float(tab(sched.posterior_mean_coef1, t)) * xstart
            + float(tab(sched.posterior_mean_coef2, t)) * x)
    if sampler == "p":
        return mean + torch.exp(0.5 * logvar) * z if t != 0 else mean
    eps = ((float(tab(sched.sqrt_recip_alphas_cumprod, t)) * x - xstart)
           / float(tab(sched.sqrt_recipm1_alphas_cumprod, t)))
    abar_prev = tab(sched.alphas_cumprod_prev, t)
    return (xstart * float(np.sqrt(abar_prev))
            + float(np.sqrt(np.float32(1) - abar_prev)) * eps)


@pytest.mark.parametrize("cond_free", [True, False])
@pytest.mark.parametrize("sampler", ["ddim", "p"])
@pytest.mark.parametrize("steps", [4, 50])
def test_device_tables_equal_host_tab_at_every_step(steps, sampler,
                                                    cond_free):
    """``step_tables`` holds the host ``_tab`` float32 values bit for bit,
    and one sampler step indexed by the device step equals the host-scalar
    step bit for bit at every respaced step (a stand-in denoiser whose
    output depends on x and the original timestep)."""
    sched = tgauss.get_schedule(steps=steps, cond_free=cond_free)
    tabs = tgauss.step_tables(sched, "cpu")
    n = sched.num_timesteps
    for name, arr in (("min_log", sched.posterior_log_variance_clipped),
                      ("max_log", sched.log_betas),
                      ("recip", sched.sqrt_recip_alphas_cumprod),
                      ("recipm1", sched.sqrt_recipm1_alphas_cumprod),
                      ("coef1", sched.posterior_mean_coef1),
                      ("coef2", sched.posterior_mean_coef2)):
        want = np.asarray([tgauss._tab(arr, t) for t in range(n)])
        np.testing.assert_array_equal(tabs[name].numpy(), want, err_msg=name)
    np.testing.assert_array_equal(tabs["timestep_map"].numpy(),
                                  sched.timestep_map)
    rng = np.random.RandomState(5)
    w = torch.from_numpy(rng.randn(200, 100).astype(np.float32) * 0.1)

    def model_fn(x, ts, _):
        te = ts.float()[:, None, None] / 4000.0
        return torch.einsum("oc,bct->bot", w, x) + te

    x0 = torch.from_numpy(rng.randn(2, 100, 16).astype(np.float32))
    gens = [torch.Generator().manual_seed(9 + r) for r in range(2)]
    x, t = x0.clone(), torch.tensor([n - 1])
    step = tgauss.sampler_step_fn(model_fn, x, t, tabs, gens, sched, sampler)
    ref_gens = [torch.Generator().manual_seed(9 + r) for r in range(2)]
    want = x0.clone()
    for ti in range(n - 1, -1, -1):
        z = torch.cat([torch.randn((1, 100, 16), generator=g)
                       for g in ref_gens])
        want = _host_tables_step(model_fn, want, ti, sched, sampler, z)
        step()
        assert torch.equal(x, want), ti
    assert int(t) == -1


@pytest.fixture(scope="module")
def diff_models():
    jcfg = jdiff.DiffusionConfig(**DIFF_TINY)
    jp = jdiff.init(jax.random.PRNGKey(0), jcfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 8))
    for lyr in jp["conditioning_timestep_integrator"] + jp["layers"]:
        lyr["attn"]["proj_out"]["w"] = 0.1 * jax.random.normal(
            next(keys), lyr["attn"]["proj_out"]["w"].shape)
    tp = bridge.diffusion_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jp, tdiff.DiffusionConfig(**DIFF_TINY), tp


@pytest.mark.parametrize("cond_free", [True, False])
def test_sample_loop_with_device_step_matches_jax(diff_models, cond_free):
    """DDIM through the tiny denoiser with the device step indexing the
    tables and the model's timesteps, from injected noise, against the
    JAX ``sample_loop``; the CPU loop captures nothing."""
    jcfg, jp, tcfg, tp = diff_models
    rng = np.random.RandomState(8)
    noise = rng.randn(1, 100, 32).astype(np.float32)
    code = rng.randn(2 if cond_free else 1, 64, 32).astype(np.float32)
    js = jgauss.get_schedule(steps=4, cond_free=cond_free)
    ts = tgauss.get_schedule(steps=4, cond_free=cond_free)
    seen = []

    def jfn(x, t, _):
        return jdiff.forward(jp, x, t, jnp.asarray(code), jcfg)

    def tfn(x, t, t_idx):
        seen.append((t.clone(), t_idx.clone()))
        return tdiff.forward(tp, x, t, torch.from_numpy(code), tcfg)

    want = jgauss.sample_loop(jfn, jnp.asarray(noise),
                              jax.random.PRNGKey(0), js)
    captures = STATS.captures
    got = tgauss.sample_loop(tfn, torch.from_numpy(noise), None, ts)
    assert STATS.captures == captures
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    rows = 2 if cond_free else 1
    for i, (t, t_idx) in enumerate(seen):
        assert t_idx.tolist() == [3 - i]
        assert t.tolist() == [int(ts.timestep_map[3 - i])] * rows
