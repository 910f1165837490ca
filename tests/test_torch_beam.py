"""Beam search (``unified_voice.inference_speech_beam``) against the JAX
package's ``inference_speech_beam`` on the CPU in fp32, and the routes
that run it, ``TTS.inference(beam_width=2)`` and
``batch_inference(beam_width=2)``, against the JAX package's TTS.

The tiny model's trunk is scaled up so rows with other texts decode
differently, and its stop logit is biased and grows with the length
(``length_penalty_factor`` < 0), so beams stop at several lengths and
``length_penalty`` changes the pick.  Tolerances: tokens and lengths
exact, greedy (no ties among distinct fp32 totals) and sampled with the
JAX package's Gumbel draws injected; the routes' wavs within two steps of
the 16-bit output, as the default route's test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pair import inject_jax_noise, make_pair
from tests.torch_tiny import one_torch_thread  # noqa: F401
from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu.ops.sampling import SamplingConfig as JSampling
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.models import unified_voice as tuv
from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig

torch.backends.cuda.matmul.allow_tf32 = False

UV = dict(layers=2, model_dim=64, heads=2, max_text_tokens=40,
          max_mel_tokens=80)
STEPS = 30
KNOBS = dict(repetition_penalty=1.3, typical_mass=0.9,
             length_penalty_factor=-0.5)


@pytest.fixture(scope="module")
def model():
    cfg = tuv.UnifiedVoiceConfig(**UV)
    tp = tuv.init(torch.Generator().manual_seed(0), cfg)
    tp["mel_head"]["w"] *= 8.0
    for name in ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj"):
        tp["gpt"][name]["w"] *= 5.0
    tp["mel_head"]["b"][cfg.stop_mel_token] = 3.0
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tp))
    return cfg, tp, juv.UnifiedVoiceConfig(**UV), jp


def _inputs(b):
    rng = np.random.RandomState(0)
    text = rng.randint(1, 200, (b, 12))
    lengths = np.asarray([12, 9][:b])
    cond = rng.randn(b, 64).astype(np.float32)
    return text, lengths, cond


def _jax_gumbel(key, b, w, v):
    """The Gumbel draws of the JAX loop's steps: (STEPS, B, W*V)."""
    draws, rng = [], key
    for _ in range(STEPS):
        rng, sub = jax.random.split(rng)
        draws.append(np.asarray(jax.random.gumbel(sub, (b, w * v),
                                                  jnp.float32)))
    return torch.from_numpy(np.stack(draws))


def _run_both(model, b, w, knobs, do_sample):
    cfg, tp, jcfg, jp = model
    text, lengths, cond = _inputs(b)
    key = jax.random.PRNGKey(7)
    want = juv.inference_speech_beam(
        jp, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(lengths), jcfg,
        num_beams=w, max_length=STEPS, sampling=JSampling(**knobs), key=key,
        do_sample=do_sample)
    gumbel = (_jax_gumbel(key, b, w, cfg.number_mel_codes) if do_sample
              else None)
    got = tuv.inference_speech_beam(
        tp, torch.from_numpy(cond), torch.from_numpy(text),
        torch.from_numpy(lengths), cfg, w, STEPS, SamplingConfig(**knobs),
        do_sample=do_sample, gumbel=gumbel)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert not got.latents.any() and got.latents.shape == (b, STEPS, 64)
    return got


@pytest.mark.parametrize("length_penalty", [1.0, 2.0])
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("w", [2, 3])
def test_greedy_beam_matches_jax(model, w, b, length_penalty):
    """``do_sample=False``: the top W of the flat totals every step, the
    repetition penalty and the typical warper on the log-probs, the stop
    logit's length penalty, frozen beams, the final pick."""
    got = _run_both(model, b, w, dict(KNOBS, length_penalty=length_penalty),
                    do_sample=False)
    assert (got.lengths < STEPS).all()


@pytest.mark.parametrize("w", [2, 3])
def test_sampled_beam_matches_jax(model, w):
    """``do_sample=True`` (HF ``beam_sample``): temperature and top-p on the
    totals, a Gumbel top-2W from the JAX package's draws, the frozen
    beams' stop continuations, the top W by warped score."""
    _run_both(model, 2, w, dict(KNOBS, temperature=0.9, top_p=0.95),
              do_sample=True)


def test_length_penalty_changes_the_pick(model):
    """The same beams, chosen with length_penalty 1 and 2: a longer beam
    wins at 2."""
    cfg, tp, _, _ = model
    text, lengths, cond = _inputs(2)
    args = (tp, torch.from_numpy(cond), torch.from_numpy(text),
            torch.from_numpy(lengths), 3, cfg, STEPS)
    state = tuv.beam_start(*args)
    tuv.advance(state, STEPS, tuv.beam_step_fn(
        tp, state, cfg, SamplingConfig(**KNOBS)))
    short = tuv.beam_result(state, 1.0).lengths
    long = tuv.beam_result(state, 2.0).lengths
    assert (long >= short).all() and (long > short).any()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX package's beam decodes with the model's own weights, so both
    sides run ``decode_quant="none"``."""
    mp = pytest.MonkeyPatch()
    jtts, ttts, ref, _ = make_pair(tmp_path_factory.mktemp("beam"), mp,
                                   decode_quant="none")
    yield jtts, ttts, ref
    mp.undo()


def test_inference_beam_matches_jax(pair, monkeypatch):
    """``inference(beam_width=2, length_penalty=2.0)``, greedy, the default
    route (cleanup, latent pass, DDIM, BigVGAN) with the JAX package's
    diffusion noise."""
    jtts, ttts, ref = pair
    inject_jax_noise(monkeypatch, [4])
    kw = dict(max_ar_steps=40, max_diffusion_steps=3, greedy=True, seed=4,
              beam_width=2, length_penalty=2.0, repetition_penalty=1.2,
              mel_pad_multiple=128)
    jwav, _ = jtts.inference("hello world, a test.", ref, **kw)
    twav, sr = ttts.inference("hello world, a test.", ref, **kw)
    assert sr == 24000 and twav.shape == jwav.shape
    assert np.isfinite(twav).all() and np.count_nonzero(twav) > 1000
    np.testing.assert_allclose(twav, jwav, rtol=0, atol=2 / 32767)


def test_batch_inference_beam_matches_jax(pair, monkeypatch):
    """``batch_inference(beam_width=2)`` of three rows, greedy: every row's
    beams in one decode, then the batch's bucketed diffusion."""
    jtts, ttts, ref = pair
    texts, seeds = ["hello world, a test.", "a second row", "three"], \
        [31, 32, 33]
    inject_jax_noise(monkeypatch, seeds)
    kw = dict(max_ar_steps=40, max_diffusion_steps=3, greedy=True,
              seeds=seeds, beam_width=2, mel_pad_multiple=128)
    jw, _ = jtts.batch_inference(texts, ref, **kw)
    tw, sr = ttts.batch_inference(texts, ref, **kw)
    assert sr == 24000 and len(tw) == len(jw) == 3
    for a, b in zip(tw, jw):
        assert a.shape == b.shape and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=2 / 32767)
