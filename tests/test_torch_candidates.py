"""The candidate route's modules against the JAX package: CLVP scores,
K3's shared-prefix form, the shared-prefix decode, the on-device rerank
and the random latent converter of voiceless generation.

The shared-prefix decode must be a pure layout change: token for token
the fan-out decode of the repeated rows with the same per-row generators
(sampled, as ``tests/test_decode_shared_prefix.py`` pins it for the JAX
package), and greedy the JAX package's ``inference_speech_shared``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu import inference as jinf
from tortoise_tts_tpu.models import clvp as jclvp
from tortoise_tts_tpu.models import rlg as jrlg
from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu.ops.sampling import SamplingConfig as JSampling
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch import inference as tinf
from tortoise_tts_tpu_torch.kernels import flash_decode as k3
from tortoise_tts_tpu_torch.models import clvp, rlg, unified_voice as uv
from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig

TOL = dict(atol=1e-5, rtol=1e-5)
UV = dict(layers=2, model_dim=64, heads=4, max_text_tokens=40,
          max_mel_tokens=80)
CL = dict(dim_text=32, dim_speech=32, dim_latent=32, text_enc_depth=2,
          speech_enc_depth=2, text_heads=2, speech_heads=2, dim_head=16,
          rotary_dim=16)
STEPS = 40


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: tuple(np.shape(x)), tree)


@pytest.fixture(scope="module")
def uv_pair():
    jcfg = juv.UnifiedVoiceConfig(**UV)
    jp = juv.init(jax.random.PRNGKey(0), jcfg)
    return jp, jcfg, bridge.unified_voice_from_jax(_np(jp)), \
        uv.UnifiedVoiceConfig(**UV)


@pytest.fixture(scope="module")
def clvp_pair():
    jcfg = jclvp.CLVPConfig(**CL)
    jp = jclvp.init(jax.random.PRNGKey(1), jcfg)
    return jp, jcfg, bridge.clvp_from_jax(_np(jp)), clvp.CLVPConfig(**CL)


def test_clvp_forward_matches_jax(clvp_pair):
    jp, jcfg, tp, tcfg = clvp_pair
    rng = np.random.RandomState(0)
    text = rng.randint(0, 256, (3, 12))
    speech = rng.randint(0, 8192, (3, 30))
    tmask = np.ones((3, 12), bool)
    tmask[1, 7:] = False
    for kw in ({}, {"text_mask": tmask}):
        got = clvp.forward(tp, torch.from_numpy(text),
                           torch.from_numpy(speech), tcfg,
                           **{k: torch.from_numpy(v) for k, v in kw.items()})
        want = jclvp.forward(jp, jnp.asarray(text), jnp.asarray(speech), jcfg,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port's own init has the JAX structure leaf for leaf
    own = bridge.to_numpy(clvp.init(torch.Generator().manual_seed(0), tcfg))
    assert _shapes(own) == _shapes(_np(jp))


def test_rlg_forward_matches_jax():
    jp = jrlg.init(jax.random.PRNGKey(2), 48)
    tp = bridge.rlg_from_jax(_np(jp))
    noise = np.random.RandomState(3).randn(2, 48).astype(np.float32)
    got = rlg.forward(tp, torch.from_numpy(noise)).numpy()
    want = np.asarray(jrlg.forward(jp, jnp.asarray(noise)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    assert got.dtype == np.float32
    own = rlg.init(torch.Generator().manual_seed(0), 48)
    assert [tuple(p["w"].shape) for p in own["equal_linears"]] == \
        [np.shape(p["w"]) for p in jp["equal_linears"]]


@pytest.mark.parametrize("g,c,pos", [(1, 4, 0), (2, 3, 17), (2, 2, 39)])
def test_flash_decode_shared_plain_matches_jax(g, c, pos):
    """K3's shared form against the JAX package's ``_mha_shared``, grouped
    and single-group, with text-padding holes in the prefix."""
    rng = np.random.RandomState(pos)
    b, h, dh, sp, sd = g * c, 4, 64, 23, 40
    q = rng.randn(b, h, dh).astype(np.float32)
    kp, vp = (rng.randn(g, h, sp, dh).astype(np.float32) for _ in range(2))
    kd, vd = (rng.randn(b, h, sd, dh).astype(np.float32) for _ in range(2))
    pmask = rng.rand(g, sp) > 0.3
    pmask[:, 0] = True
    t = torch.from_numpy
    got = k3.flash_decode_shared(t(q), t(kp), t(vp), t(pmask), t(kd), t(vd),
                                 pos).numpy()
    valid = np.concatenate([pmask, np.broadcast_to(np.arange(sd) <= pos,
                                                   (g, sd))], axis=1)
    if g == 1:
        want = juv._mha_shared(jnp.asarray(q)[:, :, None], jnp.asarray(kp[0]),
                               jnp.asarray(vp[0]), jnp.asarray(kd),
                               jnp.asarray(vd),
                               jnp.asarray(valid)[:, None, None, :], False)
    else:
        want = juv._mha_shared(jnp.asarray(q)[:, :, None], jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(kd),
                               jnp.asarray(vd),
                               jnp.asarray(valid)[:, None, None, None, :],
                               False)
    np.testing.assert_allclose(got, np.asarray(want)[:, :, 0], **TOL)


def _prompt(seed, g, tt=10):
    rng = np.random.RandomState(seed)
    text = rng.randint(3, 255, (g, tt))
    cond = rng.randn(g, UV["model_dim"]).astype(np.float32)
    lengths = np.asarray([tt - 2 * i for i in range(g)])
    return cond, text, lengths


def _gens(n, base=100):
    return [torch.Generator().manual_seed(base + i) for i in range(n)]


@pytest.mark.parametrize("quant", [False, True])
def test_shared_prefix_matches_fanout_sampled(uv_pair, quant):
    """G=2 texts x C=3 candidates, sampled with a repetition penalty: the
    shared-prefix decode and the decode of the six repeated rows, each
    row drawing from a generator of the same seed, give the same tokens,
    lengths and latents."""
    _, _, tp, cfg = uv_pair
    q = uv.quantize_decode_weights(tp) if quant else None
    cond, text, lengths = (torch.from_numpy(x) for x in _prompt(8, 2))
    samp = SamplingConfig(temperature=0.8, top_p=0.9, repetition_penalty=2.0)
    c = 3
    ref = uv.inference_speech(
        tp, cond.repeat_interleave(c, 0), text.repeat_interleave(c, 0),
        lengths.repeat_interleave(c, 0), _gens(6), cfg, samp, STEPS,
        collect_latents=True, qgpt=q)
    got = uv.inference_speech_shared(tp, cond, text, lengths, _gens(6), c,
                                     cfg, samp, STEPS, collect_latents=True,
                                     qgpt=q)
    np.testing.assert_array_equal(got.codes.numpy(), ref.codes.numpy())
    np.testing.assert_array_equal(got.lengths.numpy(), ref.lengths.numpy())
    np.testing.assert_allclose(got.latents.numpy(), ref.latents.numpy(),
                               atol=1e-5)
    assert len(set(map(tuple, got.codes[:, :8].tolist()))) > 1


@pytest.mark.parametrize("quant", [False, True])
def test_shared_prefix_greedy_matches_jax(uv_pair, quant):
    jp, jcfg, tp, cfg = uv_pair
    cond, text, lengths = _prompt(9, 2)
    c = 2
    jq = juv.quantize_decode_weights(jp) if quant else None
    want = juv.inference_speech_shared(
        jp, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(lengths),
        jnp.asarray(jinf._row_keys(np.asarray([1, 2], np.uint32), 2 * c)),
        rows=c, cfg=jcfg, sampling=JSampling(greedy=True), max_length=STEPS,
        qgpt=jq, quant_mode="int8")
    got = uv.inference_speech_shared(
        tp, *(torch.from_numpy(x) for x in (cond, text, lengths)), None, c,
        cfg, SamplingConfig(greedy=True), STEPS,
        qgpt=uv.quantize_decode_weights(tp) if quant else None)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


def test_shared_prefix_needs_one_generator_per_row(uv_pair):
    """The JAX package takes explicit per-row keys without checking their
    count (unified_voice.py:893-894); the port raises."""
    _, _, tp, cfg = uv_pair
    cond, text, lengths = (torch.from_numpy(x) for x in _prompt(2, 2))
    with pytest.raises(ValueError, match="4 generators for 6 decode rows"):
        uv.decode_start(tp, cond, text, lengths, _gens(4), cfg, 16,
                        shared_rows=3)
    state, prefix = uv.decode_start(tp, cond, text, lengths, _gens(6), cfg,
                                    16, shared_rows=3)
    assert state.tokens.shape == (6, 16)
    assert prefix.k.shape == (UV["layers"], 2, UV["heads"], 1 + 10 + 3,
                              UV["model_dim"] // UV["heads"])
    assert state.cache.k.shape[3] == 16


def test_rerank_latents_matches_jax(uv_pair, clvp_pair):
    """Injected codes (two groups of three candidates, some stopped early,
    one with a calm run): the same winners, trim points and latents."""
    jp, jcfg, tp, cfg = uv_pair
    jcp, jccfg, tcp, tccfg = clvp_pair
    cond, text, lengths = _prompt(5, 6)
    rng = np.random.RandomState(6)
    codes = rng.randint(0, 8192, (6, STEPS))
    lens = np.full(6, STEPS)
    codes[1, 20:], lens[1] = cfg.stop_mel_token, 20
    codes[4, 25:], lens[4] = cfg.stop_mel_token, 25
    codes[3, 5:16] = tinf.CALM_TOKEN
    want = jinf._jit_rerank_latents(
        jp, jcp, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(lengths),
        jnp.asarray(codes), jnp.asarray(lens), jcfg, jccfg, ncand=3)
    got = tinf._rerank_latents(
        tp, tcp, *(torch.from_numpy(x) for x in (cond, text, lengths, codes,
                                                  lens)),
        cfg, tccfg, ncand=3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    # padding rows never win
    pad = tinf._rerank_latents(
        tp, tcp, *(torch.from_numpy(x) for x in (cond, text, lengths, codes,
                                                  lens)),
        cfg, tccfg, n_real=2)[2]
    assert int(pad[0]) < 2
