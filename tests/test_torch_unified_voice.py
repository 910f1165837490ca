"""The port's UnifiedVoice prefill and greedy decode against the JAX
package, with the same weights carried across by the bridge: hidden
states and cache at 1e-4, codes and lengths token-exact, in fp32 and
with the int8 decode weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu.ops.sampling import SamplingConfig as JSampling
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.models import unified_voice as uv
from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig

TINY = dict(layers=2, model_dim=128, heads=2, max_text_tokens=40,
            max_mel_tokens=40)
MAX_LEN = 24
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    jcfg = juv.UnifiedVoiceConfig(**TINY)
    jp = juv.init(jax.random.PRNGKey(0), jcfg)
    # larger head weights give the greedy decode a varied trajectory
    jp["mel_head"]["w"] = jp["mel_head"]["w"] * 8.0
    npp = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, jp, uv.UnifiedVoiceConfig(**TINY), \
        bridge.unified_voice_from_jax(npp)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 200, size=(2, 12)).astype(np.int32)
    lengths = np.asarray([12, 7], np.int32)
    cond = rng.randn(2, 128).astype(np.float32)
    return text, lengths, cond


def test_prefill_matches_jax(models):
    jcfg, jp, _, tp = models
    rng = np.random.RandomState(1)
    emb = rng.randn(2, 19, 128).astype(np.float32)
    mask = np.ones((2, 19), bool)
    mask[1, 10:18] = False            # text padding of the shorter row
    jh, jc = juv._gpt_prefill(jp["gpt"], jnp.asarray(emb), 2,
                              jnp.asarray(mask), 30)
    th, tc = uv._gpt_prefill(tp["gpt"], torch.from_numpy(emb), 2,
                             torch.from_numpy(mask), 30)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), **TOL)


def _decode(models, quant, sampling_kw, chunks=(None,), stop_bias=None):
    jcfg, jp, tcfg, tp = models
    if stop_bias is not None:
        jp = dict(jp, mel_head=dict(jp["mel_head"]))
        jp["mel_head"]["b"] = jp["mel_head"]["b"].at[jcfg.stop_mel_token] \
            .add(stop_bias)
        tp = dict(tp, mel_head=dict(tp["mel_head"]))
        tp["mel_head"]["b"] = tp["mel_head"]["b"].clone()
        tp["mel_head"]["b"][tcfg.stop_mel_token] += stop_bias
    text, lengths, cond = _inputs()
    jq = juv.quantize_decode_weights(jp) if quant else None
    tq = (bridge.decode_weights_from_jax(
        jax.tree_util.tree_map(np.asarray, jq)) if quant else None)
    js = juv.decode_start(jp, jnp.asarray(cond), jnp.asarray(text),
                          jnp.asarray(lengths), jax.random.PRNGKey(0), jcfg,
                          MAX_LEN)
    ts = uv.decode_start(tp, torch.from_numpy(cond),
                         torch.from_numpy(text).long(),
                         torch.from_numpy(lengths).long(), None, tcfg,
                         MAX_LEN)
    for chunk in chunks:
        js = juv.decode_chunk(jp, js, jcfg, JSampling(**sampling_kw),
                              chunk=chunk, collect_latents=True, qgpt=jq)
        ts = uv.decode_chunk(tp, ts, tcfg, SamplingConfig(**sampling_kw),
                             chunk=chunk, collect_latents=True, qgpt=tq)
    return js, ts


def _check(js, ts):
    codes, lengths = np.asarray(js.tokens), np.asarray(js.lengths)
    np.testing.assert_array_equal(ts.tokens.numpy(), codes)
    np.testing.assert_array_equal(ts.lengths.numpy(), lengths)
    np.testing.assert_array_equal(ts.finished.numpy(), np.asarray(js.finished))
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(ts.latents[r, :n + 1].numpy(),
                                   np.asarray(js.latents)[r, :n + 1], **TOL)
    return codes, lengths


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("rep", [1.0, 1.5])
def test_greedy_decode_token_exact(models, quant, rep):
    js, ts = _decode(models, quant, dict(greedy=True, repetition_penalty=rep))
    codes, _ = _check(js, ts)
    assert len(set(codes[0].tolist())) > 3   # a varied trajectory
    assert ts.step == int(js.step) == MAX_LEN


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
def test_chunked_decode_resumes_token_exact(models, quant):
    """The streaming route's 60/40-style chunks, here 10 then 7s."""
    js, ts = _decode(models, quant, dict(greedy=True),
                     chunks=(10, 7, 7, 7))
    _check(js, ts)


def test_decode_stops_mid_sequence(models):
    """A stop bias that makes row 0 stop part-way: lengths, stop padding
    and the early exit agree with the JAX decode."""
    jcfg, jp, _, _ = models
    js, _ = _decode(models, False, dict(greedy=True))
    lat = np.asarray(js.latents)[0]
    w = np.asarray(jp["mel_head"]["w"])
    logits = lat @ w + np.asarray(jp["mel_head"]["b"])
    gap = logits.max(-1) - logits[:, jcfg.stop_mel_token]
    # the first step whose gap undercuts every earlier one
    j = next(i for i in range(3, MAX_LEN) if gap[i] < gap[:i].min())
    bias = 0.5 * (gap[j] + gap[:j].min())
    js, ts = _decode(models, False, dict(greedy=True), stop_bias=bias)
    _, lengths = _check(js, ts)
    assert lengths[0] == j
    assert (ts.tokens[0, j:] == uv.UnifiedVoiceConfig().stop_mel_token).all()


def test_all_rows_stopped_exits_early(models):
    js, ts = _decode(models, True, dict(greedy=True), stop_bias=1e4)
    _check(js, ts)
    assert ts.lengths.tolist() == [0, 0]
    assert ts.step <= uv.SYNC_EVERY < MAX_LEN


def test_sampled_decode_replays_per_row_generators(models):
    """Sampled decoding: row r's tokens depend only on its generator."""
    _, _, tcfg, tp = models
    text, lengths, cond = _inputs()
    sampling = SamplingConfig(temperature=0.9, top_k=50, top_p=0.9,
                              repetition_penalty=1.2)

    def run(seeds, rows):
        gens = [torch.Generator().manual_seed(s) for s in seeds]
        return uv.inference_speech(
            tp, torch.from_numpy(cond[rows]),
            torch.from_numpy(text[rows]).long(),
            torch.from_numpy(lengths[rows]).long(), gens, tcfg, sampling,
            MAX_LEN).codes

    both = run([11, 12], [0, 1])
    np.testing.assert_array_equal(both[1].numpy(), run([12], [1])[0].numpy())
    np.testing.assert_array_equal(both.numpy(), run([11, 12], [0, 1]).numpy())


def test_latent_pass_matches_jax(models):
    """``forward(..., return_latent=True)``, the latent pass of the
    default route: trunk attention through K1's plain version."""
    jcfg, jp, tcfg, tp = models
    text, lengths, cond = _inputs(2)
    codes = np.random.RandomState(3).randint(0, 8192, (2, 15))
    wav_lengths = np.asarray([15, 9]) * jcfg.mel_length_compression
    want = juv.forward(jp, jnp.asarray(cond), jnp.asarray(text),
                       jnp.asarray(lengths), jnp.asarray(codes),
                       jnp.asarray(wav_lengths), jcfg, return_latent=True)
    got = uv.forward(tp, torch.from_numpy(cond),
                     torch.from_numpy(text).long(),
                     torch.from_numpy(lengths).long(),
                     torch.from_numpy(codes), torch.from_numpy(wav_lengths),
                     tcfg)
    assert got.shape == (2, 15, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
