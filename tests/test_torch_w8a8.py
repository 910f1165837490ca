"""The W8A8 decode (K8, ``decode_quant="w8a8"``) against the JAX package.

- ``quantize_rowwise``: the same int8 codes and scales, round half to
  even included.
- ``qgemv_w8a8_plain`` against ``qgemv_stacked_w8a8`` through its
  off-TPU branch (``force_xla=True``) and its Pallas kernel in interpret
  mode, at every layer index, with a stacked, a shared and no bias, with
  and without the fused LayerNorm: atol 3e-5, rtol 1e-5, as the JAX
  package's own kernel test.
- Greedy ``inference_speech(quant_mode="w8a8")`` and
  ``inference_speech_shared`` token-exact against the JAX package with
  the same ``init`` parameters.
- ``TTS`` with ``decode_quant="w8a8"`` on the CPU: every decode route
  reaches the W8A8 GEMV (counted where ``unified_voice`` imports it) and
  never the weight-only one, and a batch of 8 texts x 4 candidates (32
  decode rows) decodes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_tiny import UV, tiny_models
from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu.ops.pallas_gemv import (qgemv_stacked_w8a8,
                                              quantize_rowwise as jquant)
from tortoise_tts_tpu.ops.sampling import SamplingConfig as JSampling
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.config import Config, Inference
from tortoise_tts_tpu_torch.inference import TTS
from tortoise_tts_tpu_torch.kernels import qgemv_w8a8 as k8
from tortoise_tts_tpu_torch.models import unified_voice as uv
from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer

TOL = dict(atol=3e-5, rtol=1e-5)
STEPS = 32


def test_quantize_rowwise_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 256).astype(np.float32)
    # a row whose scale is exactly 1: halves round to even
    x[3] = 0.0
    x[3, :6] = [127.0, 2.5, -0.5, 1.5, -3.5, 0.5]
    jq, js = jquant(jnp.asarray(x))
    tq, ts = k8.quantize_rowwise(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[3, :6].tolist() == [127, 2, 0, 2, -4, 0]


def _gemv_case(seed=1, L=3, K=256, N=512, M=2):
    rng = np.random.RandomState(seed)
    w = rng.randn(L, K, N).astype(np.float32) * 0.02
    s = (np.abs(w).max(axis=1) / 127.0 + 1e-12).astype(np.float32)
    wq = np.round(w / s[:, None, :]).astype(np.int8)
    return dict(wq=wq, s=s, b2=(rng.randn(L, N) * 0.1).astype(np.float32),
                b1=(rng.randn(N) * 0.1).astype(np.float32),
                g=(1.0 + 0.1 * rng.randn(L, K)).astype(np.float32),
                be=(0.1 * rng.randn(L, K)).astype(np.float32),
                x=rng.randn(M, K).astype(np.float32))


@pytest.mark.parametrize("path", ["force_xla", "interpret"])
@pytest.mark.parametrize("bias", ["stacked", "shared", "none"])
@pytest.mark.parametrize("ln", [False, True], ids=["no_ln", "ln"])
def test_qgemv_w8a8_plain_matches_jax(path, bias, ln):
    c = _gemv_case()
    b = {"stacked": c["b2"], "shared": c["b1"], "none": None}[bias]
    t = torch.from_numpy
    for li in range(c["wq"].shape[0]):
        want = qgemv_stacked_w8a8(
            jnp.asarray(c["x"]), jnp.asarray(c["wq"]), jnp.asarray(c["s"]),
            None if b is None else jnp.asarray(b), li,
            ln=(jnp.asarray(c["g"]), jnp.asarray(c["be"])) if ln else None,
            **{path: True})
        tb = None if b is None else t(b[li] if b.ndim == 2 else b)
        got = k8.qgemv_w8a8(t(c["x"]), t(c["wq"][li]), t(c["s"][li]), tb,
                            ln=(t(c["g"][li]), t(c["be"][li])) if ln
                            else None)
        assert got.dtype == torch.float32 and got.shape == (2, 512)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_qgemv_w8a8_plain_bf16_rounds_ln_to_x_type():
    """In bf16 the LN output is rounded to bf16 before the quantizer, as
    the JAX package's off-TPU branch does: the codes are those of the
    rounded row."""
    c = _gemv_case(seed=2, L=1)
    x = torch.from_numpy(c["x"]).to(torch.bfloat16)
    ln = (torch.from_numpy(c["g"][0]), torch.from_numpy(c["be"][0]))
    wq, s = torch.from_numpy(c["wq"][0]), torch.from_numpy(c["s"][0])
    want = qgemv_stacked_w8a8(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(c["wq"]), jnp.asarray(c["s"]), None, 0,
        ln=(jnp.asarray(c["g"]), jnp.asarray(c["be"])), force_xla=True)
    got = k8.qgemv_w8a8(x, wq, s, ln=ln)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)
    xn = k8.ln_f32(x.float(), *ln).to(torch.bfloat16)
    q_rounded, _ = k8.quantize_rowwise(xn)
    q_direct, _ = k8.quantize_rowwise(k8.ln_f32(x.float(), *ln))
    y_rounded = k8.qgemv_w8a8_plain(xn, wq, s)
    torch.testing.assert_close(got, y_rounded, atol=0, rtol=0)
    assert not torch.equal(q_rounded, q_direct)   # the rounding matters


@pytest.fixture(scope="module")
def uv_pair():
    cfg = dict(UV, max_text_tokens=40, max_mel_tokens=40)
    jcfg = juv.UnifiedVoiceConfig(**cfg)
    jp = juv.init(jax.random.PRNGKey(0), jcfg)
    jp["mel_head"]["w"] = jp["mel_head"]["w"] * 8.0
    tp = bridge.unified_voice_from_jax(jax.tree_util.tree_map(np.asarray,
                                                              jp))
    return jp, jcfg, tp, uv.UnifiedVoiceConfig(**cfg)


def _prompt(seed, rows, tt=12):
    rng = np.random.RandomState(seed)
    text = rng.randint(1, 200, size=(rows, tt)).astype(np.int32)
    lengths = np.asarray([tt - 3 * i for i in range(rows)], np.int32)
    cond = rng.randn(rows, UV["model_dim"]).astype(np.float32)
    return text, lengths, cond


def test_greedy_w8a8_decode_token_exact(uv_pair):
    jp, jcfg, tp, cfg = uv_pair
    text, lengths, cond = _prompt(0, 2)
    want = juv.inference_speech(
        jp, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(lengths),
        jax.random.PRNGKey(0), jcfg, JSampling(greedy=True), STEPS,
        collect_latents=True, qgpt=juv.quantize_decode_weights(jp),
        quant_mode="w8a8")
    got = uv.inference_speech(
        tp, torch.from_numpy(cond), torch.from_numpy(text).long(),
        torch.from_numpy(lengths).long(), None, cfg,
        SamplingConfig(greedy=True), STEPS, collect_latents=True,
        qgpt=uv.quantize_decode_weights(tp), quant_mode="w8a8")
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert len(set(got.codes[0].tolist())) > 3     # a varied trajectory
    n = int(want.lengths.max()) + 1
    np.testing.assert_allclose(got.latents[:, :n].numpy(),
                               np.asarray(want.latents)[:, :n],
                               atol=1e-4, rtol=1e-4)
    # the W8A8 decode differs from the weight-only one
    int8 = uv.inference_speech(
        tp, torch.from_numpy(cond), torch.from_numpy(text).long(),
        torch.from_numpy(lengths).long(), None, cfg,
        SamplingConfig(greedy=True), STEPS, collect_latents=True,
        qgpt=uv.quantize_decode_weights(tp), quant_mode="int8")
    assert not torch.equal(int8.latents, got.latents)


def test_greedy_w8a8_shared_decode_token_exact(uv_pair):
    jp, jcfg, tp, cfg = uv_pair
    text, lengths, cond = _prompt(1, 2)
    c = 3
    from tortoise_tts_tpu import inference as jinf
    want = juv.inference_speech_shared(
        jp, jnp.asarray(cond), jnp.asarray(text), jnp.asarray(lengths),
        jnp.asarray(jinf._row_keys(np.asarray([1, 2], np.uint32), 2 * c)),
        rows=c, cfg=jcfg, sampling=JSampling(greedy=True), max_length=STEPS,
        qgpt=juv.quantize_decode_weights(jp), quant_mode="w8a8")
    got = uv.inference_speech_shared(
        tp, *(torch.from_numpy(x) for x in (cond, text, lengths)), None, c,
        cfg, SamplingConfig(greedy=True), STEPS,
        qgpt=uv.quantize_decode_weights(tp), quant_mode="w8a8")
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))


def test_decode_refuses_unknown_quant_mode(uv_pair):
    _, _, tp, cfg = uv_pair
    text, lengths, cond = (torch.from_numpy(x) for x in _prompt(2, 1))
    with pytest.raises(ValueError, match="int8\\|w8a8"):
        uv.inference_speech(tp, cond, text.long(), lengths.long(), None, cfg,
                            SamplingConfig(greedy=True), 4,
                            qgpt=uv.quantize_decode_weights(tp),
                            quant_mode="fp8")
    with pytest.raises(ValueError, match="none\\|int8\\|w8a8"):
        Inference(decode_quant="W8A8")


@pytest.fixture
def tiny_tts(tmp_path, monkeypatch):
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER",
                       str(write_char_tokenizer(tmp_path / "tok.json")))
    tts = TTS(Config(inference=Inference(weight_dtype="float32",
                                         text_buckets=(32, 64),
                                         decode_quant="w8a8")),
              device="cpu", dtype="float32")
    tts._models = tiny_models()
    calls = {"qgemv_w8a8": [], "qgemv": []}
    for name in calls:
        fn = getattr(uv, name)

        def counted(x, *a, _fn=fn, _rows=calls[name], **kw):
            _rows.append(x.shape[0])
            return _fn(x, *a, **kw)
        monkeypatch.setattr(uv, name, counted)
    return tts, calls


def test_tts_w8a8_routes_reach_k8(tiny_tts):
    """inference (BigVGAN and HiFiGAN), stream, batch_inference and
    candidates, voiceless and sampled: four W8A8 GEMVs per layer and
    token, no weight-only GEMV.  Switching the config to int8 as the CLI
    does reuses the cached decode weights and reaches K2 instead."""
    tts, calls = tiny_tts
    layers = UV["layers"]
    kw = dict(max_ar_steps=16, seed=4)
    routes = {
        "bigvgan": lambda: tts.inference("hello there", max_diffusion_steps=2,
                                         **kw)[0],
        "hifigan": lambda: tts.inference("hello there",
                                         vocoder_type="hifigan", **kw)[0],
        "stream": lambda: np.concatenate(list(tts.stream("hello there",
                                                         **kw))),
        "batch": lambda: np.concatenate(tts.batch_inference(
            ["hello there", "a second row"], max_diffusion_steps=2,
            **kw)[0]),
        "candidates": lambda: tts.inference("hello there", candidates=3,
                                            max_diffusion_steps=2, **kw)[0],
    }
    for name, run in routes.items():
        calls["qgemv_w8a8"].clear()
        wav = run()
        assert wav.dtype == np.float32 and wav.size > 0, name
        assert np.isfinite(wav).all() and np.abs(wav).mean() > 1e-5, name
        n = len(calls["qgemv_w8a8"])
        assert n > 0 and n % (4 * layers) == 0, (name, n)
        assert not calls["qgemv"], name
    assert set(calls["qgemv_w8a8"]) == {3}     # the candidates' rows
    qgpt = tts._ar_qgpt()
    tts.cfg = dataclasses.replace(tts.cfg, inference=dataclasses.replace(
        tts.cfg.inference, decode_quant="int8"))
    assert tts._ar_qgpt() is qgpt and tts._quant_mode == "int8"
    calls["qgemv_w8a8"].clear()
    tts.inference("hello there", vocoder_type="hifigan", **kw)
    assert calls["qgemv"] and not calls["qgemv_w8a8"]


def test_tts_w8a8_batch_of_32_decode_rows(tiny_tts):
    """8 texts x 4 candidates decode as 32 rows at once (K2 and K8 took at
    most 16 rows on the card before this slice)."""
    tts, calls = tiny_tts
    texts = [f"row number {i}" for i in range(8)]
    wavs, sr = tts.batch_inference(texts, candidates=4, max_ar_steps=8,
                                   max_diffusion_steps=2, seed=7,
                                   row_buckets=False)
    assert sr == 24000 and len(wavs) == 8
    assert all(np.isfinite(w).all() and w.size > 0 for w in wavs)
    assert set(calls["qgemv_w8a8"]) == {32}
    assert len(calls["qgemv_w8a8"]) % (4 * UV["layers"]) == 0
