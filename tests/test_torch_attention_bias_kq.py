"""K9a and K9b, the denoiser's transposed-score and split/fused biased
attention, against the JAX package on the CPU in fp32.

On the CPU the wrappers run their plain versions, which must match the
JAX Pallas kernels in interpret mode at the JAX tests' own tolerances
(``tests/test_pallas_attention.py``): K9a (``flash_attention_bias_qkv_kq``),
K9b's split entry (``flash_attention_bias_cm``) and its fused entry
(``flash_attention_bias_qkv``).  ``qkv_attention`` must route as the JAX
package routes (``ops/attention.py:85-119``), the transposed rel-pos
build must be the transpose of the plain one, the tiny denoiser must
match the JAX ``forward`` in each mode, and a tiny ``TTS.inference``
under ``denoise_attention="kq"`` and ``"flash_bias"`` must match the JAX
``TTS`` default run (its switches are TPU-only; the math is the same)
within two 16-bit steps.  The CUDA kernels are held against their plain
versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu import inference as jinf
from tortoise_tts_tpu.config import Config as JConfig, Inference as JInference
from tortoise_tts_tpu.inference import TTS as JTTS
from tortoise_tts_tpu.models import (LoadedModel as JLoaded,
                                     bigvgan as jbv, diffusion as jdiff,
                                     unified_voice as juv)
from tortoise_tts_tpu.ops.attention import qkv_attention as jax_qkv_attention
from tortoise_tts_tpu.ops.pallas_attention import (
    flash_attention_bias_cm as jax_bias_cm,
    flash_attention_bias_qkv as jax_bias_qkv,
    flash_attention_bias_qkv_kq as jax_bias_kq)
from tests.torch_tiny import one_torch_thread  # noqa: F401
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch import inference as tinf
from tortoise_tts_tpu_torch.config import Config, Inference
from tortoise_tts_tpu_torch.inference import TTS
from tortoise_tts_tpu_torch.kernels import flash_attention_bias as k6
from tortoise_tts_tpu_torch.kernels import flash_attention_bias_cm as k9b
from tortoise_tts_tpu_torch.kernels import flash_attention_bias_kq as k9a
from tortoise_tts_tpu_torch.models import (LoadedModel, _bigvgan_random,
                                           bigvgan, diffusion, unified_voice)
from tortoise_tts_tpu_torch.ops import attention
from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer

D = 128
UV = dict(layers=2, model_dim=D, heads=2, max_text_tokens=80,
          max_mel_tokens=100)
DIFF = dict(model_channels=64, num_layers=2, in_latent_channels=D,
            num_heads=4)
BV = dict(upsample_initial_channel=64)
SHAPES = [(2, 4, 64, 300), (1, 2, 64, 513), (8, 2, 64, 300)]
# the JAX tests' tolerances for each entry (tests/test_pallas_attention.py)
TOL = {"kq": dict(atol=2e-5, rtol=1e-5), "cm": dict(atol=2e-5, rtol=1e-4),
       "qkv": dict(atol=2e-5, rtol=1e-4)}


def _inputs(seed, b, h, d, t):
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(b, h * 3 * d, t) * 0.5).astype(np.float32)
    bias = (rng.randn(h, t, t) * 0.3).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("entry", ["kq", "cm", "qkv"])
@pytest.mark.parametrize("b,h,d,t", SHAPES)
def test_plain_matches_jax_pallas_interpret(entry, b, h, d, t):
    """T=300 and 513 are no multiple of the TPU kernels' 128-lane padding:
    their padded keys are masked and the ragged end is sliced off; the
    port's plain versions (and kernels) take T as it is."""
    qkv, bias = _inputs(b + t, b, h, d, t)
    tq = torch.from_numpy(qkv)
    if entry == "kq":
        bias_t = np.ascontiguousarray(bias.transpose(0, 2, 1))
        got = k9a.flash_attention_bias_kq(tq, torch.from_numpy(bias_t), h)
        want = jax_bias_kq(jnp.asarray(qkv), jnp.asarray(bias_t), h,
                           interpret=True)
    elif entry == "cm":
        q, k, v = np.split(qkv.reshape(b, h, 3 * d, t), 3, axis=2)
        got = k9b.flash_attention_bias_cm(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in (q, k, v)),
            torch.from_numpy(bias)).reshape(b, h * d, t)
        want = jax_bias_cm(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(bias), interpret=True
                           ).reshape(b, h * d, t)
    else:
        got = k9b.flash_attention_bias_qkv(tq, torch.from_numpy(bias), h)
        want = jax_bias_qkv(jnp.asarray(qkv), jnp.asarray(bias), h,
                            interpret=True)
    got = got.numpy()
    assert got.shape == (b, h * d, t) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), **TOL[entry])


@pytest.fixture(scope="module")
def weights():
    """Tiny AR, denoiser (64 channels, 4 heads, 3 + 2 biased blocks) and
    BigVGAN weights, random from a seed by the port's inits (the JAX
    package's eager inits take half a minute), as torch trees and as the
    same arrays in JAX pytrees.  The denoiser's attention outputs are made
    non-zero (proj_out is zero-initialised), so every biased block
    contributes."""
    g = torch.Generator().manual_seed(7)
    tp = {"autoregressive": unified_voice.init(
              g, unified_voice.UnifiedVoiceConfig(**UV)),
          "diffusion": diffusion.init(g, diffusion.DiffusionConfig(**DIFF)),
          "bigvgan": _bigvgan_random(g, bigvgan.BigVGANConfig(**BV))}
    for lyr in (tp["diffusion"]["conditioning_timestep_integrator"]
                + tp["diffusion"]["layers"]):
        w = lyr["attn"]["proj_out"]["w"]
        w.copy_(0.1 * torch.randn(w.shape, generator=g))
    jp = {n: jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(p))
          for n, p in tp.items()}
    return tp, jp


@pytest.fixture
def counted(monkeypatch):
    """Swap the three biased-attention wrappers for counting ones; returns
    the list of (kernel, batch) of their calls."""
    calls = []
    for mod, name, tag in ((k9a, "flash_attention_bias_kq", "K9a"),
                           (k9b, "flash_attention_bias_qkv", "K9b"),
                           (k6, "flash_attention_bias", "K6")):
        def counting(*args, _fn=getattr(mod, name), _tag=tag):
            calls.append((_tag, args[0].shape[0]))
            return _fn(*args)
        monkeypatch.setattr(mod, name, counting)
    return calls


@pytest.mark.parametrize("mode,b,t,routed", [
    ("kq", 2, 256, "K9a"), ("kq", 8, 300, "K9a"), ("kq", 2, 255, None),
    ("flash_bias", 2, 256, "K9b"), ("flash_bias", 7, 300, "K9b"),
    ("flash_bias", 8, 256, "K6"), ("flash_bias", 2, 255, None),
    ("auto", 2, 256, None), ("auto", 8, 256, "K6")])
def test_qkv_attention_routes_like_jax(counted, mode, b, t, routed):
    """The JAX package's dispatch (ops/attention.py:85-119): a transposed
    bias at T >= 256 takes K9a at any batch and below T 256 is swapped back
    onto the plain path; a bias at T >= 256 takes K6 from batch 8 up and,
    in the flash_bias mode, K9b's fused entry below.  The output is the
    JAX package's at 1e-5 either way (its XLA path: the Pallas routes are
    TPU-only there)."""
    h = 2
    qkv, bias = _inputs(b * t, b, h, 16, t)
    tq, tb = torch.from_numpy(qkv), torch.from_numpy(bias)
    if mode == "kq":
        bias_t = np.ascontiguousarray(bias.transpose(0, 2, 1))
        got = attention.qkv_attention(tq, h, bias_kq=torch.from_numpy(bias_t))
        want = jax_qkv_attention(jnp.asarray(qkv), h,
                                 bias_kq=jnp.asarray(bias_t))
    else:
        got = attention.qkv_attention(tq, h, bias=tb,
                                      flash_bias=mode == "flash_bias")
        want = jax_qkv_attention(jnp.asarray(qkv), h, bias=jnp.asarray(bias))
    assert counted == ([(routed, b)] if routed else [])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_transposed_rel_biases_are_the_transpose(weights):
    tp, jp = (w["diffusion"] for w in weights)
    tcfg, jcfg = (diffusion.DiffusionConfig(**DIFF),
                  jdiff.DiffusionConfig(**DIFF))
    plain = diffusion.precompute_rel_biases(tp, 45, tcfg, torch.float32)
    kq = diffusion.precompute_rel_biases(tp, 45, tcfg, torch.float32,
                                         transposed=True)
    want = jdiff.precompute_rel_biases(jp, 45, jcfg, jnp.float32,
                                       transposed=True)
    assert (plain["kq"], kq["kq"], kq["flash_bias"]) == (False, True, False)
    for part in ("integrator", "layers"):
        for p_, k_, w_ in zip(plain[part], kq[part], want[part]):
            assert k_.is_contiguous() and k_.shape == (4, 45, 45)
            assert torch.equal(k_, p_.transpose(1, 2))
            np.testing.assert_array_equal(k_.numpy(), np.asarray(w_))
    fb = diffusion.precompute_rel_biases(tp, 45, tcfg, flash_bias=True)
    assert fb["flash_bias"] and not fb["kq"]
    for p_, f_ in zip(plain["layers"], fb["layers"]):
        assert torch.equal(p_, f_)
    with pytest.raises(ValueError, match="one"):
        diffusion.precompute_rel_biases(tp, 45, tcfg, transposed=True,
                                        flash_bias=True)


@pytest.mark.parametrize("mode", ["kq", "flash_bias"])
def test_forward_matches_jax_at_t_256_up(weights, monkeypatch, counted,
                                         mode):
    """The tiny denoiser (64 channels, 4 heads, 3 + 2 biased blocks) at a
    ragged T=260 with its biases built for ``mode``: every biased block
    takes the mode's kernel.  The JAX side runs its transposed build
    through its Pallas kernel in interpret mode (``TTS_FLASH_KQ_INTERPRET``)
    for "kq", and its default path for "flash_bias" (its K9b route is
    TPU-only)."""
    monkeypatch.setenv("TTS_FLASH_KQ_INTERPRET", "1")
    tp, jp = (w["diffusion"] for w in weights)
    tcfg, jcfg = (diffusion.DiffusionConfig(**DIFF),
                  jdiff.DiffusionConfig(**DIFF))
    rng = np.random.RandomState(11)
    t = 260
    x = rng.randn(2, 100, t).astype(np.float32)
    code = rng.randn(2, 64, t).astype(np.float32)
    ts = np.array([3, 2500], np.int32)
    kq = mode == "kq"
    got = diffusion.forward(
        tp, torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(code),
        tcfg, diffusion.precompute_rel_biases(tp, t, tcfg, transposed=kq,
                                              flash_bias=not kq))
    want = jdiff.forward(jp, jnp.asarray(x), jnp.asarray(ts),
                         jnp.asarray(code), jcfg,
                         jdiff.precompute_rel_biases(jp, t, jcfg,
                                                     transposed=kq))
    assert counted == [("K9a" if kq else "K9b", 2)] * 5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_denoise_attention_is_validated(tmp_path):
    with pytest.raises(ValueError, match="denoise_attention"):
        Inference(denoise_attention="x")
    assert Inference().denoise_attention == "auto"
    path = tmp_path / "c.yaml"
    path.write_text("inference:\n  denoise_attention: kq\n")
    assert Config.load(path).inference.denoise_attention == "kq"


# ---------------------------------------------------------------------------
# TTS.inference in each mode against the JAX TTS default run
# ---------------------------------------------------------------------------

STEPS = 64           # 64 budget latents -> 278 mel frames, padded to 384
TEXT = "hello world, this is a test."
KW = dict(max_ar_steps=STEPS, max_diffusion_steps=4, greedy=True, seed=3,
          diffusion_pad_multiple=32, mel_pad_multiple=128)


@pytest.fixture(scope="module")
def tts_pair(tmp_path_factory, weights):
    """The port's TTS on the tiny weights, explicit conditioning latents
    (they keep the reference encoders out) and the JAX TTS default run's
    wav on the same weights and latents."""
    tp, jp = weights
    mp = pytest.MonkeyPatch()
    mp.setenv("TORTOISE_TPU_TOKENIZER", str(write_char_tokenizer(
        tmp_path_factory.mktemp("kq") / "tokenizer.json")))
    cfgs = {"autoregressive": (juv.UnifiedVoiceConfig(**UV),
                               unified_voice.UnifiedVoiceConfig(**UV)),
            "diffusion": (jdiff.DiffusionConfig(**DIFF),
                          diffusion.DiffusionConfig(**DIFF)),
            "bigvgan": (jbv.BigVGANConfig(**BV), bigvgan.BigVGANConfig(**BV))}
    jmods = {"autoregressive": juv, "diffusion": jdiff, "bigvgan": jbv}
    tmods = {"autoregressive": unified_voice, "diffusion": diffusion,
             "bigvgan": bigvgan}
    jtts = JTTS(config=JConfig(inference=JInference(
        weight_dtype="float32", text_buckets=(32, 80))), dtype="float32")
    jtts._models = {n: JLoaded(n, jmods[n], cfgs[n][0], jp[n], False)
                    for n in jmods}
    ttts = TTS(Config(inference=Inference(weight_dtype="float32",
                                          text_buckets=(32, 80))),
               device="cpu", dtype="float32")
    ttts._models = {n: LoadedModel(n, tmods[n], cfgs[n][1], tp[n], False)
                    for n in tmods}
    rng = np.random.RandomState(5)
    latents = (rng.randn(1, D).astype(np.float32),
               rng.randn(1, 2 * DIFF["model_channels"]).astype(np.float32))
    jwav, _ = jtts.inference(TEXT, conditioning_latents=latents, **KW)
    yield ttts, latents, jwav
    mp.undo()


@pytest.mark.parametrize("mode", ["kq", "flash_bias"])
def test_inference_modes_match_jax_default(tts_pair, monkeypatch, counted,
                                           mode):
    """The default route (greedy decode, DDIM-4 with cond-free guidance
    and the unconditional integrator built for the mode, BigVGAN, 16-bit
    PCM) with the JAX package's diffusion noise injected: every biased
    block at T=384 takes the mode's kernel (3 integrator blocks at B=1 and
    2 trunk blocks at B=2 per step, 3 per step for the unconditional
    integrator), K6 none, and the wav is the JAX default run's within two
    16-bit steps."""
    ttts, latents, jwav = tts_pair
    (sub,) = jinf._host_keys(KW["seed"] * 1000003, 1)
    k_diff = jinf._host_keys(jinf._key_int(sub), 3)[1]
    k_noise = jax.random.split(jnp.asarray(k_diff))[0]
    drawn = []

    def jax_noise(key, shape, device):
        drawn.append(tuple(shape))
        return torch.from_numpy(np.array(jax.random.normal(
            k_noise, shape, jnp.float32))).to(device)

    monkeypatch.setattr(tinf, "_diffusion_noise", jax_noise)
    monkeypatch.setattr(ttts, "_uncond_cache", {})
    monkeypatch.setattr(ttts, "cfg", dataclasses.replace(
        ttts.cfg, inference=dataclasses.replace(ttts.cfg.inference,
                                                denoise_attention=mode)))
    twav, sr = ttts.inference(TEXT, conditioning_latents=latents, **KW)
    assert drawn == [(1, 100, 384)] and sr == 24000
    tag = "K9a" if mode == "kq" else "K9b"
    steps = KW["max_diffusion_steps"]
    assert sorted(counted) == sorted([(tag, 1)] * (3 * steps + 3 * steps)
                                     + [(tag, 2)] * (2 * steps))
    assert list(ttts._uncond_cache) == [(steps, 384, mode)]
    assert twav.shape == jwav.shape and np.isfinite(twav).all()
    assert np.count_nonzero(twav) > 1000
    np.testing.assert_allclose(twav, jwav, rtol=0, atol=2 / 32767)
