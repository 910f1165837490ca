"""The port's audio and text front end against the JAX package: mel,
resampling, the tokenizer and the AR conditioning encoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.emb import mel as jax_mel
from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu.ops import stft as jax_stft
from tortoise_tts_tpu.tokenizer import VoiceBpeTokenizer as JaxTokenizer
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.emb import mel as port_mel
from tortoise_tts_tpu_torch.models import unified_voice as uv
from tortoise_tts_tpu_torch.models.arch import attention_block
from tortoise_tts_tpu_torch.ops import stft
from tortoise_tts_tpu_torch.tokenizer import (VoiceBpeTokenizer,
                                              write_char_tokenizer)

TINY = dict(layers=2, model_dim=128, heads=2, max_text_tokens=40,
            max_mel_tokens=32)


def _wav(n, seed=0, sr=22050):
    """A sine plus broadband noise: every STFT bin carries energy."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * rng.randn(n)).astype(np.float32)


def test_mel_ar_matches_jax():
    wav = _wav(30000)[None]
    got = stft.mel_ar(torch.from_numpy(wav)).numpy()
    want = np.asarray(jax_stft.mel_ar(jnp.asarray(wav)))
    assert got.shape == want.shape == (1, 80, 30000 // 256 + 1)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("sr_in,sr_out", [(24000, 22050), (22050, 24000),
                                          (44100, 22050)])
def test_resample_matches_jax(sr_in, sr_out):
    wav = _wav(20000, seed=1, sr=sr_in)[None]
    got = stft.resample(torch.from_numpy(wav), sr_in, sr_out).numpy()
    want = np.asarray(jax_stft.resample(jnp.asarray(wav), sr_in, sr_out))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("text", [
    "Hello world, this is the tokenizer.",
    "Mr. Smith paid $3.50 on the 2nd of May, 1999!",
    "then... in the (other) room: 12,000 people?"])
def test_tokenizer_matches_jax(text, tmp_path, monkeypatch):
    path = write_char_tokenizer(tmp_path / "tokenizer.json")
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER", str(path))
    got = VoiceBpeTokenizer().encode(text)
    assert got == JaxTokenizer().encode(text)
    assert got and max(got) < 255


@pytest.fixture(scope="module")
def tiny_uv():
    cfg = juv.UnifiedVoiceConfig(**TINY)
    jp = juv.init(jax.random.PRNGKey(0), cfg)
    # non-zero attention outputs, so every block contributes
    for a in jp["conditioning_encoder"]["attn"]:
        a["proj_out"]["w"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(1), a["proj_out"]["w"].shape)
    tp = bridge.unified_voice_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return cfg, jp, uv.UnifiedVoiceConfig(**TINY), tp


def test_attention_block_matches_jax(tiny_uv):
    from tortoise_tts_tpu.models.arch import attention_block as jax_block
    _, jp, _, tp = tiny_uv
    x = np.random.RandomState(2).randn(2, 128, 37).astype(np.float32)
    pj = jp["conditioning_encoder"]["attn"][0]
    pt = tp["conditioning_encoder"]["attn"][0]
    got = attention_block(pt, torch.from_numpy(x), 2).numpy()
    want = np.asarray(jax_block(pj, jnp.asarray(x), 2))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_get_conditioning_matches_jax(tiny_uv):
    jcfg, jp, tcfg, tp = tiny_uv
    mels = np.random.RandomState(3).randn(1, 2, 80, 120).astype(np.float32)
    got = uv.get_conditioning(tp, torch.from_numpy(mels), tcfg).numpy()
    want = np.asarray(juv.get_conditioning(jp, jnp.asarray(mels), jcfg))
    assert got.shape == (1, 128)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_ar_conditioning_crop_and_latent_match_jax(tiny_uv):
    """The random 132300-sample crop draws from the same numpy RandomState
    and the AR latent of the cropped mel agrees."""
    jcfg, jp, tcfg, tp = tiny_uv
    wav22 = _wav(port_mel.AR_COND_SAMPLES + 5000, seed=4)[None]
    got = port_mel.format_autoregressive_conditioning(
        torch.from_numpy(wav22), rng=np.random.RandomState(7))
    want = jax_mel.format_autoregressive_conditioning(
        wav22, rng=np.random.RandomState(7))
    assert got.shape == want.shape == (1, 80, 517)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    lat = uv.get_conditioning(tp, got[:, None], tcfg).numpy()
    jlat = np.asarray(juv.get_conditioning(jp, want[:, None], jcfg))
    np.testing.assert_allclose(lat, jlat, atol=1e-4, rtol=1e-4)


def test_mel_diffusion_and_tacotron_norms_match_jax():
    wav24 = np.clip(_wav(30000, seed=5, sr=24000) * 3, -1.5, 1.5)[None]
    got = stft.mel_diffusion(torch.from_numpy(wav24))
    want = np.asarray(jax_stft.mel_diffusion(jnp.asarray(wav24)))
    assert got.shape == want.shape == (1, 100, 30000 // 256 + 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    norm = stft.normalize_tacotron_mel(got)
    np.testing.assert_allclose(
        norm.numpy(), np.asarray(jax_stft.normalize_tacotron_mel(want)),
        atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(stft.denormalize_tacotron_mel(norm).numpy(),
                               got.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("n", [30000, 100000])
def test_diffusion_conditioning_matches_jax(n):
    """Pad (short clip) and truncate (long clip) to 102400 samples at
    24 kHz, then the 100-bin mel."""
    wav22 = _wav(n, seed=6)[None]
    got = port_mel.format_diffusion_conditioning(torch.from_numpy(wav22))
    want = np.asarray(jax_mel.format_diffusion_conditioning(wav22))
    assert got.shape == want.shape == (1, 100, 401)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_encode_and_load_model_need_cuda_or_explicit_cpu(monkeypatch):
    from tortoise_tts_tpu_torch.models import load_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model("hifigan")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_mel.encode(_wav(2000), 22050)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_mel.encode_from_files(["unused.wav"])
    assert load_model("hifigan", device="cpu").params["conv_pre"]["w"] \
        .device.type == "cpu"
