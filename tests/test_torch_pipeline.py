"""The port's routes end to end against the JAX package's TTS, on tiny
models with the same weights: AR latent, greedy codes, the wav of the
default BigVGAN route (diffusion noise injected from the JAX package's
key) and of ``inference(..., vocoder_type="hifigan")`` and
``stream(...)``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu import inference as jinf
from tortoise_tts_tpu.config import Config as JConfig, Inference as JInference
from tortoise_tts_tpu.inference import TTS as JTTS
from tortoise_tts_tpu.models import (LoadedModel as JLoaded,
                                     _bigvgan_random as jax_bigvgan_random,
                                     _hifigan_random as jax_hifigan_random,
                                     bigvgan as jbv,
                                     diffusion as jdiff, dvae as jdvae,
                                     hifigan as jhg, unified_voice as juv)
from tortoise_tts_tpu.ops.sampling import SamplingConfig as JSampling
from tortoise_tts_tpu.utils.io import write_wav
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch import inference as tinf
from tortoise_tts_tpu_torch.config import Config, Inference
from tortoise_tts_tpu_torch.inference import TTS
from tortoise_tts_tpu_torch.models import (LoadedModel, _univnet_random,
                                           bigvgan, diffusion, hifigan,
                                           unified_voice, univnet)
from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer

D = 128
UV = dict(layers=2, model_dim=D, heads=2, max_text_tokens=80,
          max_mel_tokens=140)
HG = dict(in_channels=D, upsample_initial_channel=64, cond_channels=D)
DIFF = dict(model_channels=64, num_layers=2, in_latent_channels=D,
            num_heads=4)
BV = dict(upsample_initial_channel=64)
STEPS = 130          # three stream chunks: 60, 40, 30
TEXT = "hello world, this is a test."


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    tok = write_char_tokenizer(tmp / "tokenizer.json")
    mp = pytest.MonkeyPatch()
    mp.setenv("TORTOISE_TPU_TOKENIZER", str(tok))
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    jcfg = juv.UnifiedVoiceConfig(**UV)
    jar = juv.init(ks[0], jcfg)
    jhcfg = jhg.HifiganConfig(**HG)
    jvoc = jax_hifigan_random(ks[1], jhcfg)
    dcfg = jdiff.DiffusionConfig(**DIFF)
    jdp = jdiff.init(ks[2], dcfg)
    # non-zero attention outputs (proj_out is zero-initialised), so every
    # attention block of the denoiser contributes
    pk = iter(jax.random.split(ks[4], 64))
    for lyr in jdp["conditioning_timestep_integrator"] + jdp["layers"]:
        lyr["attn"]["proj_out"]["w"] = 0.1 * jax.random.normal(
            next(pk), lyr["attn"]["proj_out"]["w"].shape)
    bvcfg = jbv.BigVGANConfig(**BV)
    jbvp = jax_bigvgan_random(ks[4], bvcfg)
    dvcfg = jdvae.DVAEConfig(num_tokens=8192, codebook_dim=32, hidden_dim=32)
    jmodels = {
        "autoregressive": JLoaded("autoregressive", juv, jcfg, jar, False),
        "hifigan": JLoaded("hifigan", jhg, jhcfg, jvoc, False),
        "diffusion": JLoaded("diffusion", jdiff, dcfg, jdp, False),
        "bigvgan": JLoaded("bigvgan", jbv, bvcfg, jbvp, False),
        "dvae": JLoaded("dvae", jdvae, dvcfg, jdvae.init(ks[3], dvcfg),
                        False),
    }
    from tortoise_tts_tpu.emb import mel as jax_emb_mel
    mp.setattr(jax_emb_mel, "load_model",
               lambda name, dtype="float32": jmodels[name])
    jtts = JTTS(config=JConfig(inference=JInference(
        weight_dtype="float32", text_buckets=(32, 80))), dtype="float32")
    jtts._models = dict(jmodels)

    ttts = TTS(Config(inference=Inference(weight_dtype="float32",
                                          text_buckets=(32, 80))),
               device="cpu", dtype="float32")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    ttts._models = {
        "autoregressive": LoadedModel(
            "autoregressive", unified_voice,
            unified_voice.UnifiedVoiceConfig(**UV),
            bridge.unified_voice_from_jax(np_tree(jar)), False),
        "hifigan": LoadedModel(
            "hifigan", hifigan, hifigan.HifiganConfig(**HG),
            bridge.hifigan_from_jax(np_tree(jvoc), dtype=torch.float32),
            False),
        "diffusion": LoadedModel(
            "diffusion", diffusion, diffusion.DiffusionConfig(**DIFF),
            bridge.diffusion_from_jax(np_tree(jdp)), False),
        "bigvgan": LoadedModel(
            "bigvgan", bigvgan, bigvgan.BigVGANConfig(**BV),
            bridge.bigvgan_from_jax(np_tree(jbvp), dtype=torch.float32),
            False),
        # port-only: test_routes_not_ported_say_so runs the UnivNet route
        "vocoder": LoadedModel(
            "vocoder", univnet, univnet.UnivNetConfig(channel_size=8),
            _univnet_random(torch.Generator().manual_seed(0),
                            univnet.UnivNetConfig(channel_size=8)), False),
    }
    ref = tmp / "ref.wav"
    t = np.arange(22050) / 22050.0
    write_wav(ref, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
              22050)
    yield jtts, ttts, str(ref)
    mp.undo()


def test_ar_latent_and_codes_match_jax(pair):
    jtts, ttts, ref = pair
    jlat = np.asarray(jtts.encode_audio(ref, seed=0)["latent"][0])
    tlat = ttts.encode_audio(ref, seed=0)["latent"][0]
    np.testing.assert_allclose(tlat.numpy(), jlat, atol=1e-4, rtol=1e-4)
    toks = jtts.encode_text(TEXT)
    np.testing.assert_array_equal(ttts.encode_text(TEXT), toks)
    tokens = jtts._bucket_text(toks)[None]
    np.testing.assert_array_equal(ttts._bucket_text(ttts.encode_text(TEXT)),
                                  tokens[0])
    lengths = np.asarray([len(toks)])
    ar, tar = jtts._model("autoregressive"), ttts._model("autoregressive")
    # the int8 decode of the shipped default, from the same latent
    jres = juv.inference_speech(
        ar.params, jnp.asarray(jlat), jnp.asarray(tokens),
        jnp.asarray(lengths), jax.random.PRNGKey(0), ar.config,
        JSampling(greedy=True), STEPS, collect_latents=True,
        qgpt=jtts._ar_qgpt())
    tres = unified_voice.inference_speech(
        tar.params, torch.from_numpy(jlat.copy()), torch.from_numpy(tokens),
        torch.from_numpy(lengths), None, tar.config,
        SamplingConfig(greedy=True), STEPS, collect_latents=True,
        qgpt=ttts._ar_qgpt())
    np.testing.assert_array_equal(tres.codes.numpy(), np.asarray(jres.codes))
    np.testing.assert_array_equal(tres.lengths.numpy(),
                                  np.asarray(jres.lengths))


def test_inference_hifigan_matches_jax(pair, tmp_path):
    jtts, ttts, ref = pair
    kw = dict(max_ar_steps=STEPS, vocoder_type="hifigan", greedy=True,
              seed=0)
    jwav, jsr = jtts.inference(TEXT, ref, **kw)
    twav, tsr = ttts.inference(TEXT, ref, out_path=tmp_path / "o.wav", **kw)
    assert tsr == jsr == 24000
    assert twav.shape == jwav.shape and twav.dtype == np.float32
    assert np.isfinite(twav).all() and np.count_nonzero(twav) > 1000
    np.testing.assert_allclose(twav, jwav, atol=1e-4)
    assert (tmp_path / "o.wav").stat().st_size > 1000


def test_stream_matches_jax(pair):
    jtts, ttts, ref = pair
    kw = dict(max_ar_steps=STEPS, greedy=True, seed=0)
    jchunks = list(jtts.stream(TEXT, ref, **kw))
    tchunks = list(ttts.stream(TEXT, ref, **kw))
    assert len(tchunks) == len(jchunks) == 3
    assert [c.shape for c in tchunks] == [c.shape for c in jchunks]
    for a, b in zip(tchunks, jchunks):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("cond_free", [True, False])
def test_inference_bigvgan_matches_jax(pair, monkeypatch, cond_free):
    """The default route (decode, cleanup, latent pass, DDIM with
    cond-free guidance and the cached unconditional integrator, BigVGAN,
    16-bit PCM, calm trim), and DDIM without guidance, with greedy
    decoding and the JAX package's diffusion noise.  Tolerance: two
    steps of the 16-bit output (fp32 order differences through the
    denoiser and the vocoder move a few samples across a rounding
    edge)."""
    jtts, ttts, ref = pair
    seed = 3
    (sub,) = jinf._host_keys(seed * 1000003, 1)
    k_diff = jinf._host_keys(jinf._key_int(sub), 3)[1]
    k_noise = jax.random.split(jnp.asarray(k_diff))[0]
    drawn = []

    def jax_noise(key, shape, device):
        drawn.append(tuple(shape))
        return torch.from_numpy(np.array(jax.random.normal(
            k_noise, shape, jnp.float32))).to(device)

    monkeypatch.setattr(tinf, "_diffusion_noise", jax_noise)
    kw = dict(max_ar_steps=STEPS, max_diffusion_steps=4, greedy=True,
              seed=seed, diffusion_pad_multiple=32, mel_pad_multiple=128,
              cond_free=cond_free)
    jwav, _ = jtts.inference(TEXT, ref, **kw)
    twav, sr = ttts.inference(TEXT, ref, **kw)
    # 130 budget latents -> 565 mel frames, padded to 640
    assert drawn == [(1, 100, 640)] and sr == 24000
    assert twav.shape == jwav.shape and twav.dtype == np.float32
    assert np.isfinite(twav).all() and np.count_nonzero(twav) > 1000
    np.testing.assert_allclose(twav, jwav, rtol=0, atol=2 / 32767)
    # 16-bit PCM, as the JAX package returns it
    np.testing.assert_array_equal(np.round(twav * 32767.0), twav * 32767.0)


def test_routes_not_ported_say_so(pair):
    """The serving mesh and a training mesh still raise; the training
    routes of slice 14 are built; the classifier loads
    (tests/test_torch_classifier.py holds it against the JAX package);
    UnivNet, DPM++ and beam search, which raised before they were
    ported, now run
    (tests/test_torch_univnet.py, test_torch_dpmpp.py and
    test_torch_beam.py hold their results against the JAX package), and
    so do candidates and voiceless generation (tests/test_torch_batch.py)."""
    _, ttts, ref = pair
    for kw in (dict(vocoder_type="univnet"), dict(beam_width=2),
               dict(diffusion_sampler="dpm++")):
        wav, sr = ttts.inference(TEXT, ref, max_ar_steps=8,
                                 max_diffusion_steps=2, greedy=True, seed=1,
                                 **kw)
        assert sr == 24000 and wav.size > 0 and np.isfinite(wav).all()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttts.batch_inference([TEXT], ref, max_ar_steps=4, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TTS(Config(), mesh=object(), device="cpu")
    wavs, _ = ttts.batch_inference([TEXT], ref, max_ar_steps=8,
                                   max_diffusion_steps=2, greedy=True,
                                   beam_width=2)
    assert wavs[0].size > 0 and np.isfinite(wavs[0]).all()
    # training: a mesh of more than one device still raises; the CLVP and
    # BigVGAN engines, the optimizers beyond AdamW/Adam/SGD/Adagrad,
    # schedule-free and the melbin loader, which raised before slice 14,
    # are built now (tests/test_torch_{clvp_train,vocoder_train,optim,
    # melbin}.py hold them against the JAX package)
    from tortoise_tts_tpu_torch.config import DatasetConfig, Hyperparameters
    from tortoise_tts_tpu_torch.data import Dataset
    from tortoise_tts_tpu_torch.engine.factory import TRAINABLE, load_engines
    from tortoise_tts_tpu_torch.engine.optim import make_optimizer
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        load_engines(Config.from_dict({"trainer": {"mesh_shape": [2, 1]}}),
                     device="cpu")
    assert {"clvp", "bigvgan"} <= set(TRAINABLE)
    for opt in ("Adafactor", "Prodigy", "Muon", "DAdaptation", "Apollo",
                "apollo-mini"):
        assert make_optimizer(Hyperparameters(optimizer=opt)).name == \
            opt.lower()
    sf = make_optimizer(Hyperparameters(scheduler="schedulefree"))
    assert sf.schedule_free == Hyperparameters().learning_rate
    # no data.melbin beside the config: the Python path
    assert Dataset(Config(dataset=DatasetConfig(use_melbin=True,
                                                cache=False)),
                   ())._melbin is None
