"""``TTS.batch_inference`` and the single call's candidates and voiceless
routes, on tiny models.

Against the JAX package with the same weights: a greedy batch of four
rows with one reference voice, the JAX package's per-row diffusion noise
injected through ``inference._diffusion_noise``, bucketed by row length
and as one shared-max dispatch; each row's wav within two 16-bit steps.
Within the port (sampled, so no JAX comparison): the replay contract,
batch row r is ``inference(texts[r], seed=seeds[r])``, for voiceless rows
and for candidate rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu import inference as jinf
from tortoise_tts_tpu.config import Config as JConfig, Inference as JInference
from tortoise_tts_tpu.inference import TTS as JTTS
from tortoise_tts_tpu.models import (LoadedModel as JLoaded, bigvgan as jbv,
                                     clvp as jclvp, diffusion as jdiff,
                                     dvae as jdvae, rlg as jrlg,
                                     unified_voice as juv)
from tortoise_tts_tpu.utils.io import write_wav
from tests.torch_tiny import one_torch_thread  # noqa: F401
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch import inference as tinf
from tortoise_tts_tpu_torch.config import Config, Inference
from tortoise_tts_tpu_torch.inference import TTS
from tortoise_tts_tpu_torch.models import (LoadedModel, _bigvgan_random,
                                           _univnet_random, bigvgan, clvp,
                                           diffusion, rlg, unified_voice,
                                           univnet)
from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer

D = 64
UV = dict(layers=2, model_dim=D, heads=4, max_text_tokens=40,
          max_mel_tokens=80)
DIFF = dict(model_channels=32, num_layers=2, in_latent_channels=D,
            num_heads=2)
BV = dict(upsample_initial_channel=64)
CL = dict(dim_text=32, dim_speech=32, dim_latent=32, text_enc_depth=1,
          speech_enc_depth=1, text_heads=2, speech_heads=2, dim_head=16,
          rotary_dim=16)
TEXTS = ["hello world, this is a test.", "a second row", "three",
         "the fourth and last row"]
SEEDS = [11, 12, 13, 14]
STEPS = 48           # 48 latents -> 208 mel frames


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The port's tiny models, random from a seed, and the same weights
    carried to the JAX package (the JAX package's eager init of BigVGAN
    alone takes half a minute on the CPU)."""
    tmp = tmp_path_factory.mktemp("batch")
    mp = pytest.MonkeyPatch()
    mp.setenv("TORTOISE_TPU_TOKENIZER",
              str(write_char_tokenizer(tmp / "tokenizer.json")))
    g = torch.Generator().manual_seed(0)
    rd = 2 * DIFF["model_channels"]
    dparams = diffusion.init(g, diffusion.DiffusionConfig(**DIFF))
    # non-zero attention outputs, so every attention block contributes
    for lyr in dparams["conditioning_timestep_integrator"] + \
            dparams["layers"]:
        w = lyr["attn"]["proj_out"]["w"]
        w.copy_(0.1 * torch.randn(w.shape, generator=g))
    port = {
        "autoregressive": (unified_voice, juv,
                           unified_voice.UnifiedVoiceConfig(**UV),
                           juv.UnifiedVoiceConfig(**UV)),
        "diffusion": (diffusion, jdiff, diffusion.DiffusionConfig(**DIFF),
                      jdiff.DiffusionConfig(**DIFF)),
        "bigvgan": (bigvgan, jbv, bigvgan.BigVGANConfig(**BV),
                    jbv.BigVGANConfig(**BV)),
        "clvp": (clvp, jclvp, clvp.CLVPConfig(**CL), jclvp.CLVPConfig(**CL)),
        "rlg_auto": (rlg, jrlg, D, D),
        "rlg_diffuser": (rlg, jrlg, rd, rd)}
    tparams = {
        "autoregressive": unified_voice.init(g, port["autoregressive"][2]),
        "diffusion": dparams,
        "bigvgan": _bigvgan_random(g, port["bigvgan"][2]),
        "clvp": clvp.init(g, port["clvp"][2]),
        "rlg_auto": rlg.init(g, D), "rlg_diffuser": rlg.init(g, rd)}
    to_jax = lambda t: jax.tree_util.tree_map(  # noqa: E731
        jnp.asarray, bridge.to_numpy(t))
    jmodels = {n: JLoaded(n, jm, jc, to_jax(tparams[n]), False)
               for n, (_, jm, _, jc) in port.items()}
    dvcfg = jdvae.DVAEConfig(num_tokens=8192, codebook_dim=32, hidden_dim=32)
    jmodels["dvae"] = JLoaded("dvae", jdvae, dvcfg,
                              jdvae.init(jax.random.PRNGKey(0), dvcfg), False)
    from tortoise_tts_tpu.emb import mel as jax_emb_mel
    mp.setattr(jax_emb_mel, "load_model",
               lambda name, dtype="float32": jmodels[name])
    buckets = (32, 64)
    jtts = JTTS(config=JConfig(inference=JInference(
        weight_dtype="float32", text_buckets=buckets)), dtype="float32")
    jtts._models = dict(jmodels)
    ttts = TTS(Config(inference=Inference(weight_dtype="float32",
                                          text_buckets=buckets)),
               device="cpu", dtype="float32")
    ttts._models = {n: LoadedModel(n, m, c, tparams[n], False)
                    for n, (m, _, c, _) in port.items()}
    # port-only: the refusal test's UnivNet batch
    ucfg = univnet.UnivNetConfig(channel_size=8)
    ttts._models["vocoder"] = LoadedModel(
        "vocoder", univnet, ucfg,
        _univnet_random(torch.Generator().manual_seed(1), ucfg), False)
    ref = tmp / "ref.wav"
    t = np.arange(22050) / 22050.0
    write_wav(ref, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
              22050)
    yield jtts, ttts, str(ref)
    mp.undo()


def _inject_jax_noise(monkeypatch):
    """The port draws row r's x_T from a key derived from its k_diff;
    hand it the JAX package's per-row noise for the same k_diff instead
    (``_jit_diffusion``'s per-row keys: split(k_diff)[0])."""
    table = {}
    for s in SEEDS:
        k_diff = jinf._stage_keys(s)[1]
        k_port = tinf._host_keys(tinf._key_int(k_diff), 2)[0]
        table[tuple(int(x) for x in k_port)] = \
            jax.random.split(jnp.asarray(k_diff))[0]
    drawn = []

    def noise(key, shape, device):
        drawn.append(tuple(shape))
        jk = table[tuple(int(x) for x in key)]
        return torch.from_numpy(np.array(jax.random.normal(
            jk, shape[1:], jnp.float32)))[None].to(device)

    monkeypatch.setattr(tinf, "_diffusion_noise", noise)
    return drawn


@pytest.mark.parametrize("row_buckets", [True, False])
def test_batch_inference_matches_jax(pair, monkeypatch, row_buckets):
    """Four rows, one voice, greedy, DDIM-4 with cond-free guidance at
    T=256 (bucketed: the 48-latent rung) or T=384 (shared max: the budget
    rounded up to 64 latents): the trunk's cond-free batch of 8 takes K6
    in the port (its plain version here); each row within two steps of
    the 16-bit output."""
    jtts, ttts, ref = pair
    drawn = _inject_jax_noise(monkeypatch)
    kw = dict(max_ar_steps=STEPS, max_diffusion_steps=4, greedy=True,
              seeds=SEEDS, mel_pad_multiple=128, row_buckets=row_buckets)
    jw, jsr = jtts.batch_inference(TEXTS, ref, **kw)
    tw, sr = ttts.batch_inference(TEXTS, ref, **kw)
    assert sr == jsr == 24000 and len(tw) == len(jw) == 4
    t = 256 if row_buckets else 384
    assert drawn == [(1, 100, t)] * 4
    for a, b in zip(tw, jw):
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.isfinite(a).all() and np.count_nonzero(a) > 1000
        np.testing.assert_allclose(a, b, rtol=0, atol=2 / 32767)


def test_row_buckets_ladder_matches_jax_rungs():
    """The bucket ladder: rows at their rungs, small buckets promoted one
    rung when the T growth stays within 25%, 8 rows at most a dispatch."""
    t_lat = np.asarray([200, 199, 150, 60, 200, 200, 131, 200, 200, 200,
                        200, 200, 120])
    chunks = tinf._row_buckets(t_lat, 32, 128)
    rows = sorted(r for _, rs in chunks for r in rs.tolist())
    assert rows == list(range(len(t_lat)))
    assert all(len(rs) <= 8 for _, rs in chunks)
    n_of = {int(r): n for n, rs in chunks for r in rs}
    assert n_of[0] == n_of[1] == 200 and n_of[3] == 64
    assert all(n >= t for r, (n, t) in enumerate(
        (n_of[r], min(int(t_lat[r]), 200)) for r in range(len(t_lat))))


def test_batch_rows_replay_single_calls(pair):
    """Per-row seeds: every sampled row replays as the single call with
    its seed (the same decode draws, voiceless latents and diffusion
    noise), at matched geometry (row_buckets=False); a wav may differ by
    one 16-bit step where the batch's fp32 sums round a sample apart."""
    _, ttts, _ = pair
    texts = ["first row", "a second row"]
    kw = dict(max_ar_steps=24, max_diffusion_steps=3, ar_temp=0.8,
              top_p=0.95, diffusion_pad_multiple=8)
    for extra in ({}, {"candidates": 2}):
        batch, sr = ttts.batch_inference(texts, seeds=[101, 202],
                                         row_buckets=False, **kw, **extra)
        for text, s, wb in zip(texts, (101, 202), batch):
            ref, _ = ttts.inference(text, seed=s, **kw, **extra)
            assert wb.shape == ref.shape and np.isfinite(wb).all()
            np.testing.assert_allclose(wb, ref, rtol=0, atol=1.01 / 32767)


def test_batch_async_fetch_and_refusals(pair):
    _, ttts, ref = pair
    finalize, sr = ttts.batch_inference(
        ["one row", "two rows"], ref, max_ar_steps=16, max_diffusion_steps=2,
        greedy=True, seed=3, fetch="async")
    wavs = finalize()
    assert sr == 24000 and len(wavs) == 2
    assert all(w.dtype == np.float32 and w.size > 0 for w in wavs)
    # beam search and a vocoder other than BigVGAN (UnivNet, as in the
    # JAX package) raised before they were ported; they run now
    # (tests/test_torch_beam.py and test_torch_univnet.py hold them)
    for kw in (dict(beam_width=2), dict(vocoder_type="hifigan")):
        wavs, _ = ttts.batch_inference(["a", "b"], max_ar_steps=8,
                                       max_diffusion_steps=2, greedy=True,
                                       **kw)
        assert len(wavs) == 2 and all(np.isfinite(w).all() for w in wavs)
    for kw, exc, match in ((dict(mesh=object()), NotImplementedError,
                            "ROADMAP"),
                           (dict(seeds=[1]), ValueError, "seeds"),
                           (dict(voices=[None, None], references="x.wav"),
                            ValueError, "not both")):
        with pytest.raises(exc, match=match):
            ttts.batch_inference(["a", "b"], max_ar_steps=4, **kw)
    with pytest.raises(ValueError, match="single utterances"):
        ttts.batch_inference(["a\nb"], max_ar_steps=4)
