"""The port's TTS and the JAX package's TTS on the same tiny weights, for
parity tests of whole serving routes: every model a route loads (the AR
model, the denoiser, BigVGAN, UnivNet, HiFiGAN, CLVP and the random
latent converters), made by the port's inits from a seed and carried to
the JAX package as numpy (the JAX package's eager BigVGAN init alone
takes half a minute on the CPU), one voice of fixed conditioning latents
that both ``encode_audio`` return for the reference name ``VOICE`` (it
keeps the reference encoders, and the JAX package's DVAE, out of the
routes' tests; voiceless rows would draw their latents from threefry on
one side and a torch generator on the other), and the noise injectors
that hand the port the JAX package's draws."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tortoise_tts_tpu import inference as jinf
from tortoise_tts_tpu.config import Config as JConfig, Inference as JInference
from tortoise_tts_tpu.inference import TTS as JTTS
from tortoise_tts_tpu.models import (LoadedModel as JLoaded, bigvgan as jbv,
                                     clvp as jclvp, diffusion as jdiff,
                                     hifigan as jhg, rlg as jrlg,
                                     unified_voice as juv, univnet as jun)
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch import inference as tinf
from tortoise_tts_tpu_torch.config import Config, Inference
from tortoise_tts_tpu_torch.inference import TTS
from tortoise_tts_tpu_torch.models import (LoadedModel, _bigvgan_random,
                                           _hifigan_random, _univnet_random,
                                           bigvgan, clvp, diffusion, hifigan,
                                           rlg, unified_voice, univnet)
from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer

D = 64
UV = dict(layers=2, model_dim=D, heads=4, max_text_tokens=40,
          max_mel_tokens=80)
DIFF = dict(model_channels=32, num_layers=2, in_latent_channels=D,
            num_heads=2)
# BigVGAN cut to three up-sampling stages of one resblock each (a 256x
# hop still): the JAX package compiles it in a few seconds
BV = dict(upsample_initial_channel=64, upsample_rates=(8, 8, 4),
          upsample_kernel_sizes=(16, 16, 8), resblock_kernel_sizes=(3,),
          resblock_dilation_sizes=((1, 3, 5),))
HG = dict(in_channels=D, upsample_initial_channel=32, cond_channels=D)
UN = dict(channel_size=8, kpnet_hidden=16)
CL = dict(dim_text=32, dim_speech=32, dim_latent=32, text_enc_depth=1,
          speech_enc_depth=1, text_heads=2, speech_heads=2, dim_head=16,
          rotary_dim=16)
BUCKETS = (32, 64)
VOICE = "voice.wav"


def port_params(seed: int = 0):
    """{name: (port module, JAX module, port config, JAX config, params)},
    the port's params random from ``seed``; the denoiser's attention
    outputs non-zero, so every attention block contributes."""
    g = torch.Generator().manual_seed(seed)
    rd = 2 * DIFF["model_channels"]
    spec = {
        "autoregressive": (unified_voice, juv,
                           unified_voice.UnifiedVoiceConfig(**UV),
                           juv.UnifiedVoiceConfig(**UV),
                           unified_voice.init),
        "diffusion": (diffusion, jdiff, diffusion.DiffusionConfig(**DIFF),
                      jdiff.DiffusionConfig(**DIFF), diffusion.init),
        "bigvgan": (bigvgan, jbv, bigvgan.BigVGANConfig(**BV),
                    jbv.BigVGANConfig(**BV), _bigvgan_random),
        "hifigan": (hifigan, jhg, hifigan.HifiganConfig(**HG),
                    jhg.HifiganConfig(**HG), _hifigan_random),
        "vocoder": (univnet, jun, univnet.UnivNetConfig(**UN),
                    jun.UnivNetConfig(**UN), _univnet_random),
        "clvp": (clvp, jclvp, clvp.CLVPConfig(**CL), jclvp.CLVPConfig(**CL),
                 clvp.init),
        "rlg_auto": (rlg, jrlg, D, D, rlg.init),
        "rlg_diffuser": (rlg, jrlg, rd, rd, rlg.init)}
    out = {n: (m, jm, c, jc, init(g, c))
           for n, (m, jm, c, jc, init) in spec.items()}
    for lyr in out["diffusion"][4]["conditioning_timestep_integrator"] + \
            out["diffusion"][4]["layers"]:
        w = lyr["attn"]["proj_out"]["w"]
        w.copy_(0.1 * torch.randn(w.shape, generator=g))
    return out


def make_pair(tmp, mp, decode_quant: str = "int8", seed: int = 0):
    """(JAX TTS, port TTS, ``VOICE``, port params) on the same weights,
    fp32, text buckets ``BUCKETS``; ``mp`` (a MonkeyPatch) sets the
    tokenizer and both TTS's ``encode_audio``, which give the same latents
    (AR (1, D), diffusion (1, 2 x channels)) for any reference."""
    mp.setenv("TORTOISE_TPU_TOKENIZER",
              str(write_char_tokenizer(tmp / "tokenizer.json")))
    spec = port_params(seed)
    to_jax = lambda t: jax.tree_util.tree_map(  # noqa: E731
        jnp.asarray, bridge.to_numpy(t))
    jtts = JTTS(config=JConfig(inference=JInference(
        weight_dtype="float32", text_buckets=BUCKETS,
        decode_quant=decode_quant)), dtype="float32")
    jtts._models = {n: JLoaded(n, jm, jc, to_jax(p), False)
                    for n, (_, jm, _, jc, p) in spec.items()}
    ttts = TTS(Config(inference=Inference(
        weight_dtype="float32", text_buckets=BUCKETS,
        decode_quant=decode_quant)), device="cpu", dtype="float32")
    ttts._models = {n: LoadedModel(n, m, c, p, False)
                    for n, (m, _, c, _, p) in spec.items()}
    rng = np.random.RandomState(seed + 100)
    latents = (rng.randn(1, D).astype(np.float32),
               rng.randn(1, 2 * DIFF["model_channels"]).astype(np.float32))
    mp.setattr(jtts, "encode_audio",
               lambda paths, seed=None: {"latent": latents})
    mp.setattr(ttts, "encode_audio", lambda paths, seed=None: {
        "latent": tuple(torch.from_numpy(a) for a in latents)})
    return jtts, ttts, VOICE, {n: v[4] for n, v in spec.items()}


def inject_jax_noise(mp, seeds):
    """The JAX package's diffusion noise (``_jit_diffusion``: per row
    split(k_diff)[0]) and UnivNet noise (normal(k_voc)) for the calls with
    these seeds, handed to the port through ``_diffusion_noise`` and
    ``_vocoder_noise``.  Returns the shapes drawn, by kind."""
    table = {}
    for s in seeds:
        k_diff = jinf._stage_keys(s)[1]
        k_port = tinf._host_keys(tinf._key_int(k_diff), 2)[0]
        table[tuple(int(x) for x in k_port)] = \
            jax.random.split(jnp.asarray(k_diff))[0]
    drawn = {"diffusion": [], "vocoder": []}

    def diffusion_noise(key, shape, device):
        drawn["diffusion"].append(tuple(shape))
        jk = table[tuple(int(x) for x in key)]
        return torch.from_numpy(np.array(jax.random.normal(
            jk, shape[1:], jnp.float32)))[None].to(device)

    def vocoder_noise(key, shape, device):
        drawn["vocoder"].append(tuple(shape))
        return torch.from_numpy(np.array(jax.random.normal(
            jnp.asarray(key), shape, jnp.float32))).to(device)

    mp.setattr(tinf, "_diffusion_noise", diffusion_noise)
    mp.setattr(tinf, "_vocoder_noise", vocoder_noise)
    return drawn
