"""Tiny models of every kind the port's routes load, random from a seed,
for CPU runs of ``TTS`` end to end (the W8A8 and CLI tests), and
``one_torch_thread``, a module fixture for files that run them."""

import pytest
import torch

from tortoise_tts_tpu_torch.models import (LoadedModel, _bigvgan_random,
                                           _hifigan_random, _univnet_random,
                                           bigvgan, clvp, diffusion, hifigan,
                                           rlg, unified_voice, univnet)

D = 128          # head dim 64 at 2 heads, as chip_smoke's tiny models
UV = dict(layers=2, model_dim=D, heads=2, max_text_tokens=40,
          max_mel_tokens=80)
DIFF = dict(model_channels=32, num_layers=2, in_latent_channels=D,
            num_heads=2)
HG = dict(in_channels=D, upsample_initial_channel=32, cond_channels=D)
BV = dict(upsample_initial_channel=64)
UN = dict(channel_size=8, kpnet_hidden=16)
CL = dict(dim_text=32, dim_speech=32, dim_latent=32, text_enc_depth=1,
          speech_enc_depth=1, text_heads=2, speech_heads=2, dim_head=16,
          rotary_dim=16)


def tiny_models(seed: int = 0):
    """{name: LoadedModel} for the AR model, the diffusion, the three
    vocoders, CLVP and the two random latent converters, fp32 on the CPU.  The
    mel head is scaled up so a greedy decode takes a varied path."""
    g = torch.Generator().manual_seed(seed)
    cfgs = {"autoregressive": unified_voice.UnifiedVoiceConfig(**UV),
            "diffusion": diffusion.DiffusionConfig(**DIFF),
            "hifigan": hifigan.HifiganConfig(**HG),
            "bigvgan": bigvgan.BigVGANConfig(**BV),
            "vocoder": univnet.UnivNetConfig(**UN),
            "clvp": clvp.CLVPConfig(**CL)}
    ar = unified_voice.init(g, cfgs["autoregressive"])
    ar["mel_head"]["w"] *= 8.0
    params = {"autoregressive": ar,
              "diffusion": diffusion.init(g, cfgs["diffusion"]),
              "hifigan": _hifigan_random(g, cfgs["hifigan"]),
              "bigvgan": _bigvgan_random(g, cfgs["bigvgan"]),
              "clvp": clvp.init(g, cfgs["clvp"]),
              "rlg_auto": rlg.init(g, D),
              "rlg_diffuser": rlg.init(g, 2 * DIFF["model_channels"]),
              "vocoder": _univnet_random(g, cfgs["vocoder"])}
    cfgs["rlg_auto"], cfgs["rlg_diffuser"] = D, 2 * DIFF["model_channels"]
    mods = {"autoregressive": unified_voice, "diffusion": diffusion,
            "hifigan": hifigan, "bigvgan": bigvgan, "vocoder": univnet,
            "clvp": clvp,
            "rlg_auto": rlg, "rlg_diffuser": rlg}
    return {n: LoadedModel(n, mods[n], cfgs[n], params[n], False)
            for n in mods}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module's tiny models on one CPU thread (restored after): the
    suite's workers share the cores, and torch's default pool, a thread
    a core, oversubscribes them and runs small ops many times slower (a
    W8A8 route test took 43 s beside another worker's JAX compile, 1.6 s
    alone).  Imported by a test module, it applies to that module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
