"""Model registry (port of ``tortoise_tts_tpu/models/__init__.py``: the
AR model, the denoiser, the three vocoders, CLVP, the random latent
converters, the DVAE and the audio classifier).

``load_model(name)`` returns a ``LoadedModel``: the reference's
checkpoint when one is found in the model directories (``.pth``, ``.sft``
or ``.safetensors``; ``$TORTOISE_TPU_MODELS`` first), converted by
``models/convert.py`` and cast onto the device, or else random parameters
made from a seed, as the JAX package does.  A checkpoint that cannot be
read or converted raises, where the JAX package logs a warning and falls
back to random weights: a server should not speak noise unasked.
"""

from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..bridge import to_torch
from ..config import DTYPES
from ..utils.io import load_state_dict
from .common import conv1d_init, normal, tree_cast

_logger = logging.getLogger(__name__)

WEIGHT_FILES = {
    "autoregressive": "autoregressive.pth",
    "diffusion": "diffusion.pth",
    "bigvgan": "bigvgan_24khz_100band.pth",
    "hifigan": "hifigan.pth",
    "vocoder": "vocoder.pth",
    "clvp": "clvp2.pth",
    "rlg_auto": "rlg_auto.pth",
    "rlg_diffuser": "rlg_diffuser.pth",
    "mel_norms": "mel_norms.pth",
    "dvae": "dvae.pth",
    "classifier": "classifier.pth",
}
# the sub-dict of a checkpoint that holds the weights
STATE_DICT_KEYS = {"bigvgan": "generator", "vocoder": "model_g"}
MODEL_NAMES = ("autoregressive", "diffusion", "bigvgan", "hifigan", "clvp",
               "rlg_auto", "rlg_diffuser", "vocoder", "dvae", "classifier")
# conditioning latent width of each random latent converter
RLG_CHANNELS = {"rlg_auto": 1024, "rlg_diffuser": 2048}


def resolve_device(device, who: str) -> torch.device:
    """``device`` or, when it is None, the CUDA device; raises when there
    is none, so a run meant for the card never lands on the CPU
    unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        device = "cuda"
    return torch.device(device)


def model_dirs() -> List[Path]:
    dirs = [Path(__file__).parent.parent / "data" / "models"]
    if os.environ.get("TORTOISE_TPU_MODELS"):
        dirs.insert(0, Path(os.environ["TORTOISE_TPU_MODELS"]))
    return dirs


def find_weight_file(name: str) -> Optional[Path]:
    fname = WEIGHT_FILES.get(name)
    if fname is None:
        return None
    for d in model_dirs():
        for ext in (".pth", ".sft", ".safetensors"):
            p = (d / fname).with_suffix(ext)
            if p.exists():
                return p
    return None


@dataclass
class LoadedModel:
    name: str
    module: Any          # the model's python module
    config: Any          # its config dataclass
    params: Dict[str, Any]
    from_checkpoint: bool


def load_mel_norms(device=None) -> Optional[torch.Tensor]:
    """The 80-bin mel normalisation vector, or None when its file is
    absent."""
    p = find_weight_file("mel_norms")
    if p is None:
        return None
    if p.suffix in (".sft", ".safetensors"):
        t = load_state_dict(p)["mel_norms"]
    else:
        t = torch.load(str(p), map_location="cpu", weights_only=False)
    return torch.as_tensor(t, dtype=torch.float32, device=device)


def _canonical(name: str) -> str:
    for key in ("autoregressive", "unified_voice", *MODEL_NAMES[1:]):
        if key in name:
            return "autoregressive" if key == "unified_voice" else key
    return name


def convert_torch_sd(name: str, sd, cfg) -> Dict[str, Any]:
    """A reference torch-layout flat state dict -> the port's parameters
    (numpy leaves), by the converters of ``models/convert.py``."""
    from . import convert
    c = _canonical(name)
    if c == "autoregressive":
        return convert.convert_unified_voice(sd, cfg.layers)
    if c == "diffusion":
        return convert.convert_diffusion(sd, cfg.num_layers)
    if c == "clvp":
        return convert.convert_clvp(sd, cfg.text_enc_depth)
    if c == "bigvgan":
        return convert.convert_bigvgan(sd, n_ups=len(cfg.upsample_rates),
                                       resblock=cfg.resblock)
    if c == "hifigan":
        return convert.convert_hifigan(sd)
    if c == "vocoder":
        return convert.convert_univnet(sd)
    if c in RLG_CHANNELS:
        return convert.convert_rlg(sd)
    if c == "dvae":
        return convert.convert_dvae(sd)
    if c == "classifier":
        return convert.convert_classifier(sd, depth=cfg.depth)
    raise KeyError(f"no torch-layout converter for model: {name}")


def _read_checkpoint(cname: str, wpath: Path) -> Dict[str, Any]:
    try:
        sd = load_state_dict(wpath, key=STATE_DICT_KEYS.get(cname))
    except Exception as e:
        raise RuntimeError(f"{cname}: cannot read the checkpoint {wpath}: "
                           f"{e}") from e
    if not isinstance(sd, dict) or not sd:
        raise RuntimeError(f"{cname}: the checkpoint {wpath} holds no "
                           "state dict")
    return sd


def load_model(name: str, dtype: str = "float32", seed: int = 0,
               device=None) -> LoadedModel:
    """The named model with its floating leaves in ``dtype`` on ``device``
    (None: the CUDA device): converted from the reference's checkpoint
    when one is found, else random parameters from ``seed``.  An
    unreadable or unconvertible checkpoint raises."""
    from . import (bigvgan, classifier, clvp, diffusion, dvae, hifigan, rlg,
                   unified_voice, univnet)
    device = resolve_device(device, "load_model")
    cname = _canonical(name)
    if cname not in MODEL_NAMES:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md)")
    wpath = find_weight_file(cname)
    sd = _read_checkpoint(cname, wpath) if wpath is not None else None
    g = torch.Generator(device=device).manual_seed(seed)
    if cname == "autoregressive":
        cfg, module = unified_voice.UnifiedVoiceConfig(), unified_voice
        init = unified_voice.init
    elif cname == "diffusion":
        cfg, module = diffusion.DiffusionConfig(), diffusion
        init = diffusion.init
    elif cname == "bigvgan":
        jpath = wpath.with_suffix(".json") if wpath is not None else None
        cfg = (bigvgan.BigVGANConfig.from_json(json.loads(jpath.read_text()))
               if jpath is not None and jpath.exists()
               else bigvgan.BigVGANConfig())
        module, init = bigvgan, _bigvgan_random
    elif cname == "clvp":
        cfg, module, init = clvp.CLVPConfig(), clvp, clvp.init
    elif cname in RLG_CHANNELS:
        # the config is the latent width, as in the JAX package
        cfg, module, init = RLG_CHANNELS[cname], rlg, rlg.init
    elif cname == "vocoder":
        cfg, module, init = univnet.UnivNetConfig(), univnet, _univnet_random
    elif cname == "dvae":
        cfg, module, init = dvae.DVAEConfig(), dvae, dvae.init
    elif cname == "classifier":
        cfg, module = classifier.ClassifierConfig(), classifier
        init = classifier.init
    else:
        cfg, module = hifigan.HifiganConfig(), hifigan
        init = _hifigan_random
    if sd is None:
        params = tree_cast(init(g, cfg), DTYPES[dtype])
        _logger.info("%s (%s): random init from seed %d", cname, dtype, seed)
    else:
        try:
            tree = convert_torch_sd(cname, sd, cfg)
        except Exception as e:
            raise RuntimeError(f"{cname}: the checkpoint {wpath} does not "
                               f"convert: {e!r}") from e
        del sd
        params = to_torch(tree, device, DTYPES[dtype])
        _logger.info("%s (%s): loaded %s", cname, dtype, wpath)
    return LoadedModel(cname, module, cfg, params, wpath is not None)


def _hifigan_random(g: torch.Generator, cfg) -> Dict[str, Any]:
    """Random HiFiGAN parameters with the JAX package's structure."""
    ch0 = cfg.upsample_initial_channel
    p = {"conv_pre": conv1d_init(g, cfg.in_channels, ch0, 7),
         "cond_layer": conv1d_init(g, cfg.cond_channels, ch0, 1),
         "ups": [], "resblocks": []}
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        cin, cout = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
        p["ups"].append({"w": normal(g, (cin, cout, k), 0.02),
                         "b": torch.zeros(cout, device=g.device)})
        for kk, dil in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilations):
            p["resblocks"].append({
                "convs1": [conv1d_init(g, cout, cout, kk) for _ in dil],
                "convs2": [conv1d_init(g, cout, cout, kk) for _ in dil]})
    p["conv_post"] = conv1d_init(g, cout, cfg.out_channels, 7)
    return p


def _bigvgan_random(g: torch.Generator, cfg) -> Dict[str, Any]:
    """Random BigVGAN parameters with the JAX package's structure; the
    snake parameters start at 0 (logscale) or 1."""
    ch0 = cfg.upsample_initial_channel
    p = {"conv_pre": conv1d_init(g, cfg.num_mels, ch0, 7),
         "ups": [], "resblocks": []}

    def snake(ch):
        fill = torch.zeros if cfg.snake_logscale else torch.ones
        return {"alpha": fill(ch, device=g.device),
                "beta": fill(ch, device=g.device)}

    for i, k in enumerate(cfg.upsample_kernel_sizes):
        cin, cout = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
        p["ups"].append({"w": normal(g, (cin, cout, k), 0.02),
                         "b": torch.zeros(cout, device=g.device)})
        for kk, dil in zip(cfg.resblock_kernel_sizes,
                           cfg.resblock_dilation_sizes):
            p["resblocks"].append({
                "convs1": [conv1d_init(g, cout, cout, kk) for _ in dil],
                "convs2": [conv1d_init(g, cout, cout, kk) for _ in dil],
                "activations": [snake(cout) for _ in range(2 * len(dil))]})
    p["activation_post"] = snake(cout)
    p["conv_post"] = conv1d_init(g, cout, 1, 7)
    return p


def _univnet_random(g: torch.Generator, cfg) -> Dict[str, Any]:
    """Random UnivNet parameters with the JAX package's structure."""
    cs, hid = cfg.channel_size, cfg.kpnet_hidden
    layers = len(cfg.dilations)

    def kp():
        return {
            "input_conv": conv1d_init(g, cfg.n_mel_channels, hid, 5),
            "residual_convs": [{"c1": conv1d_init(g, hid, hid, 3),
                                "c2": conv1d_init(g, hid, hid, 3)}
                               for _ in range(3)],
            "kernel_conv": conv1d_init(
                g, hid, cs * 2 * cs * cfg.conv_kernel_size * layers, 3),
            "bias_conv": conv1d_init(g, hid, 2 * cs * layers, 3),
        }

    p = {"conv_pre": conv1d_init(g, cfg.noise_dim, cs, 7),
         "conv_post": conv1d_init(g, cs, 1, 7), "res_stack": []}
    for stride in cfg.strides:
        p["res_stack"].append({
            "kernel_predictor": kp(),
            "convt_pre": {"w": normal(g, (cs, cs, 2 * stride), 0.02),
                          "b": torch.zeros(cs, device=g.device)},
            "conv_blocks": [conv1d_init(g, cs, cs, cfg.conv_kernel_size)
                            for _ in cfg.dilations]})
    return p
