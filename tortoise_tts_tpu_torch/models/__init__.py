"""Model registry (port of ``tortoise_tts_tpu/models/__init__.py``, for
the models of the HiFiGAN, BigVGAN, batch and candidate routes).

``load_model(name)`` returns a ``LoadedModel`` with random parameters
made from a seed, as the JAX package does when it finds no weights.
Reading the reference's ``.pth`` checkpoints needs the port's copy of
``models/convert.py``, which is not written yet: a checkpoint found in
the model directories raises instead of being ignored.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from ..config import DTYPES
from ..utils.io import load_state_dict
from .common import conv1d_init, normal, tree_cast

_logger = logging.getLogger(__name__)

WEIGHT_FILES = {
    "autoregressive": "autoregressive.pth",
    "diffusion": "diffusion.pth",
    "bigvgan": "bigvgan_24khz_100band.pth",
    "hifigan": "hifigan.pth",
    "clvp": "clvp2.pth",
    "rlg_auto": "rlg_auto.pth",
    "rlg_diffuser": "rlg_diffuser.pth",
    "mel_norms": "mel_norms.pth",
}
MODEL_NAMES = ("autoregressive", "diffusion", "bigvgan", "hifigan", "clvp",
               "rlg_auto", "rlg_diffuser")
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


def load_model(name: str, dtype: str = "float32", seed: int = 0,
               device=None) -> LoadedModel:
    """Build a model with random parameters from ``seed``, floating
    leaves in ``dtype``, on ``device`` (None: the CUDA device)."""
    from . import bigvgan, clvp, diffusion, hifigan, rlg, unified_voice
    device = resolve_device(device, "load_model")
    cname = _canonical(name)
    if cname not in MODEL_NAMES:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md)")
    wpath = find_weight_file(cname)
    if wpath is not None:
        raise NotImplementedError(
            f"found {wpath}: reading reference checkpoints needs the port's "
            "models/convert.py (ROADMAP.md)")
    g = torch.Generator(device=device).manual_seed(seed)
    if cname == "autoregressive":
        cfg = unified_voice.UnifiedVoiceConfig()
        params, module = unified_voice.init(g, cfg), unified_voice
    elif cname == "diffusion":
        cfg = diffusion.DiffusionConfig()
        params, module = diffusion.init(g, cfg), diffusion
    elif cname == "bigvgan":
        cfg = bigvgan.BigVGANConfig()
        params, module = _bigvgan_random(g, cfg), bigvgan
    elif cname == "clvp":
        cfg = clvp.CLVPConfig()
        params, module = clvp.init(g, cfg), clvp
    elif cname in RLG_CHANNELS:
        # the config is the latent width, as in the JAX package
        cfg = RLG_CHANNELS[cname]
        params, module = rlg.init(g, cfg), rlg
    else:
        cfg = hifigan.HifiganConfig()
        params, module = _hifigan_random(g, cfg), hifigan
    params = tree_cast(params, DTYPES[dtype])
    _logger.info("%s (%s): random init from seed %d", cname, dtype, seed)
    return LoadedModel(cname, module, cfg, params, False)


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
