"""RandomLatentConverter: conditioning latents for voiceless generation
(port of ``tortoise_tts_tpu/models/rlg.py``).

Five EqualLinear layers (lr_mul 0.1, fused leaky-relu with slope 0.2
scaled by sqrt 2) and a final linear map N(0, 1) noise to a fake AR
(``rlg_auto``, 1024-d) or diffusion (``rlg_diffuser``, 2048-d)
conditioning latent.  Computed in fp32, as the JAX package's fp32 noise
promotes it.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .common import linear, linear_init

Params = Dict[str, Any]

LR_MUL = 0.1


def init(g: torch.Generator, channels: int) -> Params:
    eq = [{"w": torch.randn(channels, channels, generator=g,
                            device=g.device) / LR_MUL,
           "b": torch.zeros(channels, device=g.device)} for _ in range(5)]
    return {"equal_linears": eq,
            "final": linear_init(g, channels, channels)}


def forward(p: Params, noise: torch.Tensor) -> torch.Tensor:
    """noise: (B, C) -> latent (B, C), fp32."""
    x = noise.float()
    scale = (1.0 / math.sqrt(x.shape[-1])) * LR_MUL
    for lp in p["equal_linears"]:
        # EqualLinear keeps the torch layout w (out, in), scaled at run time
        y = x @ (lp["w"].float().T * scale) + lp["b"].float() * LR_MUL
        x = torch.where(y >= 0, y, y * 0.2) * math.sqrt(2)
    return linear(p["final"], x)


def sample(p: Params, generator: torch.Generator, batch: int,
           channels: int) -> torch.Tensor:
    """``batch`` latents from standard-normal noise drawn from
    ``generator`` (on the device the latents are made on)."""
    return forward(p, torch.randn((batch, channels), generator=generator,
                                  device=generator.device))
