"""Audio classifier (port of ``tortoise_tts_tpu/models/classifier.py``;
reference classifier.py:124-149): an AudioMiniEncoder and a linear head.

The downloadable 'classifier' checkpoint is TorToiSe's "is this tortoise
audio" detector.  The defaults are the published classifier.pth's
architecture, over raw audio (B, 1, T), not mels: base 32 channels,
depth 5 of stride-4 downsamples (C = 1024 and T / 1024 at the end), a
1x1 conv to 512 channels, 4 attention blocks of 4 heads (each head one
K4 call at C = 512 -> 1536 on the card), 2 classes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from .arch import audio_mini_encoder, audio_mini_encoder_init
from .common import linear, linear_init

Params = Dict[str, Any]


@dataclass(frozen=True)
class ClassifierConfig:
    classes: int = 2
    spec_dim: int = 1            # raw waveform channels
    embedding_dim: int = 512
    base_channels: int = 32
    depth: int = 5
    resnet_blocks: int = 2
    attn_blocks: int = 4
    num_attn_heads: int = 4
    downsample_factor: int = 4
    kernel_size: int = 5


def init(g: torch.Generator, cfg: ClassifierConfig = ClassifierConfig()
         ) -> Params:
    return {
        "enc": audio_mini_encoder_init(
            g, cfg.spec_dim, cfg.embedding_dim, cfg.base_channels, cfg.depth,
            cfg.resnet_blocks, cfg.attn_blocks, cfg.num_attn_heads,
            downsample_factor=cfg.downsample_factor,
            kernel_size=cfg.kernel_size),
        "head": linear_init(g, cfg.embedding_dim, cfg.classes),
    }


def forward(p: Params, audio: torch.Tensor,
            cfg: ClassifierConfig = ClassifierConfig()) -> torch.Tensor:
    """audio: (B, spec_dim, T) -> logits (B, classes)."""
    h = audio_mini_encoder(p["enc"], audio, cfg.num_attn_heads,
                           cfg.kernel_size,
                           downsample_factor=cfg.downsample_factor)
    return linear(p["head"], h)
