"""BigVGAN vocoder, the anti-aliased periodic-activation GAN generator
(port of ``tortoise_tts_tpu/models/bigvgan.py``).

Maps a 100-bin 24 kHz mel to a waveform (256x hop).  Defaults mirror
NVIDIA's bigvgan_24khz_100band JSON.  Every Snake activation runs K7
(``kernels/snake``) on the card: up2 -> snake -> down2 in one pass.  The
convolutions are ``torch.nn.functional`` calls: the JAX
package left them to XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..kernels.snake import snake_resample2
from .common import (conv1d, conv_transpose1d, depthwise_lowpass,
                     depthwise_upsample)

Params = Dict[str, Any]


@dataclass(frozen=True)
class BigVGANConfig:
    """bigvgan_24khz_100band.json defaults."""
    num_mels: int = 100
    upsample_rates: Tuple[int, ...] = (4, 4, 2, 2, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (8, 8, 4, 4, 4, 4)
    upsample_initial_channel: int = 1536
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    activation: str = "snakebeta"
    snake_logscale: bool = True
    hop_size: int = 256


@lru_cache(maxsize=16)
def kaiser_sinc_filter(cutoff: float, half_width: float,
                       kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc low-pass (bigvgan.py:40-69), float32."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


def _up2(x: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """UpSample1d(ratio) (bigvgan.py:112-135)."""
    k = int(6 * ratio // 2) * 2
    pad = k // ratio - 1
    pad_left = pad * ratio + (k - ratio) // 2
    pad_right = pad * ratio + (k - ratio + 1) // 2
    filt = kaiser_sinc_filter(0.5 / ratio, 0.6 / ratio, k)
    return depthwise_upsample(x, filt, ratio, pad, pad_left, pad_right)


def _down2(x: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """DownSample1d(ratio) (bigvgan.py:137-152)."""
    k = int(6 * ratio // 2) * 2
    pad_left = k // 2 - int(k % 2 == 0)
    pad_right = k // 2
    filt = kaiser_sinc_filter(0.5 / ratio, 0.6 / ratio, k)
    return depthwise_lowpass(x, filt, ratio, pad_left, pad_right)


def _snake_act(p: Params, x: torch.Tensor, logscale: bool,
               beta: bool) -> torch.Tensor:
    """Activation1d(Snake/SnakeBeta): up2 -> snake -> down2
    (bigvgan.py:158-271), through K7 at every T."""
    a = p["alpha"].float()
    b = p["beta"].float() if beta else a
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    return snake_resample2(x, a, 1.0 / (b + 1e-9))


def _get_padding(k: int, d: int) -> int:
    return (k * d - d) // 2


def _amp_block1(p: Params, x: torch.Tensor, k: int,
                dilations: Tuple[int, ...], cfg: BigVGANConfig
                ) -> torch.Tensor:
    """AMPBlock1 (bigvgan.py:306-364)."""
    beta = cfg.activation == "snakebeta"
    acts = p["activations"]
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], acts[::2],
                                 acts[1::2], dilations):
        xt = _snake_act(a1, x, cfg.snake_logscale, beta)
        xt = conv1d(c1, xt, padding=_get_padding(k, d), dilation=d)
        xt = _snake_act(a2, xt, cfg.snake_logscale, beta)
        xt = conv1d(c2, xt, padding=_get_padding(k, 1))
        x = xt + x
    return x


def _amp_block2(p: Params, x: torch.Tensor, k: int,
                dilations: Tuple[int, ...], cfg: BigVGANConfig
                ) -> torch.Tensor:
    """AMPBlock2."""
    beta = cfg.activation == "snakebeta"
    for c, a, d in zip(p["convs"], p["activations"], dilations):
        xt = _snake_act(a, x, cfg.snake_logscale, beta)
        x = conv1d(c, xt, padding=_get_padding(k, d), dilation=d) + x
    return x


def forward(p: Params, mel: torch.Tensor,
            cfg: BigVGANConfig = BigVGANConfig()) -> torch.Tensor:
    """mel: (B, 100, T) -> (B, 1, T*256) (bigvgan.py:489-511)."""
    x = conv1d(p["conv_pre"], mel, padding=3)
    nk = len(cfg.resblock_kernel_sizes)
    block = _amp_block1 if cfg.resblock == "1" else _amp_block2
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        x = conv_transpose1d(p["ups"][i], x, stride=u, padding=(k - u) // 2)
        xs = None
        for j in range(nk):
            y = block(p["resblocks"][i * nk + j], x,
                      cfg.resblock_kernel_sizes[j],
                      cfg.resblock_dilation_sizes[j], cfg)
            xs = y if xs is None else xs + y
        x = xs / nk
    x = _snake_act(p["activation_post"], x, cfg.snake_logscale,
                   cfg.activation == "snakebeta")
    return torch.tanh(conv1d(p["conv_post"], x, padding=3))


def inference(p: Params, mel: torch.Tensor,
              cfg: BigVGANConfig = BigVGANConfig()) -> torch.Tensor:
    """Pad 10 silent frames, decode, trim the tail (bigvgan.py:522-535)."""
    zero = torch.full((mel.shape[0], cfg.num_mels, 10), -11.5129,
                      dtype=mel.dtype, device=mel.device)
    audio = forward(p, torch.cat([mel, zero], dim=2), cfg)
    return audio[:, :, :-(cfg.hop_size * 10)].clamp(-1, 1)
