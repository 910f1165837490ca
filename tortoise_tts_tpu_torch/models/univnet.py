"""UnivNet, the kernel-predictor vocoder of the original TorToiSe
'vocoder' checkpoint (port of ``tortoise_tts_tpu/models/univnet.py``).

mel (B, 100, T) + noise (B, 64, T) -> 24 kHz audio, 256 samples a frame.

The location-variable convolution (LVC) is a gather and an einsum, as in
the JAX package: output[b, oc, i, t] = sum_{ic, k} x_pad[b, ic, i*hop + t +
k*d] * kernel[b, i, ic, oc, k] + bias.  XLA fused it there, with no
Pallas kernel, so library ops carry it here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .common import conv1d, conv_transpose1d, leaky_relu

Params = Dict[str, Any]

# the silent frames ``inference`` appends, and their log-mel value
PAD_FRAMES = 10
SILENT_MEL = -11.5129


@dataclass(frozen=True)
class UnivNetConfig:
    noise_dim: int = 64
    channel_size: int = 32
    dilations: Tuple[int, ...] = (1, 3, 9, 27)
    strides: Tuple[int, ...] = (8, 8, 4)
    lrelu_slope: float = 0.2
    kpnet_conv_size: int = 3
    hop_length: int = 256
    n_mel_channels: int = 100
    kpnet_hidden: int = 64
    conv_kernel_size: int = 3


def _kernel_predictor(p: Params, c: torch.Tensor, cfg: UnivNetConfig,
                      in_ch: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """c: (B, mel, T) -> kernels (B, L, IC, OC, K, T), bias (B, L, OC, T)."""
    slope = cfg.lrelu_slope
    h = leaky_relu(conv1d(p["input_conv"], c, padding=2), slope)
    for rc in p["residual_convs"]:
        y = leaky_relu(conv1d(rc["c1"], h, padding=1), slope)
        y = leaky_relu(conv1d(rc["c2"], y, padding=1), slope)
        h = h + y
    k = conv1d(p["kernel_conv"], h, padding=1)
    b = conv1d(p["bias_conv"], h, padding=1)
    batch, _, t = c.shape
    layers = len(cfg.dilations)
    kernels = k.reshape(batch, layers, in_ch, 2 * in_ch,
                        cfg.conv_kernel_size, t)
    return kernels, b.reshape(batch, layers, 2 * in_ch, t)


def _lvc(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
         dilation: int, hop: int) -> torch.Tensor:
    """x: (B, IC, T*hop); kernel: (B, IC, OC, K, T); bias: (B, OC, T) ->
    (B, OC, T*hop)."""
    b, _, _ = x.shape
    k, t_cond = kernel.shape[3], kernel.shape[-1]
    pad = dilation * (k - 1) // 2
    xp = F.pad(x, (pad, pad))
    dev = x.device
    idx = (torch.arange(t_cond, device=dev)[:, None, None] * hop
           + torch.arange(hop, device=dev)[None, :, None]
           + torch.arange(k, device=dev)[None, None, :] * dilation)
    seg = xp[:, :, idx]                          # (B, IC, T, hop, K)
    o = torch.einsum("bcitk,bcoki->boit", seg, kernel.to(x.dtype))
    o = o + bias[:, :, :, None].to(x.dtype)
    return o.reshape(b, -1, t_cond * hop)


def _lvc_block(p: Params, x: torch.Tensor, c: torch.Tensor, stride: int,
               cond_hop: int, cfg: UnivNetConfig) -> torch.Tensor:
    slope = cfg.lrelu_slope
    in_ch = x.shape[1]
    x = leaky_relu(x, slope)
    x = conv_transpose1d(p["convt_pre"], x, stride=stride,
                         padding=stride // 2 + stride % 2,
                         output_padding=stride % 2)
    kernels, bias = _kernel_predictor(p["kernel_predictor"], c, cfg, in_ch)
    for i, d in enumerate(cfg.dilations):
        y = leaky_relu(x, slope)
        y = conv1d(p["conv_blocks"][i], y,
                   padding=d * (cfg.conv_kernel_size - 1) // 2, dilation=d)
        y = leaky_relu(y, slope)
        out = _lvc(y, kernels[:, i], bias[:, i], dilation=1, hop=cond_hop)
        x = x + torch.sigmoid(out[:, :in_ch]) * torch.tanh(out[:, in_ch:])
    return x


def forward(p: Params, mel: torch.Tensor, noise: torch.Tensor,
            cfg: UnivNetConfig = UnivNetConfig()) -> torch.Tensor:
    """mel: (B, 100, T); noise: (B, 64, T) -> (B, 1, T*256)."""
    z = conv1d(p["conv_pre"], F.pad(noise, (3, 3), mode="reflect"))
    hop = 1
    for i, stride in enumerate(cfg.strides):
        hop *= stride
        z = _lvc_block(p["res_stack"][i], z, mel, stride, hop, cfg)
    z = leaky_relu(z, cfg.lrelu_slope)
    z = conv1d(p["conv_post"], F.pad(z, (3, 3), mode="reflect"))
    return torch.tanh(z)


def noise_shape(mel_frames: int, cfg: UnivNetConfig = UnivNetConfig()
                ) -> Tuple[int, int]:
    """One row's noise for ``mel_frames`` frames, the silent pad included."""
    return (cfg.noise_dim, mel_frames + PAD_FRAMES)


def inference(p: Params, mel: torch.Tensor,
              generators: Optional[Sequence[torch.Generator]] = None,
              noise: Optional[torch.Tensor] = None,
              cfg: UnivNetConfig = UnivNetConfig()) -> torch.Tensor:
    """Pad 10 silent frames, decode, trim them off and clip to [-1, 1]
    (reference vocoder.py:302-314), at the mel's type.  ``noise``: (B, 64,
    T + 10); without it, row r draws its noise from ``generators[r]``."""
    b = mel.shape[0]
    silent = torch.full((b, cfg.n_mel_channels, PAD_FRAMES), SILENT_MEL,
                        dtype=mel.dtype, device=mel.device)
    mel = torch.cat([mel, silent], dim=2)
    if noise is None:
        shape = noise_shape(mel.shape[2] - PAD_FRAMES, cfg)
        noise = torch.stack([torch.randn(shape, generator=g,
                                         device=mel.device)
                             for g in generators])
    audio = forward(p, mel, noise.to(mel.dtype), cfg)
    audio = audio[:, :, :-(cfg.hop_length * PAD_FRAMES)]
    return torch.clamp(audio, -1, 1)
