"""BigVGAN's adversarial training side (port of
``tortoise_tts_tpu/models/bigvgan_disc.py``, reference bigvgan.py:543-762):

- ``DiscriminatorP``, the MultiPeriod discriminator: a wav reflect-padded
  to a multiple of the period, read as (T/p, p), through four stride-(3,
  1) convs and one stride-1 conv, then ``post``;
- ``DiscriminatorR``, the MultiResolution discriminator: the |STFT| at
  one resolution (rectangular window) through five 2-D convs and
  ``post``;
- the LSGAN discriminator and generator losses, feature matching (x2,
  the real feature maps held constant) and the training mel's L1.

Weight-norm convs are ``{"v", "g", "b"}`` folded at every call, the norm
in fp32 over (in, kh, kw) plus 1e-12.  The FFTs are ``torch.fft.rfft``
and the convs ``F.conv2d`` (through ``common.conv``: fp32 with cuDNN's
TF32 off on the card): the JAX package left both to XLA, outside any
Pallas kernel.  Parameters are nested dicts and lists of tensors in
the JAX package's layout (OIHW convs), so ``bridge.py`` carries them
across leaf for leaf.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stft import mel_filterbank
from .common import _uniform, conv, normal

Params = Dict[str, Any]

LRELU_SLOPE = 0.1

MPD_PERIODS = (2, 3, 5, 7, 11)                     # h.mpd_reshapes
MRD_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


@dataclass(frozen=True)
class DiscriminatorConfig:
    periods: Tuple[int, ...] = MPD_PERIODS
    resolutions: Tuple[Tuple[int, int, int], ...] = MRD_RESOLUTIONS
    channel_mult: int = 1


# weight-norm 2D conv

def _wn_conv2d_init(g: torch.Generator, c_in: int, c_out: int, kh: int,
                    kw: int) -> Params:
    v = normal(g, (c_out, c_in, kh, kw), 0.01)
    bound = 1.0 / math.sqrt(c_in * kh * kw)
    return {"v": v, "g": v.pow(2).sum(dim=(1, 2, 3)).sqrt(),
            "b": _uniform(g, (c_out,), bound)}


def _wn_conv2d(p: Params, x: torch.Tensor, stride=(1, 1),
               padding=(0, 0)) -> torch.Tensor:
    """Weight-norm conv2d in x's type; ``padding`` (rows, columns), the
    same on both sides."""
    v = p["v"].to(x.dtype)
    norm = torch.sqrt(p["v"].float().pow(2).sum(dim=(1, 2, 3), keepdim=True)
                      + 1e-12).to(x.dtype)
    w = p["g"].to(x.dtype)[:, None, None, None] * v / norm
    return conv(F.conv2d, x, w, p["b"].to(x.dtype), stride=stride,
                padding=padding)


# DiscriminatorP (bigvgan.py:543-580)

def _disc_p_init(g: torch.Generator, mult: int) -> Params:
    chans = [1, 32 * mult, 128 * mult, 512 * mult, 1024 * mult, 1024 * mult]
    return {"convs": [_wn_conv2d_init(g, chans[i], chans[i + 1], 5, 1)
                      for i in range(5)],
            "post": _wn_conv2d_init(g, chans[5], 1, 3, 1)}


def _disc_p_apply(p: Params, x: torch.Tensor, period: int
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x: (B, 1, T) -> (score (B, N), feature maps)."""
    b, c, t = x.shape
    if t % period != 0:
        pad = period - t % period
        x = F.pad(x, (0, pad), mode="reflect")
        t = t + pad
    x = x.reshape(b, c, t // period, period)
    fmap = []
    for i, conv in enumerate(p["convs"]):
        x = _wn_conv2d(conv, x, stride=(3, 1) if i < 4 else (1, 1),
                       padding=(2, 0))
        x = F.leaky_relu(x, LRELU_SLOPE)
        fmap.append(x)
    x = _wn_conv2d(p["post"], x, padding=(1, 0))
    fmap.append(x)
    return x.reshape(b, -1), fmap


# DiscriminatorR (bigvgan.py:606-655)

def _disc_r_init(g: torch.Generator, mult: int) -> Params:
    ch = 32 * mult
    return {"convs": [_wn_conv2d_init(g, 1, ch, 3, 9)]
            + [_wn_conv2d_init(g, ch, ch, 3, 9) for _ in range(3)]
            + [_wn_conv2d_init(g, ch, ch, 3, 3)],
            "post": _wn_conv2d_init(g, ch, 1, 3, 3)}


def _resolution_spectrogram(x: torch.Tensor, n_fft: int, hop: int,
                            win: int, window: str = "hann") -> torch.Tensor:
    """|STFT| with center=False after a reflect pad of (n_fft - hop) / 2 on
    both sides (bigvgan.py:648-655), fp32.  x: (B, T) -> (B, F, frames).
    A window shorter than n_fft sits centred in the frame, at offset
    (n_fft - win) / 2 (torch.stft's zero padding); ``window``: "hann", the
    periodic Hann of the training mel, or "ones", the discriminator's
    rectangular window.  The magnitude is sqrt(re^2 + im^2 + 1e-9), whose
    gradient is finite at a zero bin."""
    pad = (n_fft - hop) // 2
    x = F.pad(x.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    n_frames = 1 + (x.shape[-1] - n_fft) // hop
    off = (n_fft - win) // 2
    frames = x[:, off:].unfold(-1, win, hop)[:, :n_frames]
    if window == "hann":
        frames = frames * torch.as_tensor(
            np.hanning(win + 1)[:-1].astype(np.float32), device=x.device)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    return mag.transpose(1, 2)


def _disc_r_apply(p: Params, x: torch.Tensor,
                  resolution: Tuple[int, int, int]
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """x: (B, 1, T) -> (score, feature maps), in fp32 (the spectrogram's
    type)."""
    n_fft, hop, win = resolution
    h = _resolution_spectrogram(x[:, 0], n_fft, hop, win,
                                window="ones")[:, None]
    fmap = []
    strides = [(1, 1), (1, 2), (1, 2), (1, 2), (1, 1)]
    pads = [(1, 4)] * 4 + [(1, 1)]
    for conv, s, pd in zip(p["convs"], strides, pads):
        h = F.leaky_relu(_wn_conv2d(conv, h, stride=s, padding=pd),
                         LRELU_SLOPE)
        fmap.append(h)
    h = _wn_conv2d(p["post"], h, padding=(1, 1))
    fmap.append(h)
    return h.reshape(h.shape[0], -1), fmap


# the multi-discriminator and the losses

def init(g: torch.Generator,
         cfg: DiscriminatorConfig = DiscriminatorConfig()) -> Params:
    """Random parameters with the JAX package's structure and init scales,
    fp32, on the generator's device."""
    return {"mpd": [_disc_p_init(g, cfg.channel_mult) for _ in cfg.periods],
            "mrd": [_disc_r_init(g, cfg.channel_mult)
                    for _ in cfg.resolutions]}


def discriminate(p: Params, wav: torch.Tensor,
                 cfg: DiscriminatorConfig = DiscriminatorConfig()):
    """wav: (B, 1, T) -> (scores, feature maps), MPD then MRD."""
    scores, fmaps = [], []
    for dp, period in zip(p["mpd"], cfg.periods):
        s, f = _disc_p_apply(dp, wav, period)
        scores.append(s)
        fmaps.append(f)
    for dr, res in zip(p["mrd"], cfg.resolutions):
        s, f = _disc_r_apply(dr, wav, res)
        scores.append(s)
        fmaps.append(f)
    return scores, fmaps


def discriminator_loss(real_scores, fake_scores) -> torch.Tensor:
    """LSGAN: (1 - D(y))^2 + D(y_hat)^2 (bigvgan.py:738-750)."""
    loss = 0.0
    for dr, dg in zip(real_scores, fake_scores):
        loss = loss + torch.mean((1.0 - dr) ** 2) + torch.mean(dg ** 2)
    return loss


def generator_loss(fake_scores) -> torch.Tensor:
    """LSGAN generator: (1 - D(y_hat))^2 (bigvgan.py:753-761)."""
    loss = 0.0
    for dg in fake_scores:
        loss = loss + torch.mean((1.0 - dg) ** 2)
    return loss


def feature_loss(real_fmaps, fake_fmaps) -> torch.Tensor:
    """L1 feature matching, x2 (bigvgan.py:722-728); the real maps carry
    no gradient."""
    loss = 0.0
    for fr, fg in zip(real_fmaps, fake_fmaps):
        for rl, gl in zip(fr, fg):
            loss = loss + torch.mean(torch.abs(rl.detach().float()
                                               - gl.float()))
    return loss * 2.0


def training_mel(wav: torch.Tensor) -> torch.Tensor:
    """BigVGAN's training mel (bigvgan.py:690-719): 24 kHz, |STFT| with
    center=False (1024 / 256 / 1024, periodic Hann), 100 slaney mels over
    0-12 kHz, log-clamped at 1e-5.  wav: (B, T) -> (B, 100, frames)."""
    mag = _resolution_spectrogram(wav, 1024, 256, 1024)
    fb = torch.as_tensor(mel_filterbank(24000, 1024, 100, 0.0, 12000.0,
                                        scale="slaney", norm="slaney"),
                         device=wav.device)
    return torch.log(torch.clamp(torch.einsum("mf,bft->bmt", fb, mag),
                                 min=1e-5))


def mel_loss(wav_real: torch.Tensor, wav_fake: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(training_mel(wav_real)
                                - training_mel(wav_fake)))
