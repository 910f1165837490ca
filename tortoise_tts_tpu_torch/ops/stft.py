"""Audio front end: STFT, mel filterbanks, resampling (fp32 throughout).

Port of ``tortoise_tts_tpu/ops/stft.py``:

- ``mel_ar``: TorchMelSpectrogram -- 22.05 kHz, n_fft 1024, hop 256,
  power-2 spectrogram, 80 HTK-scale mels with slaney area
  normalisation, log-clamped at 1e-5, divided by per-bin mel_norms.
- ``mel_diffusion``: TacotronSTFT -- 24 kHz, n_fft 1024, hop 256,
  magnitude spectrogram, 100 slaney mels up to 12 kHz, log-clamped at
  1e-5; ``normalize_tacotron_mel`` / ``denormalize_tacotron_mel`` map it
  to and from the diffusion model's [-1, 1] space.
- ``resample``: torchaudio.functional.resample equivalent (windowed
  sinc, hann window, lowpass_filter_width=6, rolloff=0.99).
- ``griffin_lim_from_mel``: rough audio from a log-mel (the dataset's
  ``--action sample`` listening aid), with ``torch.fft``.

Filterbanks and resampling kernels are built with numpy once per
geometry; the signal path is torch on the caller's device.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f, scale: str):
    f = np.asarray(f, dtype=np.float64)
    if scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, mels)


def _mel_to_hz(m, scale: str):
    m = np.asarray(m, dtype=np.float64)
    if scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float,
                   scale: str = "slaney", norm: str = "slaney") -> np.ndarray:
    """Triangular mel filterbank, shape (n_mels, n_fft//2 + 1).

    scale='htk', norm='slaney' == torchaudio MelSpectrogram(norm='slaney');
    scale='slaney', norm='slaney' == librosa.filters.mel defaults."""
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin, scale), _hz_to_mel(fmax, scale),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, scale)
    fb = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:n_mels + 2] - hz_pts[:n_mels])
        fb *= enorm[:, None]
    return fb.astype(np.float32)


@lru_cache(maxsize=4)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic hann (torch.hann_window)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2 * np.pi * n / win_length)).astype(np.float32)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Center-padded (reflect) framing. x: (B, T) -> (B, n_frames, n_fft)."""
    pad = n_fft // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    return x.unfold(-1, n_fft, hop)


def stft_magnitude(x: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                   win_length: int = 1024, power: float = 1.0) -> torch.Tensor:
    """|STFT|^power. x: (B, T) -> (B, n_fft//2+1, n_frames), fp32."""
    window = np.asarray(hann_window(win_length))
    if win_length != n_fft:
        lo = (n_fft - win_length) // 2
        window = np.pad(window, (lo, n_fft - win_length - lo))
    window = torch.as_tensor(window, device=x.device)
    frames = frame_signal(x.float(), n_fft, hop) * window
    mag = torch.fft.rfft(frames, n=n_fft, dim=-1).abs()
    if power != 1.0:
        mag = mag ** power
    return mag.transpose(1, 2)


def mel_ar(wav: torch.Tensor, mel_norms: torch.Tensor | None = None
           ) -> torch.Tensor:
    """AR-conditioning mel. wav: (B, T) at 22.05 kHz -> (B, 80, frames)."""
    mag2 = stft_magnitude(wav, 1024, 256, 1024, power=2.0)
    fb = torch.as_tensor(mel_filterbank(22050, 1024, 80, 0.0, 8000.0,
                                        scale="htk", norm="slaney"),
                         device=wav.device)
    mel = torch.einsum("mf,bft->bmt", fb, mag2)
    mel = torch.log(torch.clamp(mel, min=1e-5))
    if mel_norms is not None:
        mel = mel / mel_norms.to(mel.device, torch.float32)[None, :, None]
    return mel


def mel_diffusion(wav24: torch.Tensor) -> torch.Tensor:
    """Diffusion-conditioning mel. wav24: (B, T) at 24 kHz -> (B, 100,
    frames); the input is clipped to [-1, 1] (arch_utils.py:692-694)."""
    mag = stft_magnitude(torch.clamp(wav24.float(), -1.0, 1.0), 1024, 256,
                         1024, power=1.0)
    fb = torch.as_tensor(mel_filterbank(24000, 1024, 100, 0.0, 12000.0,
                                        scale="slaney", norm="slaney"),
                         device=wav24.device)
    mel = torch.einsum("mf,bft->bmt", fb, mag)
    return torch.log(torch.clamp(mel, min=1e-5))


TACOTRON_MEL_MAX = 2.3143386840820312
TACOTRON_MEL_MIN = -11.512925148010254


def normalize_tacotron_mel(mel):
    """arch_utils.py:540-541"""
    return 2 * ((mel - TACOTRON_MEL_MIN)
                / (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN)) - 1


def denormalize_tacotron_mel(norm_mel):
    """arch_utils.py:536-537"""
    return (((norm_mel + 1) / 2) * (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN)
            + TACOTRON_MEL_MIN)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, n) frames -> (B, n + hop (T - 1)): each frame added in at
    its hop offset."""
    b, t, n = frames.shape
    out_len = n + hop * (t - 1)
    return F.fold(frames.transpose(1, 2), (1, out_len), (1, n),
                  stride=(1, hop)).reshape(b, out_len)


def griffin_lim_from_mel(mel_log: torch.Tensor, sr: int = 22050,
                         n_fft: int = 1024, hop: int = 256,
                         n_mels: int = 80, fmax: float = 8000.0,
                         scale: str = "htk", iters: int = 32,
                         phase: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Rough audio from a natural-log mel (B, n_mels, T) -> (B, hop (T -
    1)): a pseudo-inverse filterbank, then ``iters`` Griffin-Lim rounds.
    ``phase``: the initial phase (B, n_fft // 2 + 1, T); otherwise drawn
    uniform in [-pi, pi) from a ``torch.Generator`` seeded 0 on the mel's
    device."""
    mel_log = mel_log.float()
    dev = mel_log.device
    fb = mel_filterbank(sr, n_fft, n_mels, 0.0, fmax, scale=scale)
    pinv = torch.as_tensor(np.linalg.pinv(fb), device=dev)   # (F, n_mels)
    mag = torch.sqrt(torch.clamp(torch.einsum(
        "fm,bmt->bft", pinv, torch.exp(mel_log)), min=1e-10))
    window = torch.as_tensor(hann_window(n_fft), device=dev)
    b, _, t = mag.shape
    if phase is None:
        generator = torch.Generator(device=dev).manual_seed(0)
        phase = (torch.rand(mag.shape, generator=generator, device=dev)
                 * 2 - 1) * math.pi
    spec = mag * torch.exp(1j * phase.to(dev, torch.float32))
    wsum = _overlap_add((window ** 2).expand(1, t, n_fft), hop)
    wsum = torch.clamp(wsum, min=1e-8)

    def istft(s):
        frames = torch.fft.irfft(s.transpose(1, 2), n=n_fft, dim=-1) * window
        wav = _overlap_add(frames, hop) / wsum
        return wav[:, n_fft // 2: -(n_fft // 2)]

    for _ in range(iters):
        re = torch.fft.rfft(frame_signal(istft(spec), n_fft, hop) * window,
                            n=n_fft, dim=-1).transpose(1, 2)
        spec = mag * torch.exp(1j * torch.angle(re))
    return istft(spec)


@lru_cache(maxsize=16)
def _resample_kernel(orig_freq: int, new_freq: int,
                     lowpass_filter_width: int = 6,
                     rolloff: float = 0.99) -> tuple[np.ndarray, int, int]:
    """Polyphase windowed-sinc kernel, hann window (torchaudio default)."""
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    new = new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = t * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    scale = base_freq / orig
    kernel = np.where(t == 0, 1.0, np.sinc(t)) * window * scale
    return kernel.astype(np.float32), width, int(orig)


def resample(wav: torch.Tensor, orig_freq: int, new_freq: int) -> torch.Tensor:
    """wav: (..., T) -> (..., ceil(T*new/orig)). Matches torchaudio defaults."""
    if orig_freq == new_freq:
        return wav
    kernel, width, orig = _resample_kernel(orig_freq, new_freq)
    new = new_freq // math.gcd(orig_freq, new_freq)
    shape = wav.shape
    x = wav.reshape(-1, shape[-1]).float()
    length = x.shape[-1]
    x = F.pad(x, (width, width + orig))
    # strided conv: each of the `new` phases is an output channel
    k = torch.as_tensor(kernel, device=x.device)[:, None, :]
    y = F.conv1d(x[:, None, :], k, stride=orig)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)
    target_len = math.ceil(new * length / orig)
    return y[:, :target_len].reshape(shape[:-1] + (target_len,))
