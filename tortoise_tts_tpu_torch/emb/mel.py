"""Audio encode: wav -> DVAE codes, conditioning mels and latents (port
of ``tortoise_tts_tpu/emb/mel.py``).

    wav --resample 22.05k--> 80-mel  --DVAE--> discrete codes
                             80-mel (132300-sample clip) --UV--> AR latent
        --resample 24k, pad/trunc 102400--> 100-mel --Diff--> diff latent

The DVAE encodes the whole utterance's mel at its exact shape.  The JAX
package edge-pads it to a multiple of 256 frames first, to compile one
program per bucket on the TPU (``TTS_MEL_EXACT=1`` turns that off there);
the codes of the exact shape are the reference's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..models import LoadedModel, load_mel_norms, load_model, resolve_device
from ..models import diffusion as diffusion_m
from ..models.unified_voice import get_conditioning
from ..ops import stft
from ..utils.io import read_wav

AR_COND_SAMPLES = 132_300
DIFF_COND_SAMPLES = 102_400


def format_autoregressive_conditioning(
        wav22: torch.Tensor, cond_length: int = AR_COND_SAMPLES,
        rng: Optional[np.random.RandomState] = None) -> torch.Tensor:
    """(B?, T) 22.05 kHz -> (B, 80, frames) AR-conditioning mel: pad, or
    crop at a random start drawn from the numpy ``rng``."""
    wav22 = torch.atleast_2d(wav22)
    if cond_length > 0:
        gap = wav22.shape[-1] - cond_length
        if gap < 0:
            wav22 = F.pad(wav22, (0, -gap))
        elif gap > 0:
            rng = rng or np.random.RandomState()
            start = rng.randint(0, gap + 1)
            wav22 = wav22[:, start:start + cond_length]
    return stft.mel_ar(wav22.float(), load_mel_norms(wav22.device))


def format_diffusion_conditioning(wav22: Optional[torch.Tensor],
                                  wav24: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """(B?, T) 22.05 kHz -> (B, 100, frames) diffusion-conditioning mel:
    resample to 24 kHz (or take ``wav24``), pad or truncate to 102400."""
    if wav24 is None:
        wav24 = stft.resample(torch.atleast_2d(wav22).float(), 22050, 24000)
    t = wav24.shape[-1]
    if t < DIFF_COND_SAMPLES:
        wav24 = F.pad(wav24, (0, DIFF_COND_SAMPLES - t))
    else:
        wav24 = wav24[:, :DIFF_COND_SAMPLES]
    return stft.mel_diffusion(wav24)


def encode(wav: np.ndarray, sr: int, dtype: str = "float32",
           rng: Optional[np.random.RandomState] = None,
           return_mels: bool = False, device=None,
           ar: Optional[LoadedModel] = None,
           diffusion: Optional[LoadedModel] = None,
           dvae: Optional[LoadedModel] = None, codes: bool = True) -> Dict:
    """wav: (T,) or (1, T) float at ``sr`` -> {'codes', 'conds', 'latent',
    'metadata'}; 'codes' are the DVAE's (1, frames / 4) over the whole
    utterance's 80-bin mel, 'conds' and 'latent' (AR, diffusion) pairs.
    ``return_mels`` adds the training mels: 'mel' (1, 80, frames), the
    DVAE's and the AR model's space, and 'mel_diff' (1, 100, frames at
    24 kHz), tacotron-normalised, the diffusion's x_start space.
    ``codes=False`` leaves the DVAE out (the serving path needs no codes).
    ``ar``/``diffusion``/``dvae``: the models to encode with (loaded from
    the registry when None).  ``device`` None is the CUDA device."""
    device = resolve_device(device, "encode")
    wav = np.atleast_2d(np.asarray(wav, dtype=np.float32))
    wav_length = wav.shape[-1]
    wav22 = stft.resample(torch.as_tensor(wav, device=device), sr, 22050)
    if ar is None:
        ar = load_model("autoregressive", dtype, device=device)
    if diffusion is None:
        diffusion = load_model("diffusion", dtype, device=device)
    if codes and dvae is None:
        dvae = load_model("dvae", dtype, device=device)
    wav24 = stft.resample(wav22, 22050, 24000)
    ar_conds = format_autoregressive_conditioning(wav22, rng=rng)[:, None]
    diff_conds = format_diffusion_conditioning(None, wav24=wav24)[:, None]
    ar_latent = get_conditioning(ar.params, ar_conds, ar.config)
    diff_latent = diffusion_m.get_conditioning(diffusion.params, diff_conds,
                                               diffusion.config)
    out = {
        "conds": (ar_conds, diff_conds),
        "latent": (ar_latent, diff_latent),
        "metadata": {"original_length": wav_length, "sample_rate": sr,
                     "duration": wav_length / sr},
    }
    mel_full = None
    if codes or return_mels:
        mel_full = stft.mel_ar(wav22.float(), load_mel_norms(device))
    if codes:
        out["codes"] = dvae.module.get_codebook_indices(
            dvae.params, mel_full, dvae.config)
    if return_mels:
        out["mel"] = mel_full
        out["mel_diff"] = stft.normalize_tacotron_mel(
            stft.mel_diffusion(wav24))
    return out


def load_models(dtype: str = "float32", device=None
                ) -> Dict[str, LoadedModel]:
    """The three models ``encode`` runs, from the registry, once: {'ar',
    'diffusion', 'dvae'} (keyword arguments of ``encode``)."""
    device = resolve_device(device, "load_models")
    return {"ar": load_model("autoregressive", dtype, device=device),
            "diffusion": load_model("diffusion", dtype, device=device),
            "dvae": load_model("dvae", dtype, device=device)}


def encode_from_files(paths: Sequence[str | Path], dtype: str = "float32",
                      rng: Optional[np.random.RandomState] = None,
                      device=None, ar: Optional[LoadedModel] = None,
                      diffusion: Optional[LoadedModel] = None,
                      codes: bool = True) -> Dict:
    """Concatenate the reference clips, then encode."""
    device = resolve_device(device, "encode_from_files")
    wavs, main_sr = [], None
    for p in paths:
        data, sr = read_wav(p)
        if main_sr is None:
            main_sr = sr
        if sr != main_sr:
            raise ValueError(f"mismatching sample rates: {sr} != {main_sr}")
        wavs.append(data)
    return encode(np.concatenate(wavs, axis=-1), main_sr, dtype=dtype,
                  rng=rng, device=device, ar=ar, diffusion=diffusion,
                  codes=codes)
