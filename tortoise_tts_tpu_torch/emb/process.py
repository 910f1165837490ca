"""Dataset preparation: slice and quantize audio into .mel artifacts (port
of ``tortoise_tts_tpu/emb/process.py``; reference emb/process.py).

    python -m tortoise_tts_tpu_torch.emb.process --input-audio voices \
        --output-dataset training/data [--stride N --stride-offset K] \
        [--device cpu]

Walks ``<input>/<group>/<speaker>/*.wav`` with sibling ``whisper.json``
transcripts (or ``.txt`` files), slices by segment timestamps, encodes
each segment (``emb.mel.encode``: the DVAE codes, the conditioning mels
and latents, the training mels) and writes the reference's artifact
(emb/process.py:43-74): an ``np.save``'d dict of numpy arrays, uint16
codes, float32 conds and latents, float16 mels, uint8 text tokens and
metadata, the layout the JAX package writes and reads.  The three models
load once, on the CUDA device unless ``--device`` says otherwise.
``--stride/--stride-offset`` shard speakers across processes.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from ..models import LoadedModel
from ..tokenizer import default_tokenizer
from ..utils.io import read_wav
from . import mel as emb_mel

_logger = logging.getLogger(__name__)


def _np(t, dtype) -> np.ndarray:
    return t.detach().float().cpu().numpy().astype(dtype)


def process_job(outpath: Path, wav: np.ndarray, sample_rate: int,
                text: Optional[str] = None, language: str = "en",
                dtype: str = "float32", store_mels: bool = True,
                device=None,
                models: Optional[Dict[str, LoadedModel]] = None) -> bool:
    """Encode one segment and write its artifact; False (nothing written)
    when the DVAE's codes are all zero.  ``models``: ``emb.mel.load_models``'
    dict (loaded here when None)."""
    models = models or emb_mel.load_models(dtype, device)
    state = emb_mel.encode(wav, sample_rate, dtype=dtype,
                           return_mels=store_mels, device=device, **models)
    codes = state["codes"].cpu().numpy()
    if np.count_nonzero(codes) == 0:
        _logger.warning("quantization returned zero'd tensor: %s", outpath)
        return False
    artifact = {
        "codes": codes.astype(np.uint16),
        "conds": tuple(_np(c, np.float32) for c in state["conds"]),
        "latent": tuple(_np(c, np.float32) for c in state["latent"]),
        "metadata": dict(state["metadata"]),
    }
    if store_mels:
        # training-mel targets for the diffusion, DVAE and vocoder engines
        artifact["mel"] = _np(state["mel"], np.float16)
        artifact["mel_diff"] = _np(state["mel_diff"], np.float16)
    if text:
        text = text.strip()
        artifact["text"] = np.array(default_tokenizer().encode(text),
                                    dtype=np.uint8)
        artifact["metadata"].update({"text": text, "language": language})
    outpath.parent.mkdir(parents=True, exist_ok=True)
    with open(outpath, "wb") as f:
        np.save(f, artifact)
    return True


def _segments_for(audio_path: Path):
    """Yield (name, start, end, text) from whisper.json or a .txt sibling."""
    wj = audio_path.parent / "whisper.json"
    if wj.exists():
        entry = json.loads(wj.read_text()).get(audio_path.name)
        if entry:
            for i, seg in enumerate(entry.get("segments", [])):
                # pad the segments (process.py:349-350)
                yield (f"{audio_path.stem}_{i:05d}",
                       max(0.0, seg["start"] - 0.05), seg["end"] + 0.5,
                       seg["text"])
            return
    txt = audio_path.with_suffix(".txt")
    yield (audio_path.stem, 0.0, -1.0,
           txt.read_text() if txt.exists() else None)


def process(input_audio: Path, output_dataset: Path, stride: int = 0,
            stride_offset: int = 0, dtype: str = "float32",
            audio_exts=(".wav",), device=None,
            models: Optional[Dict[str, LoadedModel]] = None) -> int:
    """Every segment of every speaker under ``input_audio`` into
    ``output_dataset`` (existing artifacts are kept); returns the count
    written."""
    speakers = sorted(p for p in input_audio.rglob("*") if p.is_dir()) or \
        [input_audio]
    if stride:
        speakers = [s for i, s in enumerate(speakers)
                    if (i + stride_offset) % stride == 0]
    done = 0
    for spk in speakers:
        rel = spk.relative_to(input_audio)
        for audio in sorted(spk.iterdir()):
            if audio.suffix.lower() not in audio_exts:
                continue
            wav, sr = read_wav(audio)
            for name, start, end, text in _segments_for(audio):
                out = output_dataset / rel / f"{name}.mel"
                if out.exists():
                    continue
                s = int(start * sr)
                e = len(wav) if end < 0 else int(end * sr)
                seg = wav[s:e]
                if len(seg) < sr // 4:
                    continue
                if models is None:
                    models = emb_mel.load_models(dtype, device)
                if process_job(out, seg, sr, text=text, dtype=dtype,
                               device=device, models=models):
                    done += 1
    return done


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("tortoise_tts_tpu_torch.emb.process")
    parser.add_argument("--input-audio", type=Path, required=True)
    parser.add_argument("--output-dataset", type=Path, required=True)
    parser.add_argument("--stride", type=int, default=0)
    parser.add_argument("--stride-offset", type=int, default=0)
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    n = process(args.input_audio, args.output_dataset, args.stride,
                args.stride_offset, args.dtype, device=args.device)
    print(f"processed {n} segments")
    return n


if __name__ == "__main__":
    main()
