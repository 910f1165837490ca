"""Batch transcription to whisper.json (port of
``tortoise_tts_tpu/emb/transcribe.py``; reference emb/transcribe.py:
140-383).

    python -m tortoise_tts_tpu_torch.emb.transcribe --input-audio voices \
        --output-metadata training/metadata \
        [--model-name openai/whisper-base] [--device cpu]

The Hugging Face ASR pipeline (``transformers``, imported when a
pipeline is built) runs on the CUDA device unless ``--device`` says
otherwise; with no network, point ``--model-name`` at a local snapshot.
As in the reference:
- word-level timestamps: segments are rebuilt from word gaps and
  sentence punctuation rather than the coarse 30 s chunks;
- pipelines are built once per (model, timestamp mode, device) and
  reused across files and speakers;
- ``--stride/--stride-offset`` shard speakers across processes.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import Dict, Optional

_logger = logging.getLogger(__name__)

_PIPELINES: Dict[tuple, object] = {}   # the model cache

SENTENCE_END = (".", "!", "?")
MAX_GAP_S = 0.75          # a word gap that forces a segment break
MAX_SEGMENT_S = 30.0


def get_pipeline(model_name: str, word_timestamps: bool = True,
                 device=None):
    """The ASR pipeline of ``model_name`` on ``device`` (None: the CUDA
    device), built once."""
    from ..models import resolve_device
    device = resolve_device(device, "transcribe")
    key = (model_name, word_timestamps, str(device))
    if key not in _PIPELINES:
        from transformers import pipeline
        _PIPELINES[key] = pipeline(
            "automatic-speech-recognition", model=model_name,
            chunk_length_s=30, device=device,
            return_timestamps="word" if word_timestamps else True)
    return _PIPELINES[key]


def _segments_from_words(words, total_dur: float):
    """Sentence-level segments from word timestamps (the shape whisperX
    emits and ``emb.process`` reads)."""
    segments = []
    cur = None
    prev_end = 0.0
    open_end = False
    for w in words:
        t0, t1 = w["timestamp"]
        t0 = prev_end if t0 is None else t0
        open_end = t1 is None      # common for the final word chunk
        t1 = t0 if t1 is None else t1
        if cur is not None and (t0 - cur["end"] > MAX_GAP_S
                                or t1 - cur["start"] > MAX_SEGMENT_S):
            segments.append(cur)
            cur = None
        if cur is None:
            cur = {"start": t0, "end": t1, "text": "", "words": []}
        cur["end"] = max(cur["end"], t1)
        cur["text"] = (cur["text"] + w["text"]).rstrip() \
            if cur["text"] else w["text"].strip()
        cur["words"].append({"word": w["text"].strip(),
                             "start": t0, "end": t1})
        prev_end = t1
        if cur["text"].endswith(SENTENCE_END):
            segments.append(cur)
            cur = None
    if cur is not None:
        if not cur["end"] or open_end:
            # the last word's end was missing: extend the segment to the
            # end of the audio so slicing keeps the final word
            cur["end"] = total_dur
        segments.append(cur)
    return segments


def transcribe(audio_path: Path, model_name: str = "openai/whisper-base",
               language: str = "en", word_timestamps: bool = True,
               device=None) -> Optional[dict]:
    """One file -> its whisper.json entry (reference transcribe(),
    transcribe.py:140-266)."""
    from ..utils.io import read_wav
    pipe = get_pipeline(model_name, word_timestamps, device)
    wav, sr = read_wav(audio_path)
    dur = len(wav) / sr
    result = pipe({"array": wav, "sampling_rate": sr})
    chunks = result.get("chunks", [])
    if word_timestamps:
        segments = _segments_from_words(chunks, dur)
    else:
        segments = [{"start": c["timestamp"][0] or 0.0,
                     "end": c["timestamp"][1] if c["timestamp"][1]
                     is not None else dur,
                     "text": c["text"]} for c in chunks]
    return {"text": result["text"].strip(), "language": language,
            "start": 0.0, "end": dur, "segments": segments}


def transcribe_batch(input_audio: Path, output_metadata: Path,
                     model_name: str = "openai/whisper-base",
                     language: str = "en", stride: int = 0,
                     stride_offset: int = 0, batch_size: int = 4,
                     word_timestamps: bool = True, device=None) -> int:
    """Walk voices/<group>/<speaker>/ and write a whisper.json per speaker
    (reference transcribe_batch, transcribe.py:268-336); returns the
    count of files transcribed.  A file whose transcription fails is
    logged and skipped, as in the reference."""
    speakers = sorted(p for p in input_audio.rglob("*") if p.is_dir())
    if not speakers or any(p.suffix.lower() in (".wav", ".mp3", ".flac")
                           for p in input_audio.iterdir()):
        speakers = [input_audio] + speakers
    if stride:
        speakers = [s for i, s in enumerate(speakers)
                    if (i + stride_offset) % stride == 0]
    done = 0
    for spk in speakers:
        rel = spk.relative_to(input_audio) if spk != input_audio else Path(".")
        outdir = output_metadata / rel
        outpath = outdir / "whisper.json"
        meta = json.loads(outpath.read_text()) if outpath.exists() else {}
        for audio in sorted(spk.glob("*.wav")):
            if audio.name in meta:
                continue
            try:
                entry = transcribe(audio, model_name, language,
                                   word_timestamps, device)
            except Exception as e:
                _logger.warning("transcription failed for %s: %s",
                                audio, e)
                continue
            meta[audio.name] = entry
            done += 1
            outdir.mkdir(parents=True, exist_ok=True)
            outpath.write_text(json.dumps(meta, indent=1))
    return done


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("tortoise_tts_tpu_torch.emb.transcribe")
    parser.add_argument("--input-audio", type=Path, required=True)
    parser.add_argument("--output-metadata", type=Path, required=True)
    parser.add_argument("--model-name", type=str,
                        default="openai/whisper-base")
    parser.add_argument("--language", type=str, default="en")
    parser.add_argument("--stride", type=int, default=0)
    parser.add_argument("--stride-offset", type=int, default=0)
    parser.add_argument("--no-word-timestamps", dest="word_timestamps",
                        action="store_false", default=True)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA device)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    n = transcribe_batch(args.input_audio, args.output_metadata,
                         args.model_name, args.language, args.stride,
                         args.stride_offset,
                         word_timestamps=args.word_timestamps,
                         device=args.device)
    print(f"transcribed {n} files")
    return n


if __name__ == "__main__":
    main()
