"""Checkpoint and audio IO (the port's copy of ``tortoise_tts_tpu/utils/io.py``).

- ``load_state_dict``: .pth/.pt (torch pickle) or .sft/.safetensors into
  a flat name -> tensor dict.  The safetensors format is read and written
  here (``load_safetensors``, ``save_state_dict``), without the
  ``safetensors`` package.
- WAV read/write through the stdlib ``wave`` module.
"""

from __future__ import annotations

import json
import math
import struct
import wave
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def load_safetensors(path: str | Path) -> Dict[str, torch.Tensor]:
    """Read a .safetensors file into {name: CPU tensor}: an 8-byte
    little-endian header length, a JSON header of {name: {"dtype",
    "shape", "data_offsets": [begin, end]}} (plus an optional
    "__metadata__"), then the raw little-endian buffers, offsets counted
    from the end of the header.  The tensors share one buffer with the
    file's bytes.  Raises ValueError on a file that does not hold what
    its header says."""
    path = Path(path)
    buf = bytearray(path.stat().st_size)
    with open(path, "rb") as f:
        f.readinto(buf)
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors header")
    n = struct.unpack("<Q", bytes(buf[:8]))[0]
    base = 8 + n
    if base > len(buf):
        raise ValueError(f"{path}: header of {n} bytes past the end")
    try:
        header = json.loads(bytes(buf[8:base]))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable safetensors header") from e
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info.get("dtype"))
        begin, end = info["data_offsets"]
        count = math.prod(info["shape"])
        size = torch.empty((), dtype=dtype).element_size() if dtype else 0
        if dtype is None or end - begin != count * size \
                or base + end > len(buf) or begin < 0:
            raise ValueError(f"{path}: tensor {name!r} does not match its "
                             f"header entry {info}")
        t = (torch.frombuffer(buf, dtype=dtype, count=count,
                              offset=base + begin)
             if count else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(info["shape"])
    return out


def save_state_dict(state: Dict[str, Any], path: str | Path,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    """Write {name: tensor or numpy array} as a .safetensors file, the
    layout ``load_safetensors`` reads: the buffers in the dict's order,
    contiguous, the header padded with spaces to 8 bytes.  Metadata values
    that are not strings are stored as JSON, as the JAX package stores
    them.  The file is written under a temporary name and renamed."""
    names = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {
            k: v if isinstance(v, str) else json.dumps(v)
            for k, v in metadata.items()}
    bufs, offset = [], 0
    for name, value in state.items():
        t = torch.as_tensor(value).detach().cpu().contiguous()
        if t.dtype not in names:
            raise TypeError(f"{name}: no safetensors type for {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        bufs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in bufs:
            f.write(raw)
    tmp.replace(path)


def load_metadata(path: str | Path) -> Dict[str, Any]:
    """The "__metadata__" of a safetensors header, each value read as JSON
    where it is JSON."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        meta = json.loads(f.read(n)).get("__metadata__", {})
    out = {}
    for k, v in meta.items():
        try:
            out[k] = json.loads(v)
        except (json.JSONDecodeError, TypeError):
            out[k] = v
    return out


def pick_path(path: Path, *extensions: str) -> Path:
    """``path`` if it exists, else its first sibling with one of the
    extensions that exists, else ``path``."""
    if path.exists():
        return path
    for ext in extensions:
        p = path.with_suffix(ext)
        if p.exists():
            return p
    return path


def load_state_dict(path: str | Path, key: Optional[str] = None
                    ) -> Dict[str, torch.Tensor]:
    """Load a checkpoint file into {name: CPU tensor}.  ``key`` selects a
    sub-dict (e.g. 'generator'); trainer checkpoints that nest the
    weights under 'model' are unwrapped."""
    path = Path(path)
    if path.suffix in (".sft", ".safetensors"):
        return load_safetensors(path)
    sd = torch.load(str(path), map_location="cpu", weights_only=False)
    if key is not None and key in sd:
        sd = sd[key]
    if (isinstance(sd, dict) and isinstance(sd.get("model"), dict)
            and not torch.is_tensor(sd["model"])):
        sd = sd["model"]
    return {k: (v.detach() if torch.is_tensor(v) else v)
            for k, v in sd.items()}


def write_wav(path: str | Path, wav, sr: int = 24_000) -> None:
    """wav: float array (T,) or (1, T) in [-1, 1] -> 16-bit PCM WAV."""
    if torch.is_tensor(wav):
        wav = wav.detach().float().cpu().numpy()
    wav = np.asarray(wav).squeeze()
    if wav.ndim != 1:
        wav = wav.reshape(-1)
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read 8/16/24/32-bit PCM WAV -> (float32 (T,) mono, sr)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2**31
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 2**23, vals - 2**24, vals)
        data = vals.astype(np.float32) / 2**23
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        data = data.reshape(-1, ch)[:, 0]   # first channel
    return data, sr
