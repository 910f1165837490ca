"""The native (C++) packed-dataset batch loader (port of
``tortoise_tts_tpu/data/native_loader.py``): ctypes bindings of the
repo's ``native/melbin.cpp``.

``pack_melbin`` writes a tree of reference-format .mel artifacts into one
mmap-able pack (format v2: a header, a fixed-size index, the records'
payloads 4-byte aligned) and a ``<pack>.paths.json`` sidecar with the
packed order; the bytes are the JAX package's, so a pack made by either
package loads in both.  ``MelBinDataset`` assembles fixed-shape training
batches in C++ threads with the GIL released.

The library is built from ``native/melbin.cpp`` at first use with the
flags of ``native/Makefile`` (``g++ -O3 -std=c++17 -fPIC -Wall -pthread
-shared``) into ``tortoise_tts_tpu_torch/_build/<hash>/libmelbin.so``,
keyed by a hash of the source and the command, as the CUDA kernels are
built; ``native/`` is only read.  A library that fails to build or load
raises: there is no fallback to the Python path behind the caller's back.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "melbin.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

MAGIC = 0x424C454D  # "MELB"
# v2: every record's payload starts on 4 bytes, and the latents after the
# codes and text start on 4 bytes, so the reader's u16 / f32 pointers are
# aligned; the reader rejects v1 packs
VERSION = 2
_INDEX_FMT = "<QIIIIQfI"   # offset, n_codes, n_text, lat, dlat,
_INDEX_SIZE = struct.calcsize(_INDEX_FMT)  # wav_length, duration, pad
_HEADER_FMT = "<IIQ"
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _cxx() -> str:
    return os.environ.get("CXX", "g++")


def lib_path() -> Path:
    """Where the library of this source and command is built."""
    key = NATIVE_SRC.read_bytes() + " ".join([_cxx()] + CXX_FLAGS).encode()
    return BUILD_ROOT / hashlib.sha256(key).hexdigest()[:16] / "libmelbin.so"


def build() -> Path:
    """Compile ``native/melbin.cpp`` unless its library exists; raises on a
    failed build."""
    out = lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent process sees
    # no library or a whole one
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                               str(NATIVE_SRC)], capture_output=True,
                              text=True)
    except OSError as e:
        raise RuntimeError(f"building {NATIVE_SRC}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {NATIVE_SRC} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The bound library, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.mb_open.restype = ctypes.c_void_p
        lib.mb_open.argtypes = [ctypes.c_char_p]
        lib.mb_close.argtypes = [ctypes.c_void_p]
        lib.mb_count.restype = ctypes.c_uint64
        lib.mb_count.argtypes = [ctypes.c_void_p]
        lib.mb_durations.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.mb_batch.restype = ctypes.c_int
        lib.mb_batch.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                                 + [ctypes.c_int] * 5
                                 + [ctypes.c_void_p] * 6 + [ctypes.c_int])
        _lib = lib
        return _lib


def _align4(x: int) -> int:
    return (x + 3) & ~3


def pack_melbin(mel_paths: Sequence[str | Path], out_path: str | Path) -> int:
    """Pack .mel artifacts into one melbin file; returns the record count.

    The ``<out>.paths.json`` sidecar records the packed order, so the
    Dataset maps its (pruned, sharded, filtered, reordered) sample indices
    onto pack rows.  The pack is written to a temporary file and renamed:
    an interrupted pack never leaves a truncated file."""
    from .dataset import load_artifact
    records = []
    for p in mel_paths:
        art = load_artifact(p)
        codes = np.asarray(art["codes"]).reshape(-1).astype(np.uint16)
        text = np.asarray(art.get("text", [])).reshape(-1).astype(np.uint8)
        lat = np.asarray(art["latent"][0]).reshape(-1).astype(np.float32)
        dlat = np.asarray(art["latent"][1]).reshape(-1).astype(np.float32)
        md = art.get("metadata", {})
        wav_length = int(md.get("original_length", len(codes) * 1024))
        duration = float(md.get("duration") or
                         wav_length / md.get("sample_rate", 22050))
        records.append((codes, text, lat, dlat, wav_length, duration))

    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    tmp_path = out_path.with_suffix(out_path.suffix + ".tmp")
    with open(tmp_path, "wb") as f:
        f.write(struct.pack(_HEADER_FMT, MAGIC, VERSION, len(records)))
        offset = _align4(_HEADER_SIZE + len(records) * _INDEX_SIZE)
        for codes, text, lat, dlat, wav_length, duration in records:
            f.write(struct.pack(_INDEX_FMT, offset, len(codes), len(text),
                                len(lat), len(dlat), wav_length, duration, 0))
            offset = _align4(offset + _align4(codes.nbytes + text.nbytes)
                             + lat.nbytes + dlat.nbytes)
        pos = _HEADER_SIZE + len(records) * _INDEX_SIZE
        f.write(b"\0" * (_align4(pos) - pos))
        pos = _align4(pos)
        for codes, text, lat, dlat, _, _ in records:
            for part in ((codes, text), (lat, dlat)):
                for a in part:
                    f.write(a.tobytes())
                    pos += a.nbytes
                f.write(b"\0" * (_align4(pos) - pos))
                pos = _align4(pos)
    os.replace(tmp_path, out_path)
    Path(str(out_path) + ".paths.json").write_text(
        json.dumps([str(p) for p in mel_paths]))
    return len(records)


class MelBinDataset:
    """A pack opened by the native reader.  ``lat_dim`` / ``dlat_dim``
    default to record 0's (any model width)."""

    def __init__(self, path: str | Path, lat_dim: Optional[int] = None,
                 dlat_dim: Optional[int] = None, num_threads: int = 4):
        self._lib = get_lib()
        self._h = self._lib.mb_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open melbin file {path} (not a v{VERSION} "
                          "pack, or truncated)")
        if lat_dim is None or dlat_dim is None:
            with open(path, "rb") as f:
                f.seek(_HEADER_SIZE)
                raw = f.read(_INDEX_SIZE)
            if len(raw) == _INDEX_SIZE:
                rec = struct.unpack(_INDEX_FMT, raw)
                lat_dim = rec[3] if lat_dim is None else lat_dim
                dlat_dim = rec[4] if dlat_dim is None else dlat_dim
            else:                      # an empty pack
                lat_dim, dlat_dim = lat_dim or 1024, dlat_dim or 2048
        self.lat_dim = int(lat_dim)
        self.dlat_dim = int(dlat_dim)
        self.num_threads = num_threads

    def __len__(self) -> int:
        return int(self._lib.mb_count(self._h))

    def durations(self) -> np.ndarray:
        out = np.zeros(len(self), dtype=np.float32)
        self._lib.mb_durations(self._h, out.ctypes.data_as(ctypes.c_void_p))
        return out

    def batch(self, indices: Sequence[int], text_bucket: int,
              mel_bucket: int) -> Dict[str, np.ndarray]:
        """Rows ``indices`` of the pack as the Dataset's fixed-shape batch:
        text stop(0)-padded to ``text_bucket``, codes to ``mel_bucket``, the
        wav lengths clamped to ``mel_bucket`` codes."""
        idx = np.asarray(indices, dtype=np.uint32)
        n = len(idx)
        out = {"text": np.empty((n, text_bucket), np.int32),
               "text_lengths": np.empty((n,), np.int32),
               "codes": np.empty((n, mel_bucket), np.int32),
               "wav_lengths": np.empty((n,), np.int32),
               "latents": np.empty((n, self.lat_dim), np.float32),
               "diffusion_latents": np.empty((n, self.dlat_dim), np.float32)}
        ptr = {k: v.ctypes.data_as(ctypes.c_void_p) for k, v in out.items()}
        rc = self._lib.mb_batch(
            self._h, idx.ctypes.data_as(ctypes.c_void_p), n, text_bucket,
            mel_bucket, self.lat_dim, self.dlat_dim, ptr["text"],
            ptr["text_lengths"], ptr["codes"], ptr["wav_lengths"],
            ptr["latents"], ptr["diffusion_latents"], self.num_threads)
        if rc != 0:
            raise ValueError("mb_batch failed (bad index or dim mismatch)")
        return out

    def close(self):
        if self._h:
            self._lib.mb_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
