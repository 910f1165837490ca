"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` into its own shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas=-v -o lib<name>.so csrc/<name>.cu

Libraries go to ``tortoise_tts_tpu_torch/_build/<hash>/``, keyed by a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source, all at once.  Nothing here
runs at import: the CPU tests import every module of the package on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()

# csrc/hopper.cuh's host error codes, above every cudaError_t value
ERR_NO_ENCODER = 10001    # cuTensorMapEncodeTiled not found in libcuda
ERR_TENSOR_MAP = 20000   # plus the CUresult of a tensor map libcuda refused


def describe(rc: int) -> str:
    """A C entry's non-zero return code in words."""
    if rc == ERR_NO_ENCODER:
        return "cuTensorMapEncodeTiled not found in libcuda"
    if ERR_TENSOR_MAP < rc < ERR_TENSOR_MAP + 1000:
        return (f"libcuda refused a TMA map (CUresult "
                f"{rc - ERR_TENSOR_MAP})")
    return f"CUDA error {rc}"


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    # the shared headers are part of every source's hash
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / h / f"lib{name}.so"


def _start(name: str, nvcc: str):
    out = _lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent process
    # either sees no library or a whole one
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per distinct source, all started together.  Returns {name: compiler output}
    for the sources built by this call (``-Xptxas=-v`` register and
    spill counts included).  Raises on the first failed build."""
    with _lock:
        todo = [n for n in dict.fromkeys(names) if not _lib_path(n).exists()]
        if not todo:
            return {}
        nvcc = find_nvcc()
        procs = {n: _start(n, nvcc) for n in todo}
        logs, failed = {}, []
        for n, (proc, tmp, out) in procs.items():
            logs[n] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(n)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
                out.with_suffix(".log").write_text(logs[n])
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                               + "\n".join(logs[n] for n in failed))
        return logs


class Kernel:
    """One CUDA source bound through ctypes, plus its launch count.

    ``entries`` maps each C entry point of the source to its ``argtypes``;
    the first is the default.  Each returns ``cudaGetLastError()`` after
    its launches.  The wrapper that launches one calls ``launch``, which
    raises on a non-zero code and adds one to ``launches``: a kernel with
    several entries (K9b's split and fused inputs) has one count."""

    def __init__(self, source: str, symbol: str, argtypes: List,
                 **more_entries: List):
        self.source = source
        self.symbol = symbol
        self.entries = {symbol: argtypes, **more_entries}
        self.launches = 0
        self._fns: Dict[str, object] = {}

    def _load(self, symbol: str):
        if symbol not in self._fns:
            build([self.source])
            lib = ctypes.CDLL(str(_lib_path(self.source)))
            fn = getattr(lib, symbol)
            fn.argtypes = self.entries[symbol]
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return self._fns[symbol]

    def launch(self, *args, entry: Optional[str] = None) -> None:
        symbol = entry or self.symbol
        rc = self._load(symbol)(*args)
        if rc != 0:
            raise RuntimeError(f"{symbol}: {describe(rc)} at launch")
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
U = ctypes.c_uint
LL = ctypes.c_longlong
F = ctypes.c_float
