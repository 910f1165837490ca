#!/usr/bin/env python3
"""Time K7 (BigVGAN's anti-aliased Snake, ``kernels/snake.py``) of a
checkout at every BigVGAN call shape on a CUDA card, beside its plain
version and its bounds.

    python3 tools/snake_profile.py [--repo DIR] [--out FILE]

Imports ``tortoise_tts_tpu_torch`` from ``--repo`` (default: this
checkout), so one call can time two checkouts on one card in turns.
Prints, as JSON lines:

- ``build``: the ``-Xptxas -v`` lines of the checkout's ``csrc/snake.cu``
  (registers, spills);
- ``sass``: the instructions of each kernel in ``cuobjdump -sass``, by
  class.  Where the source knows ``SNAKE_SASS_INTERIOR`` it is compiled
  once more with it, which leaves out the branches only a row's ends
  take and warp 0's block-edge pairs: that kernel's count is the
  instructions a warp issues for a run inside a row, and divided by the
  run's outputs (``Li<run>E`` in the kernel's name), the instructions a
  sample;
- one line a shape, in bf16 at 906 mel frames, B = 1 and 8: the six
  stages (C, T) = (768, 3624) ... (24, 231936) and ``activation_post``
  (24, 231936), with the calls an utterance makes at each: the kernel's
  device ms a call and CUDA kernels a call (torch.profiler over 30 calls
  on one input, as chip_smoke times it, and ``cold_ms`` cycling over
  inputs of more than 100 MB, so every call reads from device memory),
  the plain version's device ms, the bytes bound (one bf16 read and
  write, ``chip_smoke.bound_ms``) and the issue floor: the interior
  count of the run length the call takes (``kernels/snake.plan``), one
  warp instruction a cycle on each of an SM's 4 schedulers at the card's
  maximum SM clock;
- a ``total`` line a batch: the shapes weighted by their calls (109 an
  utterance);
- the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402  (helpers only: it imports no port)

FRAMES = 906
# (name, C, T, calls an utterance): 3 resblocks x 6 activations a stage
SHAPES = [(f"stage{i}", 768 >> i, FRAMES * hop, 18)
          for i, hop in enumerate((4, 16, 32, 64, 128, 256))] + [
              ("activation_post", 24, FRAMES * 256, 1)]
CLASSES = {"fp32": ("FFMA", "FMUL", "FADD", "FSEL", "FMNMX", "FSETP"),
           "mufu": ("MUFU",), "shfl": ("SHFL",),
           "global": ("LDG", "STG"), "shared": ("LDS", "STS"),
           "barrier": ("BAR",)}


def sass_counts(binary: Path, cuobjdump: str) -> dict:
    """{kernel: {"instructions": n, class: n, ...}} of a library or cubin,
    without the NOPs and the self-branch that pad the end of a kernel."""
    text = subprocess.run([cuobjdump, "-sass", str(binary)],
                          capture_output=True, text=True, check=True).stdout
    ops, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            ops[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w*\s+)?"
                     r"([A-Z0-9_.]+)[^;]*;", line)
        if m and name:
            op = m.group(1).split(".")[0]
            if op != "NOP":
                ops[name].append(op)
    out = {}
    for name, seq in ops.items():
        if seq and seq[-1] == "BRA":
            seq = seq[:-1]
        c = {"instructions": len(seq), **{k: 0 for k in CLASSES}, "other": 0}
        for op in seq:
            c[next((k for k, v in CLASSES.items() if op in v), "other")] += 1
        out[name] = c
    return out


def interior_counts(src: Path, nvcc: str, cuobjdump: str, flags) -> dict:
    if "SNAKE_SASS_INTERIOR" not in src.read_text():
        return {}
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "snake_interior.cubin"
        arch = [f for f in flags if f.startswith(("-gencode", "arch="))]
        subprocess.run([nvcc, *arch, "-std=c++17", "-O3", "-cubin",
                        "-DSNAKE_SASS_INTERIOR", "-o", str(cubin), str(src)],
                       check=True, capture_output=True, text=True)
        return sass_counts(cubin, cuobjdump)


def profiled(fn, n: int = 30) -> tuple:
    """(device ms a call, CUDA kernels a call) of fn(i) over n calls."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.profiler_warmup(torch)
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    ev = cs._cuda_events(prof)
    return sum(e.device_time for e in ev) / 1e3 / n, len(ev) / n


def max_sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("snake_profile: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    from tortoise_tts_tpu_torch.kernels import _build
    from tortoise_tts_tpu_torch.kernels import snake as k7
    assert Path(k7.__file__).resolve().is_relative_to(repo), k7.__file__
    out = open(args.out, "a") if args.out else None

    def emit(**kw):
        line = json.dumps({"repo": args.repo, **kw})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    _build.build(["snake"])
    lib = _build._lib_path("snake")
    log = lib.with_suffix(".log").read_text()
    emit(phase="build", ptxas=[ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln
                               or "Function properties" in ln])
    nvcc = _build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    emit(phase="sass", kernels=sass_counts(lib, cuobjdump))
    inner = interior_counts(_build.CSRC / "snake.cu", nvcc, cuobjdump,
                            _build.NVCC_FLAGS)
    # bf16 interior instructions a run, by run length
    per_run = {}
    for name, c in inner.items():
        m = re.search(r"nv_bfloat16Li(\d+)E", name)
        if m:
            per_run[int(m.group(1))] = c["instructions"]
            c["instructions_a_sample"] = c["instructions"] / int(m.group(1))
    if inner:
        emit(phase="sass_interior", kernels=inner)
    props = torch.cuda.get_device_properties(0)
    clock = max_sm_clock_hz()
    dev = torch.device("cuda")
    with torch.inference_mode():
        for b in (1, 8):
            tot = dict(calls=0, ms=0.0, cold_ms=0.0, plain_ms=0.0,
                       bound_ms=0.0, issue_floor_ms=0.0)
            for name, c, t, calls in SHAPES:
                g = torch.Generator(device=dev).manual_seed(c)
                nbytes = 2 * 2 * b * c * t + 8 * c
                copies = max(1, -(-100_000_000 // nbytes) + 1)
                xs = [torch.randn(b, c, t, generator=g, device=dev).to(
                    torch.bfloat16) for _ in range(copies)]
                alpha = torch.exp(0.3 * torch.randn(c, generator=g,
                                                    device=dev))
                ib = 1 / (torch.exp(0.3 * torch.randn(c, generator=g,
                                                      device=dev)) + 1e-9)
                ms, n = profiled(lambda i: k7.snake_resample2(xs[0], alpha,
                                                              ib))
                cold, _ = profiled(lambda i: k7.snake_resample2(
                    xs[i % copies], alpha, ib))
                plain, _ = profiled(lambda i: k7.snake_resample2_plain(
                    xs[0], alpha, ib), n=10)
                bound, by = cs.bound_ms(nbytes, 0.0)
                floor = run = None
                if per_run:
                    run = k7.plan(b * c, c, t, torch.bfloat16).run
                    warps = -(-b * c * -(-t // run) // 32)
                    floor = (warps * per_run[run]
                             / (props.multi_processor_count * 4 * clock)
                             * 1e3)
                emit(phase="shape", name=name, b=b, c=c, t=t, run=run,
                     calls=calls,
                     ms=ms, cold_ms=cold, cuda_kernels_per_call=n,
                     plain_ms=plain, bound_ms=bound, bound_by=by,
                     bound_share=bound / ms, issue_floor_ms=floor,
                     sm_clock_max_mhz=clock / 1e6)
                tot["calls"] += calls
                for key, val in (("ms", ms), ("cold_ms", cold),
                                 ("plain_ms", plain), ("bound_ms", bound),
                                 ("issue_floor_ms", floor or 0.0)):
                    tot[key] += calls * val
                del xs
                torch.cuda.empty_cache()
            emit(phase="total", b=b, **tot)
    smi = cs.nvidia_smi()
    print(smi)
    if out:
        out.write(json.dumps({"nvidia_smi": smi}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
