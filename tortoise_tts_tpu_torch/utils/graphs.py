"""One step of a device-resident loop, captured once as a CUDA graph and
replayed: the port's counterpart of the JAX package's ``lax.while_loop``
decode (``models/unified_voice.decode_chunk``) and ``lax.scan`` sampler
(``models/gaussian.sample_loop``), which run as one device program each.

``StepGraph(step, device, generators)`` takes a step function that reads
and writes only device buffers that outlive it (no host value, no
rebinding: every result is written in place) and

1. warms it up: runs it once, eagerly, on the capture stream, so that
   what is built on first use exists before the capture (the kernel
   libraries, ``kernels/_build.py``; cuBLAS's and cuDNN's workspaces; K2's
   and K8's split-K counters, which ``kernels/qgemv.counters`` keys by
   stream).  That run is a real step of the loop;
2. registers each ``torch.Generator`` the step draws from with the graph,
   so a replay draws what the eager step would draw next, and captures
   the step on the capture stream;
3. replays it on the current stream with ``replay()``.

A kernel wrapper counts its host calls (``Kernel.launches``), and a
replay makes none.  So the launches made while capturing, which run
nothing, are taken back off, and every replay adds them again:
``kernels.launch_counts()`` still counts device launches.  ``STATS``
counts captures, replays and the seconds spent capturing.

Only CUDA tensors take this path; a failed capture or replay raises, and
nothing falls back to the eager loop.  A failed capture leaves no
generator in capture mode (``_end_generator_capture``).  Temporaries of
the captured step come from the graph's private memory pool, held as
long as the ``StepGraph``; so is the step function, and with it every
tensor it reads.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Sequence

import torch

from .. import kernels


@dataclass
class GraphStats:
    """Captures, replays and capture seconds (warm-up step included)."""
    captures: int = 0
    replays: int = 0
    capture_s: float = 0.0

    def reset(self) -> None:
        self.captures, self.replays, self.capture_s = 0, 0, 0.0


STATS = GraphStats()

_STREAMS: Dict[int, torch.cuda.Stream] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every capture on ``device`` and its warm-up run on
    (capture needs a stream other than the legacy default stream)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


def _end_generator_capture(generators: Sequence[torch.Generator],
                           device: torch.device) -> None:
    """Take the default CUDA generator and ``generators`` out of capture
    mode after a capture whose ``capture_end`` raised before it could: a
    generator left in it refuses every later draw outside a capture ("Offset
    increment outside graph capture").  A one-kernel capture of a throwaway
    graph over the same generators, on the current (capture) stream,
    begins and ends cleanly."""
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    graph.capture_begin()
    torch.zeros(1, device=device)
    graph.capture_end()


class StepGraph:
    """``step`` run once eagerly (a real step), then captured; ``replay``
    runs it again.  ``generators``: every generator ``step`` draws from."""

    def __init__(self, step: Callable[[], None], device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        if torch.device(device).type != "cuda":
            raise ValueError(f"StepGraph captures CUDA work, got {device}")
        t0 = time.perf_counter()
        self._step = step
        self.graph = torch.cuda.CUDAGraph()
        stream = capture_stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        try:
            with torch.cuda.stream(stream):
                step()
                for g in generators:
                    self.graph.register_generator_state(g)
                before = kernels.launch_counts()
                self.graph.capture_begin()
                try:
                    step()
                except BaseException:
                    try:
                        self.graph.capture_end()
                    except RuntimeError:
                        # the capture is invalid; the step's error wins
                        _end_generator_capture(generators, device)
                    raise
                self.graph.capture_end()
                after = kernels.launch_counts()
        finally:
            # what the warm-up wrote is read on the current stream, also
            # when the step raised
            current.wait_stream(stream)
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] > before[k]}
        for name, n in self.launches.items():
            kernels.KERNELS[name].launches -= n
        STATS.captures += 1
        STATS.capture_s += time.perf_counter() - t0

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launches.items():
            kernels.KERNELS[name].launches += n
        STATS.replays += 1
