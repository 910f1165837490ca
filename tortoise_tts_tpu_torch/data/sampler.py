"""Resumable samplers (port of ``tortoise_tts_tpu/data/sampler.py``, a
copy: the same ``random.Random`` streams, so a sampler replays the JAX
package's order and its state crosses between the two packages).

OrderedSampler / RandomSampler / BatchedOrderedSampler (duration-budgeted
batches), all with ``get_state``/``set_state`` for resumable dataloading
(reference sampler.py:62-184 + data.py:608-661 per-rank state files).
"""

from __future__ import annotations

import random
from typing import Any, Dict, Iterator, List, Sequence


class OrderedSampler:
    """Deterministic in-order sampler with a resumable position."""

    def __init__(self, length: int):
        self.length = length
        self.position = 0

    def __len__(self):
        return self.length

    def __iter__(self) -> Iterator[int]:
        if self.position >= self.length:
            self.position = 0
        while self.position < self.length:
            idx = self.position
            self.position += 1
            yield idx

    def get_state(self) -> Dict[str, Any]:
        return {"position": self.position, "length": self.length}

    def set_state(self, state: Dict[str, Any]):
        self.position = state["position"]
        self.length = state["length"]


class RandomSampler:
    """Shuffled sampler with reproducible, resumable permutation."""

    def __init__(self, length: int, seed: int = 0):
        self.length = length
        self.generator = random.Random(seed)
        self.perm: List[int] = []
        self.position = 0
        self._reshuffle()

    def _reshuffle(self):
        self.perm = list(range(self.length))
        self.generator.shuffle(self.perm)
        self.position = 0

    def __len__(self):
        return self.length

    def __iter__(self) -> Iterator[int]:
        if self.position >= self.length:
            self._reshuffle()
        while self.position < self.length:
            idx = self.perm[self.position]
            self.position += 1
            yield idx

    def get_state(self) -> Dict[str, Any]:
        return {"position": self.position, "perm": list(self.perm),
                "random_state": self.generator.getstate()}

    def set_state(self, state: Dict[str, Any]):
        self.position = state["position"]
        self.perm = list(state["perm"])
        self.generator.setstate(tuple(
            tuple(x) if isinstance(x, list) else x
            for x in state["random_state"]))


class BatchedOrderedSampler:
    """Pre-computed batches under a duration budget
    (reference sampler.py:119-184).

    ``buckets``: list of (index, duration); batches fill until
    ``max_duration`` seconds or ``max_batch_size`` items.
    """

    def __init__(self, durations: Sequence[float], max_duration: float = 0,
                 max_batch_size: int = 0, shuffle: bool = False,
                 seed: int = 0):
        assert max_duration or max_batch_size
        self.batches: List[List[int]] = []
        current: List[int] = []
        total = 0.0
        for idx, dur in enumerate(durations):
            if current and (
                    (max_duration and total + dur > max_duration)
                    or (max_batch_size and len(current) >= max_batch_size)):
                self.batches.append(current)
                current, total = [], 0.0
            current.append(idx)
            total += dur
        if current:
            self.batches.append(current)
        self.generator = random.Random(seed)
        self.shuffle = shuffle
        self.position = 0
        if shuffle:
            self.generator.shuffle(self.batches)

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[List[int]]:
        if self.position >= len(self.batches):
            self.position = 0
            if self.shuffle:
                self.generator.shuffle(self.batches)
        while self.position < len(self.batches):
            batch = self.batches[self.position]
            self.position += 1
            yield batch

    def get_state(self) -> Dict[str, Any]:
        return {"position": self.position, "batches": self.batches,
                "random_state": self.generator.getstate()}

    def set_state(self, state: Dict[str, Any]):
        self.position = state["position"]
        self.batches = [list(b) for b in state["batches"]]
        self.generator.setstate(tuple(
            tuple(x) if isinstance(x, list) else x
            for x in state["random_state"]))
