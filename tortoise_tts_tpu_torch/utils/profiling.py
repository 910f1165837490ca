"""Profiling helpers (port of ``tortoise_tts_tpu/utils/profiling.py``):
a wall-clock timer, a ``torch.profiler`` trace in place of the JAX
package's ``jax.profiler`` one, a FLOPs estimate and an optional wandb
sink (the reference's DeepSpeed flops profiler and timer, config.py:
549-556, utils/utils.py:89-104)."""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

_logger = logging.getLogger(__name__)


@contextlib.contextmanager
def timer(name: str = "", callback=None):
    """Wall-clock timer context (reference utils/utils.py:89-104)."""
    t0 = time.time()
    try:
        yield
    finally:
        # log even when the timed block raises: failing runs are the ones
        # whose timing matters most
        dt = time.time() - t0
        if callback:
            callback(dt)
        else:
            _logger.info("%s took %.3fs", name or "block", dt)


@contextlib.contextmanager
def trace(log_dir: str | Path = "logs/trace"):
    """``torch.profiler`` over the block (the host, and the CUDA device's
    kernels where there is one), written as a Chrome trace to
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto).  Yields the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    path = Path(log_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    _logger.info("profiler trace written to %s", path)


def estimate_flops_per_token(layers: int, model_dim: int) -> int:
    """Dense-transformer FLOPs a token (forward): the flops profiler's
    stand-in."""
    return 2 * layers * (4 * model_dim * model_dim      # qkv + proj
                         + 8 * model_dim * model_dim)   # the 4x MLP


class WandbLogger:
    """Optional wandb metric sink (reference engines/__init__.py:308-338);
    disabled when wandb is not installed."""

    def __init__(self, project: str = "tortoise-tts-tpu", name: str = "",
                 config: dict | None = None, enabled: bool = True):
        self._run = None
        if not enabled:
            return
        try:
            import wandb
            self._run = wandb.init(project=project, name=name or None,
                                   config=config or {})
        except Exception:
            _logger.info("wandb unavailable; metrics logged locally only")

    def log(self, metrics: dict, step: int | None = None):
        if self._run is not None:
            self._run.log(metrics, step=step)

    def finish(self):
        if self._run is not None:
            self._run.finish()
