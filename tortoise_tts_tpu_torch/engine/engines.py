"""The multi-engine orchestrator (port of
``tortoise_tts_tpu/engine/engines.py``, reference Engines,
engines/base.py:319-656).

A dict of named (TrainState, step function, batch selector) entries
stepped together on each batch, with namespaced and averaged metrics,
joint checkpoints and export.

OOM: torch has no buffer donation, so a ``torch.cuda.OutOfMemoryError``
in an engine's forward or backward leaves its parameters as they were
and the engine skips the batch (``<name>.skipped`` in the metrics).  One
inside the optimizer's update may leave them half written
(``TrainState.intact`` False): the engine then reloads its last
checkpoint (``_recover_state``), as the JAX package does for a donated
state.  Nothing broader than the OOM error is caught.  The all-rank vote
of the JAX package is one rank's decision here (one device).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .optim import eval_params
from .state import (AsyncCheckpointer, TrainState, export_weights,
                    load_checkpoint, save_checkpoint, snapshot_state)

_logger = logging.getLogger(__name__)


def _eval_params(state: TrainState):
    """An engine's export: its parameters as ``optim.eval_params`` gives
    them under its optimizer's state."""
    return eval_params(state.params, state.opt_state)


class Engines:
    def __init__(self):
        self._engines: Dict[str, Dict[str, Any]] = {}
        # the last checkpoint's directory: the source of an OOM recovery
        self._ckpt_dir: Optional[Path] = None
        self._saver = AsyncCheckpointer()
        # seconds the loop stalled in the last save (the device copy of an
        # async save, the whole write of a sync one)
        self.last_save_stall_s: Optional[float] = None

    def add(self, name: str, state: TrainState, step_fn: Callable,
            batch_selector: Optional[Callable] = None,
            config: Optional[dict] = None,
            export_params: Optional[Callable] = None):
        """step_fn(state, batch) -> (state, metrics); batch_selector maps
        the global batch to this engine's batch on its device (the feeder
        role); export_params(state) gives the weights ``export`` writes
        (default: ``optim.eval_params`` of the parameters and their one
        optimizer's state)."""
        self._engines[name] = {
            "state": state, "step": step_fn,
            "select": batch_selector or (lambda b: b),
            "config": config or {}, "host_step": int(state.step),
            "export": export_params or _eval_params}

    def __getitem__(self, name: str) -> TrainState:
        return self._engines[name]["state"]

    def __contains__(self, name):
        return name in self._engines

    def names(self):
        return list(self._engines)

    @property
    def global_step(self) -> int:
        return max((e["host_step"] for e in self._engines.values()),
                   default=0)

    def step(self, batch, fetch_metrics: bool = True) -> Dict[str, float]:
        """Step every engine on its view of the batch.  Metrics are
        ``<engine>.<metric>`` plus the averaged ``loss`` and ``grad_norm``
        and each engine's ``elapsed_time``; with ``fetch_metrics`` False
        they stay on the device and ``{}`` comes back (the trainer reads
        them on its log cadence)."""
        metrics: Dict[str, float] = {}
        grad_norms = []
        for name, e in self._engines.items():
            t0 = time.time()
            try:
                state, m = e["step"](e["state"], e["select"](batch))
            except torch.cuda.OutOfMemoryError:
                _logger.error("OOM during %s step: skipping the batch", name)
                metrics[f"{name}.skipped"] = 1.0
                if not e["state"].intact:
                    self._recover_state(name, e)
                torch.cuda.empty_cache()
                continue
            e["state"] = state
            e["host_step"] += 1
            if not fetch_metrics:
                continue
            m = {k: float(v) for k, v in m.items()}
            for k, v in m.items():
                metrics[f"{name}.{k}"] = v
            metrics[f"{name}.elapsed_time"] = time.time() - t0
            if "grad_norm" in m:
                grad_norms.append(m["grad_norm"])
            if e.get("wandb") is not None:
                try:
                    e["wandb"].log(m, step=e["host_step"])
                except Exception:
                    pass
        losses = [v for k, v in metrics.items() if k.endswith(".loss")]
        if losses:
            metrics["loss"] = float(np.mean(losses))
        if grad_norms:
            metrics["grad_norm"] = float(np.mean(grad_norms))
        return metrics

    def _recover_state(self, name: str, e: Dict[str, Any]):
        """Reload an engine's state from its last checkpoint after an
        update died part-way (the step counter rewinds to it)."""
        if self._ckpt_dir is None:
            raise RuntimeError(
                f"engine {name}: an OOM inside the update left the "
                "parameters half written, and no checkpoint has been "
                "written yet: cannot continue (trainer.save_frequency)")
        self.finish_saves()
        try:
            restored = load_checkpoint(self._ckpt_dir, name, e["state"],
                                       strict=True)
        except FileNotFoundError:
            raise RuntimeError(
                f"engine {name}: an OOM inside the update left the "
                f"parameters half written, and no checkpoint exists under "
                f"{self._ckpt_dir}: cannot continue") from None
        # copy into the live tensors: a step function's closures (the
        # diffusion feeder reads the AR engine's params) keep seeing them
        live = e["state"]
        with torch.no_grad():
            from .state import tree_leaves
            for dst, src in zip(tree_leaves(live.params)
                                + tree_leaves(live.opt_state),
                                tree_leaves(restored.params)
                                + tree_leaves(restored.opt_state)):
                dst.copy_(src)
        live.step, live.samples_processed, live.tokens_processed = (
            restored.step, restored.samples_processed,
            restored.tokens_processed)
        live.intact = True
        e["host_step"] = live.step
        _logger.warning("%s: state restored from the checkpoint at step %d "
                        "after an OOM inside the update", name, live.step)

    def set_lr(self, rate: float):
        """``lr <x>``: every engine's LR scale set so the effective rate is
        ``rate`` (exact for a constant rate, proportional under a
        schedule)."""
        from .optim import set_lr_scale
        for name, e in self._engines.items():
            base = e["config"].get("base_lr")
            if not base:
                _logger.warning("%s: no base_lr recorded; skipping", name)
                continue
            set_lr_scale(e["state"].opt_state, rate / base)
            _logger.info("%s: lr -> %g (scale %.4g)", name, rate,
                         rate / base)

    def attach_wandb(self, project_prefix: str = "", wandb_params=None):
        """Per-engine wandb runs, where the package is installed."""
        try:
            import wandb
        except ImportError:
            _logger.info("wandb not installed; logging disabled")
            return
        for name, e in self._engines.items():
            kwargs = {"id": f"{project_prefix}{name}-run", "resume": "allow",
                      "config": dict(e["config"]), **(wandb_params or {})}
            try:
                e["wandb"] = wandb.init(project=name, **kwargs)
            except Exception as exc:
                _logger.warning("wandb init failed for %s: %s", name, exc)
                e["wandb"] = None

    def save_checkpoint(self, ckpt_dir: Path, keep_last: int = 0,
                        is_leader: bool = True, mode: str = "sync"):
        """``mode="async"``: copy every engine's state on its device and
        write the copies from a background thread (the loop stalls for the
        copy); ``"sync"`` writes before returning (save_on_quit, OOM).
        ``finish_saves()`` joins the writer."""
        self._ckpt_dir = Path(ckpt_dir)
        t0 = time.perf_counter()
        if mode == "async":
            if is_leader:
                snaps = [(name, snapshot_state(e["state"]), e["host_step"],
                          None, None) for name, e in self._engines.items()]
                self._saver.submit(ckpt_dir, snaps, keep_last=keep_last)
        else:
            self.finish_saves()
            for name, e in self._engines.items():
                save_checkpoint(ckpt_dir, name, e["state"],
                                int(e["state"].step), keep_last=keep_last,
                                is_leader=is_leader)
        self.last_save_stall_s = time.perf_counter() - t0

    @property
    def last_write_s(self) -> Optional[float]:
        """Wall seconds of the last finished background write."""
        return self._saver.last_write_s

    def finish_saves(self):
        """Join any background checkpoint write (raises its error)."""
        self._saver.wait()

    def load_checkpoint(self, ckpt_dir: Path, strict: bool = True):
        self._ckpt_dir = Path(ckpt_dir)
        for name, e in self._engines.items():
            try:
                e["state"] = load_checkpoint(ckpt_dir, name, e["state"],
                                             strict=strict)
            except FileNotFoundError:
                continue
            e["host_step"] = int(e["state"].step)
            _logger.info("%s resumed at step %d", name, e["host_step"])

    def export(self, ckpt_dir: Path, weights_format: str = "sft",
               userdata: Optional[dict] = None):
        """fp32 export of each engine (engines/base.py:356-400)."""
        for name, e in self._engines.items():
            s = e["state"]
            export_weights(e["export"](s),
                           Path(ckpt_dir) / name / f"fp32.{weights_format}",
                           config={"name": name, **e["config"]},
                           stats={"step": int(s.step)}, userdata=userdata)
