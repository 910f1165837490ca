"""The training loop (port of ``tortoise_tts_tpu/utils/trainer.py``,
reference utils/trainer.py).

- an endless batch iterator and ``Engines.step`` a batch;
- JSON metric lines on the log cadence (``trainer.log_frequency``: the
  metrics are read to the host only then);
- the stdin command REPL, polled without blocking: ``save``, ``quit``,
  ``eval``, ``export``, ``lr <x>``, ``time [to N]``, deferred
  ``<cmd>@<step>`` events, ``event show`` / ``event clear``;
- save, export and eval by their frequencies.

One repair against the JAX package: a save that fails inside the
``KeyboardInterrupt`` handler is the root cause that propagates, and a
later background-writer error is then logged, not raised over it (the
JAX loop leaves its ``propagating`` flag unset there, ROADMAP.md §3).
"""

from __future__ import annotations

import json
import logging
import selectors
import sys
import time
from pathlib import Path
from typing import Callable, Optional

from ..config import Config

_logger = logging.getLogger(__name__)

_sel: Optional[selectors.BaseSelector] = None


def _non_blocking_input() -> str:
    """A line from stdin if one is waiting, else ""."""
    global _sel
    if sys.stdin is None or sys.stdin.closed:
        return ""
    try:
        if _sel is None:
            _sel = selectors.DefaultSelector()
            _sel.register(sys.stdin, selectors.EVENT_READ)
        result = ""
        for key, _ in _sel.select(timeout=0):
            result = key.fileobj.readline().strip()
        return result
    except (ValueError, OSError, PermissionError):
        return ""


def train_engines(cfg: Config, dataset, engines,
                  eval_fn: Optional[Callable] = None,
                  save_fn: Optional[Callable] = None,
                  log_path: Optional[Path] = None,
                  max_iterations: Optional[int] = None):
    """Engines-based training loop (reference trainer.py:133-292).
    ``loss_scale`` is accepted and noted (bf16 training has none)."""
    tcfg = cfg.trainer
    it = max_iterations if max_iterations is not None else tcfg.iterations
    log_f = open(log_path, "a") if log_path else None
    if tcfg.wandb:
        engines.attach_wandb()

    events: list = []
    last_save_step = engines.global_step
    last_eval_step = -1
    start = time.time()

    def do_save():
        if save_fn:
            save_fn(engines, engines.global_step)

    def do_export():
        from ..tokenizer import get_phone_symmap
        try:
            symmap = get_phone_symmap()
        except FileNotFoundError:      # no tokenizer.json: no symmap
            symmap = {}
        engines.export(cfg.ckpt_dir, cfg.weights_format,
                       userdata={"symmap": symmap})

    pre = _non_blocking_input()
    if pre in ("eval", "eval_quit") and eval_fn:
        eval_fn(engines)
    if pre in ("quit", "eval_quit"):
        return engines

    propagating = False
    try:
        log_every = max(1, tcfg.log_frequency)
        for batch in dataset.batches():
            if engines.global_step >= it:
                break
            step_start = time.time()
            will_log = (engines.global_step + 1) % log_every == 0
            metrics = engines.step(batch, fetch_metrics=will_log)
            step = engines.global_step
            elapsed = time.time() - step_start
            if will_log:
                metrics.update({
                    "it": step,
                    "epoch": step * cfg.hyperparameters.batch_size
                    / max(1, len(dataset)),
                    "elapsed_time": elapsed})
                line = json.dumps(metrics)
                _logger.info(line)
                if log_f:
                    log_f.write(line + "\n")
                    log_f.flush()

            command = _non_blocking_input()
            if "@" in command:          # deferred event
                what, _, when = command.rpartition("@")
                try:
                    events.append((what, int(when)))
                    _logger.info("event %s registered", command)
                except ValueError as e:
                    _logger.error("bad event %r: %s", command, e)
                command = ""
            events = [e for e in events if e[1] >= step]
            commands = [command] + [e[0] for e in events if e[1] == step]

            for command in commands:
                if not command:
                    continue
                if command in ("event show", "event"):
                    _logger.info("events:\n%s", "\n".join(
                        f"{w}@{s}" for w, s in events))
                elif command == "event clear":
                    events.clear()
                elif command.startswith("time"):
                    target = it
                    if " to " in command:
                        try:
                            target = int(command.split(" to ")[-1])
                        except ValueError:
                            pass
                    rem = max(0, target - step + 1) * elapsed
                    _logger.info("est. remaining: %.1f h (%.0f s)",
                                 rem / 3600, rem)
                elif command.startswith("lr "):
                    try:
                        engines.set_lr(float(command.split()[-1]))
                    except (ValueError, IndexError) as e:
                        _logger.warning("bad lr command: %s", e)
                elif command.startswith("loss_scale"):
                    _logger.info("bf16 training has no loss scale; noted")
                elif command == "export":
                    do_save()
                    last_save_step = step
                    do_export()
                elif command == "save":
                    do_save()
                    last_save_step = step
                elif command == "eval" and eval_fn:
                    last_eval_step = step
                    eval_fn(engines)
                elif command == "quit":
                    if tcfg.save_on_quit:
                        do_save()
                    return engines

            save_every = tcfg.save_frequency or cfg.evaluation.frequency
            if (step != last_save_step and save_every
                    and step % save_every == 0):
                do_save()
                last_save_step = step
                if tcfg.export_on_save:
                    do_export()
            if (eval_fn and cfg.evaluation.frequency
                    and step % cfg.evaluation.frequency == 0
                    and step != last_eval_step):
                last_eval_step = step
                eval_fn(engines)
    except KeyboardInterrupt:
        if tcfg.save_on_quit:
            # a save that raises here is the error that propagates
            propagating = True
            do_save()
            propagating = False
    except BaseException:
        propagating = True
        raise
    finally:
        # join a background checkpoint write before returning, without
        # letting its error replace a propagating one
        if hasattr(engines, "finish_saves"):
            try:
                engines.finish_saves()
            except BaseException:
                if not propagating:
                    if log_f:
                        log_f.close()
                    raise
                _logger.exception("async checkpoint write failed")
        if log_f:
            log_f.close()
    _logger.info("training done in %.1fs", time.time() - start)
    return engines


def train(cfg: Config, dataset, step_fn: Callable, state,
          eval_fn: Optional[Callable] = None,
          save_fn: Optional[Callable] = None,
          log_path: Optional[Path] = None,
          max_iterations: Optional[int] = None):
    """The single-state loop: step_fn(state, batch) -> (state, metrics);
    save_fn(state, step) and eval_fn(state).  Returns the final state.
    An OOM saves (``save_on_oom``) and raises."""
    import torch
    tcfg = cfg.trainer
    it = max_iterations if max_iterations is not None else tcfg.iterations
    log_f = open(log_path, "a") if log_path else None
    last_save_step = host_step = int(state.step)
    log_every = max(1, tcfg.log_frequency)
    start = time.time()
    try:
        for batch in dataset.batches():
            step_start = time.time()
            try:
                state, metrics = step_fn(state, batch)
            except torch.cuda.OutOfMemoryError as e:
                _logger.error("OOM during step: %s", e)
                if tcfg.save_on_oom and save_fn and state.intact:
                    save_fn(state, int(state.step))
                raise
            host_step += 1
            step = host_step
            if step % log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics.update({
                    "it": step,
                    "epoch": step * cfg.hyperparameters.batch_size
                    / max(1, len(dataset)),
                    "elapsed_time": time.time() - step_start})
                line = json.dumps(metrics)
                _logger.info(line)
                if log_f:
                    log_f.write(line + "\n")
                    log_f.flush()
            cmd = _non_blocking_input()
            if cmd == "quit":
                if tcfg.save_on_quit and save_fn:
                    save_fn(state, step)
                break
            if cmd == "save" and save_fn:
                save_fn(state, step)
                last_save_step = step
            if cmd == "eval" and eval_fn:
                eval_fn(state)
            if cmd.startswith("lr "):
                _logger.warning("runtime lr override needs Engines "
                                "(train_engines); noted: %s", cmd)
            if (save_fn and tcfg.save_frequency
                    and step % tcfg.save_frequency == 0
                    and step != last_save_step):
                save_fn(state, step)
                last_save_step = step
            if (eval_fn and cfg.evaluation.frequency
                    and step % cfg.evaluation.frequency == 0):
                eval_fn(state)
            if step >= it:
                if save_fn:
                    save_fn(state, step)
                break
    except KeyboardInterrupt:
        if tcfg.save_on_quit and save_fn:
            save_fn(state, int(state.step))
    finally:
        if log_f:
            log_f.close()
    _logger.info("training done in %.1fs", time.time() - start)
    return state
