"""TrainState and checkpoints (port of ``tortoise_tts_tpu/engine/state.py``).

A ``TrainState`` holds an engine's parameter tree (nested dicts and lists
of tensors), its optimizer state (``engine/optim.py``, a tree of the
same kind) and three counters on the host.  The train step updates the
tensors in place.

Checkpoints keep the JAX package's layout, so a parameter checkpoint
crosses between the two packages in both directions:
``<ckpt_dir>/<name>/<step>/module.sft`` (the parameters, '/'-joined keys,
the step and any userdata in the metadata), ``optimizer.sft`` (the
optimizer state under the port's own keys, plus ``__step__``,
``__samples__`` and ``__tokens__``), a ``latest`` tag file and pruning to
the newest ``keep_last`` steps.  The files are written by the port's own
safetensors writer (``utils/io.save_state_dict``).  ``AsyncCheckpointer``
copies the state on the device (the loop's only stall) and writes it from
a background thread.
"""

from __future__ import annotations

import logging
import shutil
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.io import load_state_dict, save_state_dict
from ..utils.state import unflatten_like

_logger = logging.getLogger(__name__)


@dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0                 # global micro-step
    samples_processed: int = 0
    tokens_processed: int = 0
    # False once an update died part-way: the tensors may be half written
    intact: bool = True


def init_state(params, tx) -> TrainState:
    return TrainState(params, tx.init(params))


# pytree <-> flat dict

def _walk(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _walk(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _walk(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> List[Any]:
    """The leaves of nested dicts / lists, in their order."""
    return [leaf for _, leaf in _walk(tree)]


def tree_unflatten_like(tree, leaves: List[Any]):
    """``tree`` with its leaves replaced, in ``tree_leaves`` order."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v) for v in node)
        return next(it)
    return fill(tree)


def flatten_tree(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{'/'-joined dict keys and list indices: leaf}, the JAX package's
    ``flatten_tree`` names."""
    return {prefix + name: leaf for name, leaf in _walk(tree)}


# checkpointing

def save_checkpoint(ckpt_dir: Path, name: str, state: TrainState,
                    step: int, keep_last: int = 0,
                    extra_state: Optional[Dict[str, Any]] = None,
                    userdata: Optional[dict] = None,
                    is_leader: bool = True) -> Optional[Path]:
    """Write ``<ckpt_dir>/<name>/<step>/{module,optimizer}.sft``, point the
    ``latest`` tag at it and prune; returns the step's directory."""
    if not is_leader:
        return None
    d = Path(ckpt_dir) / name / str(step)
    d.mkdir(parents=True, exist_ok=True)
    save_state_dict(flatten_tree(state.params), d / "module.sft",
                    metadata={"step": step, **(userdata or {})})
    opt = flatten_tree(state.opt_state)
    opt["__step__"] = np.asarray(int(state.step))
    opt["__samples__"] = np.asarray(int(state.samples_processed))
    opt["__tokens__"] = np.asarray(int(state.tokens_processed))
    for k, v in (extra_state or {}).items():
        opt[f"extra/{k}"] = v
    save_state_dict(opt, d / "optimizer.sft")
    (Path(ckpt_dir) / name / "latest").write_text(str(step))
    if keep_last > 0:
        _prune_checkpoints(Path(ckpt_dir) / name, keep_last)
    _logger.info("saved checkpoint %s", d)
    return d


def snapshot_state(state: TrainState) -> TrainState:
    """A copy of the state's tensors made on their device (the loop's
    stall is this copy only); the writer reads the copy while the next
    steps update the live tensors in place."""
    def copy(tree):
        return tree_unflatten_like(tree, [t.clone()
                                          for t in tree_leaves(tree)])
    return TrainState(copy(state.params), copy(state.opt_state), state.step,
                      state.samples_processed, state.tokens_processed)


class AsyncCheckpointer:
    """Background checkpoint writer: ``submit`` takes snapshots made on
    the caller's thread (``snapshot_state``) and writes them from a worker
    thread, whose host copies run on a stream of their own after the
    snapshot's copies.  One save is in flight at a time; ``wait`` joins
    the writer and raises its error on the caller's thread.  Terminal
    saves (save_on_quit, OOM recovery) use ``save_checkpoint`` itself."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        # wall seconds of the last finished background write
        self.last_write_s: Optional[float] = None

    @property
    def pending(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, ckpt_dir: Path, snaps, keep_last: int = 0) -> None:
        """``snaps``: [(name, snapshot, step, extra_state, userdata)]."""
        self.wait()
        ready = None
        leaves = [t for s in snaps for t in tree_leaves(s[1].params)]
        if leaves and leaves[0].is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(leaves[0].device))

        def write():
            t0 = time.perf_counter()
            try:
                if ready is not None:
                    side = torch.cuda.Stream(leaves[0].device)
                    side.wait_event(ready)
                    with torch.cuda.stream(side):
                        for name, snap, step, extra, userdata in snaps:
                            save_checkpoint(ckpt_dir, name, snap, step,
                                            keep_last=keep_last,
                                            extra_state=extra,
                                            userdata=userdata)
                else:
                    for name, snap, step, extra, userdata in snaps:
                        save_checkpoint(ckpt_dir, name, snap, step,
                                        keep_last=keep_last,
                                        extra_state=extra, userdata=userdata)
                self.last_write_s = time.perf_counter() - t0
            except BaseException as exc:   # raised by the next wait()
                self._err = exc

        self._thread = threading.Thread(target=write, daemon=True,
                                        name="ckpt-write")
        self._thread.start()


def _prune_checkpoints(base: Path, keep_last: int) -> None:
    """Remove all but the newest ``keep_last`` step directories."""
    steps = sorted(int(p.name) for p in base.iterdir()
                   if p.is_dir() and p.name.isdigit())
    for s in steps[:-keep_last]:
        shutil.rmtree(base / str(s), ignore_errors=True)


def latest_checkpoint(ckpt_dir: Path, name: str) -> Optional[Path]:
    tag = Path(ckpt_dir) / name / "latest"
    if not tag.exists():
        return None
    return Path(ckpt_dir) / name / tag.read_text().strip()


def load_checkpoint(ckpt_dir: Path, name: str, state: TrainState,
                    step: Optional[int] = None, load_states: bool = True,
                    strict: bool = True) -> TrainState:
    """A new TrainState from the named (or the latest) checkpoint, the
    tensors on ``state``'s devices in its types.  The optimizer state is
    filled where its keys match (a JAX package checkpoint brings the
    counters and leaves the port's optimizer state fresh)."""
    d = (Path(ckpt_dir) / name / str(step) if step is not None
         else latest_checkpoint(ckpt_dir, name))
    if d is None or not d.exists():
        raise FileNotFoundError(f"no checkpoint for {name} in {ckpt_dir}")
    params = unflatten_like(state.params, load_state_dict(d / "module.sft"),
                            strict=strict)
    opt_state, st, sm, tk = (state.opt_state, state.step,
                             state.samples_processed, state.tokens_processed)
    opt_path = d / "optimizer.sft"
    if load_states and opt_path.exists():
        flat = load_state_dict(opt_path)

        def scalar(key):
            v = flat.pop(key, None)
            return 0 if v is None else int(np.asarray(v).reshape(-1)[0])
        st, sm, tk = (scalar("__step__"), scalar("__samples__"),
                      scalar("__tokens__"))
        flat = {k: v for k, v in flat.items() if not k.startswith("extra/")}
        opt_state = unflatten_like(state.opt_state, flat, strict=False)
    return TrainState(params, opt_state, st, sm, tk)


def export_weights(params, path: Path, config: Optional[dict] = None,
                   stats: Optional[dict] = None,
                   userdata: Optional[dict] = None,
                   lora_split: bool = False) -> None:
    """Deployable fp32 export with config, stats and userdata in the
    metadata (engines/base.py:356-400); ``lora_split`` writes the LoRA
    leaves to ``lora.<ext>`` beside it."""
    flat = {k: (v.float() if v.is_floating_point() else v)
            for k, v in flatten_tree(params).items()}
    meta = {"config": config or {}, "stats": stats or {},
            "userdata": userdata or {}}
    path = Path(path)
    if lora_split:
        lora = {k: v for k, v in flat.items() if "lora" in k}
        save_state_dict({k: v for k, v in flat.items() if "lora" not in k},
                        path, metadata=meta)
        if lora:
            save_state_dict(lora, path.parent / f"lora.{path.suffix[1:]}")
    else:
        save_state_dict(flat, path, metadata=meta)
