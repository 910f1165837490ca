"""Parameter trees and flat checkpoints (the port's copy of
``unflatten_like`` from ``tortoise_tts_tpu/engine/state.py``)."""

from __future__ import annotations

from typing import Any, Mapping

import torch


def unflatten_like(tree: Any, flat: Mapping[str, Any], prefix: str = "",
                   strict: bool = True) -> Any:
    """``tree`` with each leaf replaced by ``flat``'s entry of the same name:
    the leaf's dict keys and list indices joined by "/", after ``prefix``.
    An entry takes the leaf's type and device.  ``strict``: a missing name
    or a shape that differs raises; otherwise the leaf stays."""
    def fill(node, name):
        if isinstance(node, dict):
            return {k: fill(v, f"{name}/{k}" if name else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v, f"{name}/{i}" if name else str(i))
                              for i, v in enumerate(node))
        key = prefix + name
        if key not in flat:
            if strict:
                raise KeyError(f"missing key in checkpoint: {key}")
            return node
        arr = torch.as_tensor(flat[key])
        if strict and tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{tuple(arr.shape)} vs {tuple(node.shape)}")
        return arr.to(dtype=node.dtype, device=node.device)
    return fill(tree, "")

