"""LoRA adapters of the AR model's trunk (port of
``tortoise_tts_tpu/models/lora.py``).

An adapter is a tree of its own, {"gpt": {target: {"a": (L, d_in, r),
"b": (L, r, d_out)}}}, over the stacked trunk weights, which the port
keeps in the JAX package's (L, d_in, d_out) layout.  ``merge_lora`` gives
the weights w + (alpha / rank) a @ b, which the decode then quantizes
like any other weights.  In adapter training the factors are the
trainable tree and the base weights stay frozen (``freeze_non_lora_mask``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

Params = Dict[str, Any]

# every linear of the trunk (the reference's include policy, ["gpt"])
GPT_TARGETS = ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj")


def init_lora(g: torch.Generator, params: Params, rank: int = 128,
              targets: Tuple[str, ...] = GPT_TARGETS) -> Params:
    """Factors with no effect yet: a uniform in +-1/sqrt(d_in), b = 0
    (reference lora.py:59-61), on the generator's device in the weights'
    type."""
    lora: Params = {"gpt": {}}
    for name in targets:
        w = params["gpt"][name]["w"]
        n_layers, d_in, d_out = w.shape
        bound = 1.0 / math.sqrt(d_in)
        a = (torch.rand((n_layers, d_in, rank), generator=g,
                        device=g.device) * 2 - 1) * bound
        lora["gpt"][name] = {
            "a": a.to(w.dtype),
            "b": torch.zeros((n_layers, rank, d_out), dtype=w.dtype,
                             device=g.device)}
    return lora


def apply_lora(params: Params, lora: Optional[Params], alpha: float = 128,
               rank: int = 128) -> Params:
    """The params with each adapter merged, w + (alpha / rank) a @ b in the
    weights' type; the input trees are left as they are."""
    if lora is None:
        return params
    scale = alpha / rank
    gpt = dict(params["gpt"])
    for name, ab in lora["gpt"].items():
        entry = dict(gpt[name])
        w = entry["w"]
        delta = torch.einsum("ldr,lrk->ldk", ab["a"].to(w), ab["b"].to(w))
        entry["w"] = w + scale * delta
        gpt[name] = entry
    return {**params, "gpt": gpt}


def merge_lora(params: Params, lora: Params, alpha: float = 128,
               rank: int = 128) -> Params:
    """The merge for serving (reference lora.py:220-228)."""
    return apply_lora(params, lora, alpha, rank)


def freeze_non_lora_mask(params: Params, lora: Params):
    """Trainable masks: every leaf of ``params`` False, every leaf of
    ``lora`` True (reference freeze_non_lora_weights, lora.py:207-218)."""
    from .common import tree_map
    return tree_map(lambda _: False, params), tree_map(lambda _: True, lora)
