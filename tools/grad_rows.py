#!/usr/bin/env python3
"""How K1's gradients read against chip_smoke's ``train_grads`` bound:
K1's autograd path (its forward kernel and its backward kernel), the
plain version's in bf16 and the plain version's in fp32 on the same
bf16 inputs, at the AR train steps' shapes, read row by row as
``chip_smoke._row_err`` reads them (the worst row's error over its
TRAIN_GRAD_TOL bound; above 1 fails).

    python3 tools/grad_rows.py

Prints one JSON line a shape and upstream gradient: ``output`` (the
gradients of 0.5 sum(out^2), so each version's backward takes its own
output) or ``fixed`` (one seeded draw for both), with the readings of
the kernel path against the bf16 plain one (``kernel_vs_plain``) and of
each against the fp32 plain version on the same inputs
(``kernel_vs_fp32``, what ``train_grads`` holds, and ``plain_vs_fp32``).
Then the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402  (helpers only: it imports no port)


def grads(fn, inputs, upstream):
    """fn(*inputs) and its gradients; ``upstream`` None: the output's own
    (the gradients of 0.5 sum(out^2)), else taken in the output's dtype."""
    xs = [t.detach().requires_grad_() for t in inputs]
    out = fn(*xs)
    up = out.detach() if upstream is None else upstream.to(out.dtype)
    return [out.detach()] + list(torch.autograd.grad(out, xs, up))


def readings(got, want) -> dict:
    return {n: round(cs._row_err(a, b)["row"], 4)
            for n, a, b in zip(("out", "dq", "dk", "dv"), got, want)}


def main() -> int:
    if not torch.cuda.is_available():
        print("grad_rows: no CUDA device", file=sys.stderr)
        return 2
    from tortoise_tts_tpu_torch.kernels import flash_attention as k1
    dev = torch.device("cuda")

    def kernel(q, k, v):
        return k1.flash_attention(q, k, v, causal=True)

    def plain(q, k, v):
        return k1.flash_attention_plain(q, k, v, causal=True)
    for i, (b, h, s, d) in enumerate(cs.K1_TRAIN_SHAPES):
        g = torch.Generator(device=dev).manual_seed(70 + i)
        qkv = [torch.randn(b, h, s, d, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3)]
        fixed = torch.randn(b, h, s, d, generator=g, device=dev
                            ).to(torch.bfloat16)
        for name, up in (("output", None), ("fixed", fixed)):
            kg, pg = grads(kernel, qkv, up), grads(plain, qkv, up)
            line = dict(shape=[b, h, s, d], upstream=name,
                        kernel_vs_plain=readings(kg, pg))
            fg = grads(plain, [t.float() for t in qkv], up)
            line.update(kernel_vs_fp32=readings(kg, fg),
                        plain_vs_fp32=readings(pg, fg))
            del fg
            print(json.dumps(line), flush=True)
            del kg, pg
            torch.cuda.empty_cache()
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
