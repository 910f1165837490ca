#!/usr/bin/env python3
"""Model the fp32 biased attention kernel's error under two ways the
tensor cores could round their fp32 accumulation (a CPU model, numpy).

    python3 tools/fp32_accumulation.py [--planes N]

Emulates ``attn_bias_f32_block`` (csrc/attention_bias.cuh) on N random
(head, batch) planes at T=896 with chip_smoke's input scales (q, k, v
N(0, 0.25), bias N(0, 4)): 64-key steps, the lazy base-2 softmax, and
both products as three TF32 products of each 8-deep slice (hi = rna with
the 13 low bits cleared, lo read truncated), each slice's exact sum added
to its accumulator rounded to fp32 either to nearest ("rn") or toward
zero ("rz").  Prints the largest error against a float64 reference for
each rounding, with O accumulated over every key in one chain and with
each step's P V^T summed apart and added to O in fp32 (the kernel's
choice).  No card is involved; it says which rounding the card's measured
errors fit, not what the card does.
"""

from __future__ import annotations

import sys

import numpy as np

T, D, STEP = 896, 64, 64
LOG2E = np.float32(1.4426950408889634)


def to_f32(x: np.ndarray, mode: str) -> np.ndarray:
    r = x.astype(np.float32)
    if mode == "rz":   # one step back toward zero where rounding went out
        r = np.where(np.abs(r.astype(np.float64)) > np.abs(x),
                     np.nextafter(r, np.float32(0)), r)
    return r


def tf32_hi(x: np.ndarray) -> np.ndarray:
    b = x.astype(np.float32).view(np.int32)
    return ((b + 0x1000) & -0x2000).view(np.float32)


def tf32_read(x: np.ndarray) -> np.ndarray:
    return (x.astype(np.float32).view(np.int32) & -0x2000).view(np.float32)


def mma_3xtf32(a, b, acc, mode):
    """acc (M, N) += a (M, K) b (K, N): per 8-deep slice lo hi, hi lo and
    hi hi, each slice's sum added to acc and rounded by ``mode``."""
    ah, bh = tf32_hi(a), tf32_hi(b)
    al, bl = tf32_read(a - ah), tf32_read(b - bh)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = to_f32(acc.astype(np.float64)
                         + x[:, s].astype(np.float64) @ y[s], mode)
    return acc


def plane_error(rng, mode: str, per_step: bool) -> float:
    q, k, v = ((rng.randn(D, T) * 0.5).astype(np.float32) for _ in range(3))
    bias = (rng.randn(T, T) * 2).astype(np.float32)
    s = q.T.astype(np.float64) @ k / 8 + bias
    p = np.exp(s - s.max(1, keepdims=True))
    want = p @ v.T.astype(np.float64) / p.sum(1, keepdims=True)
    m = np.full((T, 1), -np.inf, np.float32)
    l = np.zeros((T, 1), np.float32)
    o = np.zeros((T, D), np.float32)
    for k0 in range(0, T, STEP):
        ks = slice(k0, k0 + STEP)
        sc = mma_3xtf32(q.T, k[:, ks], np.zeros((T, STEP), np.float32), mode)
        x = sc * np.float32(0.125) + bias[:, ks]
        mx = x.max(1, keepdims=True) * LOG2E
        base = np.where(mx > m + 8, mx, m)
        alpha = np.exp2((m - base).astype(np.float64)).astype(np.float32)
        m, o, l = base, o * alpha, l * alpha
        pp = np.exp2(x.astype(np.float64) * LOG2E - m).astype(np.float32)
        l = l + pp.sum(1, keepdims=True)
        vt = np.ascontiguousarray(v[:, ks].T)
        if per_step:
            o = o + mma_3xtf32(pp, vt, np.zeros((T, D), np.float32), mode)
        else:
            o = mma_3xtf32(pp, vt, o, mode)
    return float(np.abs(o / l - want).max())


def main() -> int:
    planes = int(sys.argv[sys.argv.index("--planes") + 1]) \
        if "--planes" in sys.argv else 3
    for mode in ("rn", "rz"):
        for per_step in (False, True):
            rng = np.random.RandomState(0)
            errs = [plane_error(rng, mode, per_step) for _ in range(planes)]
            print(f"{mode} {'per-step P V^T' if per_step else 'one O chain'}:"
                  f" max abs err {min(errs):.3g}-{max(errs):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
