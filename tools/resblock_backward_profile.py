#!/usr/bin/env python3
"""Time K4's and K5's backward (``csrc/resblock.cu``) of one or more
checkouts at the diffusion training step's shapes on a CUDA card, in turns.

    python3 tools/resblock_backward_profile.py [--repo DIR ...]

Imports ``tortoise_tts_tpu_torch`` from each ``--repo`` (default: this
checkout) and times them in the order given, then in reverse (A, B, B, A),
so two versions compare on one card.  For each checkout, first its
``ptxas`` report of ``resblock.cu`` (each kernel's registers and spills),
then one JSON line a turn and shape, bf16, at ``chip_smoke``'s
(DIFF_TRAIN_B, 1024, DIFF_TRAIN_T): K4 -> 1024 (the resblock in-half,
``act``), K4 -> 3072 (the attention qkv head) and K5: the kernel forward's
device ms (no autograd), the autograd path's fwd+bwd, every CUDA kernel of
that fwd+bwd by name (torch.profiler over 10 calls, as
``chip_smoke.device_ms`` sums them; a checkout whose backward is the plain
recompute shows its library kernels there), the library's fwd+bwd and
backward alone (autograd of F.group_norm + F.silu + F.conv1d, the backward
on a kept graph), and the backward's bound (``chip_smoke.bound_ms``: x, the
upstream and W read, dx and dW written, or its two products).  Each turn
also times the forwards alone at the default route's denoiser shapes
(B=2, T=896: K4 -> 1024 and -> 3072, K5 with its prepared weight; no
autograd), the serving rows a change to the shared source must leave as
they were, with digests of their outputs' bits in bf16 and fp32 and of
each training shape's bf16 gradients (``*_sha``: bit-equality across
checkouts).  ``--fp32`` adds, for every checkout in the same turns, one
line a shape of the fp32 backward (autograd of the kernel path on a kept
graph, every CUDA kernel by name and their sum) beside its plain version
(``gn_conv1x1_bwd_plain``, ``ts_res_block_out_bwd_plain`` on the forward's
statistics), the library's fp32 backward with TF32 off and the bounds:
the fp32 bytes, the two products at the FFMA rate (67 TFLOP/s) and in
3xTF32 (three TF32 products each at 495); then the fp32 training
micro-steps with that checkout's port (``chip_smoke.fp32_train_routes``:
the AR finetune and the diffusion engine at ``trainer.weight_dtype:
float32`` and full width, ms a micro-step and peak GB).  Then the card's
name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402  (helpers only: it imports no port)

GROUPS = 32
SHAPES = (("k4_in_half", 1024, 1, True), ("k4_qkv", 3072, 1, False),
          ("k5", 1024, 3, True))
SERVING_B, SERVING_T = 2, 896


def _forget_port() -> None:
    """Drop the imported port, so the next import reads sys.path anew."""
    for m in [m for m in sys.modules
              if m.startswith("tortoise_tts_tpu_torch")]:
        del sys.modules[m]


def load(repo: str):
    """(K4's module, K5's module) of the checkout at ``repo``, built."""
    _forget_port()
    sys.path.insert(0, repo)
    try:
        k4 = importlib.import_module("tortoise_tts_tpu_torch.kernels.gn_conv")
        k5 = importlib.import_module(
            "tortoise_tts_tpu_torch.kernels.ts_res_block")
        from tortoise_tts_tpu_torch.kernels import _build
    finally:
        sys.path.pop(0)
    _build.build(["resblock"])
    log = _build._lib_path("resblock").with_suffix(".log")
    lines = log.read_text().splitlines()
    report = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            regs = [x.strip() for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            report.append({"kernel": name, "ptxas": regs})
    print(json.dumps({"repo": repo, "ptxas": report}), flush=True)
    return k4, k5


def fwd_bwd_kernels(fn, n: int = 10) -> dict:
    """Device ms a call of fn by CUDA kernel (``chip_smoke._short_name``)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.profiler_warmup(torch)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in cs._cuda_events(prof):
        key = cs._short_name(e.name)[:48]
        out[key] = out.get(key, 0.0) + e.device_time / 1e3 / n
    return {k: round(v, 5) for k, v in out.items()}


def inputs(dev, m, taps, b=cs.DIFF_TRAIN_B, t=cs.DIFF_TRAIN_T):
    """x (or h), gamma, beta, w, bias, emb (K5) or None, the upstream."""
    c = 1024
    g = torch.Generator(device=dev).manual_seed(m + taps)
    x = (torch.randn(b, c, t, generator=g, device=dev) * 2 + 0.5).bfloat16()
    ga = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    be = 0.1 * torch.randn(c, generator=g, device=dev)
    bound = (c * taps) ** -0.5
    w = ((torch.rand(m, c, taps, generator=g, device=dev) * 2 - 1)
         * bound).bfloat16()
    bi = (torch.rand(m, generator=g, device=dev) * 2 - 1) * bound
    emb = ((0.3 * torch.randn(b, 2 * c, generator=g, device=dev)).bfloat16()
           if taps == 3 else None)
    up = torch.randn(b, m, t, generator=g, device=dev).bfloat16()
    return x, ga, be, w, bi, emb, up


def serving(k4, k5, dev) -> tuple:
    """The forwards' device ms at the default route's denoiser shapes, and
    digests of their outputs in bf16 and in fp32 (3xTF32)."""
    out, sha = {}, {}
    for name, m, taps, act in SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x, ga, be, w, bi, emb, _ = (
                None if v is None else v.to(dt) if v.dtype == torch.bfloat16
                else v for v in inputs(dev, m, taps, SERVING_B, SERVING_T))
            norm = {"scale": ga, "bias": be}
            if taps == 1:
                conv = {"w": w, "b": bi}
                fn = lambda _: k4.gn_conv1x1(x, norm, conv, GROUPS,  # noqa
                                             act)
            else:
                conv = k5.prepare_conv({"w": w, "b": bi})
                fn = lambda _: k5.ts_res_block_out(x, x, emb, norm,  # noqa
                                                   conv, GROUPS)
            with torch.no_grad():
                sha[f"{name}_{str(dt)[6:]}"] = cs.digest(torch, [fn(0)])
                if dt == torch.bfloat16:
                    out[name] = cs.device_ms(torch, fn, n=30, warmup=5)
    return out, sha


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", action="append", default=None,
                    help="checkout to time (repeatable; default: this one)")
    ap.add_argument("--fp32", action="store_true",
                    help="also time the fp32 backwards of every checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("resblock_backward_profile: no CUDA device", file=sys.stderr)
        return 2
    repos = args.repo or [str(HERE)]
    mods = {r: load(r) for r in repos}
    dev = torch.device("cuda")
    F = torch.nn.functional
    for turn, repo in enumerate(repos + repos[::-1]):
        k4, k5 = mods[repo]
        ms, sha = serving(k4, k5, dev)
        print(json.dumps({"repo": repo, "turn": turn,
                          "serving_shape": [SERVING_B, 1024, SERVING_T],
                          "serving_fwd_ms": ms, "serving_sha": sha}),
              flush=True)
        for name, m, taps, act in SHAPES:
            x, ga, be, w, bi, emb, up = inputs(dev, m, taps)
            b, c, t = x.shape
            if taps == 1:
                def kernel(x, ga, be, w, bi, act=act):
                    return k4.gn_conv1x1(x, {"scale": ga, "bias": be},
                                         {"w": w, "b": bi}, GROUPS, act)

                def library(x, ga, be, w, bi, act=act):
                    y = F.group_norm(x, GROUPS, ga.bfloat16(), be.bfloat16())
                    return F.conv1d(F.silu(y) if act else y, w, bi.bfloat16())
                ins = (x, ga, be, w, bi)
            else:
                res = torch.randn_like(x)

                def kernel(h, ga, be, w, bi, emb):
                    return k5.ts_res_block_out(
                        h, res, emb, {"scale": ga, "bias": be},
                        k5.prepare_conv({"w": w, "b": bi}), GROUPS)

                def library(h, ga, be, w, bi, emb):
                    sc, sh = emb[..., None].chunk(2, dim=1)
                    y = F.group_norm(h, GROUPS, ga.bfloat16(), be.bfloat16())
                    return res + F.conv1d(F.silu(y * (1 + sc) + sh), w,
                                          bi.bfloat16(), padding=1)
                ins = (x, ga, be, w, bi, emb)
            with torch.no_grad():
                fwd = cs.device_ms(torch, lambda _: kernel(*ins), n=10,
                                   warmup=2)
            xs = [v.detach().requires_grad_() for v in ins]
            lib = library(*xs)
            line = dict(
                repo=repo, turn=turn, name=name, shape=[b, c, t, m],
                fwd_bwd_sha=cs.digest(torch, cs._fwd_bwd(torch, kernel, ins,
                                                        up)[1]),
                fwd_ms=fwd,
                fwd_bwd_ms=cs.device_ms(torch, lambda _: cs._fwd_bwd(
                    torch, kernel, ins, up), n=10, warmup=2),
                fwd_bwd_kernels_ms=fwd_bwd_kernels(
                    lambda: cs._fwd_bwd(torch, kernel, ins, up)),
                library_fwd_bwd_ms=cs.device_ms(torch, lambda _: cs._fwd_bwd(
                    torch, library, ins, up), n=10, warmup=2),
                library_bwd_ms=cs.device_ms(torch, lambda _: torch.autograd
                                            .grad(lib, xs, up,
                                                  retain_graph=True),
                                            n=10, warmup=2))
            line["bwd_bound_ms"], line["bwd_bound_by"] = cs.bound_ms(
                2 * (2 * b * c * t + b * m * t + 2 * m * c * taps),
                4 * b * m * c * t * taps)
            print(json.dumps(line), flush=True)
            del lib, xs
            torch.cuda.empty_cache()
        if args.fp32:
            fp32_lines(k4, k5, repo, turn, dev)
            fp32_train(repo, turn, dev)
    print(cs.nvidia_smi())
    return 0


def fp32_lines(k4, k5, repo: str, turn: int, dev) -> None:
    """Each shape's fp32 backward, kernel path (by CUDA kernel) and
    library, on kept graphs, TF32 off, beside its plain version and its
    bounds."""
    F = torch.nn.functional
    backends = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [bk.allow_tf32 for bk in backends]
    for bk in backends:
        bk.allow_tf32 = False
    try:
        _fp32_shapes(k4, k5, repo, turn, dev, F)
    finally:
        for bk, v in zip(backends, saved):
            bk.allow_tf32 = v


def _fp32_shapes(k4, k5, repo, turn, dev, F) -> None:
    for name, m, taps, act in SHAPES:
        x, ga, be, w, bi, emb, up = (None if v is None else v.float()
                                     for v in inputs(dev, m, taps))
        b, c, t = x.shape
        with torch.no_grad():
            if taps == 1:
                _, st = k4._launch(x, ga, be, w, bi, GROUPS, act, 1e-5,
                                   with_stats=True)
            else:
                _, st = k5._launch(x, x, emb, ga, be, k5.taps(w), bi,
                                   GROUPS, 1e-5, with_stats=True)
        stats = (st[:b * GROUPS], st[b * GROUPS:])
        if taps == 1:
            def kernel(x, ga, be, w, bi, act=act):
                return k4.gn_conv1x1(x, {"scale": ga, "bias": be},
                                     {"w": w, "b": bi}, GROUPS, act)

            def library(x, ga, be, w, bi, act=act):
                y = F.group_norm(x, GROUPS, ga, be)
                return F.conv1d(F.silu(y) if act else y, w, bi)

            def plain(_):
                return k4.gn_conv1x1_bwd_plain(x, ga, be, w, bi, up, GROUPS,
                                               act, stats=stats)
            ins = (x, ga, be, w, bi)
        else:
            def kernel(h, ga, be, w, bi, emb):
                return k5.ts_res_block_out(
                    h, h, emb, {"scale": ga, "bias": be},
                    k5.prepare_conv({"w": w, "b": bi}), GROUPS)

            def library(h, ga, be, w, bi, emb):
                sc, sh = emb[..., None].chunk(2, dim=1)
                y = F.group_norm(h, GROUPS, ga, be)
                return h + F.conv1d(F.silu(y * (1 + sc) + sh), w, bi,
                                    padding=1)

            def plain(_):
                return k4.ts_res_block_out_bwd_plain(
                    x, emb, ga, be, w, bi, up, GROUPS, stats=stats)
            ins = (x, ga, be, w, bi, emb)
        line = dict(repo=repo, turn=turn, dtype="float32", name=name,
                    shape=[b, c, t, m])
        xs = [v.detach().requires_grad_() for v in ins]
        out = kernel(*xs)
        parts = cs.kernel_ms(torch, lambda: torch.autograd.grad(
            out, xs, up, retain_graph=True), n=5, warmup=1)
        line["bwd_kernels_ms"], line["bwd_ms"] = parts, sum(parts.values())
        del out, xs
        xs = [v.detach().requires_grad_() for v in ins]
        out = library(*xs)
        line["library_bwd_ms"] = cs.device_ms(
            torch, lambda _: torch.autograd.grad(out, xs, up,
                                                 retain_graph=True),
            n=3, warmup=1)
        del out, xs
        line["plain_ms"] = cs.device_ms(torch, plain, n=2, warmup=1)
        flops = 4 * b * m * c * t * taps
        line["bytes_bound_ms"] = cs.bound_ms(
            4 * (2 * b * c * t + b * m * t + 2 * m * c * taps), 0)[0]
        line["ffma_bound_ms"] = cs.bound_ms(0, flops, cs.FP32_FLOPS)[0]
        line["tf32x3_bound_ms"] = cs.bound_ms(0, 3 * flops,
                                              cs.TF32_FLOPS)[0]
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()


def fp32_train(repo: str, turn: int, dev) -> None:
    """``chip_smoke.fp32_train_routes`` with the checkout's port: the AR
    finetune (batch 8, buckets 128/256) and the diffusion engine alone at
    the README yaml's buckets (the largest batch of 16, 8, 4 that fits) at
    ``trainer.weight_dtype: float32`` and full width, every micro-step
    checked against the launches the code implies; its ``train_route``
    lines (ms a micro-step, peak GB) follow a ``{"repo", "turn"}`` line."""
    _forget_port()
    sys.path.insert(0, repo)
    try:
        from tortoise_tts_tpu_torch import kernels
        from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer
        kernels.build_all()
        print(json.dumps({"repo": repo, "turn": turn, "fp32_train": True}),
              flush=True)
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["TORTOISE_TPU_TOKENIZER"] = str(
                write_char_tokenizer(Path(tmp) / "tokenizer.json"))
            cs.fp32_train_routes(torch, dev, tmp)
    finally:
        sys.path.remove(repo)
    torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
