#!/usr/bin/env python3
"""Time K1's backward kernel (``csrc/flash_attention_bwd.cu``) of one or
more checkouts at the AR train steps' shapes on a CUDA card, in turns.

    python3 tools/flash_backward_profile.py [--repo DIR ...] [--fp32]

Imports ``tortoise_tts_tpu_torch`` from each ``--repo`` (default: this
checkout) and times them in the order given, then in reverse (A, B, B, A),
so two versions of the kernel compare on one card.  For each checkout,
first its ``ptxas`` report of the backward's CUDA kernels (registers,
spills), then one JSON line a turn and shape (bf16, causal, no key mask,
``chip_smoke.K1_TRAIN_SHAPES``): the device ms a call of each of the
backward's two CUDA kernels and their sum (torch.profiler over 10 calls,
as ``chip_smoke.device_ms`` sums them), the fwd+bwd device ms of K1's
autograd path, SDPA's fwd+bwd and its backward alone (autograd of a kept
graph), and the backward's bound (``chip_smoke.bound_ms``), with a digest
of its gradients' bits (``bwd_sha``, for bit-equality across checkouts); K1's
forward
alone (no autograd: no log-sum-exp) beside SDPA's and the forward's
bound, with its output's digest (``fwd_sha``); one line a turn of K1's
bf16 forward at the serving shapes (the prefill and the latent pass at
B=1: ``serving_sha``, ``serving_ms``).  ``--fp32`` adds, for every checkout in the same turns, one line a
shape of the fp32 backward (its CUDA kernels apart and their sum) beside
its plain version, SDPA's fp32 backward (TF32 off) and its bounds: the
fp32 bytes, the five products at the FFMA rate (67 TFLOP/s) and in 3xTF32
(three TF32 products each at 495); and one line a shape of
``chip_smoke.K1_F32_FWD_SHAPES`` (the training shapes, the prefill with
its key mask, the latent pass) of the fp32 forward alone (no autograd):
its CUDA kernels' device ms, SDPA's fp32 forward (TF32 off) and the
bounds (fp32 bytes; S and P V over the causal half in 3xTF32 and at the
FFMA rate), a digest of its output's bits (``fwd_sha``), and, where the
checkout has the persistent fp32 forward (``fwd_f32_plan``), its device
ms in each work-item order.  Then the card's name and power limit.  Needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402  (helpers only: it imports no port)


def load(repo: str):
    """K1's module of the checkout at ``repo``, its kernels built."""
    for m in [m for m in sys.modules
              if m.startswith("tortoise_tts_tpu_torch")]:
        del sys.modules[m]
    sys.path.insert(0, repo)
    try:
        k1 = importlib.import_module(
            "tortoise_tts_tpu_torch.kernels.flash_attention")
        from tortoise_tts_tpu_torch.kernels import _build
    finally:
        sys.path.pop(0)
    _build.build(["flash_attention", "flash_attention_bwd"])
    log = _build._lib_path("flash_attention_bwd").with_suffix(".log")
    print(json.dumps({"repo": repo, "ptxas": [
        ln.strip() for ln in log.read_text().splitlines()
        if "Used" in ln or "spill" in ln or "Function properties" in ln]}),
        flush=True)
    return k1


def per_kernel_ms(fn, n: int = 10) -> dict:
    """Device ms a call of fn by CUDA kernel (dq, dkdv, other)."""
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
        key = ("dq" if "bwd_dq" in e.name else
               "dkdv" if "bwd_dkdv" in e.name else "other")
        out[key] = out.get(key, 0.0) + e.device_time / 1e3 / n
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", action="append", default=None,
                    help="checkout to time (repeatable; default: this one)")
    ap.add_argument("--fp32", action="store_true",
                    help="also time the fp32 backward of every checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_backward_profile: no CUDA device", file=sys.stderr)
        return 2
    repos = args.repo or [str(HERE)]
    mods = {r: load(r) for r in repos}
    dev = torch.device("cuda")
    F = torch.nn.functional
    for turn, repo in enumerate(repos + repos[::-1]):
        k1 = mods[repo]
        for i, shape in enumerate(cs.K1_TRAIN_SHAPES):
            b, h, s, d = shape
            g = torch.Generator(device=dev).manual_seed(70 + i)
            q, k, v, up = (torch.randn(shape, generator=g, device=dev)
                           .to(torch.bfloat16) for _ in range(4))
            with torch.no_grad():
                _, lse = k1._launch(q, k, v, None, True, with_lse=True)
            parts = per_kernel_ms(lambda: k1.flash_attention_bwd(
                q, k, v, lse, up))
            xs = [t.detach().requires_grad_() for t in (q, k, v)]
            sdpa = F.scaled_dot_product_attention(*xs, is_causal=True)
            line = dict(
                repo=repo, turn=turn, shape=list(shape),
                bwd_ms={key: round(val, 5) for key, val in parts.items()},
                bwd_total_ms=sum(parts.values()),
                bwd_sha=cs.digest(torch, k1.flash_attention_bwd(
                    q, k, v, lse, up)),
                fwd_bwd_ms=cs.device_ms(torch, lambda _: cs._fwd_bwd(
                    torch, lambda q, k, v: k1.flash_attention(q, k, v),
                    (q, k, v), up), n=10, warmup=2),
                sdpa_fwd_bwd_ms=cs.device_ms(torch, lambda _: cs._fwd_bwd(
                    torch, lambda q, k, v: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True), (q, k, v), up),
                    n=10, warmup=2),
                sdpa_bwd_ms=cs.device_ms(torch, lambda _: torch.autograd.grad(
                    sdpa, xs, up, retain_graph=True), n=10, warmup=2))
            line["bound_ms"], line["bound_by"] = cs.bound_ms(
                7 * b * h * s * d * 2 + 4 * b * h * s,
                5 * b * h * d * s * (s + 1))
            with torch.no_grad():
                line["fwd_sha"] = cs.digest(torch, [k1.flash_attention(
                    q, k, v)])
                line["fwd_ms"] = cs.device_ms(
                    torch, lambda _: k1.flash_attention(q, k, v), n=10,
                    warmup=2)
                line["sdpa_fwd_ms"] = cs.device_ms(
                    torch, lambda _: F.scaled_dot_product_attention(
                        q, k, v, is_causal=True), n=10, warmup=2)
            # q, k, v in, o out; S and P V over the causal half
            line["fwd_bound_ms"], line["fwd_bound_by"] = cs.bound_ms(
                4 * b * h * s * d * 2, 2 * b * h * d * s * (s + 1))
            print(json.dumps(line), flush=True)
            del sdpa, xs
            torch.cuda.empty_cache()
        serving_line(k1, repo, turn, dev)
        if args.fp32:
            fp32_lines(k1, repo, turn, dev)
    print(cs.nvidia_smi())
    return 0


def serving_line(k1, repo: str, turn: int, dev) -> None:
    """K1's bf16 forward at the serving shapes of ``K1_F32_FWD_SHAPES``
    (the prefill with its key mask, the latent pass; B=1): a digest of
    each output's bits (``serving_sha``, for bit-equality across
    checkouts) and its device ms."""
    line = dict(repo=repo, turn=turn, serving_sha={}, serving_ms={})
    for shape, masked in cs.K1_F32_FWD_SHAPES:
        b, h, s, d = shape
        if b != 1:
            continue
        g = torch.Generator(device=dev).manual_seed(90 + s)
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        mask = None
        if masked:
            mask = torch.ones(b, s, dtype=torch.bool, device=dev)
            mask[:, s // 3:s - 1] = False
        with torch.no_grad():
            line["serving_sha"][str(s)] = cs.digest(
                torch, [k1.flash_attention(q, k, v, mask)])
            line["serving_ms"][str(s)] = cs.device_ms(
                torch, lambda _: k1.flash_attention(q, k, v, mask))
    print(json.dumps(line), flush=True)


def fp32_lines(k1, repo: str, turn: int, dev) -> None:
    """The fp32 backward at each training shape, by CUDA kernel, beside
    its plain version, SDPA's fp32 backward (TF32 off) and its bounds; the
    fp32 forward at ``chip_smoke.K1_F32_FWD_SHAPES`` beside SDPA's fp32
    forward."""
    F = torch.nn.functional
    torch.backends.cuda.matmul.allow_tf32 = False
    for i, shape in enumerate(cs.K1_TRAIN_SHAPES):
        b, h, s, d = shape
        g = torch.Generator(device=dev).manual_seed(70 + i)
        q, k, v, up = (torch.randn(shape, generator=g, device=dev)
                       for _ in range(4))
        with torch.no_grad():
            _, lse = k1._launch(q, k, v, None, True, with_lse=True)
        xs = [t.detach().requires_grad_() for t in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*xs, is_causal=True)
        flops = 5 * b * h * d * s * (s + 1)
        nbytes = 7 * b * h * s * d * 4 + 4 * b * h * s
        parts = cs.kernel_ms(torch, lambda: k1.flash_attention_bwd(
            q, k, v, lse, up), n=5, warmup=1)
        line = dict(
            repo=repo, turn=turn, dtype="float32", shape=list(shape),
            bwd_kernels_ms=parts, bwd_ms=sum(parts.values()),
            plain_ms=cs.device_ms(
                torch, lambda _: k1.flash_attention_bwd_plain(
                    q, k, v, lse, up), n=2, warmup=1),
            sdpa_bwd_ms=cs.device_ms(torch, lambda _: torch.autograd.grad(
                sdpa, xs, up, retain_graph=True), n=3, warmup=1),
            bytes_bound_ms=cs.bound_ms(nbytes, 0)[0],
            ffma_bound_ms=cs.bound_ms(0, flops, cs.FP32_FLOPS)[0],
            tf32x3_bound_ms=cs.bound_ms(0, 3 * flops, cs.TF32_FLOPS)[0])
        print(json.dumps(line), flush=True)
        del sdpa, xs
        torch.cuda.empty_cache()
    for shape, masked in cs.K1_F32_FWD_SHAPES:
        b, h, s, d = shape
        g = torch.Generator(device=dev).manual_seed(80 + s)
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   for _ in range(3))
        mask = allowed = None
        if masked:
            mask = torch.ones(b, s, dtype=torch.bool, device=dev)
            mask[:, s // 3:s - 1] = False
            allowed = mask[:, None, None, :] & torch.ones(
                s, s, dtype=torch.bool, device=dev).tril()
        fl = 2 * b * h * d * s * (s + 1)
        with torch.no_grad():
            parts = cs.kernel_ms(torch, lambda: k1.flash_attention(
                q, k, v, mask), n=10, warmup=2)
            line = dict(
                repo=repo, turn=turn, dtype="float32",
                shape=list(shape), masked=masked, fwd_kernels_ms=parts,
                fwd_ms=sum(parts.values()),
                fwd_sha=cs.digest(torch, [k1.flash_attention(q, k, v,
                                                             mask)]),
                sdpa_fwd_ms=cs.device_ms(
                    torch, lambda _: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=allowed, is_causal=not masked),
                    n=10, warmup=2),
                fwd_bytes_bound_ms=cs.bound_ms(4 * b * h * s * d * 4, 0)[0],
                fwd_tf32x3_bound_ms=cs.bound_ms(0, 3 * fl,
                                                cs.TF32_FLOPS)[0],
                fwd_ffma_bound_ms=cs.bound_ms(0, fl, cs.FP32_FLOPS)[0])
            plan = getattr(k1, "fwd_f32_plan", None)
            for order in ((0, 1) if plan else ()):
                k1.fwd_f32_plan = (lambda b_, h_, s_, o=order:
                                   plan(b_, h_, s_)._replace(order=o))
                try:
                    line[f"fwd_ms_order{order}"] = cs.device_ms(
                        torch, lambda _: k1.flash_attention(q, k, v, mask),
                        n=10, warmup=2)
                finally:
                    k1.fwd_f32_plan = plan
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
