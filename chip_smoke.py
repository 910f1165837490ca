#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``tortoise_tts_tpu_torch``) on one CUDA card and prints
one JSON line per phase:

1. ``env``: torch and CUDA versions, the card.
2. ``build``: builds every CUDA kernel from ``tortoise_tts_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and its build seconds.
3. ``kernel``: each kernel against its plain PyTorch version in bf16 at
   the main path's shapes (max abs error against a stated tolerance), and
   the kernel's, the plain version's and one PyTorch library call's time
   beside the bound: the larger of the bytes the function must move over
   3.35 TB/s and its operations over 989 TFLOP/s (H100 SXM bf16 dense
   peak; 67 TFLOP/s for K7's fp32 arithmetic).  ``ms`` is device time per
   call (the summed kernel durations from torch.profiler); ``call_ms`` is
   the time per call of back-to-back calls by CUDA events, which adds the
   gaps the host leaves while it launches.
4. ``reference``: tiny models through the same entry points on the card
   (fp32, kernels) and on the CPU (plain versions), both routes: greedy
   codes equal, the same injected diffusion noise, wavs close; the W8A8
   decode (K8) the same way, greedy codes equal, and every decode route
   (BigVGAN, HiFiGAN, stream, batch, candidates) on the card with
   ``decode_quant="w8a8"`` reaching K8 and never K2; then
   ``reference_batch``: a tiny ``batch_inference`` of 4 rows (its
   cond-free trunk batch of 8 at T=417 takes K6), a tiny
   ``inference(candidates=4)`` (K3's shared form) and a tiny batch of 8
   texts x 4 candidates (32 decode rows: K2 at M=32), wavs within
   4/32767.
5. ``main_path``: the default route, ``TTS.inference(text, ref)`` (AR
   decode, latent pass, DDIM-50 with cond-free guidance, BigVGAN) with
   bench.py's knobs, at the shipped widths (UnifiedVoice 30 x 1024,
   DiffusionTTS 1024 x 10 layers, BigVGAN 24 kHz/100-band), random bf16
   weights from seed 0, int8 decode, 200 AR steps: wall seconds per stage
   and the launches of each stage, twice (the first call builds the
   cached unconditional integrator), then once with the diffusion and
   vocoder stages under the profiler: their CUDA kernels by kind, which
   must agree with the launch counts, and the device's busy share of
   each stage; then slice 1's route,
   ``TTS.inference(..., vocoder_type="hifigan")`` and ``TTS.stream``.
   Each route is driven with the launch counts at 0 and read after it;
   every kernel it runs must have launched.
6. ``batch_route`` and ``candidates_route``: slice 3's entry points at
   the same widths with bench.py's knobs, each once warm (the voice,
   the unconditional integrator and every kernel already cached by the
   default route) and once profiled: ``TTS.batch_inference`` over 8
   copies of the text (8 rows decoded at once, the CLVP-free cleanup, the
   diffusion bucketed by row length: one dispatch of 8 rows, cond-free
   trunk B=16, K6 in every attention block), and ``TTS.inference(text, ref,
   candidates=16)`` (a shared-prefix decode of 16 rows through K3's
   shared form, the CLVP rerank, the winner's latent pass, diffusion and
   vocoder at B=1).  Wall seconds per stage, audio seconds per wall
   second, K6 launches per DDIM step against the profiler, the
   diffusion's busy share, peak memory.
7. ``w8a8_route``: the default route again on the same ``TTS`` with
   ``decode_quant="w8a8"`` (the CLI's ``--decode-quant w8a8``): stage
   seconds, RTF, peak memory, K8's launches (4 per layer and token, K2
   none).
8. ``decode``: eager decode time per token and CUDA launches per token
   (from the profiler), the size a CUDA graph would capture, and the
   device's busy share, for the int8 and the W8A8 decode; K8's CUDA
   kernels in the profiler must match its wrapper's launches.

Then the ``kernels`` summary, the card's name and power limit from
``nvidia-smi``, and as the last line ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and prints no result.
It needs one card and no network; kernels build under
``tortoise_tts_tpu_torch/_build``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM
BF16_FLOPS = 989e12            # H100 SXM, dense tensor core
FP32_FLOPS = 67e12             # H100 SXM, fp32 outside the tensor cores
INT8_OPS = 1979e12             # H100 SXM, dense int8 tensor core
AR_STEPS = 200
DIFF_STEPS = 50
# bench.py's workload: DDIM-50, cond-free guidance, padded geometry
ROUTE_KW = dict(max_ar_steps=AR_STEPS, max_diffusion_steps=DIFF_STEPS,
                diffusion_pad_multiple=32, mel_pad_multiple=128)
TEXT = "The quick brown fox jumps over the lazy dog."
BUCKET = 64                    # the first text bucket, which TEXT fits
# slice 3's kernels: the batch and candidate routes launch them
SLICE3_KERNELS = ("flash_attention_bias", "flash_decode_shared")
# the W8A8 decode's kernel: only decode_quant="w8a8" launches it
W8A8 = "qgemv_w8a8"
INT8_ROUTE_IDLE = SLICE3_KERNELS + (W8A8,)
GEMV_SHAPES = [("attn_qkv", 1024, 3072, True), ("attn_proj", 1024, 1024, False),
               ("mlp_fc", 1024, 4096, True), ("mlp_proj", 4096, 1024, False)]
BATCH_ROWS = 8
CANDIDATES = 16


T0 = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line; ``t_s`` is the script's elapsed seconds."""
    print(json.dumps({"phase": phase, **kw,
                      "t_s": time.perf_counter() - T0}), flush=True)


def profiler_warmup(torch) -> None:
    """The start of a profiling window: the profiler on the chip machine
    drops the kernels of the first milliseconds of a window (one to 48
    kernels in this script's runs with 16 tiny kernels as the only
    warm-up), so wait 50 ms, then run spin kernels, which are the ones
    it may drop (``_cuda_events`` leaves them out), and synchronise."""
    time.sleep(0.05)
    for _ in range(16):
        torch.cuda._sleep(200_000)
    torch.cuda.synchronize()


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS
             ) -> tuple:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def call_ms(torch, fn, n: int = 50, warmup: int = 5) -> float:
    """Mean time between calls over n back-to-back calls, by CUDA events:
    the device time plus whatever gaps the host leaves while launching.
    fn takes the call index, so callers can cycle over inputs bigger
    than the 50 MB L2."""
    for i in range(warmup):
        fn(i)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _cuda_events(prof):
    return [e for e in prof.events() if "CUDA" in str(e.device_type)
            and "spin_kernel" not in e.name]


def device_ms(torch, fn, n: int = 30, warmup: int = 5) -> float:
    """Mean device time of one call: the summed durations of the CUDA
    kernels it launches (torch.profiler / CUPTI), over n calls."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_warmup(torch)
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    return sum(e.device_time for e in _cuda_events(prof)) / 1e3 / n


def timings(torch, kernel, plain, library) -> dict:
    """Device time (``*ms``) and back-to-back call time (``*call_ms``) of
    the kernel, its plain version and the library call (None where no
    PyTorch call computes the same function)."""
    out = {}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        out[key + "ms"] = device_ms(torch, fn) if fn else None
        out[key + "call_ms"] = call_ms(torch, fn) if fn else None
    return out


def bf16_err(torch, got, want, atol: float, rtol: float, name: str) -> float:
    """Max abs error; fails where |got - want| > atol + rtol |want| (bf16
    output: one ulp is 2^-7 of the value)."""
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    err = d.max().item()
    assert math.isfinite(err), f"{name}: non-finite output"
    bad = (d > atol + rtol * want.float().abs()).sum().item()
    assert bad == 0, f"{name}: {bad} elements off, max abs err {err}"
    return err


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash_attention(torch, k1, dev, n_text):
    """K1 at the prefill of the main path: B=1, H=16, D=64, S = 1 + (64+2)
    + 1 for the 64-token text bucket, the text's padded tail masked; q/k/v
    are views of one fused qkv projection, as _gpt_prefill passes them."""
    F = torch.nn.functional
    b, h, d = 1, 16, 64
    s = 1 + BUCKET + 2 + 1
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (z.view(b, s, h, d).transpose(1, 2)
               for z in qkv.split(h * d, dim=-1))
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[:, 1 + n_text + 2:s - 1] = False
    got = k1.flash_attention(q, k, v, mask)
    want = k1.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 5e-2      # a few bf16 ulps at |o| <= 4; the plain version
    #                 rounds the softmax weights to bf16, the kernel not
    assert math.isfinite(err) and err <= tol, f"flash_attention err {err}"
    allowed = mask[:, None, None, :] & torch.ones(
        s, s, dtype=torch.bool, device=dev).tril()
    t = timings(torch, lambda i: k1.flash_attention(q, k, v, mask),
                lambda i: k1.flash_attention_plain(q, k, v, mask),
                lambda i: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=allowed))
    nbytes = 4 * b * h * s * d * 2 + b * s
    flops = 2 * 2 * b * h * d * s * (s + 1) / 2
    bms, by = bound_ms(nbytes, flops)
    emit("kernel", name="flash_attention", shape=[b, h, s, d],
         max_abs_err=err, tol=tol, library="scaled_dot_product_attention",
         bound_ms=bms, bound_by=by, **t)
    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, **t)


def check_qgemv(torch, k2, dev, layers=30):
    """K2 at one decode layer's four GEMVs (M=1), each cycling over 30
    layers of weights (378 MB of int8, > L2) as the decode does; and the
    error at M=32 (the batch route's 8 texts x 4 candidates)."""
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(1)
    tot = dict(bytes=0.0, flops=0.0)
    err_max, tol = 0.0, 3e-2   # |y| <~ 1.5: 1 bf16 ulp is <= 8e-3
    for name, kd, nd, ln in GEMV_SHAPES:
        wq = torch.randint(-127, 128, (layers, kd, nd), generator=g,
                           device=dev, dtype=torch.int8)
        s = torch.rand(layers, nd, generator=g, device=dev) * 2e-4
        bias = torch.randn(layers, nd, generator=g, device=dev) * 0.1
        bias16 = bias.to(torch.bfloat16)
        gam = 1 + 0.1 * torch.randn(layers, kd, generator=g, device=dev)
        bet = 0.1 * torch.randn(layers, kd, generator=g, device=dev)
        x = torch.randn(1, kd, generator=g, device=dev).to(torch.bfloat16)

        def lnp(li):
            return (gam[li], bet[li]) if ln else None
        got = k2.qgemv(x, wq[0], s[0], bias[0], ln=lnp(0))
        want = k2.qgemv_plain(x, wq[0], s[0], bias[0], ln=lnp(0))
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert math.isfinite(err) and err <= tol, f"qgemv {name} err {err}"
        x32 = torch.randn(32, kd, generator=g, device=dev).to(torch.bfloat16)
        err32 = bf16_err(torch, k2.qgemv(x32, wq[1], s[1], bias[1],
                                         ln=lnp(1)),
                         k2.qgemv_plain(x32, wq[1], s[1], bias[1], ln=lnp(1)),
                         atol=tol, rtol=0, name=f"qgemv {name} M=32")
        err_max = max(err_max, err, err32)
        wdq = (wq.float() * s[:, None, :]).to(torch.bfloat16)
        wdq_t = wdq.transpose(1, 2).contiguous()      # (L, N, K) for linear
        del wdq
        t = timings(
            torch,
            lambda i: k2.qgemv(x, wq[i % layers], s[i % layers],
                               bias[i % layers], ln=lnp(i % layers)),
            lambda i: k2.qgemv_plain(x, wq[i % layers], s[i % layers],
                                     bias[i % layers], ln=lnp(i % layers)),
            lambda i: F.linear(x, wdq_t[i % layers], bias16[i % layers]))
        del wdq_t
        nbytes = kd * nd + kd * 2 + nd * 4 * 2 + (2 * kd * 4 if ln else 0) \
            + nd * 2
        emit("kernel_detail", name="qgemv", gemv=name, shape=[1, kd, nd],
             ln=ln, max_abs_err=err, max_abs_err_m32=err32,
             bound_ms=bound_ms(nbytes, 2 * kd * nd)[0], **t)
        for key, val in t.items():
            tot[key] = tot.get(key, 0.0) + val
        tot["bytes"] += nbytes
        tot["flops"] += 2 * kd * nd
    bms, by = bound_ms(tot.pop("bytes"), tot.pop("flops"))
    emit("kernel", name="qgemv", shape="one decode layer: 4 GEMVs, M=1",
         max_abs_err=err_max, tol=tol,
         library="F.linear on pre-dequantized bf16 weights (2x the bytes)",
         bound_ms=bms, bound_by=by, **tot)
    return dict(max_abs_err=err_max, bound_ms=bms, bound_by=by, **tot)


def _w8a8_case(torch, k8, x, wq, s, b, ln) -> tuple:
    """One K8 call against its plain version.  fp32 without the LN: the
    codes, the row scales and the output bit-equal.  Otherwise the LN's
    sums run in another order, so an activation on a rounding edge may
    take the next int8 code: every code within one step, the output the
    plain epilogue of the kernel's own codes bit for bit, and |y - plain|
    within what the differing codes and scales allow (one int8 step per
    differing code times |w| sx s, the scale's change times |acc| s) plus
    a rounding of the output type.  Returns (max abs err, codes that
    differ, rows with a differing code)."""
    y, codes, sx = k8.qgemv_w8a8_codes(x, wq, s, b, ln=ln)
    xn = x if ln is None else k8.ln_f32(x.float(), *ln).to(x.dtype)
    pcodes, psx = k8.quantize_rowwise(xn)
    psx = psx[:, 0]
    want = k8.qgemv_w8a8_plain(x, wq, s, b, ln=ln)
    torch.cuda.synchronize()
    dq = (codes.int() - pcodes.int()).abs()
    n_codes, n_rows = int((dq > 0).sum()), int((dq > 0).any(1).sum())
    err = float((y.float() - want.float()).abs().max())
    case = f"K8 {tuple(wq.shape)} M={x.shape[0]} {x.dtype} ln={ln is not None}"
    assert math.isfinite(err), case
    if x.dtype == torch.float32 and ln is None:
        assert n_codes == 0 and torch.equal(sx, psx), case
        assert torch.equal(y, want), f"{case}: err {err}"
        return err, 0, 0
    assert int(dq.max()) <= 1, f"{case}: a code {int(dq.max())} steps off"
    wd = wq.double()
    acc = codes.double() @ wd
    own = acc.float() * sx[:, None] * s
    if b is not None:
        own = own + b
    assert torch.equal(y, own.to(x.dtype)), f"{case}: epilogue differs"
    s64, acc_p = s.double(), pcodes.double() @ wd
    ulp = 2.0 ** -7 if x.dtype == torch.bfloat16 else 2.0 ** -22
    bound = ((dq.double() @ wd.abs()) * psx[:, None].double() * s64
             + acc.abs() * (sx - psx).abs()[:, None].double() * s64
             + ulp * ((acc_p * psx[:, None].double() * s64).abs()
                      + want.double().abs()
                      + (0 if b is None else b.double().abs())))
    over = int(((y.double() - want.double()).abs() > bound).sum())
    assert over == 0, f"{case}: {over} outputs past the bound, err {err}"
    return err, n_codes, n_rows


def check_qgemv_w8a8(torch, k8, k2, dev, layers=30):
    """K8 at the four decode GEMVs.  Right: at M = 1, 16 and 32, with and
    without the fused LN, in fp32 and bf16 (``_w8a8_case``).  Time per
    layer (4 GEMVs, the LN fused where the decode fuses it, bf16, each
    GEMV cycling over 30 layers of int8 weights as the decode does) at
    M=1, the main path's, and M=32, beside K2 at the same M in the same
    run and ``torch._int_mm`` on the quantized rows at M=32 (its CUDA
    shape rule needs more than 16 rows; at M=1 no PyTorch call computes
    the function)."""
    g = torch.Generator(device=dev).manual_seed(3)
    tot = {m: dict(bytes=0.0, ops=0.0) for m in (1, 32)}
    err_max, cases = 0.0, []
    for name, kd, nd, ln_model in GEMV_SHAPES:
        wq = torch.randint(-127, 128, (layers, kd, nd), generator=g,
                           device=dev, dtype=torch.int8)
        s = torch.rand(layers, nd, generator=g, device=dev) * 2e-4
        bias = torch.randn(layers, nd, generator=g, device=dev) * 0.1
        gam = 1 + 0.1 * torch.randn(layers, kd, generator=g, device=dev)
        bet = 0.1 * torch.randn(layers, kd, generator=g, device=dev)
        for m in (1, 16, 32):
            for ln in (False, True):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn(m, kd, generator=g, device=dev).to(dtype)
                    err, nc, nr = _w8a8_case(torch, k8, x, wq[0], s[0],
                                             bias[0],
                                             (gam[0], bet[0]) if ln else None)
                    err_max = max(err_max, err)
                    cases.append(dict(gemv=name, m=m, ln=ln,
                                      dtype=str(dtype)[6:], max_abs_err=err,
                                      codes_differ=nc, rows_differ=nr))

        def lnp(li):
            return (gam[li], bet[li]) if ln_model else None
        for m in (1, 32):
            x = torch.randn(m, kd, generator=g, device=dev).to(torch.bfloat16)
            t = timings(
                torch,
                lambda i: k8.qgemv_w8a8(x, wq[i % layers], s[i % layers],
                                        bias[i % layers], ln=lnp(i % layers)),
                (lambda i: k8.qgemv_w8a8_plain(
                    x, wq[i % layers], s[i % layers], bias[i % layers],
                    ln=lnp(i % layers))) if m == 1 else None,
                None)
            t["k2_ms"] = device_ms(torch, lambda i: k2.qgemv(
                x, wq[i % layers], s[i % layers], bias[i % layers],
                ln=lnp(i % layers)))
            if m == 32:
                xq = k8.quantize_rowwise(x)[0]
                t["library_ms"] = device_ms(
                    torch, lambda i: torch._int_mm(xq, wq[i % layers]))
                t["library_call_ms"] = call_ms(
                    torch, lambda i: torch._int_mm(xq, wq[i % layers]))
            nbytes = (kd * nd + m * kd * 2 + nd * 4 * 2
                      + (2 * kd * 4 if ln_model else 0) + m * nd * 2)
            emit("kernel_detail", name="qgemv_w8a8", gemv=name,
                 shape=[m, kd, nd], ln=ln_model,
                 bound_ms=bound_ms(nbytes, 2 * m * kd * nd, INT8_OPS)[0],
                 **t)
            for key, val in t.items():
                tot[m][key] = (None if val is None
                               else tot[m].get(key, 0.0) + val)
            tot[m]["bytes"] += nbytes
            tot[m]["ops"] += 2 * m * kd * nd
        del wq
        torch.cuda.empty_cache()
    emit("kernel_detail", name="qgemv_w8a8", checks=cases)
    out = {}
    for m in (1, 32):
        bms, by = bound_ms(tot[m].pop("bytes"), tot[m].pop("ops"), INT8_OPS)
        emit("kernel_detail" if m > 1 else "kernel", name="qgemv_w8a8",
             shape=f"one decode layer: 4 GEMVs, M={m}",
             max_abs_err=err_max, checks=len(cases),
             codes_differ=sum(c["codes_differ"] for c in cases),
             rows_differ=sum(c["rows_differ"] for c in cases),
             library=("torch._int_mm on the quantized rows (the integer "
                      "product only)" if m > 1 else None),
             bound_ms=bms, bound_by=by, **tot[m])
        out[m] = dict(bound_ms=bms, bound_by=by, **tot[m])
    return dict(max_abs_err=err_max, **out[1],
                m32_ms=out[32]["ms"], m32_k2_ms=out[32]["k2_ms"],
                m32_bound_ms=out[32]["bound_ms"],
                m32_library_ms=out[32]["library_ms"])


def check_flash_decode(torch, k3, dev, slots, layers=30, report=True):
    """K3 at the last step of a decode with a cache of ``slots`` slots
    (B=1, H=16, Dh=64), cycling over 30 layers of cache as the decode
    does; a padded text tail in the prefix."""
    F = torch.nn.functional
    b, h, dh = 1, 16, 64
    pos = slots - 1
    g = torch.Generator(device=dev).manual_seed(2)
    ck = torch.randn(layers, b, h, slots, dh, generator=g, device=dev,
                     dtype=torch.bfloat16)
    cv = torch.randn(layers, b, h, slots, dh, generator=g, device=dev,
                     dtype=torch.bfloat16)
    qkv = torch.randn(b, 3 * h * dh, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q = qkv[:, :h * dh].view(b, h, dh)
    mask = torch.ones(b, slots, dtype=torch.bool, device=dev)
    mask[:, 55:67] = False
    got = k3.flash_decode(q, ck[0], cv[0], pos, mask)
    want = k3.flash_decode_plain(q, ck[0], cv[0], pos, mask)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 5e-2      # as for flash_attention
    assert math.isfinite(err) and err <= tol, f"flash_decode err {err}"
    q4 = q[:, :, None]
    am = mask[:, None, None, :pos + 1]
    t = timings(
        torch,
        lambda i: k3.flash_decode(q, ck[i % layers], cv[i % layers], pos,
                                  mask),
        lambda i: k3.flash_decode_plain(q, ck[i % layers], cv[i % layers],
                                        pos, mask),
        lambda i: F.scaled_dot_product_attention(
            q4, ck[i % layers][:, :, :pos + 1],
            cv[i % layers][:, :, :pos + 1], attn_mask=am))
    nbytes = 2 * b * h * (pos + 1) * dh * 2 + 2 * b * h * dh * 2 + (pos + 1)
    flops = 4 * b * h * (pos + 1) * dh
    bms, by = bound_ms(nbytes, flops)
    emit("kernel" if report else "kernel_detail", name="flash_decode",
         shape=[b, h, slots, dh], pos=pos, max_abs_err=err, tol=tol,
         library="scaled_dot_product_attention", bound_ms=bms, bound_by=by,
         **t)
    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, **t)


def check_flash_decode_shared(torch, k3, dev, c=16, sp=1 + BUCKET + 2 + 1,
                              sd=AR_STEPS, layers=30):
    """K3's shared form at the candidates route's last decode step: G=1
    group of 16 candidates, a 68-slot prefix (cond, the 64-token text
    bucket with its padded tail masked, start_mel) and a 200-slot region
    up to pos = 199, cycling over 30 layers of cache.  No single PyTorch
    call takes a prefix held once per group beside per-row regions; SDPA
    over the same slots concatenated per row (built outside the timed
    call) is printed as ``sdpa_concat_ms`` for scale."""
    F = torch.nn.functional
    h, dh, pos = 16, 64, sd - 1
    g = torch.Generator(device=dev).manual_seed(4)
    kp, vp = (torch.randn(layers, 1, h, sp, dh, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    kd, vd = (torch.randn(layers, c, h, sd, dh, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    qkv = torch.randn(c, 3 * h * dh, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q = qkv[:, :h * dh].view(c, h, dh)
    pmask = torch.ones(1, sp, dtype=torch.bool, device=dev)
    pmask[:, 55:67] = False
    got = k3.flash_decode_shared(q, kp[0], vp[0], pmask, kd[0], vd[0], pos)
    want = k3.flash_decode_shared_plain(q, kp[0], vp[0], pmask, kd[0], vd[0],
                                        pos)
    err = bf16_err(torch, got, want, atol=5e-2, rtol=0,
                   name="flash_decode_shared")
    kc = torch.cat([kp[0].expand(c, -1, -1, -1), kd[0][:, :, :pos + 1]], 2)
    vc = torch.cat([vp[0].expand(c, -1, -1, -1), vd[0][:, :, :pos + 1]], 2)
    am = torch.cat([pmask, torch.ones(1, pos + 1, dtype=torch.bool,
                                      device=dev)], 1)[:, None, None]
    t = timings(
        torch,
        lambda i: k3.flash_decode_shared(q, kp[i % layers], vp[i % layers],
                                         pmask, kd[i % layers],
                                         vd[i % layers], pos),
        lambda i: k3.flash_decode_shared_plain(
            q, kp[i % layers], vp[i % layers], pmask, kd[i % layers],
            vd[i % layers], pos),
        None)
    sdpa_ms = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=am))
    # the prefix read once, each row's region up to pos, q and o, the mask
    nbytes = (2 * h * sp * dh * 2 + 2 * c * h * (pos + 1) * dh * 2
              + 2 * c * h * dh * 2 + sp)
    flops = 4 * c * h * (sp + pos + 1) * dh
    bms, by = bound_ms(nbytes, flops)
    emit("kernel", name="flash_decode_shared", shape=dict(
        g=1, c=c, h=h, sp=sp, sd=sd, pos=pos), max_abs_err=err, tol=5e-2,
        library=None, sdpa_concat_ms=sdpa_ms, bound_ms=bms, bound_by=by,
        **t)
    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, **t)


def _bias_attn_inputs(torch, dev, b, h, t, dtype, seed, n_bias=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn(b, h * 192, t, generator=g, device=dev)
           * 0.5).to(dtype)
    bias = [(torch.randn(h, t, t, generator=g, device=dev) * 2).to(dtype)
            for _ in range(n_bias)]
    return qkv, bias


def check_flash_attention_bias(torch, k6, dev):
    """K6 at the batch route's shapes (T=896, H=16): the cond-free trunk
    at B=16 and the integrator at B=8, each cycling over 4 biases (every
    attention block has its own, 25.7 MB each); a ragged T=300 and fp32
    (T=257, odd: the unvectorised loads) for the error only; and B=2, the
    single route's shape, a data point beside the plain path that shape
    takes (``route_plain_ms``).  The row sums the B=16 and B=8 calls.  The library call is
    SDPA on the (B, H, T, 64) views of the fused qkv with the bias as a
    float mask; the output's copy back to channels-major is inside its
    timed call, as the kernel writes channels-major."""
    from tortoise_tts_tpu_torch.ops import attention
    F = torch.nn.functional
    tol = dict(atol=3e-2, rtol=2e-2)   # |o| <~ 2: one bf16 ulp <= 1.6e-2

    def sdpa(qkv, bias, h):
        b, _, t = qkv.shape
        q, k, v = qkv.view(b, h, 3, 64, t).transpose(-1, -2).unbind(2)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return o.transpose(-1, -2).reshape(b, h * 64, t)

    for b, h, t, dtype, seed in ((8, 16, 300, torch.bfloat16, 40),
                                 (8, 2, 257, torch.float32, 41)):
        qkv, (bias,) = _bias_attn_inputs(torch, dev, b, h, t, dtype, seed)
        got = k6.flash_attention_bias(qkv, bias, h)
        want = k6.flash_attention_bias_plain(qkv, bias, h)
        err = bf16_err(torch, got, want, name=f"K6 T={t} {dtype}",
                       **(dict(atol=1e-5, rtol=1e-5)
                          if dtype == torch.float32 else tol))
        emit("kernel_detail", name="flash_attention_bias", shape=[b, h, t],
             dtype=str(dtype), max_abs_err=err)
    tot = dict(bytes=0.0, flops=0.0)
    err_max = 0.0
    for b, role in ((16, "trunk"), (8, "integrator"), (2, "single_route")):
        h, t = 16, 896
        qkv, biases = _bias_attn_inputs(torch, dev, b, h, t, torch.bfloat16,
                                        42 + b, n_bias=4)
        got = k6.flash_attention_bias(qkv, biases[0], h)
        want = k6.flash_attention_bias_plain(qkv, biases[0], h)
        err = bf16_err(torch, got, want, name=f"K6 B={b}", **tol)
        del got, want
        t_ = timings(
            torch, lambda i: k6.flash_attention_bias(qkv, biases[i % 4], h),
            lambda i: k6.flash_attention_bias_plain(qkv, biases[i % 4], h),
            lambda i: sdpa(qkv, biases[i % 4], h))
        nbytes = 4 * b * h * 64 * t * 2 + h * t * t * 2
        flops = 2 * 2 * b * h * t * t * 64
        extra = {}
        if role == "single_route":
            # what the single route runs at this shape instead: the plain
            # path of ops/attention.qkv_attention (bf16 scores)
            extra["route_plain_ms"] = device_ms(
                torch, lambda i: attention.qkv_attention(
                    qkv, h, bias=biases[i % 4]))
        emit("kernel_detail", name="flash_attention_bias", role=role,
             shape=[b, h, t], max_abs_err=err, tol=tol,
             bound_ms=bound_ms(nbytes, flops)[0],
             bound_by=bound_ms(nbytes, flops)[1], **t_, **extra)
        if role == "single_route":
            continue
        err_max = max(err_max, err)
        for key, val in t_.items():
            tot[key] = tot.get(key, 0.0) + val
        tot["bytes"] += nbytes
        tot["flops"] += flops
        torch.cuda.empty_cache()
    bms, by = bound_ms(tot.pop("bytes"), tot.pop("flops"))
    emit("kernel", name="flash_attention_bias",
         shape="two calls: (16,16,896) trunk + (8,16,896) integrator",
         max_abs_err=err_max, tol=tol,
         library="scaled_dot_product_attention, bias as a float mask "
         "(views in, channels-major copy out, both timed)", bound_ms=bms,
         bound_by=by, **tot)
    return dict(max_abs_err=err_max, bound_ms=bms, bound_by=by, **tot)


def _gn_conv_inputs(torch, dev, b, c, t, m, k, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, c, t, generator=g, device=dev) * 2 + 0.5) \
        .to(torch.bfloat16)
    norm = {"scale": 1 + 0.1 * torch.randn(c, generator=g, device=dev),
            "bias": 0.1 * torch.randn(c, generator=g, device=dev)}
    bound = (c * k) ** -0.5
    conv = {"w": ((torch.rand(m, c, k, generator=g, device=dev) * 2 - 1)
                  * bound).to(torch.bfloat16),
            "b": (torch.rand(m, generator=g, device=dev) * 2 - 1) * bound}
    return x, norm, conv


RESBLOCK_TOL = dict(atol=3e-2, rtol=2e-2)   # 1-2 bf16 ulps at |y| <~ 4


def check_gn_conv(torch, k4, dev):
    """K4 at the denoiser's shapes (T=896): the resblock in-half at B=2
    (act, c_out=1024), the attention qkv head at B=2 (c_out=3072) and the
    integrator's in-half at B=1.  The row sums the three."""
    F = torch.nn.functional
    shapes = [("resblock_in_half", 2, 1024, True),
              ("attention_qkv_head", 2, 3072, False),
              ("integrator_in_half_b1", 1, 1024, True)]
    c, t, groups, eps = 1024, 896, 32, 1e-5
    tot = dict(bytes=0.0, flops=0.0)
    err_max = 0.0
    for i, (name, b, m, act) in enumerate(shapes):
        x, norm, conv = _gn_conv_inputs(torch, dev, b, c, t, m, 1, 10 + i)
        got = k4.gn_conv1x1(x, norm, conv, groups, act)
        want = k4.gn_conv1x1_plain(x, norm, conv, groups, act)
        err = bf16_err(torch, got, want, name=f"gn_conv {name}",
                       **RESBLOCK_TOL)
        err_max = max(err_max, err)
        g16, b16 = (norm[n].to(torch.bfloat16) for n in ("scale", "bias"))
        w16, bias16 = conv["w"], conv["b"].to(torch.bfloat16)

        def library(_, x=x, g16=g16, b16=b16, w16=w16, bias16=bias16,
                    act=act):
            h = F.group_norm(x, groups, g16, b16, eps)
            return F.conv1d(F.silu(h) if act else h, w16, bias16)
        t_ = timings(
            torch,
            lambda _, x=x, n=norm, cv=conv, a=act: k4.gn_conv1x1(
                x, n, cv, groups, a),
            lambda _, x=x, n=norm, cv=conv, a=act: k4.gn_conv1x1_plain(
                x, n, cv, groups, a),
            library)
        nbytes = 2 * b * c * t + 2 * m * c + 8 * c + 4 * m + 2 * b * m * t
        flops = 2 * b * m * c * t
        emit("kernel_detail", name="gn_conv", shape=name, b=b, c=c, t=t,
             c_out=m, act=act, max_abs_err=err, tol=RESBLOCK_TOL,
             library="F.group_norm + " + ("F.silu + " if act else "")
             + "F.conv1d", bound_ms=bound_ms(nbytes, flops)[0], **t_)
        for key, val in t_.items():
            tot[key] = tot.get(key, 0.0) + val
        tot["bytes"] += nbytes
        tot["flops"] += flops
    bms, by = bound_ms(tot.pop("bytes"), tot.pop("flops"))
    emit("kernel", name="gn_conv", shape="three calls: " + ", ".join(
        n for n, *_ in shapes), max_abs_err=err_max, tol=RESBLOCK_TOL,
        library="F.group_norm + (F.silu) + F.conv1d, two or three calls",
        bound_ms=bms, bound_by=by, **tot)
    return dict(max_abs_err=err_max, bound_ms=bms, bound_by=by, **tot)


def check_ts_res_block(torch, k5, dev):
    """K5 at the denoiser's trunk shape: B=2, C=1024, T=896."""
    F = torch.nn.functional
    b, c, t, groups, eps = 2, 1024, 896, 32, 1e-5
    h, norm, conv = _gn_conv_inputs(torch, dev, b, c, t, c, 3, 20)
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(b, c, t, generator=g, device=dev).to(torch.bfloat16)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=dev)) \
        .to(torch.bfloat16)
    got = k5.ts_res_block_out(h, x, emb, norm, conv, groups)
    want = k5.ts_res_block_out_plain(h, x, emb, norm, conv, groups)
    err = bf16_err(torch, got, want, name="ts_res_block", **RESBLOCK_TOL)
    g16, b16 = (norm[n].to(torch.bfloat16) for n in ("scale", "bias"))
    bias16 = conv["b"].to(torch.bfloat16)
    t_ = timings(
        torch, lambda _: k5.ts_res_block_out(h, x, emb, norm, conv, groups),
        lambda _: k5.ts_res_block_out_plain(h, x, emb, norm, conv, groups),
        lambda _: F.conv1d(F.group_norm(h, groups, g16, b16, eps),
                           conv["w"], bias16, padding=1))
    nbytes = 3 * 2 * b * c * t + 2 * 3 * c * c + 2 * b * 2 * c + 12 * c
    flops = 2 * b * c * 3 * c * t
    bms, by = bound_ms(nbytes, flops)
    emit("kernel", name="ts_res_block", shape=[b, c, t], max_abs_err=err,
         tol=RESBLOCK_TOL, library="F.group_norm + F.conv1d (two calls)",
         bound_ms=bms, bound_by=by, **t_)
    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, **t_)


def check_snake(torch, k7, dev):
    """K7 at the first and the last BigVGAN stage of the main path (906
    mel frames: 768 x 3624 and 24 x 231936, B=1).  The row sums the two.
    No single PyTorch call computes it."""
    tol = dict(atol=5e-2, rtol=2e-2)   # |y| <~ 6: one bf16 ulp <= 3.1e-2
    tot = dict(bytes=0.0, flops=0.0)
    err_max = 0.0
    for i, (c, t) in enumerate(((768, 3624), (24, 231936))):
        g = torch.Generator(device=dev).manual_seed(30 + i)
        x = torch.randn(1, c, t, generator=g, device=dev).to(torch.bfloat16)
        alpha = torch.exp(0.3 * torch.randn(c, generator=g, device=dev))
        inv_beta = 1 / (torch.exp(0.3 * torch.randn(c, generator=g,
                                                    device=dev)) + 1e-9)
        got = k7.snake_resample2(x, alpha, inv_beta)
        want = k7.snake_resample2_plain(x, alpha, inv_beta)
        err = bf16_err(torch, got, want, name=f"snake {c}x{t}", **tol)
        err_max = max(err_max, err)
        t_ = timings(
            torch,
            lambda _, x=x, a=alpha, ib=inv_beta: k7.snake_resample2(x, a, ib),
            lambda _, x=x, a=alpha, ib=inv_beta: k7.snake_resample2_plain(
                x, a, ib),
            None)
        # one read and one write in bf16; per input sample the two 6-tap
        # polyphase sums (24), two snakes (10, a sine each counted as
        # one) and the 12-tap down sum (24)
        nbytes, flops = 2 * 2 * c * t + 8 * c, 58 * c * t
        emit("kernel_detail", name="snake", shape=[1, c, t],
             max_abs_err=err, tol=tol,
             bound_ms=bound_ms(nbytes, flops, FP32_FLOPS)[0], **t_)
        for key, val in t_.items():
            tot[key] = None if val is None else tot.get(key, 0.0) + val
        tot["bytes"] += nbytes
        tot["flops"] += flops
    bms, by = bound_ms(tot.pop("bytes"), tot.pop("flops"), FP32_FLOPS)
    emit("kernel", name="snake", shape="768x3624 + 24x231936, B=1",
         max_abs_err=err_max, tol=tol, library=None, bound_ms=bms,
         bound_by=by, **tot)
    return dict(max_abs_err=err_max, bound_ms=bms, bound_by=by, **tot)


# ---------------------------------------------------------------------------
# phases 4-6: the port's entry points
# ---------------------------------------------------------------------------


def reference_wav(path: Path, seconds: float = 4.0, sr: int = 22050,
                  seed: int = 0):
    from tortoise_tts_tpu_torch.utils.io import write_wav
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 140 + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6))
    wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) \
        + 0.01 * rng.randn(t.size)
    write_wav(path, wav.astype(np.float32), sr)
    return str(path)


def _w8a8_tiny_routes(torch, tts, ref: str, layers: int) -> dict:
    """Every decode route of a tiny ``TTS`` on the card with
    ``decode_quant="w8a8"``, each with the launch counts at 0 before it:
    K8 four times per layer and decoded token, K2 never."""
    from tortoise_tts_tpu_torch import kernels
    kw = dict(max_ar_steps=24, seed=1)
    routes = {
        "bigvgan": lambda: tts.inference(TEXT, ref, max_diffusion_steps=2,
                                         **kw)[0],
        "hifigan": lambda: tts.inference(TEXT, ref, vocoder_type="hifigan",
                                         **kw)[0],
        "stream": lambda: np.concatenate(list(tts.stream(TEXT, ref, **kw))),
        "batch": lambda: np.concatenate(tts.batch_inference(
            [TEXT, "A second, shorter row."], ref, max_diffusion_steps=2,
            **kw)[0]),
        "candidates": lambda: tts.inference(TEXT, ref, candidates=2,
                                            max_diffusion_steps=2, **kw)[0]}
    out = {}
    for name, run in routes.items():
        kernels.reset_launches()
        wav = run()
        torch.cuda.synchronize()
        c = kernels.launch_counts()
        assert np.isfinite(wav).all() and wav.size > 0, name
        assert c[W8A8] > 0 and c[W8A8] % (4 * layers) == 0, (name, c)
        assert c["qgemv"] == 0, (name, c)
        out[name] = c[W8A8]
    return out


def check_reference(torch, ref: str):
    """Tiny models (UnifiedVoice 2 layers x 128 wide, head dim 64; the
    denoiser 64 channels x 2 layers, 4 heads; BigVGAN and HiFiGAN from 64
    channels) through the same entry points, both routes: on the card in
    fp32 through the kernels, on the CPU through the plain versions.  TF32
    is off for both convolutions and matmuls so the two run the same fp32
    arithmetic; the diffusion noise is drawn on the CPU and handed to
    both.  Then the same ``TTS`` with ``decode_quant="w8a8"`` (switched as
    the CLI switches it): the greedy W8A8 decode on the card (K8) and on
    the CPU (its plain version) gives the same codes, and on the card
    every decode route (the BigVGAN and HiFiGAN ``inference``, ``stream``,
    ``batch_inference`` and ``candidates``) launches K8 and never K2."""
    from tortoise_tts_tpu_torch import inference, kernels
    from tortoise_tts_tpu_torch.config import Config, Inference
    from tortoise_tts_tpu_torch.inference import TTS
    from tortoise_tts_tpu_torch.models import (LoadedModel, _bigvgan_random,
                                               _hifigan_random, bigvgan, clvp,
                                               diffusion, hifigan,
                                               unified_voice)
    from tortoise_tts_tpu_torch.models.common import tree_map
    from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ucfg = unified_voice.UnifiedVoiceConfig(layers=2, model_dim=128, heads=2)
    hcfg = hifigan.HifiganConfig(in_channels=128, cond_channels=128,
                                 upsample_initial_channel=64)
    dcfg = diffusion.DiffusionConfig(model_channels=64, num_layers=2,
                                     num_heads=4, in_latent_channels=128)
    bcfg = bigvgan.BigVGANConfig(upsample_initial_channel=64)
    g = torch.Generator().manual_seed(5)
    params = unified_voice.init(g, ucfg)
    params["mel_head"]["w"] *= 8.0
    hparams = _hifigan_random(g, hcfg)
    dparams = diffusion.init(g, dcfg)
    # non-zero attention outputs, so every attention block contributes
    for lyr in dparams["conditioning_timestep_integrator"] + \
            dparams["layers"]:
        w = lyr["attn"]["proj_out"]["w"]
        w.copy_(0.1 * torch.randn(w.shape, generator=g))
    bparams = _bigvgan_random(g, bcfg)
    ccfg = clvp.CLVPConfig(dim_text=64, dim_speech=64, dim_latent=64,
                           text_enc_depth=1, speech_enc_depth=1,
                           text_heads=2, speech_heads=2, dim_head=32,
                           rotary_dim=16)
    cparams = clvp.init(g, ccfg)
    cfg = Config(inference=Inference(weight_dtype="float32"))
    w8a8 = dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, decode_quant="w8a8"))
    draw_noise = inference._diffusion_noise

    def cpu_noise(key, shape, device):
        return draw_noise(key, shape, "cpu").to(device)
    inference._diffusion_noise = cpu_noise
    out, routes8 = {}, None
    try:
        for where in ("cuda", "cpu"):
            tts = TTS(cfg, device=where, dtype="float32")
            move = lambda t: t.to(where)  # noqa: E731
            tts._models = {
                name: LoadedModel(name, mod, c, tree_map(move, p), False)
                for name, mod, c, p in (
                    ("autoregressive", unified_voice, ucfg, params),
                    ("hifigan", hifigan, hcfg, hparams),
                    ("diffusion", diffusion, dcfg, dparams),
                    ("bigvgan", bigvgan, bcfg, bparams),
                    ("clvp", clvp, ccfg, cparams))}
            before = dict(kernels.launch_counts())
            wav, _ = tts.inference(TEXT, ref, max_ar_steps=80,
                                   vocoder_type="hifigan", greedy=True,
                                   seed=0)
            bwav, _ = tts.inference(TEXT, ref, max_ar_steps=80,
                                    max_diffusion_steps=10, greedy=True,
                                    seed=0)
            enc = tts.encode_audio(ref, seed=0)
            toks = tts._bucket_text(tts.encode_text(TEXT))
            res = unified_voice.inference_speech(
                tts._model("autoregressive").params, enc["latent"][0],
                torch.as_tensor(toks[None], device=where),
                torch.tensor([len(tts.encode_text(TEXT))], device=where),
                None, ucfg, SamplingConfig(greedy=True), 80,
                qgpt=tts._ar_qgpt())
            launched = {k: v - before[k]
                        for k, v in kernels.launch_counts().items()}
            tts.cfg = w8a8
            kernels.reset_launches()
            res8 = unified_voice.inference_speech(
                tts._model("autoregressive").params, enc["latent"][0],
                torch.as_tensor(toks[None], device=where),
                torch.tensor([len(tts.encode_text(TEXT))], device=where),
                None, ucfg, SamplingConfig(greedy=True), 80,
                qgpt=tts._ar_qgpt(), quant_mode=tts._quant_mode)
            launched8 = kernels.launch_counts()
            out[where] = (wav, bwav, res.codes.cpu().numpy(), launched,
                          res8.codes.cpu().numpy(), launched8)
            if where == "cuda":
                routes8 = _w8a8_tiny_routes(torch, tts, ref, ucfg.layers)
    finally:
        inference._diffusion_noise = draw_noise
        torch.backends.cudnn.allow_tf32 = True
    (wg, bg, cg, lg, c8g, l8g), (wc, bc, cc, lc, c8c, l8c) = \
        out["cuda"], out["cpu"]
    assert l8g[W8A8] == 80 * 4 * ucfg.layers and l8g["qgemv"] == 0, l8g
    assert not any(l8c.values()), f"CPU run launched kernels: {l8c}"
    assert np.array_equal(c8g, c8c), "W8A8 greedy codes differ GPU/CPU"
    assert len(set(c8g[0].tolist())) > 3
    # the single routes' kernels; K6 and K3's shared form run in
    # check_reference_batch
    assert all(v > 0 for k, v in lg.items() if k not in INT8_ROUTE_IDLE), \
        f"kernels not reached: {lg}"
    assert lg[W8A8] == 0, lg
    assert not any(lc.values()), f"CPU run launched kernels: {lc}"
    assert np.array_equal(cg, cc), "greedy codes differ between GPU and CPU"
    assert wg.shape == wc.shape and np.isfinite(wg).all()
    assert bg.shape == bc.shape and np.isfinite(bg).all()
    assert np.count_nonzero(bg) > 1000
    err = float(np.abs(wg - wc).max())
    tol = 1e-3
    assert err <= tol, f"reference HiFiGAN wav err {err}"
    # the BigVGAN route ends in 16-bit PCM: 1/32767 is one step, and the
    # two runs may round a sample near a step's edge apart
    berr = float(np.abs(bg - bc).max())
    btol = 4 / 32767
    assert berr <= btol, f"reference BigVGAN wav err {berr}"
    emit("reference", codes_equal=True, n_codes=int(cg.shape[1]),
         wav_samples=int(wg.shape[0]), wav_max_abs_err=err, tol=tol,
         wav_mean_abs=float(np.abs(wc).mean()),
         bigvgan_wav_samples=int(bg.shape[0]), bigvgan_wav_max_abs_err=berr,
         bigvgan_tol=btol, bigvgan_wav_mean_abs=float(np.abs(bc).mean()),
         launches_on_card=lg, w8a8_codes_equal=True,
         w8a8_launches_on_card=l8g,
         w8a8_codes_differ_from_int8=int((c8g != cg).sum()),
         w8a8_routes=routes8)


def check_reference_batch(torch, ref: str):
    """Slice 3's entry points on tiny models, on the card (fp32, kernels)
    and on the CPU (plain versions), TF32 off and the diffusion noise
    drawn on the CPU, as in ``check_reference``: ``batch_inference`` over
    4 texts (greedy, one shared-max dispatch: 80 budget latents -> 96 ->
    T=417, so the cond-free trunk's batch of 8 takes K6; the denoiser is
    128 channels x 2 heads, head dim 64) and ``inference(candidates=4)``
    (greedy, K3's shared form and the CLVP rerank).  Every kernel must
    launch on the card; each row's wav within 4/32767.  A random tiny
    denoiser drives most of the mel to the sampler's clip at +-1, so the
    wavs alone say little about the denoiser: the first DDIM step's trunk
    output (B=8, through K6, before any clipping) is compared too, within
    1e-3 of its largest value.  Last, ``batch_inference`` over 8 texts x
    ``candidates=4``: one shared-prefix decode of 32 rows, K2 at M=32 on
    the card (more than K2 took before this slice), each wav within
    4/32767 of the CPU's."""
    from tortoise_tts_tpu_torch import inference, kernels
    from tortoise_tts_tpu_torch.config import Config, Inference
    from tortoise_tts_tpu_torch.inference import TTS
    from tortoise_tts_tpu_torch.models import (LoadedModel, _bigvgan_random,
                                               bigvgan, clvp, diffusion,
                                               unified_voice)
    from tortoise_tts_tpu_torch.models.common import tree_map
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ucfg = unified_voice.UnifiedVoiceConfig(layers=2, model_dim=128, heads=2)
    dcfg = diffusion.DiffusionConfig(model_channels=128, num_layers=2,
                                     num_heads=2, in_latent_channels=128)
    bcfg = bigvgan.BigVGANConfig(upsample_initial_channel=64)
    ccfg = clvp.CLVPConfig(dim_text=64, dim_speech=64, dim_latent=64,
                           text_enc_depth=2, speech_enc_depth=2,
                           text_heads=2, speech_heads=2, dim_head=32,
                           rotary_dim=16)
    g = torch.Generator().manual_seed(6)
    params = unified_voice.init(g, ucfg)
    params["mel_head"]["w"] *= 8.0
    dparams = diffusion.init(g, dcfg)
    for lyr in dparams["conditioning_timestep_integrator"] + \
            dparams["layers"]:
        w = lyr["attn"]["proj_out"]["w"]
        w.copy_(0.1 * torch.randn(w.shape, generator=g))
    models = (("autoregressive", unified_voice, ucfg, params),
              ("diffusion", diffusion, dcfg, dparams),
              ("bigvgan", bigvgan, bcfg, _bigvgan_random(g, bcfg)),
              ("clvp", clvp, ccfg, clvp.init(g, ccfg)))
    cfg = Config(inference=Inference(weight_dtype="float32"))
    texts = [TEXT, "A second sentence, not as long.", "Third.",
             "And the fourth one closes the batch."]
    texts8 = texts + ["Five.", "Six is a little longer.", "Seven, then",
                      "eight rows, each with four candidates."]
    gemv_rows = []
    qgemv = unified_voice.qgemv

    def recorded_qgemv(x, *args, **kw):
        gemv_rows.append(x.shape[0])
        return qgemv(x, *args, **kw)
    draw_noise = inference._diffusion_noise
    trunk = diffusion.forward_trunk
    first_trunk = []

    def cpu_noise(key, shape, device):
        return draw_noise(key, shape, "cpu").to(device)

    def recorded_trunk(*args, **kw):
        y = trunk(*args, **kw)
        if not first_trunk:
            first_trunk.append(y.float().cpu())
        return y
    inference._diffusion_noise = cpu_noise
    diffusion.forward_trunk = recorded_trunk
    out = {}
    try:
        for where in ("cuda", "cpu"):
            tts = TTS(cfg, device=where, dtype="float32")
            move = lambda t: t.to(where)  # noqa: E731
            tts._models = {name: LoadedModel(name, mod, c, tree_map(move, p),
                                             False)
                           for name, mod, c, p in models}
            kernels.reset_launches()
            first_trunk.clear()
            bw, _ = tts.batch_inference(texts, ref, max_ar_steps=80,
                                        max_diffusion_steps=4, greedy=True,
                                        seed=0, row_buckets=False)
            y = first_trunk[0]
            cw, _ = tts.inference(TEXT, ref, candidates=4, max_ar_steps=80,
                                  max_diffusion_steps=4, greedy=True, seed=0)
            counts = kernels.launch_counts()
            gemv_rows.clear()
            unified_voice.qgemv = recorded_qgemv
            w32, _ = tts.batch_inference(texts8, ref, candidates=4,
                                         max_ar_steps=24,
                                         max_diffusion_steps=2, greedy=True,
                                         seed=0, row_buckets=False)
            unified_voice.qgemv = qgemv
            assert set(gemv_rows) == {32}, set(gemv_rows)
            out[where] = (bw + [cw] + w32, counts, y)
    finally:
        inference._diffusion_noise = draw_noise
        diffusion.forward_trunk = trunk
        unified_voice.qgemv = qgemv
        torch.backends.cudnn.allow_tf32 = True
    (wg, lg, yg), (wc, lc, yc) = out["cuda"], out["cpu"]
    assert yg.shape == (2 * len(texts), 2 * 100, 417), yg.shape
    y_err, y_max = float((yg - yc).abs().max()), float(yc.abs().max())
    assert y_err <= 1e-3 * y_max, f"trunk output err {y_err} of {y_max}"
    missing = [k for k, v in lg.items() if v == 0 and k != W8A8]
    assert not missing, f"kernels not reached on the card: {missing}"
    assert not any(lc.values()), f"CPU run launched kernels: {lc}"
    tol = 4 / 32767
    errs = []
    for a, b in zip(wg, wc):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.count_nonzero(a) > 1000
        errs.append(float(np.abs(a - b).max()))
    assert max(errs) <= tol, f"reference batch/candidates wav errs {errs}"
    emit("reference_batch", rows=len(texts), rows_32=len(texts8) * 4,
         wav_samples=[int(w.size) for w in wc],
         trunk_shape=list(yc.shape), trunk_max_abs_err=y_err,
         trunk_max_abs=y_max, trunk_tol=1e-3 * y_max,
         wav_max_abs_err=errs, tol=tol,
         wav_mean_abs=[float(np.abs(w).mean()) for w in wc],
         launches_on_card=lg)


class Stages:
    """Wall seconds and kernel launches per stage of ``TTS.inference``: the
    stage functions of ``tortoise_tts_tpu_torch.inference`` are wrapped
    here (the library does not synchronise); each wrapper synchronises
    before and after its stage.  With ``profile`` set, the diffusion and
    vocoder stages run under torch.profiler and their CUDA kernels are
    counted by name."""

    NAMES = (("emb_mel", "encode_from_files", "encode"),
             ("inference", "inference_speech", "ar_decode"),
             ("inference", "inference_speech_shared", "ar_decode"),
             ("inference", "_cleanup_latents", "latent_pass"),
             ("inference", "_rerank_latents", "latent_pass"),
             ("inference", "_uncond_integrate", "uncond_cache"),
             ("inference", "_diffusion", "diffusion"),
             ("inference", "_vocode", "vocoder"))
    PROFILED = ("diffusion", "vocoder")

    def __init__(self, torch):
        from tortoise_tts_tpu_torch import inference, kernels
        from tortoise_tts_tpu_torch.emb import mel as emb_mel
        self.torch, self.kernels = torch, kernels
        self.profile = False
        self.undo = []
        mods = {"inference": inference, "emb_mel": emb_mel}
        for mod, attr, name in self.NAMES:
            m = mods[mod]
            orig = getattr(m, attr)
            self.undo.append((m, attr, orig))
            setattr(m, attr, self._wrap(orig, name))
        self.reset()

    def reset(self):
        self.seconds = {name: 0.0 for *_, name in self.NAMES}
        self.launches = {name: {} for *_, name in self.NAMES}
        self.cuda_kernels = {}
        self.diffusion_calls = []   # (rows, T) of each _diffusion call

    def _wrap(self, fn, name):
        torch, kernels = self.torch, self.kernels

        def timed(*args, **kw):
            if name == "diffusion":   # positional: latents, ..., seq_len,
                #                       ..., pad_seq_len
                self.diffusion_calls.append(
                    (args[1].shape[0], args[12] or args[7]))
            torch.cuda.synchronize()
            c0 = kernels.launch_counts()
            t0 = time.perf_counter()
            if self.profile and name in self.PROFILED:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    profiler_warmup(torch)
                    out = fn(*args, **kw)
                    torch.cuda.synchronize()
                # a stage called more than once in a run (the batch
                # route's length buckets) sums its calls
                self.cuda_kernels[name] = _sum_census(
                    self.cuda_kernels.get(name), _kernel_census(prof))
            else:
                out = fn(*args, **kw)
            torch.cuda.synchronize()
            self.seconds[name] += time.perf_counter() - t0
            for k, v in kernels.launch_counts().items():
                if v > c0[k]:
                    self.launches[name][k] = (self.launches[name].get(k, 0)
                                              + v - c0[k])
            return out
        return timed

    def close(self):
        for m, attr, orig in self.undo:
            setattr(m, attr, orig)


def _sum_census(a, b) -> dict:
    if a is None:
        return b
    out = {k: a[k] + b[k] for k in a if k != "device_ms_by_kind"}
    out["device_ms_by_kind"] = {k: a["device_ms_by_kind"][k]
                                + b["device_ms_by_kind"][k]
                                for k in a["device_ms_by_kind"]}
    return out


def _kernel_census(prof) -> dict:
    """CUDA kernels of one profiled stage: the launches and device ms of
    the port's K4 and K5 GEMMs (the ``gemm<T, TAPS>`` of csrc/resblock.cu,
    TAPS 1 and 3), their group statistics, K6 (``attn_bias<T>`` of
    csrc/flash_attention_bias.cu), K7 and all other kernels."""
    import re
    events = _cuda_events(prof)
    kinds = ("gn_conv_gemm", "ts_res_block_gemm", "group_stats",
             "attn_bias", "snake", "other")
    out = {k: 0 for k in kinds}
    ms = {k: 0.0 for k in kinds}
    for e in events:
        # demangled "(anonymous namespace)::gemm<__nv_bfloat16, 1>(...)",
        # or mangled "..4gemmI13__nv_bfloat16Li1EE.."
        m = (re.search(r"::gemm<[^>]*,\s*(\d)>", e.name)
             or re.search(r"4gemmI\w*?Li(\d)EE", e.name))
        if m:
            kind = "gn_conv_gemm" if m.group(1) == "1" \
                else "ts_res_block_gemm"
        elif "group_stats" in e.name:
            kind = "group_stats"
        elif "attn_bias" in e.name:
            kind = "attn_bias"
        elif "snake_resample2" in e.name:
            kind = "snake"
        else:
            kind = "other"
        out[kind] += 1
        ms[kind] += e.device_time / 1e3
    out["cuda_kernels"] = len(events)
    out["device_ms"] = sum(ms.values())
    out["device_ms_by_kind"] = ms
    return out


def bigvgan_route(torch, tts, ref: str):
    """This slice's main path, the default route, at full width: a cold
    call (it builds the cached unconditional integrator for T=896), a warm
    one, then a profiled one.  Per-step launch counts are checked against
    the denoiser's structure and against the profiler."""
    from tortoise_tts_tpu_torch import kernels
    dcfg = tts._model("diffusion").config
    stages = Stages(torch)
    runs = []
    try:
        for run in ("cold", "warm", "profiled"):
            if run == "cold":
                tts._voice_cache.clear()
                tts._uncond_cache.clear()
            stages.reset()
            stages.profile = run == "profiled"
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            wav, sr = tts.inference(TEXT, ref, seed=0, **ROUTE_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            emit("launches", route="bigvgan", run=run, **counts)
            missing = [k for k, v in counts.items()
                       if v == 0 and k not in INT8_ROUTE_IDLE]
            assert not missing, f"BigVGAN route never launched: {missing}"
            assert counts[W8A8] == 0, counts
            assert wav.ndim == 1 and wav.dtype == np.float32
            assert wav.size > 24000 and np.isfinite(wav).all()
            assert np.count_nonzero(wav) > 1000
            assert float(np.abs(wav).mean()) > 1e-4
            # 16-bit PCM, trimmed to whole 256-sample hops
            assert np.array_equal(np.round(wav * 32767.0), wav * 32767.0)
            assert wav.size % 256 == 0
            audio_s = wav.size / sr
            stage_s = dict(stages.seconds)
            stage_s["other"] = wall - sum(stage_s.values())
            runs.append((run, wav, counts, stage_s))
            emit("main_path", route="bigvgan", run=run, wall_s=wall,
                 audio_s=audio_s, rtf_x_realtime=audio_s / wall,
                 stage_s=stage_s, stage_launches=stages.launches,
                 diffusion_ms_per_step=stages.seconds["diffusion"] * 1e3
                 / DIFF_STEPS,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 **({"cuda_kernels": stages.cuda_kernels}
                    if run == "profiled" else {}))
            # K4 per DDIM step: 13 resblock in-halves (3 integrator at B=1,
            # 10 trunk, 3 final) + 13 attention heads (3 + 10); K5: 16
            nl = dcfg.num_layers
            per_k4, per_k5 = 2 * (3 + nl) + 3, 3 + nl + 3
            dl = stages.launches["diffusion"]
            pre = len(tts._model("diffusion").params[
                "latent_conditioner_attn"])
            assert dl.get("gn_conv") == pre + DIFF_STEPS * per_k4, dl
            assert dl.get("ts_res_block") == DIFF_STEPS * per_k5, dl
            n_up = len(tts._model("bigvgan").config.upsample_rates)
            n_snake = n_up * 3 * 6 + 1
            assert stages.launches["vocoder"].get("snake") == n_snake
            if run == "profiled":
                ck = stages.cuda_kernels
                assert ck["diffusion"]["gn_conv_gemm"] == dl["gn_conv"], ck
                assert ck["diffusion"]["ts_res_block_gemm"] == \
                    dl["ts_res_block"], ck
                assert ck["diffusion"]["group_stats"] == \
                    dl["gn_conv"] + dl["ts_res_block"], ck
                assert ck["vocoder"]["snake"] == n_snake, ck
    finally:
        stages.close()
    # device busy share of a stage: its summed kernel time (profiled run)
    # over its wall time in the warm run
    warm_s = runs[1][3]
    emit("bigvgan_counts", k4_per_ddim_step=per_k4,
         k5_per_ddim_step=per_k5, k7_per_utterance=n_snake,
         runs_identical=bool(np.array_equal(runs[0][1], runs[1][1])),
         device_busy_share={
             name: ck[name]["device_ms"] / 1e3 / warm_s[name]
             for name in Stages.PROFILED})
    return runs[1][2]


def _k6_expected(calls, steps: int, num_layers: int) -> int:
    """K6 launches of the cond-free diffusion calls (rows, T): per DDIM
    step the trunk's ``num_layers`` attention blocks at B = 2 rows and the
    integrator's 3 at B = rows, where B >= 8 and T >= 256."""
    return sum(steps * (num_layers * (2 * rows >= 8 and t >= 256)
                        + 3 * (rows >= 8 and t >= 256))
               for rows, t in calls)


def batch_route(torch, tts, ref: str):
    """``TTS.batch_inference`` over 8 copies of the text with bench.py's
    batch knobs (BENCH_MODE=batch): 8 rows decoded together (K2 at M=8,
    K3), the latent pass, the diffusion bucketed by row length (random
    weights decode the whole budget: one dispatch of 8 rows at T=896, so
    every attention block takes K6: 10 at B=16 and 3 at B=8 per DDIM
    step) and BigVGAN at B=8.  A warm call and a profiled one; the K6
    launches are checked against the dispatches and the profiler."""
    from tortoise_tts_tpu_torch import kernels
    texts = [TEXT] * BATCH_ROWS
    stages = Stages(torch)
    runs = []
    try:
        for run in ("warm", "profiled"):
            stages.reset()
            stages.profile = run == "profiled"
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            wavs, sr = tts.batch_inference(texts, ref, seed=1, top_p=0.9,
                                           **ROUTE_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            emit("launches", route="batch", run=run, **counts)
            missing = [k for k, v in counts.items()
                       if v == 0 and k not in ("flash_decode_shared", W8A8)]
            assert not missing, f"batch route never launched: {missing}"
            assert counts[W8A8] == 0, counts
            assert len(wavs) == BATCH_ROWS
            for w in wavs:
                assert w.ndim == 1 and w.dtype == np.float32
                assert w.size > 24000 and np.isfinite(w).all()
                assert float(np.abs(w).mean()) > 1e-4
                assert np.array_equal(np.round(w * 32767.0), w * 32767.0)
            audio_s = sum(w.size for w in wavs) / sr
            stage_s = dict(stages.seconds)
            stage_s["other"] = wall - sum(stage_s.values())
            calls = list(stages.diffusion_calls)
            dl = stages.launches["diffusion"]
            k6 = _k6_expected(calls, DIFF_STEPS,
                              tts._model("diffusion").config.num_layers)
            assert dl.get("flash_attention_bias", 0) == k6, (dl, calls)
            runs.append((run, wall, stage_s))
            emit("batch_route", run=run, wall_s=wall, audio_s=audio_s,
                 audio_s_per_wall_s=audio_s / wall, stage_s=stage_s,
                 diffusion_calls=calls, stage_launches=stages.launches,
                 k6_launches=dl.get("flash_attention_bias", 0),
                 k6_per_ddim_step=dl.get("flash_attention_bias", 0)
                 / (DIFF_STEPS * len(calls)),
                 diffusion_ms_per_step=stages.seconds["diffusion"] * 1e3
                 / DIFF_STEPS,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 **({"cuda_kernels": stages.cuda_kernels}
                    if run == "profiled" else {}))
            if run == "profiled":
                ck = stages.cuda_kernels["diffusion"]
                assert ck["attn_bias"] == k6, ck
                assert ck["gn_conv_gemm"] == dl["gn_conv"], ck
                assert ck["ts_res_block_gemm"] == dl["ts_res_block"], ck
    finally:
        stages.close()
    warm_s = runs[0][2]
    emit("batch_counts", k6_per_call=k6, diffusion_calls=calls,
         device_busy_share={name: ck_["device_ms"] / 1e3 / warm_s[name]
                            for name, ck_ in stages.cuda_kernels.items()})
    return counts


def candidates_route(torch, tts, ref: str):
    """``TTS.inference(text, ref, candidates=16)`` (BENCH_MODE=candidates):
    a shared-prefix decode of 16 rows, one prefill whose K/V every row
    reads through K3's shared form (30 launches a token, K2 at M=16), the
    CLVP rerank and the winner's latent pass, then the default route's
    diffusion and BigVGAN at B=1.  A warm call and a profiled one."""
    from tortoise_tts_tpu_torch import kernels
    stages = Stages(torch)
    runs = []
    layers = tts._model("autoregressive").config.layers
    try:
        for run in ("warm", "profiled"):
            stages.reset()
            stages.profile = run == "profiled"
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            wav, sr = tts.inference(TEXT, ref, candidates=CANDIDATES, seed=2,
                                    top_p=0.9, **ROUTE_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            emit("launches", route="candidates", run=run, **counts)
            need = ("flash_attention", "qgemv", "flash_decode_shared",
                    "gn_conv", "ts_res_block", "snake")
            missing = [k for k in need if counts[k] == 0]
            assert not missing, f"candidates route never launched: {missing}"
            assert counts["flash_decode"] == 0 and counts[W8A8] == 0, counts
            # one shared-form launch per layer and decoded token
            assert counts["flash_decode_shared"] % layers == 0, counts
            assert wav.ndim == 1 and wav.size > 24000
            assert np.isfinite(wav).all() and float(np.abs(wav).mean()) > 1e-4
            audio_s = wav.size / sr
            stage_s = dict(stages.seconds)
            stage_s["other"] = wall - sum(stage_s.values())
            runs.append((run, wall, stage_s))
            emit("candidates_route", run=run, wall_s=wall, audio_s=audio_s,
                 rtf_x_realtime=audio_s / wall, stage_s=stage_s,
                 stage_launches=stages.launches,
                 decode_tokens=counts["flash_decode_shared"] // layers,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 **({"cuda_kernels": stages.cuda_kernels}
                    if run == "profiled" else {}))
    finally:
        stages.close()
    warm_s = runs[0][2]
    emit("candidates_counts", device_busy_share={
        name: ck["device_ms"] / 1e3 / warm_s[name]
        for name, ck in stages.cuda_kernels.items()})
    return counts


def main_path(torch, ref: str):
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.inference import TTS
    t0 = time.time()
    tts = TTS(device="cuda")
    ar = tts._model("autoregressive")
    dm = tts._model("diffusion")
    voc = tts._model("bigvgan")
    tts._model("hifigan")
    tts._model("clvp")
    tts._ar_qgpt()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    cfg = ar.config
    assert (cfg.layers, cfg.model_dim, cfg.heads) == (30, 1024, 16)
    assert (dm.config.model_channels, dm.config.num_layers,
            dm.config.num_heads) == (1024, 10, 16)
    assert voc.config.upsample_initial_channel == 1536
    assert tts.dtype == "bfloat16" and tts.cfg.inference.decode_quant == "int8"
    # warm-up: cuBLAS/cuDNN handles and the voice cache, both routes
    tts.inference(TEXT, ref, max_ar_steps=8, max_diffusion_steps=2, seed=1)
    tts.inference(TEXT, ref, max_ar_steps=8, vocoder_type="hifigan", seed=1)
    torch.cuda.synchronize()
    emit("setup", seconds=setup_s)

    bv_counts = bigvgan_route(torch, tts, ref)

    kernels.reset_launches()
    t0 = time.time()
    wav, sr = tts.inference(TEXT, ref, max_ar_steps=AR_STEPS,
                            vocoder_type="hifigan", seed=0)
    torch.cuda.synchronize()
    inf_s = time.time() - t0
    t0 = time.time()
    first_s, chunks = None, []
    for c in tts.stream(TEXT, ref, max_ar_steps=AR_STEPS, seed=0):
        if first_s is None:
            first_s = time.time() - t0
        chunks.append(c)
    stream_s = time.time() - t0
    counts = kernels.launch_counts()
    emit("launches", route="hifigan", **counts)
    missing = [k for k in ("flash_attention", "qgemv", "flash_decode")
               if counts[k] == 0]
    assert not missing, f"HiFiGAN route never launched: {missing}"
    assert counts[W8A8] == 0, counts

    swav = np.concatenate(chunks)
    for w in (wav, swav):
        assert w.ndim == 1 and w.dtype == np.float32 and w.size > 24000
        assert np.isfinite(w).all(), "non-finite audio"
        assert np.count_nonzero(w) > 1000 and float(np.abs(w).mean()) > 1e-4
    audio_s = wav.size / sr
    emit("main_path", route="hifigan", inference_s=inf_s, audio_s=audio_s,
         rtf_x_realtime=audio_s / inf_s, stream_s=stream_s,
         stream_first_chunk_s=first_s, stream_chunks=len(chunks),
         stream_audio_s=swav.size / sr,
         stream_rtf_x_realtime=swav.size / sr / stream_s,
         stream_vs_inference_max_abs=(
             float(np.abs(swav - wav).max()) if swav.size == wav.size
             else None),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return tts, {k: bv_counts[k] + counts[k] for k in counts}


def w8a8_route(torch, tts, ref: str):
    """The default route at the shipped widths with bench.py's single
    knobs on the same ``TTS``, switched to ``decode_quant="w8a8"`` as the
    CLI switches it (the cached int8 weights serve both modes): one warm
    call with the launch counts at 0 before it.  Stage seconds, RTF, peak
    memory; K8 four times per layer and decoded token, K2 never."""
    from tortoise_tts_tpu_torch import kernels
    int8_cfg = tts.cfg
    tts.cfg = dataclasses.replace(int8_cfg, inference=dataclasses.replace(
        int8_cfg.inference, decode_quant="w8a8"))
    layers = tts._model("autoregressive").config.layers
    stages = Stages(torch)
    try:
        for run in ("warm",):
            stages.reset()
            kernels.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            wav, sr = tts.inference(TEXT, ref, seed=0, **ROUTE_KW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            emit("launches", route="w8a8", run=run, **counts)
            missing = [k for k, v in counts.items()
                       if v == 0 and k not in SLICE3_KERNELS + ("qgemv",)]
            assert not missing, f"W8A8 route never launched: {missing}"
            assert counts["qgemv"] == 0, counts
            tokens = counts["flash_decode"] // layers
            assert stages.launches["ar_decode"].get(W8A8) == \
                counts[W8A8] == 4 * layers * tokens, (stages.launches, counts)
            assert wav.ndim == 1 and wav.size > 24000
            assert np.isfinite(wav).all() and float(np.abs(wav).mean()) > 1e-4
            audio_s = wav.size / sr
            stage_s = dict(stages.seconds)
            stage_s["other"] = wall - sum(stage_s.values())
            emit("w8a8_route", run=run, wall_s=wall, audio_s=audio_s,
                 rtf_x_realtime=audio_s / wall, stage_s=stage_s,
                 stage_launches=stages.launches, decode_tokens=tokens,
                 k8_per_token=counts[W8A8] / tokens,
                 decode_ms_per_token=stage_s["ar_decode"] * 1e3 / tokens,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    finally:
        stages.close()
        tts.cfg = int8_cfg
    return counts


def decode_timing(torch, tts, ref: str, quant_mode: str,
                  steps: int = AR_STEPS):
    """Eager decode alone in ``quant_mode``: ms per token at the main
    path's shapes (the whole budget, unprofiled), and from the profiler
    over 8 tokens the CUDA launches and device ms per token by kernel,
    hence the device's busy share.  The GEMV kernels that the profiler
    counts must match the GEMV wrapper's launches (one GEMV kernel and
    one split-K merge per call at M=1)."""
    from torch.profiler import ProfilerActivity, profile
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.models.unified_voice import (decode_chunk,
                                                             decode_start)
    from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
    ar = tts._model("autoregressive")
    dev = tts.device
    enc = tts.encode_audio(ref, seed=0)
    toks = tts.encode_text(TEXT)
    tokens = torch.as_tensor(tts._bucket_text(toks)[None], device=dev)
    lengths = torch.tensor([len(toks)], device=dev)
    kw = dict(qgpt=tts._ar_qgpt(), quant_mode=quant_mode)

    def start():
        return decode_start(ar.params, enc["latent"][0], tokens, lengths,
                            [torch.Generator(device=dev).manual_seed(0)],
                            ar.config, steps)

    with torch.inference_mode():
        state = start()
        torch.cuda.synchronize()
        t0 = time.time()
        state = decode_chunk(ar.params, state, ar.config, SamplingConfig(),
                             chunk=None, **kw)
        torch.cuda.synchronize()
        dt = time.time() - t0
        n_tok = state.step
        state = start()
        decode_chunk(ar.params, state, ar.config, SamplingConfig(), chunk=8,
                     **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiler_warmup(torch)
            c0 = kernels.launch_counts()
            decode_chunk(ar.params, state, ar.config, SamplingConfig(),
                         chunk=8, **kw)
            torch.cuda.synchronize()
            c1 = kernels.launch_counts()
    events = _cuda_events(prof)
    by_name = {"qgemv": ("qgemv_kernel", "qgemv_finalize"),
               "qgemv_w8a8": ("w8a8_kernel", "w8a8_finalize"),
               "flash_decode": ("fd_split", "fd_merge")}
    split = {k: 0.0 for k in (*by_name, "other")}
    n_by = {p: 0 for pre in by_name.values() for p in pre}
    for e in events:
        key = next((k for k, pre in by_name.items()
                    if any(p in e.name for p in pre)), "other")
        split[key] += e.device_time / 1e3 / 8
        for p in n_by:
            n_by[p] += p in e.name
    gemv = "qgemv" if quant_mode == "int8" else W8A8
    calls = c1[gemv] - c0[gemv]
    assert calls == 8 * 4 * ar.config.layers, (c0, c1)
    kern, merge = by_name[gemv]
    assert n_by[kern] == calls and n_by[merge] == calls, (n_by, calls)
    busy = sum(split.values())
    emit("decode", quant_mode=quant_mode, tokens=n_tok,
         ms_per_token=dt * 1e3 / n_tok,
         cuda_launches_per_token=len(events) / 8,
         device_busy_ms_per_token=busy,
         device_busy_share=busy / (dt * 1e3 / n_tok),
         device_ms_per_token_by_kernel=split,
         gemv_cuda_kernels_per_token={p: n / 8 for p, n in n_by.items()},
         port_kernel_calls_per_token={gemv: calls / 8,
                                      "flash_decode": ar.config.layers})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.kernels import flash_attention as k1
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias as k6
    from tortoise_tts_tpu_torch.kernels import flash_decode as k3
    from tortoise_tts_tpu_torch.kernels import gn_conv as k4
    from tortoise_tts_tpu_torch.kernels import qgemv as k2
    from tortoise_tts_tpu_torch.kernels import qgemv_w8a8 as k8
    from tortoise_tts_tpu_torch.kernels import snake as k7
    from tortoise_tts_tpu_torch.kernels import ts_res_block as k5
    from tortoise_tts_tpu_torch.tokenizer import (VoiceBpeTokenizer,
                                                  write_char_tokenizer)

    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.time()
    logs = kernels.build_all()
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
            for n, log in logs.items()}
    emit("build", seconds=time.time() - t0, built=sorted(logs),
         ptxas=regs)

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["TORTOISE_TPU_TOKENIZER"] = str(
            write_char_tokenizer(Path(tmp) / "tokenizer.json"))
        n_text = len(VoiceBpeTokenizer().encode(TEXT))
        assert n_text <= BUCKET, n_text
        with torch.inference_mode():
            r1 = check_flash_attention(torch, k1, dev, n_text)
            r2 = check_qgemv(torch, k2, dev)
            r8 = check_qgemv_w8a8(torch, k8, k2, dev)
            r3 = check_flash_decode(torch, k3, dev,
                                    slots=1 + BUCKET + 2 + 1 + AR_STEPS)
            check_flash_decode(torch, k3, dev, slots=604, report=False)
            r4 = check_gn_conv(torch, k4, dev)
            r5 = check_ts_res_block(torch, k5, dev)
            r7 = check_snake(torch, k7, dev)
            r6 = check_flash_attention_bias(torch, k6, dev)
            r3s = check_flash_decode_shared(torch, k3, dev)
        torch.cuda.empty_cache()

        ref = reference_wav(Path(tmp) / "reference.wav")
        check_reference(torch, ref)
        check_reference_batch(torch, ref)
        tts, counts = main_path(torch, ref)
        for route in (batch_route, candidates_route, w8a8_route):
            c = route(torch, tts, ref)
            counts = {k: counts[k] + c[k] for k in counts}
        decode_timing(torch, tts, ref, "int8")
        decode_timing(torch, tts, ref, "w8a8")

    src = "tortoise_tts_tpu_torch/csrc/"
    rows = [
        ("flash_attention", "flash_attention.cu",
         "tortoise_tts_tpu/ops/pallas_attention.py:657", r1),
        ("qgemv", "qgemv.cu", "tortoise_tts_tpu/ops/pallas_gemv.py:152", r2),
        ("flash_decode", "flash_decode.cu",
         "tortoise_tts_tpu/ops/pallas_decode_attn.py:100", r3),
        ("gn_conv", "resblock.cu",
         "tortoise_tts_tpu/ops/pallas_resblock.py:97", r4),
        ("ts_res_block", "resblock.cu",
         "tortoise_tts_tpu/ops/pallas_resblock.py:179", r5),
        ("snake", "snake.cu", "tortoise_tts_tpu/ops/pallas_snake.py:217",
         r7),
        ("flash_attention_bias", "flash_attention_bias.cu",
         "tortoise_tts_tpu/ops/pallas_attention.py:209", r6),
        ("flash_decode_shared", "flash_decode.cu",
         "tortoise_tts_tpu/models/unified_voice.py:311", r3s),
        ("qgemv_w8a8", "qgemv_w8a8.cu",
         "tortoise_tts_tpu/ops/pallas_gemv.py:189", r8),
    ]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src + f, "replaces": rep,
         "launches": counts[n], **r} for n, f, rep, r in rows]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
