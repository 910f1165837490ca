#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``tortoise_tts_tpu_torch``) on one CUDA card and prints
one JSON line per phase:

1. ``env``: torch and CUDA versions, the card.
2. ``build``: builds every CUDA kernel from ``tortoise_tts_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and its build seconds; fails if
   ``ptxas`` spilled in the biased attention kernels (K6, K9a, K9b).
3. ``kernel``: each kernel against its plain PyTorch version in bf16 at
   the main path's shapes (K2 and K8 at the decode's M = 1, 8, 16 and
   32; max abs error against a stated tolerance), and
   the kernel's, the plain version's and one PyTorch library call's time
   beside the bound: the larger of the bytes the function must move over
   3.35 TB/s and its operations over 989 TFLOP/s (H100 SXM bf16 dense
   peak; 67 TFLOP/s for K7's fp32 arithmetic); K9a and both entries of
   K9b at B = 1, 2, 8 and 16 (T=896); K1 also at the batch's prefill
   (B=8) and, after the main path, at the latent pass's S read off the
   route, K3 also at 604 slots and at the batch's 8 rows, K7 also at the
   batch's first BigVGAN stage (B=8) (detail lines).
   Each K1 and K3 call is one CUDA kernel, and K3 with ``pos`` in device
   memory gives the int's output bit for bit.  ``ms`` is device time per
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
   diffusion's busy share, its device ms a DDIM step and K6's share of
   them, peak memory.
7. ``w8a8_route``: the default route again on the same ``TTS`` with
   ``decode_quant="w8a8"`` (the CLI's ``--decode-quant w8a8``): stage
   seconds, RTF, peak memory, K8's launches (4 per layer and token, K2
   none).
8. ``attention_route``: slice 5's paths on the same ``TTS``, switched by
   ``Inference.denoise_attention``: the default route with "kq" (every
   biased attention block through K9a) cold and warm, with "flash_bias"
   (through K9b's fused entry) cold and warm, and ``batch_inference`` over
   8 texts with "kq" (K9a in place of K6) warm and profiled; in the cold
   and the profiled calls the profiler's count of each kernel's
   ``__global__`` must match the wrapper counts (650 a warm call: 13
   blocks a DDIM step).
   Then ``attention_compare``: each route's first DDIM step's trunk
   output against the "auto" mode's on the same inputs (the 13 blocks'
   ``proj_out`` randomised for the phase, so the attention reaches it).
9. ``diffusion_pair``: ``inference._diffusion`` at the default route's
   geometry, B=1 (the denoiser at 2 rows) and B=8 (16), under each
   ``denoise_attention`` mode, its sampler loop eager (the step run 50
   times) and captured (``gaussian.sample_loop``: one CUDA graph,
   replayed): ms and device ms a DDIM step, capture seconds, and the two
   mels, equal bit for bit.
10. ``decode``: the decode alone, eager (its step run by
   ``unified_voice.advance``) and captured (``decode_chunk``: one CUDA
   graph a decode, replayed a token) from the same generator seeds: ms a
   token, CUDA kernels a token (from the profiler: a replay is one host
   call, so the captured run counts the graph's kernels), device ms a
   token, busy share and capture seconds, for the int8 and the W8A8
   decode, each at the single route's shape (M=1), the batch's (8 rows)
   and the candidates' (16 rows through the shared prefix).  The two runs
   must give the same tokens and lengths; K2's and K8's CUDA kernels in
   the profiler must match their wrappers' launches (one GEMM a call,
   and the row kernel where the GEMM does not do its work: at most two
   kernels a call), and K3's one kernel a call.
Phases 11-15 (slice 12's routes) run after phase 8, before 9 and 10:
11. ``dpmpp_route``: the default route with ``diffusion_sampler="dpm++"``
   warm (stage seconds, RTF, ms a step, one capture and a replay a
   step), then ``diffusion_pair`` for DPM++ at B=1 and B=8: captured and
   eager mels equal bit for bit.
12. ``univnet_route``: ``inference(vocoder_type="vocoder")`` cold and warm
   and ``batch_inference`` of 8 texts through UnivNet (wall, RTF, audio
   seconds per wall second); ``univnet_reference``: UnivNet at its
   widths on the card against the CPU, the same injected noise, fp32
   with TF32 off within 1e-4 (the difference with the card's default
   TF32 convolutions, as the route runs, reported).
13. ``beam_route``: ``inference(beam_width=4)`` at the 200-token budget,
   greedy and sampled; ``beam_decode``: the beam alone, eager and
   captured from the same seed (equal tokens, lengths and launches: K2 4
   and K3 1 a layer and step), the CUDA kernels and device ms a step
   over 8 replays, and the cache gather timed alone with its share.
14. ``stream_growing``: ``stream(mode="growing")``, first-chunk latency
   and the chunks.
15. ``lora_route``: a random rank-16 adapter merged into the full-width
   AR model on the card (``enable_lora``) against the CPU's fp32 merge;
   a decode captured with it, ``disable_lora``, the same state's next
   chunk captured again with the base weights, equal to the eager step.

Phases 16-22 (training) run last, after the serving models
leave the card:
16. ``train_grads``: K1 at the AR train steps' shapes ((16, 16, 773, 64),
   the README yaml's, and (8, 16, 389, 64), train_bench's: the ring
   path), K4 (the resblock in-half and the attention qkv head) and K5 at
   the diffusion step's (16, 1024, 2240), K7 at the vocoder step's six
   (8, C, T) stages, in bf16: the kernel's autograd
   path (kernel forward, plain recompute backward; K5's tap-major weight
   made from the live weight in the graph) against the plain version's
   autograd, the output and every input's gradient within 2% of the
   plain one's largest value, and fwd+bwd device ms beside the library's
   (SDPA causal; F.group_norm + F.silu + F.conv1d) and the bound.
17. ``train_tiny``: one step of a tiny AR, diffusion and DVAE model, fp32
   with TF32 off, on the card (K1, K4, K5) and on the CPU from the same
   params, batch, t and noise: loss and every gradient leaf within 1e-3
   of the leaf's largest value, the params after one SGD update within
   1e-6 + 1e-5 |p|, and the launches the code implies; a tiny CLVP step
   and a tiny vocoder GAN step (K7 218 times) the same way, their
   parameter moves within 1e-3 of each leaf's largest plus 1e-6.
18. ``train_route``: ``train.main(cfg=...)`` at full width on fabricated
   3-5 s artifacts with the ``store_mels`` targets: the AR finetune at
   train_bench's shape (batch 8, buckets 128/256, AdamW without warmup on
   one fixed batch: the loss must fall), a checkpoint at its last step
   that a new ``load_engines`` resumes (its next step against the
   uninterrupted one's), one profiled step (device ms, busy share, device
   ms by kernel group) and one ``run_eval`` sample (a wav); the README
   yaml (AR + diffusion co-trained, batch 16, buckets 256/512, the batch
   halved until it fits; never an OOM-skipped step), profiled too; a
   rank-128 LoRA run; one DVAE step.  Each prints ms a micro-step per
   engine over the steady window, tokens a second, peak memory and
   checks finite losses, no skipped step and K1, K4 and K5's launches a
   micro-step against the count the code implies (``train_launches``);
   the AR finetune also the checkpoint's stall and write seconds.
19. ``vocoder_gan``: the BigVGAN engine through ``load_engines`` and
   ``Engines.step`` at full width (the shipped generator, MPD periods 2,
   3, 5, 7, 11, MRD; AdamW), 8 steps on one batch of 8 x 8192 samples of
   the synthetic reference at 24 kHz (halved until it fits): K7 218
   times a step and no other kernel, the mel L1 falling, a checkpoint
   resumed bit for bit (generator, discriminator, both optimizer states),
   ms a step, peak GB, one profiled step.
20. ``clvp``: CLVP through ``train.main`` at full width, batch 32 (halved
   until it fits), 6 steps on a fixed batch: the loss falls.
21. ``optimizers``: Adafactor, Prodigy, Muon, DAdaptation, APOLLO,
   apollo-mini and AdamW under schedule-free, 3 micro-steps each on the
   AR finetune's shape: ms a micro-step and peak GB.
22. ``melbin``: the native loader built from ``native/melbin.cpp``, a
   pack of 32 artifacts, the AR finetune's batches from it equal to the
   Python path's, ms a batch both ways.
The training launches join the ``kernels`` line's counts.
Phases 23-26 (dataset preparation and the tools):
23. ``classifier_route`` (after the training phases, so that what runs
   before the default route is as in slice 14): ``load_model(
   "classifier")`` at the published widths in bf16 over 16 clips of 9.28 s
   at 24 kHz: finite logits, one K4 launch for each of the 4 attention
   heads at (16, 512, 218) -> 1536 and no other kernel; K4 at that shape
   against its plain version (device ms, bound, F.group_norm + F.conv1d);
   the forward's ms.
24. ``webui_route`` (after ``lora_route``): ``webui.make_server`` over the
   shipped-width ``TTS`` on port 0: ``GET /``, ``POST /generate`` with the
   default route's budgets and its ``/audio/<name>`` (no "error:" in the
   page, a non-silent wav), the chunked ``GET /stream`` (seconds to the
   first PCM bytes, total bytes).
25. ``tools_route``: ``utils.profiling.trace`` around one default
   inference (the Chrome trace names K2's and K7's CUDA kernels), and,
   after phase 26, ``export`` of the checkpoint phase 26 wrote (every
   leaf the checkpoint's, in float32).
26. ``prep_route`` (after the training phases): ``emb.process``'s CLI at
   its default float32 over 2 speakers x 2 clips of 4 and 6 s of the
   synthetic voice at distinct f0, with random full-width DVAE, AR and
   diffusion models: every artifact's codes non-zero and as many as the
   DVAE gives for its length, K4 11 times a clip and held in fp32
   against its plain version on the first inputs it took at each shape
   (device ms, bound, library ms); the ``data`` CLI's
   metadata, similar, validate (0 bad), sample (two finite, non-silent
   wavs) and melbin; ``train.main`` for 2 AR micro-steps on what it
   prepared; the stage seconds.  A ``left_out`` line names the phases
   whose packages the machine lacks (h5py: hdf5, matplotlib: plot,
   transformers: transcribe, gradio: the web UI's gradio branch).

Every route runs its decode and its sampler loop as CUDA graphs
(``utils/graphs.StepGraph``): each route phase asserts one capture a
decode and a diffusion call and a replay for every other token and DDIM
step (``stage_graphs``), and its kernel launches, replays counted, are
what the eager path launches.

Every profiled count check reads ``Stages.census``: a window whose
kernels the profiler cut short is profiled once more, alone, and the
phase reports ``profiler_retries``.  Then the ``kernels`` summary, the
card's name and power limit from ``nvidia-smi``, and as the last line
``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and prints no result.
It needs one card and no network; kernels build under
``tortoise_tts_tpu_torch/_build``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import struct
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
# slice 5's kernels, by the denoise_attention mode that launches them
MODE_KERNEL = {"kq": "flash_attention_bias_kq",
               "flash_bias": "flash_attention_bias_cm"}
SLICE5_KERNELS = tuple(MODE_KERNEL.values())
# the biased attention kernels' sources (K6, K9a, K9b): no ptxas spill, and
# each call one CUDA kernel, by name in bf16 (tensor cores)
BIAS_SOURCES = ("flash_attention_bias", "flash_attention_bias_kq",
                "flash_attention_bias_cm")
BIAS_CUDA_KERNELS = {"flash_attention_bias": "attn_bias_tc",
                     "flash_attention_bias_kq": "attn_bias_kq_tc",
                     "flash_attention_bias_cm": "attn_bias_cm_tc"}
INT8_ROUTE_IDLE = SLICE3_KERNELS + (W8A8,) + SLICE5_KERNELS
# the modes' first trunk output against "auto", relative to its largest
# value: "auto" runs the single route's attention (and every route's
# unconditional integrator) with bf16 scores, the kernels with fp32 ones;
# the biases reach |24|, where a bf16 step is 0.125, so a weight may move
# by 6% (1.6% of the largest value measured on an H100)
ATTN_ROUTE_TOL = 0.05
GEMV_SHAPES = [("attn_qkv", 1024, 3072, True), ("attn_proj", 1024, 1024, False),
               ("mlp_fc", 1024, 4096, True), ("mlp_proj", 4096, 1024, False)]
BATCH_ROWS = 8
CANDIDATES = 16
# the decode GEMVs' row counts: the single routes, the batch, candidates,
# and the batch with 4 candidates a text
GEMV_ROWS = (1, BATCH_ROWS, CANDIDATES, 32)
# the CUDA kernels of each port kernel's wrapper on the decode, by name
DECODE_KERNELS = {"qgemv": ("qgemv_gemm", "qgemv_ln_rows"),
                  "qgemv_w8a8": ("w8a8_gemm", "w8a8_quantize"),
                  "flash_decode": ("fd_cluster",)}
# K1's CUDA kernel in bf16 (tensor cores)
K1_KERNELS = ("flash_attn_mma",)
# the latent pass's S: cond, the text bucket with its start and stop
# tokens, the mel codes of the whole budget with theirs
LATENT_S = 1 + BUCKET + 2 + AR_STEPS + 2


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


def one_kernel(torch, fn, names) -> str:
    """fn(0) is one CUDA kernel (by the profiler) whose name holds one of
    ``names``; returns that name.  A window in which the profiler saw no
    kernel at all (it loses some) is profiled again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiler_warmup(torch)
            fn(0)
            torch.cuda.synchronize()
        got = [e.name for e in _cuda_events(prof)]
        if got:
            break
    assert len(got) == 1 and any(n in got[0] for n in names), got
    return next(n for n in names if n in got[0])


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


def no_spills(sources) -> None:
    """Fails where ``ptxas -v`` reported a spill for a kernel of these
    sources (read from the build log kept beside each library)."""
    import re
    from tortoise_tts_tpu_torch.kernels import _build
    for name in sources:
        log = _build._lib_path(name).with_suffix(".log").read_text()
        counts = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", log)
        assert counts, f"{name}: no ptxas report in its build log"
        assert all(a == b == "0" for a, b in counts), \
            f"{name}: ptxas spilled: {counts}"


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_flash_attention(torch, k1, dev, n_text, b=1, s=1 + BUCKET + 2 + 1,
                          masked=True, report=True):
    """K1 at a trunk shape of the main paths: B=1 or 8, H=16, D=64; the
    prefill (S = 1 + (64+2) + 1 for the 64-token text bucket, the text's
    padded tail masked) or the latent pass (S = LATENT_S, no key mask,
    as ``unified_voice.forward`` attends); q/k/v are views of one fused
    qkv projection, as _gpt_prefill passes them.  One CUDA kernel a call
    (``flash_attn_mma``)."""
    F = torch.nn.functional
    h, d = 16, 64
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=dev,
                      dtype=torch.bfloat16)
    q, k, v = (z.view(b, s, h, d).transpose(1, 2)
               for z in qkv.split(h * d, dim=-1))
    mask = None
    allowed = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    if masked:
        mask = torch.ones(b, s, dtype=torch.bool, device=dev)
        mask[:, 1 + n_text + 2:s - 1] = False
        allowed = mask[:, None, None, :] & allowed
    got = k1.flash_attention(q, k, v, mask)
    want = k1.flash_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 5e-2      # a few bf16 ulps at |o| <= 4; the plain version
    #                 rounds the softmax weights to bf16, the kernel the
    #                 unnormalised ones
    assert math.isfinite(err) and err <= tol, f"flash_attention err {err}"
    kernel = one_kernel(torch, lambda i: k1.flash_attention(q, k, v, mask),
                        K1_KERNELS)
    t = timings(torch, lambda i: k1.flash_attention(q, k, v, mask),
                lambda i: k1.flash_attention_plain(q, k, v, mask),
                lambda i: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=allowed))
    nbytes = 4 * b * h * s * d * 2 + (b * s if mask is not None else 0)
    flops = 2 * 2 * b * h * d * s * (s + 1) / 2
    bms, by = bound_ms(nbytes, flops)
    emit("kernel" if report else "kernel_detail", name="flash_attention",
         shape=[b, h, s, d], key_mask=mask is not None, max_abs_err=err,
         tol=tol, cuda_kernel=kernel, plan=k1.plan(b, h, s),
         library="scaled_dot_product_attention", bound_ms=bms, bound_by=by,
         **t)
    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, **t)


def _gemv_weights(torch, g, dev, layers, kd, nd):
    wq = torch.randint(-127, 128, (layers, kd, nd), generator=g, device=dev,
                       dtype=torch.int8)
    s = torch.rand(layers, nd, generator=g, device=dev) * 2e-4
    bias = torch.randn(layers, nd, generator=g, device=dev) * 0.1
    gam = 1 + 0.1 * torch.randn(layers, kd, generator=g, device=dev)
    bet = 0.1 * torch.randn(layers, kd, generator=g, device=dev)
    return wq, s, bias, gam, bet


def _gemv_bytes(m, kd, nd, ln) -> int:
    """Bytes a decode GEMV must move: the int8 weights, bf16 rows in and
    out, fp32 scales and biases (and LN parameters)."""
    return (kd * nd + m * kd * 2 + nd * 4 * 2 + (2 * kd * 4 if ln else 0)
            + m * nd * 2)


def _layer_lines(name, tot, peak, **kw) -> dict:
    """One line a row count for a decode layer's four GEMVs (M=1 the
    ``kernel`` line); returns {m: totals with the bound}."""
    out = {}
    for m, t in tot.items():
        bms, by = bound_ms(t.pop("bytes"), t.pop("ops"), peak)
        emit("kernel" if m == 1 else "kernel_detail", name=name,
             shape=f"one decode layer: 4 GEMVs, M={m}", bound_ms=bms,
             bound_by=by, **kw, **t)
        out[m] = dict(bound_ms=bms, bound_by=by, **t)
    return out


def check_qgemv(torch, k2, dev, layers=30):
    """K2 at one decode layer's four GEMVs, each cycling over 30 layers of
    weights (378 MB of int8, > L2) as the decode does, at the decode's row
    counts (``GEMV_ROWS``): the error against the plain version at each M;
    the device time of a layer beside ``F.linear`` on pre-dequantized bf16
    weights at the same M (one PyTorch call of the same product; it
    streams twice the bytes), and the plain version's at M=1.  For the
    two GEMVs with the LN, at M <= 16 both forms of the LN: in the GEMM's
    prologue (one kernel) and the row kernel + GEMM."""
    F = torch.nn.functional
    g = torch.Generator(device=dev).manual_seed(1)
    tot = {m: dict(bytes=0.0, ops=0.0) for m in GEMV_ROWS}
    err_max, tol = 0.0, 3e-2   # |y| <~ 1.5: 1 bf16 ulp is <= 8e-3
    for name, kd, nd, ln in GEMV_SHAPES:
        wq, s, bias, gam, bet = _gemv_weights(torch, g, dev, layers, kd, nd)
        bias16 = bias.to(torch.bfloat16)
        wdq_t = (wq.float() * s[:, None, :]).to(torch.bfloat16) \
            .transpose(1, 2).contiguous()      # (L, N, K) for F.linear

        def lnp(li):
            return (gam[li], bet[li]) if ln else None
        for m in GEMV_ROWS:
            x = torch.randn(m, kd, generator=g, device=dev).to(torch.bfloat16)
            err = bf16_err(torch, k2.qgemv(x, wq[0], s[0], bias[0],
                                           ln=lnp(0)),
                           k2.qgemv_plain(x, wq[0], s[0], bias[0], ln=lnp(0)),
                           atol=tol, rtol=0, name=f"qgemv {name} M={m}")
            err_max = max(err_max, err)
            t = timings(
                torch,
                lambda i: k2.qgemv(x, wq[i % layers], s[i % layers],
                                   bias[i % layers], ln=lnp(i % layers)),
                (lambda i: k2.qgemv_plain(
                    x, wq[i % layers], s[i % layers], bias[i % layers],
                    ln=lnp(i % layers))) if m == 1 else None,
                lambda i: F.linear(x, wdq_t[i % layers], bias16[i % layers]))
            if ln and m <= k2.FUSED_ROWS:
                for key, fused in (("ln_fused_ms", True),
                                   ("ln_row_kernel_ms", False)):
                    t[key] = device_ms(torch, lambda i: k2._launch(
                        x, wq[i % layers], s[i % layers], bias[i % layers],
                        lnp(i % layers), ln_fused=fused))
            nbytes = _gemv_bytes(m, kd, nd, ln)
            emit("kernel_detail", name="qgemv", gemv=name, shape=[m, kd, nd],
                 ln=ln, max_abs_err=err, ksplit=k2.ksplit(kd, nd, m),
                 ln_fused=ln and m <= k2.LN_FUSED_MAX_M,
                 bound_ms=bound_ms(nbytes, 2 * m * kd * nd)[0], **t)
            for key, val in t.items():
                if not key.startswith("ln_"):
                    tot[m][key] = (None if val is None
                                   else tot[m].get(key, 0.0) + val)
            tot[m]["bytes"] += nbytes
            tot[m]["ops"] += 2 * m * kd * nd
        del wq, wdq_t
        torch.cuda.empty_cache()
    out = _layer_lines(
        "qgemv", tot, BF16_FLOPS, max_abs_err=err_max, tol=tol,
        library="F.linear on pre-dequantized bf16 weights (2x the bytes)")
    return dict(max_abs_err=err_max, **out[1],
                ms_by_m={m: out[m]["ms"] for m in GEMV_ROWS},
                library_ms_by_m={m: out[m]["library_ms"] for m in GEMV_ROWS},
                bound_ms_by_m={m: out[m]["bound_ms"] for m in GEMV_ROWS})


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
    """K8 at the four decode GEMVs.  Right: at M = 1, 8, 16 and 32, with
    and without the fused LN, in fp32 and bf16 (``_w8a8_case``).  Time per
    layer (4 GEMVs, the LN fused where the decode fuses it, bf16, each
    GEMV cycling over 30 layers of int8 weights as the decode does) at the
    decode's row counts (``GEMV_ROWS``), beside K2 at the same M in the
    same run and ``torch._int_mm`` on the quantized rows at M=32 (its CUDA
    shape rule needs more than 16 rows; at M <= 16 no PyTorch call
    computes the function).  At M <= 16 both forms of the quantizer: in
    the GEMM's prologue (one kernel) and the quantize kernel + GEMM."""
    g = torch.Generator(device=dev).manual_seed(3)
    tot = {m: dict(bytes=0.0, ops=0.0) for m in GEMV_ROWS}
    err_max, cases = 0.0, []
    for name, kd, nd, ln_model in GEMV_SHAPES:
        wq, s, bias, gam, bet = _gemv_weights(torch, g, dev, layers, kd, nd)
        for m in GEMV_ROWS:
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
        for m in GEMV_ROWS:
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
            if m > 16:
                xq = k8.quantize_rowwise(x)[0]
                t["library_ms"] = device_ms(
                    torch, lambda i: torch._int_mm(xq, wq[i % layers]))
                t["library_call_ms"] = call_ms(
                    torch, lambda i: torch._int_mm(xq, wq[i % layers]))
            if m <= k8.FUSED_ROWS:
                for key, fused in (("fused_ms", True),
                                   ("quantize_kernel_ms", False)):
                    t[key] = device_ms(torch, lambda i: k8._launch(
                        x, wq[i % layers], s[i % layers], bias[i % layers],
                        lnp(i % layers), fused=fused))
            nbytes = _gemv_bytes(m, kd, nd, ln_model)
            emit("kernel_detail", name="qgemv_w8a8", gemv=name,
                 shape=[m, kd, nd], ln=ln_model,
                 ksplit=k2.ksplit(kd, nd, m),
                 fused=m <= k8.QUANT_FUSED_MAX_M,
                 bound_ms=bound_ms(nbytes, 2 * m * kd * nd, INT8_OPS)[0],
                 **t)
            for key, val in t.items():
                if key not in ("fused_ms", "quantize_kernel_ms"):
                    tot[m][key] = (None if val is None
                                   else tot[m].get(key, 0.0) + val)
            tot[m]["bytes"] += nbytes
            tot[m]["ops"] += 2 * m * kd * nd
        del wq
        torch.cuda.empty_cache()
    emit("kernel_detail", name="qgemv_w8a8", checks=cases)
    out = _layer_lines(
        "qgemv_w8a8", tot, INT8_OPS, max_abs_err=err_max, checks=len(cases),
        codes_differ=sum(c["codes_differ"] for c in cases),
        rows_differ=sum(c["rows_differ"] for c in cases),
        library="torch._int_mm on the quantized rows (the integer product "
                "only; M > 16)")
    return dict(max_abs_err=err_max, **out[1],
                ms_by_m={m: out[m]["ms"] for m in GEMV_ROWS},
                k2_ms_by_m={m: out[m]["k2_ms"] for m in GEMV_ROWS},
                bound_ms_by_m={m: out[m]["bound_ms"] for m in GEMV_ROWS},
                m32_library_ms=out[32]["library_ms"])


def check_flash_decode(torch, k3, dev, slots, b=1, layers=30, report=True):
    """K3 at the last step of a decode with a cache of ``slots`` slots
    (B=1 or the batch's 8 rows, H=16, Dh=64), cycling over 30 layers of
    cache as the decode does; a padded text tail in the prefix.  One CUDA
    kernel a call (``fd_cluster``); ``pos`` from device memory gives the
    int's output bit for bit."""
    F = torch.nn.functional
    h, dh = 16, 64
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
    dpos = torch.tensor(pos, dtype=torch.int32, device=dev)
    got_dev = k3.flash_decode(q, ck[0], cv[0], dpos, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, got_dev), "flash_decode: device pos differs"
    err = (got.float() - want.float()).abs().max().item()
    tol = 5e-2      # as for flash_attention
    assert math.isfinite(err) and err <= tol, f"flash_decode err {err}"
    kernel = one_kernel(torch, lambda i: k3.flash_decode(q, ck[0], cv[0],
                                                         pos, mask),
                        DECODE_KERNELS["flash_decode"])
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
    nbytes = 2 * b * h * (pos + 1) * dh * 2 + 2 * b * h * dh * 2 \
        + b * (pos + 1)
    flops = 4 * b * h * (pos + 1) * dh
    bms, by = bound_ms(nbytes, flops)
    emit("kernel" if report else "kernel_detail", name="flash_decode",
         shape=[b, h, slots, dh], pos=pos, max_abs_err=err, tol=tol,
         device_pos_bit_equal=True, cuda_kernel=kernel,
         plan=k3.plan(b, h, slots), library="scaled_dot_product_attention",
         bound_ms=bms, bound_by=by, **t)
    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, **t)


def check_flash_decode_shared(torch, k3, dev, c=16, sp=1 + BUCKET + 2 + 1,
                              sd=AR_STEPS, layers=30):
    """K3's shared form at the candidates route's last decode step: G=1
    group of 16 candidates, a 68-slot prefix (cond, the 64-token text
    bucket with its padded tail masked, start_mel) and a 200-slot region
    up to pos = 199, cycling over 30 layers of cache.  No single PyTorch
    call takes a prefix held once per group beside per-row regions; SDPA
    over the same slots concatenated per row (built outside the timed
    call) is printed as ``sdpa_concat_ms`` for scale.  One CUDA kernel a
    call; ``pos`` from device memory gives the int's output bit for
    bit."""
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
    dpos = torch.tensor(pos, dtype=torch.int32, device=dev)
    got_dev = k3.flash_decode_shared(q, kp[0], vp[0], pmask, kd[0], vd[0],
                                     dpos)
    err = bf16_err(torch, got, want, atol=5e-2, rtol=0,
                   name="flash_decode_shared")
    assert torch.equal(got, got_dev), "flash_decode_shared: device pos differs"
    kernel = one_kernel(
        torch, lambda i: k3.flash_decode_shared(q, kp[0], vp[0], pmask,
                                                kd[0], vd[0], pos),
        DECODE_KERNELS["flash_decode"])
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
        device_pos_bit_equal=True, cuda_kernel=kernel,
        plan=k3.plan(c, h, sp + sd), library=None, sdpa_concat_ms=sdpa_ms,
        bound_ms=bms, bound_by=by, bound_share=bms / t["ms"], **t)
    return dict(max_abs_err=err, bound_ms=bms, bound_by=by, **t)


def _bias_attn_inputs(torch, dev, b, h, t, dtype, seed, n_bias=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn(b, h * 192, t, generator=g, device=dev)
           * 0.5).to(dtype)
    bias = [(torch.randn(h, t, t, generator=g, device=dev) * 2).to(dtype)
            for _ in range(n_bias)]
    return qkv, bias


def _sdpa_cm(F, q, k, v, mask):
    """SDPA on channels-major (B, H, 64, T) views, the bias as a float
    mask; the output copied back to channels-major (B, H*64, T)."""
    b, h, _, t = q.shape
    o = F.scaled_dot_product_attention(q.transpose(-1, -2),
                                       k.transpose(-1, -2),
                                       v.transpose(-1, -2), attn_mask=mask)
    return o.transpose(-1, -2).reshape(b, h * 64, t)


def check_flash_attention_bias(torch, k6, dev):
    """K6 at the batch route's shapes (T=896, H=16): the cond-free trunk
    at B=16 and the integrator at B=8, each cycling over 4 biases (every
    attention block has its own, 25.7 MB each); a ragged T=300 (rows off
    16 bytes: warp 0's element copies) and fp32 (T=257, the CUDA-core
    kernel) for the error only; and B=2, the single route's shape, a data
    point beside the plain path that shape takes (``route_plain_ms``).
    Every shape's call is one CUDA kernel (``cuda_kernel``, with the
    launch ``plan``).  The row sums the B=16 and B=8 calls.  The library
    call is SDPA on the (B, H, T, 64) views of the fused qkv with the bias
    as a float mask; the output's copy back to channels-major is inside
    its timed call, as the kernel writes channels-major."""
    from tortoise_tts_tpu_torch.ops import attention
    F = torch.nn.functional
    tol = dict(atol=3e-2, rtol=2e-2)   # |o| <~ 2: one bf16 ulp <= 1.6e-2

    def sdpa(qkv, bias, h):
        b, _, t = qkv.shape
        return _sdpa_cm(F, *qkv.view(b, h, 3, 64, t).unbind(2), bias)

    for b, h, t, dtype, seed in ((8, 16, 300, torch.bfloat16, 40),
                                 (8, 2, 257, torch.float32, 41)):
        qkv, (bias,) = _bias_attn_inputs(torch, dev, b, h, t, dtype, seed)
        got = k6.flash_attention_bias(qkv, bias, h)
        want = k6.flash_attention_bias_plain(qkv, bias, h)
        err = bf16_err(torch, got, want, name=f"K6 T={t} {dtype}",
                       **(dict(atol=1e-5, rtol=1e-5)
                          if dtype == torch.float32 else tol))
        kernel = one_kernel(
            torch, lambda i: k6.flash_attention_bias(qkv, bias, h),
            ("attn_bias_f32",) if dtype == torch.float32
            else (BIAS_CUDA_KERNELS["flash_attention_bias"],))
        emit("kernel_detail", name="flash_attention_bias", shape=[b, h, t],
             dtype=str(dtype), max_abs_err=err, cuda_kernel=kernel,
             plan=list(k6.plan(b, h, t)))
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
        kernel = one_kernel(
            torch, lambda i: k6.flash_attention_bias(qkv, biases[0], h),
            (BIAS_CUDA_KERNELS["flash_attention_bias"],))
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
             shape=[b, h, t], max_abs_err=err, tol=tol, cuda_kernel=kernel,
             plan=list(k6.plan(b, h, t)),
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


def check_flash_attention_bias_k9(torch, k9a, k9b, dev):
    """K9a and both entries of K9b against their plain versions at the
    full width (H=16, T=896, bf16): B=1 and 2, the single route's
    integrator and trunk under ``denoise_attention="kq"`` (K9a) and
    ``"flash_bias"`` (K9b's fused entry), and B=8 and 16, the batch
    route's under "kq"; a ragged T=300 (warp 0's element copies) and
    fp32 at T=257 for the error only; each entry's call at T=896 is one
    CUDA kernel.  Each biased attention block
    has its own (H, T, T) bias (25.7 MB), so the timed calls cycle over 4.
    The library call is SDPA on the (B, H, T, 64) views with the bias as a
    float mask (K9a: the view of its transpose), the output's copy back to
    channels-major inside its timed call.  The rows sum the single route's
    two calls, B=2 and B=1; K9b's split entry has no route and is timed
    at B=2 as a detail."""
    F = torch.nn.functional
    tol = dict(atol=3e-2, rtol=2e-2)   # |o| <~ 2: one bf16 ulp <= 1.6e-2

    def entries(qkv, biases, h):
        """{entry: (kernel, plain, library)}, each a function of the call
        index, on one set of inputs."""
        b, _, t = qkv.shape
        bts = [x.transpose(1, 2).contiguous() for x in biases]
        q, k, v = (x.contiguous() for x in qkv.view(b, h, 3, 64, t).unbind(2))
        qv, kv, vv = qkv.view(b, h, 3, 64, t).unbind(2)
        n = len(biases)
        return {
            "kq": (lambda i: k9a.flash_attention_bias_kq(qkv, bts[i % n], h),
                   lambda i: k9a.flash_attention_bias_kq_plain(
                       qkv, bts[i % n], h),
                   lambda i: _sdpa_cm(F, qv, kv, vv,
                                      bts[i % n].transpose(1, 2))),
            "qkv": (lambda i: k9b.flash_attention_bias_qkv(
                        qkv, biases[i % n], h),
                    lambda i: k9b.flash_attention_bias_qkv_plain(
                        qkv, biases[i % n], h),
                    lambda i: _sdpa_cm(F, qv, kv, vv, biases[i % n])),
            "cm": (lambda i: k9b.flash_attention_bias_cm(
                       q, k, v, biases[i % n]).view(b, h * 64, t),
                   lambda i: k9b.flash_attention_bias_cm_plain(
                       q, k, v, biases[i % n]).view(b, h * 64, t),
                   lambda i: _sdpa_cm(F, qv, kv, vv, biases[i % n]))}

    errs = {"kq": 0.0, "qkv": 0.0, "cm": 0.0}
    checks = []
    for b, h, t, dtype, seed in ((2, 16, 300, torch.bfloat16, 50),
                                 (3, 2, 257, torch.float32, 51)):
        qkv, bias = _bias_attn_inputs(torch, dev, b, h, t, dtype, seed)
        for name, (kern, plain, _) in entries(qkv, bias, h).items():
            err = bf16_err(torch, kern(0), plain(0), name=f"K9 {name} T={t} "
                           f"{dtype}", **(dict(atol=1e-5, rtol=1e-5)
                                          if dtype == torch.float32 else tol))
            checks.append(dict(entry=name, shape=[b, h, t],
                               dtype=str(dtype)[6:], max_abs_err=err))
            errs[name] = max(errs[name], err)
    tot = {"kq": dict(bytes=0.0, flops=0.0), "qkv": dict(bytes=0.0, flops=0.0)}
    timed = {1: ("kq", "qkv"), 2: ("kq", "qkv", "cm"), 8: ("kq",),
             16: ("kq",)}
    for b in (1, 2, 8, 16):
        h, t = 16, 896
        qkv, biases = _bias_attn_inputs(torch, dev, b, h, t, torch.bfloat16,
                                        52 + b, n_bias=4)
        nbytes = 4 * b * h * 64 * t * 2 + h * t * t * 2
        flops = 2 * 2 * b * h * t * t * 64
        bms, by = bound_ms(nbytes, flops)
        for name, (kern, plain, library) in entries(qkv, biases, h).items():
            err = bf16_err(torch, kern(0), plain(0), name=f"K9 {name} B={b}",
                           **tol)
            kname = MODE_KERNEL["kq"] if name == "kq" else MODE_KERNEL[
                "flash_bias"]
            checks.append(dict(entry=name, shape=[b, h, t], dtype="bfloat16",
                               max_abs_err=err, cuda_kernel=one_kernel(
                                   torch, kern, (BIAS_CUDA_KERNELS[kname],))))
            errs[name] = max(errs[name], err)
            if name not in timed[b]:
                continue
            t_ = timings(torch, kern, plain, library)
            emit("kernel_detail", name=MODE_KERNEL["kq"] if name == "kq"
                 else MODE_KERNEL["flash_bias"], entry=name, shape=[b, h, t],
                 max_abs_err=err, tol=tol, bound_ms=bms, bound_by=by, **t_)
            if b <= 2 and name in tot:
                for key, val in t_.items():
                    tot[name][key] = tot[name].get(key, 0.0) + val
                tot[name]["bytes"] += nbytes
                tot[name]["flops"] += flops
        del qkv, biases
        torch.cuda.empty_cache()
    emit("kernel_detail", name="k9_checks", checks=checks)
    out = {}
    for name, kname in (("kq", MODE_KERNEL["kq"]),
                        ("qkv", MODE_KERNEL["flash_bias"])):
        bms, by = bound_ms(tot[name].pop("bytes"), tot[name].pop("flops"))
        err = errs[name] if name == "kq" else max(errs["qkv"], errs["cm"])
        emit("kernel", name=kname,
             shape="two calls: (2,16,896) trunk + (1,16,896) integrator"
             + ("" if name == "kq" else ", fused entry"),
             max_abs_err=err, tol=tol, checks=len(checks),
             library="scaled_dot_product_attention, bias as a float mask "
             "(views in, channels-major copy out, both timed)", bound_ms=bms,
             bound_by=by, **tot[name])
        out[kname] = dict(max_abs_err=err, bound_ms=bms, bound_by=by,
                          **tot[name])
    return out


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
F32_TOL = dict(atol=1e-4, rtol=1e-4)        # fp32 sums in another order


@contextlib.contextmanager
def recorded_heads():
    """Every attention head's K4 call (``models.arch.gn_conv1x1``) made in
    the block, in order: yields a list of ((B, C, T, M), inputs), the
    inputs (x copied; the norm's and conv's params; groups; act) kept
    for the first call at each shape and None for the others."""
    from tortoise_tts_tpu_torch.models import arch
    head, calls, seen = arch.gn_conv1x1, [], set()

    def recorded(x, norm, conv, groups, act, eps=1e-5):
        key = (*x.shape, conv["w"].shape[0])
        calls.append((key, None if key in seen else
                      (x.detach().clone(), norm, conv, groups, act)))
        seen.add(key)
        return head(x, norm, conv, groups, act, eps)
    arch.gn_conv1x1 = recorded
    try:
        yield calls
    finally:
        arch.gn_conv1x1 = head


def _normalise_bits(torch, k4, x, norm, groups, act, emb=None) -> int:
    """Elements where the bf16 path's normalise kernel and its plain
    version (given the kernel's statistics) differ: 0, bit for bit."""
    y, stats = k4.group_norm_act(x, norm["scale"], norm["bias"], groups, act,
                                 emb=emb)
    c = x.shape[1]
    scale, shift = (None, None) if emb is None else (emb[:, :c].float(),
                                                     emb[:, c:].float())
    want = k4.group_norm_act_plain(x, norm["scale"], norm["bias"], groups,
                                   act, scale=scale, shift=shift,
                                   stats=stats)
    diff = int((y.view(torch.int16) != want.view(torch.int16)).sum())
    assert diff == 0, f"normalise kernel: {diff} elements differ"
    return diff


def _gn_conv_case(torch, k4, name, x, norm, conv, act, groups=32,
                  plain=True):
    """One K4 call on these inputs: the kernel against its plain version
    (bf16: ``RESBLOCK_TOL``; fp32: ``F32_TOL``, TF32 off, as the library
    call is timed too), its time, the library's and the bound at its
    type's peak rate; one ``kernel_detail`` line.  Returns (error,
    times, bytes, operations)."""
    F = torch.nn.functional
    eps = 1e-5
    b, c, t = x.shape
    m = conv["w"].shape[0]
    fp32 = x.dtype == torch.float32
    tol = F32_TOL if fp32 else RESBLOCK_TOL
    backends = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [bk.allow_tf32 for bk in backends]
    try:
        for bk in backends:
            bk.allow_tf32 = bk.allow_tf32 and not fp32
        got = k4.gn_conv1x1(x, norm, conv, groups, act)
        want = k4.gn_conv1x1_plain(x, norm, conv, groups, act)
        err = bf16_err(torch, got, want, name=f"gn_conv {name}", **tol)
        del got, want
        gn_w, gn_b = (norm[n].to(x.dtype) for n in ("scale", "bias"))
        w, bias = conv["w"].to(x.dtype), conv["b"].to(x.dtype)

        def library(_):
            h = F.group_norm(x, groups, gn_w, gn_b, eps)
            return F.conv1d(F.silu(h) if act else h, w, bias)
        t_ = timings(
            torch, lambda _: k4.gn_conv1x1(x, norm, conv, groups, act),
            (lambda _: k4.gn_conv1x1_plain(x, norm, conv, groups, act))
            if plain else None, library)
    finally:
        for bk, v in zip(backends, saved):
            bk.allow_tf32 = v
    nbytes = sum(v.numel() * v.element_size() for v in (
        x, norm["scale"], norm["bias"], conv["w"], conv["b"])) \
        + b * m * t * x.element_size()
    flops = 2 * b * m * c * t
    bms, by = bound_ms(nbytes, flops, FP32_FLOPS if fp32 else BF16_FLOPS)
    emit("kernel_detail", name="gn_conv", shape=name, b=b, c=c, t=t,
         c_out=m, act=act, dtype=str(x.dtype), max_abs_err=err, tol=tol,
         library="F.group_norm + " + ("F.silu + " if act else "")
         + "F.conv1d", bound_ms=bms, bound_by=by,
         gemm_tile_t=None if fp32 else k4.plan(b, c, t, m, groups, x.dtype),
         **t_)
    return err, t_, nbytes, flops


def check_gn_conv(torch, k4, dev):
    """K4 at the denoiser's shapes (T=896): the resblock in-half at B=2
    (act, c_out=1024), the attention qkv head at B=2 (c_out=3072) and the
    integrator's in-half at B=1; the row sums the three.  Then detail lines
    at the batch route's shapes (trunk B=16, integrator B=8) and the ragged
    heads (the AR conditioning encoder's at T=517, the contextual
    embedder's at C=2048, T=101), and the normalise kernel's Y against its
    plain version, bit for bit."""
    shapes = [("resblock_in_half", 2, 1024, True),
              ("attention_qkv_head", 2, 3072, False),
              ("integrator_in_half_b1", 1, 1024, True)]
    tot = dict(bytes=0.0, flops=0.0)
    err_max = 0.0
    for i, (name, b, m, act) in enumerate(shapes):
        err, t_, nbytes, flops = _gn_conv_case(
            torch, k4, name, *_gn_conv_inputs(torch, dev, b, 1024, 896, m, 1,
                                              10 + i), act)
        err_max = max(err_max, err)
        for key, val in t_.items():
            tot[key] = tot.get(key, 0.0) + val
        tot["bytes"] += nbytes
        tot["flops"] += flops
    for i, (name, b, c, t, m, act) in enumerate((
            ("trunk_in_half_b16", 16, 1024, 896, 1024, True),
            ("trunk_qkv_head_b16", 16, 1024, 896, 3072, False),
            ("integrator_in_half_b8", 8, 1024, 896, 1024, True),
            ("integrator_qkv_head_b8", 8, 1024, 896, 3072, False),
            ("ar_conditioning_head_t517", 1, 1024, 517, 3072, False),
            ("contextual_embedder_head_t101", 1, 2048, 101, 6144, False))):
        inputs = _gn_conv_inputs(torch, dev, b, c, t, m, 1, 40 + i)
        err_max = max(err_max, _gn_conv_case(torch, k4, name, *inputs, act,
                                              plain=False)[0])
        del inputs
        torch.cuda.empty_cache()
    x, norm, _ = _gn_conv_inputs(torch, dev, 2, 1024, 896, 8, 1, 13)
    bits = _normalise_bits(torch, k4, x, norm, 32, True)
    bms, by = bound_ms(tot.pop("bytes"), tot.pop("flops"))
    emit("kernel", name="gn_conv", shape="three calls: " + ", ".join(
        n for n, *_ in shapes), max_abs_err=err_max, tol=RESBLOCK_TOL,
        library="F.group_norm + (F.silu) + F.conv1d, two or three calls",
        bound_ms=bms, bound_by=by, normalise_bits_differ=bits, **tot)
    return dict(max_abs_err=err_max, bound_ms=bms, bound_by=by, **tot)


def _ts_res_block_case(torch, k5, dev, b, seed, plain=True):
    """K5 at (b, 1024, 896): the kernel (on the weight prepared once)
    against its plain version, its time, the library's and the bound."""
    from tortoise_tts_tpu_torch.kernels import gn_conv as k4
    F = torch.nn.functional
    c, t, groups, eps = 1024, 896, 32, 1e-5
    h, norm, conv = _gn_conv_inputs(torch, dev, b, c, t, c, 3, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(b, c, t, generator=g, device=dev).to(torch.bfloat16)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=dev)) \
        .to(torch.bfloat16)
    prepared = k5.prepare_conv(conv)
    got = k5.ts_res_block_out(h, x, emb, norm, prepared, groups)
    want = k5.ts_res_block_out_plain(h, x, emb, norm, conv, groups)
    err = bf16_err(torch, got, want, name=f"ts_res_block B={b}",
                   **RESBLOCK_TOL)
    del got, want
    g16, b16 = (norm[n].to(torch.bfloat16) for n in ("scale", "bias"))
    bias16 = conv["b"].to(torch.bfloat16)
    t_ = timings(
        torch, lambda _: k5.ts_res_block_out(h, x, emb, norm, prepared,
                                             groups),
        (lambda _: k5.ts_res_block_out_plain(h, x, emb, norm, conv, groups))
        if plain else None,
        lambda _: F.conv1d(F.group_norm(h, groups, g16, b16, eps),
                           conv["w"], bias16, padding=1))
    nbytes = 3 * 2 * b * c * t + 2 * 3 * c * c + 2 * b * 2 * c + 12 * c
    flops = 2 * b * c * 3 * c * t
    extra = {}
    if plain:
        # the one-off reorder of the weight to tap-major (once per weight
        # when the denoiser's params are first used), by CUDA events
        extra["prepare_ms"] = call_ms(torch, lambda _: k5.prepare_conv(conv))
        extra["normalise_bits_differ"] = _normalise_bits(
            torch, k4, h, norm, groups, True, emb)
    return err, t_, nbytes, flops, extra


def check_ts_res_block(torch, k5, dev):
    """K5 at the denoiser's trunk shape, B=2, C=1024, T=896, with the
    one-off weight reorder timed on its own; detail lines at the batch
    route's trunk (B=16) and integrator (B=8)."""
    b = 2
    err, t_, nbytes, flops, extra = _ts_res_block_case(torch, k5, dev, b, 20)
    bms, by = bound_ms(nbytes, flops)
    emit("kernel", name="ts_res_block", shape=[b, 1024, 896],
         max_abs_err=err, tol=RESBLOCK_TOL,
         library="F.group_norm + F.conv1d (two calls)", bound_ms=bms,
         bound_by=by, **extra, **t_)
    err_max = err
    for i, bb in enumerate((16, 8)):
        e, td, nb, fl, _ = _ts_res_block_case(torch, k5, dev, bb, 50 + 2 * i,
                                              plain=False)
        err_max = max(err_max, e)
        emit("kernel_detail", name="ts_res_block", shape=[bb, 1024, 896],
             max_abs_err=e, tol=RESBLOCK_TOL,
             library="F.group_norm + F.conv1d (two calls)",
             bound_ms=bound_ms(nb, fl)[0], **td)
        torch.cuda.empty_cache()
    return dict(max_abs_err=err_max, bound_ms=bms, bound_by=by, **t_)


def check_snake(torch, k7, dev):
    """K7 at the first and the last BigVGAN stage of the main path (906
    mel frames: 768 x 3624 and 24 x 231936, B=1); the row sums the two.
    A detail line at the batch route's first stage (B=8, 768 x 3624), not
    in the sum.  No single PyTorch call computes it."""
    tol = dict(atol=5e-2, rtol=2e-2)   # |y| <~ 6: one bf16 ulp <= 3.1e-2
    tot = dict(bytes=0.0, flops=0.0)
    err_max = 0.0
    for i, (b, c, t) in enumerate(((1, 768, 3624), (1, 24, 231936),
                                   (8, 768, 3624))):
        g = torch.Generator(device=dev).manual_seed(30 + i)
        x = torch.randn(b, c, t, generator=g, device=dev).to(torch.bfloat16)
        alpha = torch.exp(0.3 * torch.randn(c, generator=g, device=dev))
        inv_beta = 1 / (torch.exp(0.3 * torch.randn(c, generator=g,
                                                    device=dev)) + 1e-9)
        got = k7.snake_resample2(x, alpha, inv_beta)
        want = k7.snake_resample2_plain(x, alpha, inv_beta)
        err = bf16_err(torch, got, want, name=f"snake {b}x{c}x{t}", **tol)
        err_max = max(err_max, err)
        del got, want
        t_ = timings(
            torch,
            lambda _, x=x, a=alpha, ib=inv_beta: k7.snake_resample2(x, a, ib),
            lambda _, x=x, a=alpha, ib=inv_beta: k7.snake_resample2_plain(
                x, a, ib),
            None)
        # one read and one write in bf16; per input sample the two 6-tap
        # polyphase sums (24), two snakes (10, a sine each counted as
        # one) and the 12-tap down sum (24)
        nbytes, flops = 2 * 2 * b * c * t + 8 * c, 58 * b * c * t
        emit("kernel_detail", name="snake", shape=[b, c, t],
             max_abs_err=err, tol=tol,
             bound_ms=bound_ms(nbytes, flops, FP32_FLOPS)[0], **t_)
        if b > 1:
            continue
        for key, val in t_.items():
            tot[key] = None if val is None else tot.get(key, 0.0) + val
        tot["bytes"] += nbytes
        tot["flops"] += flops
    bms, by = bound_ms(tot.pop("bytes"), tot.pop("flops"), FP32_FLOPS)
    emit("kernel", name="snake", shape="768x3624 + 24x231936, B=1",
         max_abs_err=err_max, tol=tol, library=None, bound_ms=bms,
         bound_by=by, **tot)
    torch.cuda.empty_cache()
    return dict(max_abs_err=err_max, bound_ms=bms, bound_by=by, **tot)


# ---------------------------------------------------------------------------
# phases 4-6: the port's entry points
# ---------------------------------------------------------------------------


def reference_signal(seconds: float = 4.0, sr: int = 22050,
                     seed: int = 0, f0: float = 140.0) -> np.ndarray:
    """The synthetic reference voice: five harmonics of a pitch gliding
    around ``f0`` Hz, amplitude-modulated, with a little noise
    (float32)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(round(seconds * sr))) / sr
    f0 = f0 + 30 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.2 / k * np.sin(k * phase) for k in range(1, 6))
    wav = wav * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t)) \
        + 0.01 * rng.randn(t.size)
    return wav.astype(np.float32)


def reference_wav(path: Path, seconds: float = 4.0, sr: int = 22050,
                  seed: int = 0):
    from tortoise_tts_tpu_torch.utils.io import write_wav
    write_wav(path, reference_signal(seconds, sr, seed), sr)
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
    missing = [k for k, v in lg.items()
               if v == 0 and k not in (W8A8,) + SLICE5_KERNELS]
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
    counted by name; ``census`` reads them."""

    NAMES = (("emb_mel", "encode_from_files", "encode"),
             ("inference", "inference_speech", "ar_decode"),
             ("inference", "inference_speech_shared", "ar_decode"),
             ("inference", "inference_speech_beam", "ar_decode"),
             ("inference", "_cleanup_latents", "latent_pass"),
             ("inference", "_rerank_latents", "latent_pass"),
             ("inference", "_uncond_integrate", "uncond_cache"),
             ("inference", "_diffusion", "diffusion"),
             ("inference", "_vocode", "vocoder"),
             ("inference", "_univnet", "univnet"))
    PROFILED = ("diffusion", "vocoder")

    def __init__(self, torch):
        from tortoise_tts_tpu_torch import inference, kernels
        from tortoise_tts_tpu_torch.emb import mel as emb_mel
        self.torch, self.kernels = torch, kernels
        self.profile = False
        self.undo, self.timed = [], {}
        mods = {"inference": inference, "emb_mel": emb_mel}
        for mod, attr, name in self.NAMES:
            m = mods[mod]
            orig = getattr(m, attr)
            self.undo.append((m, attr, orig))
            self.timed[name] = self._wrap(orig, name)
            setattr(m, attr, self.timed[name])
        self.reset()

    def reset(self):
        self.seconds = {name: 0.0 for *_, name in self.NAMES}
        self.launches = {name: {} for *_, name in self.NAMES}
        self.cuda_kernels = {}
        self.diffusion_calls = []   # (rows, T) of each _diffusion call
        self.calls = {name: [] for name in self.PROFILED}   # (args, kw)
        # CUDA graphs captured and replayed in each stage, and the seconds
        # their captures took (``utils/graphs.STATS``)
        self.graphs = {name: dict(captures=0, replays=0, capture_s=0.0)
                       for *_, name in self.NAMES}

    def census(self, stage: str, ok):
        """The profiled ``stage``'s CUDA kernels and wrapper launches in
        this run, once ``ok(census, launches)`` holds.  The profiler on the
        chip machine can lose a share of a long window (about half of every
        kind of kernel in one diffusion window of 20000): if ``ok`` fails,
        the stage's calls of this run are profiled once more, alone.
        Returns (census, launches, retries)."""
        if ok(self.cuda_kernels[stage], self.launches[stage]):
            return self.cuda_kernels[stage], self.launches[stage], 0
        calls, self.calls[stage] = self.calls[stage], []
        del self.cuda_kernels[stage]
        self.launches[stage] = {}
        self.graphs[stage] = dict(captures=0, replays=0, capture_s=0.0)
        profile, self.profile = self.profile, True
        with self.torch.inference_mode():
            for args, kw in calls:
                self.timed[stage](*args, **kw)
        self.profile = profile
        return self.cuda_kernels[stage], self.launches[stage], 1

    def _wrap(self, fn, name):
        from tortoise_tts_tpu_torch.utils.graphs import STATS
        torch, kernels = self.torch, self.kernels

        def timed(*args, **kw):
            if name in self.PROFILED:
                self.calls[name].append((args, kw))
            if name == "diffusion":   # positional: latents, ..., seq_len,
                #                       ..., pad_seq_len
                self.diffusion_calls.append(
                    (args[1].shape[0], args[12] or args[7]))
            torch.cuda.synchronize()
            c0 = kernels.launch_counts()
            g0 = dataclasses.replace(STATS)
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
            gr = self.graphs[name]
            gr["captures"] += STATS.captures - g0.captures
            gr["replays"] += STATS.replays - g0.replays
            gr["capture_s"] += STATS.capture_s - g0.capture_s
            return out
        return timed

    def assert_captured(self, decode_calls: int, tokens: int,
                        diffusion_calls: int) -> None:
        """Every decode and sampler loop of the run went through a CUDA
        graph: one capture a call (its warm-up the first step), a replay
        for every other decode token and DDIM step."""
        d, f = self.graphs["ar_decode"], self.graphs["diffusion"]
        assert d["captures"] == decode_calls, self.graphs
        assert d["replays"] == tokens - decode_calls, (self.graphs, tokens)
        assert f["captures"] == diffusion_calls, self.graphs
        assert f["replays"] == diffusion_calls * (DIFF_STEPS - 1), \
            self.graphs

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
    the port's K4 and K5 GEMMs (csrc/resblock.cu: ``gn_conv_wgmma<BN>``
    and ``ts_res_block_wgmma<BN>`` in bf16, ``gn_conv_f32`` and
    ``ts_res_block_f32`` in fp32), the normalise kernel before each of
    them (``group_norm_act<CACHED>`` in bf16, ``group_stats_f32`` in
    fp32), K6 (``attn_bias_tc<NB, NQ>`` of csrc/flash_attention_bias.cu in
    bf16, ``attn_bias_f32`` in fp32), K9a (``attn_bias_kq_*``), K9b
    (``attn_bias_cm_*``), K7, K2 and K8 (their
    GEMM and row kernels, ``DECODE_KERNELS``) and all other kernels.  The
    names match demangled and mangled alike."""
    events = _cuda_events(prof)
    kinds = ("gn_conv_gemm", "ts_res_block_gemm", "normalise",
             "attn_bias", "attn_bias_kq", "attn_bias_cm", "snake", "qgemv",
             "qgemv_w8a8", "other")
    out = {k: 0 for k in kinds}
    ms = {k: 0.0 for k in kinds}
    for e in events:
        if "gn_conv_wgmma" in e.name or "gn_conv_f32" in e.name:
            kind = "gn_conv_gemm"
        elif "ts_res_block_wgmma" in e.name or "ts_res_block_f32" in e.name:
            kind = "ts_res_block_gemm"
        elif "group_norm_act" in e.name or "group_stats_f32" in e.name:
            kind = "normalise"
        elif "attn_bias_kq" in e.name:
            kind = "attn_bias_kq"
        elif "attn_bias_cm" in e.name:
            kind = "attn_bias_cm"
        elif "attn_bias" in e.name:
            kind = "attn_bias"
        elif "snake_resample2" in e.name:
            kind = "snake"
        elif any(p in e.name for p in DECODE_KERNELS["qgemv"]):
            kind = "qgemv"
        elif any(p in e.name for p in DECODE_KERNELS[W8A8]):
            kind = "qgemv_w8a8"
        else:
            kind = "other"
        out[kind] += 1
        ms[kind] += e.device_time / 1e3
    out["cuda_kernels"] = len(events)
    out["device_ms"] = sum(ms.values())
    out["device_ms_by_kind"] = ms
    return out


def _resblock_ok(c, launched) -> bool:
    """Each K4 and K5 call ran one normalise kernel and one GEMM."""
    k4, k5 = launched.get("gn_conv", 0), launched.get("ts_res_block", 0)
    return (c["gn_conv_gemm"] == k4 and c["ts_res_block_gemm"] == k5
            and c["normalise"] == k4 + k5)


def bigvgan_route(torch, tts, ref: str):
    """This slice's main path, the default route, at full width: a cold
    call (it builds the cached unconditional integrator for T=896), a warm
    one, then a profiled one.  Per-step launch counts are checked against
    the denoiser's structure and against the profiler."""
    from tortoise_tts_tpu_torch import kernels
    dcfg = tts._model("diffusion").config
    layers = tts._model("autoregressive").config.layers
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
            assert not any(counts[k] for k in SLICE5_KERNELS), counts
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
            stages.assert_captured(1, counts["flash_decode"] // layers, 1)
            emit("main_path", route="bigvgan", run=run, wall_s=wall,
                 audio_s=audio_s, rtf_x_realtime=audio_s / wall,
                 stage_s=stage_s, stage_launches=stages.launches,
                 stage_graphs=stages.graphs,
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
                ckd, dl, retries = stages.census("diffusion", _resblock_ok)
                assert _resblock_ok(ckd, dl), (ckd, dl)
                ckv, _, rv = stages.census(
                    "vocoder", lambda c, _: c["snake"] == n_snake)
                assert ckv["snake"] == n_snake, ckv
                retries += rv
                ck = stages.cuda_kernels
    finally:
        stages.close()
    # device busy share of a stage: its summed kernel time (profiled run)
    # over its wall time in the warm run
    warm_s = runs[1][3]
    emit("bigvgan_counts", k4_per_ddim_step=per_k4,
         k5_per_ddim_step=per_k5, k7_per_utterance=n_snake,
         profiler_retries=retries,
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
    layers = tts._model("autoregressive").config.layers
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
                       if v == 0 and k not in ("flash_decode_shared", W8A8)
                       + SLICE5_KERNELS]
            assert not missing, f"batch route never launched: {missing}"
            assert counts[W8A8] == 0, counts
            assert not any(counts[k] for k in SLICE5_KERNELS), counts
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
            stages.assert_captured(1, counts["flash_decode"] // layers,
                                   len(calls))
            runs.append((run, wall, stage_s))
            emit("batch_route", run=run, wall_s=wall, audio_s=audio_s,
                 audio_s_per_wall_s=audio_s / wall, stage_s=stage_s,
                 diffusion_calls=calls, stage_launches=stages.launches,
                 stage_graphs=stages.graphs,
                 k6_launches=dl.get("flash_attention_bias", 0),
                 k6_per_ddim_step=dl.get("flash_attention_bias", 0)
                 / (DIFF_STEPS * len(calls)),
                 diffusion_ms_per_step=stages.seconds["diffusion"] * 1e3
                 / DIFF_STEPS,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 **({"cuda_kernels": stages.cuda_kernels}
                    if run == "profiled" else {}))
            if run == "profiled":
                def diffusion_ok(c, launched):
                    return c["attn_bias"] == k6 and _resblock_ok(c, launched)
                ck, dl, retries = stages.census("diffusion", diffusion_ok)
                assert diffusion_ok(ck, dl), (ck, dl)
    finally:
        stages.close()
    warm_s = runs[0][2]
    # the profiled diffusion's device time a DDIM step, and K6's share
    steps = DIFF_STEPS * len(calls)
    emit("batch_counts", k6_per_call=k6, diffusion_calls=calls,
         profiler_retries=retries,
         diffusion_device_ms_per_ddim_step=ck["device_ms"] / steps,
         k6_device_ms_per_ddim_step=ck["device_ms_by_kind"]["attn_bias"]
         / steps,
         k6_share_of_diffusion_device=ck["device_ms_by_kind"]["attn_bias"]
         / ck["device_ms"],
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
            assert not any(counts[k] for k in SLICE5_KERNELS), counts
            # one shared-form launch per layer and decoded token
            assert counts["flash_decode_shared"] % layers == 0, counts
            assert wav.ndim == 1 and wav.size > 24000
            assert np.isfinite(wav).all() and float(np.abs(wav).mean()) > 1e-4
            audio_s = wav.size / sr
            stage_s = dict(stages.seconds)
            stage_s["other"] = wall - sum(stage_s.values())
            stages.assert_captured(
                1, counts["flash_decode_shared"] // layers, 1)
            runs.append((run, wall, stage_s))
            emit("candidates_route", run=run, wall_s=wall, audio_s=audio_s,
                 rtf_x_realtime=audio_s / wall, stage_s=stage_s,
                 stage_launches=stages.launches, stage_graphs=stages.graphs,
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
    from tortoise_tts_tpu_torch.utils.graphs import STATS
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

    # K1's shapes, read off the routes: the prefill with its key mask, the
    # latent pass (the default route's) without, at S = LATENT_S when the
    # whole budget decodes
    from tortoise_tts_tpu_torch.models import unified_voice
    trunk, k1_shapes = unified_voice.flash_attention, set()

    def recorded_k1(q, *a, **kw):
        k1_shapes.add((q.shape[0], q.shape[2], kw.get("key_mask") is not None))
        return trunk(q, *a, **kw)
    unified_voice.flash_attention = recorded_k1
    layers = cfg.layers
    graphs = {}

    def captured_decode(name, g0, c0):
        """The route's decode ran as one capture and a replay a token."""
        tokens = (kernels.launch_counts()["flash_decode"]
                  - c0["flash_decode"]) // layers
        graphs[name] = dict(captures=STATS.captures - g0.captures,
                            replays=STATS.replays - g0.replays,
                            capture_s=STATS.capture_s - g0.capture_s,
                            tokens=tokens)
        assert graphs[name]["captures"] == 1, graphs
        assert graphs[name]["replays"] == tokens - 1, graphs
    try:
        bv_counts = bigvgan_route(torch, tts, ref)
        kernels.reset_launches()
        g0, c0 = dataclasses.replace(STATS), kernels.launch_counts()
        t0 = time.time()
        wav, sr = tts.inference(TEXT, ref, max_ar_steps=AR_STEPS,
                                vocoder_type="hifigan", seed=0)
        torch.cuda.synchronize()
        inf_s = time.time() - t0
        captured_decode("hifigan", g0, c0)
    finally:
        unified_voice.flash_attention = trunk
    emit("k1_shapes", routes=["bigvgan", "hifigan"],
         shapes=sorted(k1_shapes), latent_s_full_budget=LATENT_S)
    g0, c0 = dataclasses.replace(STATS), kernels.launch_counts()
    t0 = time.time()
    first_s, chunks = None, []
    for c in tts.stream(TEXT, ref, max_ar_steps=AR_STEPS, seed=0):
        if first_s is None:
            first_s = time.time() - t0
        chunks.append(c)
    stream_s = time.time() - t0
    captured_decode("stream", g0, c0)
    counts = kernels.launch_counts()
    emit("launches", route="hifigan", **counts)
    missing = [k for k in ("flash_attention", "qgemv", "flash_decode")
               if counts[k] == 0]
    assert not missing, f"HiFiGAN route never launched: {missing}"
    assert counts[W8A8] == 0, counts
    assert not any(counts[k] for k in SLICE5_KERNELS), counts

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
         graphs=graphs,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return tts, {k: bv_counts[k] + counts[k] for k in counts}, k1_shapes


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
                       if v == 0 and k not in SLICE3_KERNELS + ("qgemv",)
                       + SLICE5_KERNELS]
            assert not missing, f"W8A8 route never launched: {missing}"
            assert counts["qgemv"] == 0, counts
            assert not any(counts[k] for k in SLICE5_KERNELS), counts
            tokens = counts["flash_decode"] // layers
            assert stages.launches["ar_decode"].get(W8A8) == \
                counts[W8A8] == 4 * layers * tokens, (stages.launches, counts)
            assert wav.ndim == 1 and wav.size > 24000
            assert np.isfinite(wav).all() and float(np.abs(wav).mean()) > 1e-4
            audio_s = wav.size / sr
            stage_s = dict(stages.seconds)
            stage_s["other"] = wall - sum(stage_s.values())
            stages.assert_captured(1, tokens, 1)
            emit("w8a8_route", run=run, wall_s=wall, audio_s=audio_s,
                 rtf_x_realtime=audio_s / wall, stage_s=stage_s,
                 stage_launches=stages.launches, stage_graphs=stages.graphs,
                 decode_tokens=tokens,
                 k8_per_token=counts[W8A8] / tokens,
                 decode_ms_per_token=stage_s["ar_decode"] * 1e3 / tokens,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    finally:
        stages.close()
        tts.cfg = int8_cfg
    return counts


class _FirstStep(Exception):
    """Ends a replayed diffusion after its first trunk call."""


def _random_proj_out(torch, tts, seed: int):
    """Give the 13 biased attention blocks' ``proj_out`` random weights
    (std 1/sqrt(C)): the random denoiser zeroes them, as the reference
    initialises them, so its attention adds nothing to the output.
    Returns the function that restores them and drops the cached
    unconditional integrators of the other modes, built meanwhile."""
    dm = tts._model("diffusion")
    blocks = (dm.params["conditioning_timestep_integrator"]
              + dm.params["layers"])
    g = torch.Generator(device=tts.device).manual_seed(seed)
    saved = []
    with torch.inference_mode():
        for blk in blocks:
            w = blk["attn"]["proj_out"]["w"]
            saved.append(w.clone())
            w.copy_(torch.randn(w.shape, generator=g, device=w.device)
                    * w.shape[1] ** -0.5)

    def restore():
        with torch.inference_mode():
            for blk, w in zip(blocks, saved):
                blk["attn"]["proj_out"]["w"].copy_(w)
        for key in [k for k in tts._uncond_cache if k[2] != "auto"]:
            del tts._uncond_cache[key]
    return restore


def _with_attention(cfg, mode: str):
    return dataclasses.replace(cfg, inference=dataclasses.replace(
        cfg.inference, denoise_attention=mode))


def denoise_attention_routes(torch, tts, ref: str):
    """Slice 5's paths on the same ``TTS``, switched by
    ``Inference.denoise_attention``: the default route with "kq" (every
    biased attention block through K9a: per DDIM step 3 integrator blocks
    at B=1 and 10 trunk blocks at B=2) cold and warm, the default route
    with "flash_bias" (the same 13 blocks through K9b's fused entry) cold
    and warm, and ``batch_inference`` over 8 copies of the text with "kq"
    (the trunk at B=16 and the integrator at B=8 through K9a, none through
    K6), warm and profiled.  A cold call also builds the mode's cached
    unconditional integrator (3 blocks at B=1 a step) and runs under the
    profiler: in each profiled call the wrapper counts and the profiler's
    count of each kernel's own ``__global__`` must agree.

    The random denoiser zeroes every attention block's ``proj_out``, as
    the reference initialises it, so its attention adds nothing to the
    output; for this phase the 13 biased blocks' ``proj_out`` get random
    weights (std 1/sqrt(C)), restored after.  Each route's first DDIM
    step's trunk output, before the sampler's clip, is held against the
    "auto" mode's on the same inputs: the recorded ``_diffusion`` call
    replayed with "auto" and an "auto" unconditional integrator of the
    same weights, stopped after its first trunk call."""
    from tortoise_tts_tpu_torch import inference, kernels
    from tortoise_tts_tpu_torch.models import diffusion
    dm = tts._model("diffusion")
    per_step = 3 + dm.config.num_layers
    restore = _random_proj_out(torch, tts, 60)
    auto_cfg = tts.cfg
    plain_diffusion, trunk = inference._diffusion, diffusion.forward_trunk
    stages = Stages(torch)
    staged_diffusion = inference._diffusion
    calls, firsts, want, stop = [], [], [False], [False]

    def recorded_trunk(*a, **k):
        y = trunk(*a, **k)
        if want[0]:
            firsts.append(y.float())
            want[0] = False
            if stop[0]:
                raise _FirstStep
        return y

    def recorded_diffusion(*a, **k):
        calls.append((a, k))
        return staged_diffusion(*a, **k)

    auto_uh = {}

    def auto_first_trunk(a):
        """The first trunk output of the recorded call ``a`` in "auto"."""
        T = a[12] or a[7]
        with torch.inference_mode():
            if T not in auto_uh:
                auto_uh[T] = inference._uncond_integrate(
                    tts._denoiser_params(), dm.config, DIFF_STEPS, T, "auto")
            want[0], stop[0] = True, True
            try:
                plain_diffusion(*a[:13], auto_uh[T], attention="auto")
            except _FirstStep:
                pass
            finally:
                stop[0] = False
        return firsts.pop()

    plan = (("single", "kq", "cold"), ("single", "kq", "warm"),
            ("single", "flash_bias", "cold"), ("single", "flash_bias", "warm"),
            ("batch", "kq", "warm"), ("batch", "kq", "profiled"))
    total, compare, ys, census, walls = None, {}, {}, {}, {}
    inference._diffusion = recorded_diffusion
    diffusion.forward_trunk = recorded_trunk
    try:
        for route, mode, run in plan:
            kname = MODE_KERNEL[mode]
            profiled = run != "warm"
            tts.cfg = _with_attention(auto_cfg, mode)
            stages.reset()
            stages.profile = profiled
            kernels.reset_launches()
            calls.clear()
            want[0] = True
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            if route == "single":
                wavs = [tts.inference(TEXT, ref, seed=0, **ROUTE_KW)[0]]
            else:
                wavs = tts.batch_inference([TEXT] * BATCH_ROWS, ref, seed=1,
                                           top_p=0.9, **ROUTE_KW)[0]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kernels.launch_counts()
            emit("launches", route=f"{route}_{mode}", run=run, **counts)
            for w in wavs:
                assert w.ndim == 1 and w.size > 24000
                assert np.isfinite(w).all() and float(np.abs(w).mean()) > 1e-4
            dl, ul = stages.launches["diffusion"], stages.launches[
                "uncond_cache"]
            n_calls = len(stages.diffusion_calls)
            want_diff = DIFF_STEPS * per_step * n_calls
            want_uncond = DIFF_STEPS * 3 if run == "cold" else 0
            assert dl.get(kname) == want_diff, (dl, stages.diffusion_calls)
            assert ul.get(kname, 0) == want_uncond, ul
            assert counts[kname] == want_diff + want_uncond, counts
            idle = ["flash_attention_bias", W8A8] + [
                k for k in SLICE5_KERNELS if k != kname]
            assert not any(counts[k] for k in idle), counts
            y = firsts.pop()
            stages.assert_captured(
                1, counts["flash_decode"]
                // tts._model("autoregressive").config.layers, n_calls)
            audio_s = sum(w.size for w in wavs) / 24000
            stage_s = dict(stages.seconds)
            stage_s["other"] = wall - sum(stage_s.values())
            run_launches = stages.launches
            diffusion_calls = list(stages.diffusion_calls)
            prof = {}
            if profiled:
                kind = "attn_bias_kq" if mode == "kq" else "attn_bias_cm"
                other = {"attn_bias", "attn_bias_kq", "attn_bias_cm"} - {kind}

                def diffusion_ok(c, launched):
                    # the mode's kernel, K4's and K5's kernels as often as
                    # their wrappers launched, no other biased attention
                    return (c[kind] == launched.get(kname)
                            and _resblock_ok(c, launched)
                            and not any(c[k] for k in other))
                ck, launched, prof["profiler_retries"] = stages.census(
                    "diffusion", diffusion_ok)
                assert diffusion_ok(ck, launched), (ck, launched)
                prof["cuda_kernels"] = stages.cuda_kernels
                census[f"{route}_{mode}"] = stages.cuda_kernels
                # the mode's first trunk output against "auto" on the same
                # inputs (once per route and mode)
                y_auto = auto_first_trunk(calls[0][0])
                ys[(route, mode)] = (y, y_auto)
            emit("attention_route", route=route, mode=mode, run=run,
                 wall_s=wall, audio_s=audio_s,
                 rtf_x_realtime=audio_s / wall, stage_s=stage_s,
                 stage_launches=run_launches, stage_graphs=stages.graphs,
                 diffusion_calls=diffusion_calls,
                 kernel_launches=counts[kname],
                 per_ddim_step=dl[kname] / (DIFF_STEPS * n_calls),
                 diffusion_ms_per_step=stage_s["diffusion"] * 1e3
                 / DIFF_STEPS,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 **prof)
            if run == "warm":   # one run of each path, as the other routes
                walls[f"{route}_{mode}"] = stage_s
                total = counts if total is None else {
                    k: total[k] + counts[k] for k in counts}
    finally:
        inference._diffusion = staged_diffusion
        diffusion.forward_trunk = trunk
        stages.close()
        tts.cfg = auto_cfg
        restore()
    for (route, mode), (y, y_auto) in ys.items():
        d = (y - y_auto).abs()
        scale = float(y_auto.abs().max())
        compare[f"{route}_{mode}"] = dict(
            shape=list(y.shape), max_abs_err=float(d.max()),
            mean_abs_err=float(d.mean()), max_abs=scale,
            mean_abs=float(y_auto.abs().mean()),
            rel_max_err=float(d.max()) / scale)
    ykq, yfb = ys[("single", "kq")][0], ys[("single", "flash_bias")][0]
    yb, yba = ys[("batch", "kq")]
    rows = yb.shape[0] // 2     # cond rows first, then the guidance rows
    extra = dict(single_kq_equals_flash_bias=bool(torch.equal(ykq, yfb)),
                 single_kq_vs_flash_bias_max_abs=float(
                     (ykq - yfb).abs().max()),
                 batch_cond_rows_equal_auto=bool(torch.equal(
                     yb[:rows], yba[:rows])))
    # a stage's device busy share: its kernel time in the profiled run over
    # its wall time in the warm one
    busy = {name: {st: c["device_ms"] / 1e3 / walls[name][st]
                   for st, c in ck.items()} for name, ck in census.items()}
    emit("attention_compare", trunk_vs_auto=compare, tol=ATTN_ROUTE_TOL,
         device_busy_share=busy, **extra)
    for name, c in compare.items():
        assert math.isfinite(c["max_abs_err"]), name
        assert c["rel_max_err"] <= ATTN_ROUTE_TOL, (name, c)
    # K9a, K9b and K6 share one body and read the same bias values
    assert extra["single_kq_equals_flash_bias"], extra
    assert extra["batch_cond_rows_equal_auto"], extra
    return total


def _decode_census(torch, events, c0, c1, quant_mode, m, layers):
    """Per-token split of 8 profiled tokens' CUDA kernels by port kernel,
    checked against the wrappers' launches: one GEMM a GEMV call, and a
    row kernel (K2's LN rows, K8's quantize) only where the GEMM does not
    do its work at this M; K3 one kernel a call."""
    from tortoise_tts_tpu_torch.kernels import qgemv as k2
    from tortoise_tts_tpu_torch.kernels import qgemv_w8a8 as k8
    split = {k: 0.0 for k in (*DECODE_KERNELS, "other")}
    n_by = {p: 0 for pre in DECODE_KERNELS.values() for p in pre}
    for e in events:
        key = next((k for k, pre in DECODE_KERNELS.items()
                    if any(p in e.name for p in pre)), "other")
        split[key] += e.device_time / 1e3 / 8
        for p in n_by:
            n_by[p] += p in e.name
    gemv = "qgemv" if quant_mode == "int8" else W8A8
    calls = c1[gemv] - c0[gemv]
    assert calls == 8 * 4 * layers, (c0, c1)
    gemm, row = DECODE_KERNELS[gemv]
    if gemv == "qgemv":   # the LN rows: 2 of the 4 GEMVs carry the LN
        want_rows = 0 if m <= k2.LN_FUSED_MAX_M else 8 * 2 * layers
    else:
        want_rows = 0 if m <= k8.QUANT_FUSED_MAX_M else calls
    assert n_by[gemm] == calls and n_by[row] == want_rows, \
        (n_by, calls, want_rows)
    attn = next(k for k in ("flash_decode", "flash_decode_shared")
                if c1[k] > c0[k])
    attn_calls = c1[attn] - c0[attn]
    assert attn_calls == 8 * layers, (c0, c1)
    assert sum(n_by[p] for p in DECODE_KERNELS["flash_decode"]) \
        == attn_calls, (n_by, attn_calls)
    return dict(device_ms_per_token_by_kernel=split,
                gemv_cuda_kernels_per_token={p: n / 8
                                             for p, n in n_by.items()},
                gemv_cuda_kernels_per_call=(n_by[gemm] + n_by[row]) / calls,
                port_kernel_calls_per_token={gemv: calls / 8,
                                             attn: attn_calls / 8})


def decode_timing(torch, tts, ref: str, quant_mode: str, rows: int = 1,
                  fan_out: int = 0, steps: int = AR_STEPS):
    """The decode alone in ``quant_mode`` of ``rows`` copies of the text
    (the single route at 1, the batch's decode at 8) or, with ``fan_out``,
    one text fanned out to that many candidates through the shared prefix
    (the candidates route's), twice from the same generator seeds: eager
    (``decode_step_fn`` run by ``advance``, the step the graph captures)
    and captured (``decode_chunk``, which captures the step at the first
    token and replays it).  For each: ms per token over the whole budget
    (unprofiled; the captured run's capture included, and its seconds
    apart), and from the profiler over 8 tokens the CUDA kernels and
    device ms per token by kernel, hence the device's busy share.  A
    replay is one host call, so the captured run's "kernels a token"
    counts the graph's kernels, not host launches.  Both runs must give
    the same tokens and lengths; the GEMV kernels the profiler counts
    must match the wrappers' launches in both."""
    from torch.profiler import ProfilerActivity, profile
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.models import unified_voice as uv
    from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
    from tortoise_tts_tpu_torch.utils.graphs import STATS
    ar = tts._model("autoregressive")
    dev = tts.device
    enc = tts.encode_audio(ref, seed=0)
    toks = tts.encode_text(TEXT)
    tokens = torch.as_tensor(tts._bucket_text(toks)[None], device=dev) \
        .repeat(rows, 1)
    lengths = torch.tensor([len(toks)] * rows, device=dev)
    lat = enc["latent"][0].reshape(1, -1).repeat(rows, 1)
    m = fan_out or rows
    kw = dict(qgpt=tts._ar_qgpt(), quant_mode=quant_mode)
    sampling = SamplingConfig()

    def start():
        gens = [torch.Generator(device=dev).manual_seed(i) for i in range(m)]
        out = uv.decode_start(ar.params, lat, tokens, lengths, gens,
                              ar.config, steps, shared_rows=fan_out)
        return out if fan_out else (out, None)

    def chunk(captured, state, prefix, n):
        if captured:
            return uv.decode_chunk(ar.params, state, ar.config, sampling,
                                   chunk=n, prefix=prefix, **kw)
        limit = steps if n is None else min(state.step + n, steps)
        return uv.advance(state, limit, uv.decode_step_fn(
            ar.params, state, ar.config, sampling, prefix=prefix, **kw))

    runs, out = {}, {}
    with torch.inference_mode():
        for mode in ("eager", "captured"):
            captured = mode == "captured"
            state, prefix = start()
            torch.cuda.synchronize()
            s0 = dataclasses.replace(STATS)
            t0 = time.time()
            chunk(captured, state, prefix, None)
            torch.cuda.synchronize()
            dt = time.time() - t0
            n_tok = state.step
            out[mode] = (state.tokens.clone(), state.lengths.clone())
            graphs = dict(captures=STATS.captures - s0.captures,
                          replays=STATS.replays - s0.replays,
                          capture_s=STATS.capture_s - s0.capture_s)
            if captured:    # one capture; its warm-up is the first token
                assert graphs["captures"] == 1, graphs
                assert graphs["replays"] == n_tok - 1, (graphs, n_tok)
            else:
                assert graphs["captures"] == graphs["replays"] == 0, graphs
            del state
            state, prefix = start()
            chunk(captured, state, prefix, 8)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                profiler_warmup(torch)
                c0 = kernels.launch_counts()
                chunk(captured, state, prefix, 8)
                torch.cuda.synchronize()
                c1 = kernels.launch_counts()
            del state
            events = _cuda_events(prof)
            busy = sum(e.device_time for e in events) / 1e3 / 8
            ms = dt * 1e3 / n_tok
            runs[mode] = dict(
                tokens=n_tok, ms_per_token=ms,
                cuda_kernels_per_token=len(events) / 8,
                device_busy_ms_per_token=busy, device_busy_share=busy / ms,
                graphs=graphs,
                **_decode_census(torch, events, c0, c1, quant_mode, m,
                                 ar.config.layers))
    same = (torch.equal(out["eager"][0], out["captured"][0])
            and torch.equal(out["eager"][1], out["captured"][1]))
    emit("decode", quant_mode=quant_mode, rows=m,
         route=("candidates" if fan_out else
                "batch" if rows > 1 else "single"),
         eager=runs["eager"], captured=runs["captured"],
         captured_equals_eager=same,
         speedup=runs["eager"]["ms_per_token"]
         / runs["captured"]["ms_per_token"])
    assert same, "captured decode differs from the eager decode"


def _eager_sample_loop(model_fn, noise, generators, sched, sampler="ddim"):
    """``gaussian.sample_loop`` with its step run eagerly every time: the
    reference the captured loop is held against."""
    import torch
    from tortoise_tts_tpu_torch.models import gaussian
    x = noise.float().clone()
    t = torch.tensor([sched.num_timesteps - 1], device=x.device)
    step = gaussian.sampler_step_fn(model_fn, x, t,
                                    gaussian.step_tables(sched, x.device),
                                    generators, sched, sampler)
    for _ in range(sched.num_timesteps):
        step()
    return x


def diffusion_pairs(torch, tts, ref: str, sampler: str = "ddim",
                    modes=("auto", "kq", "flash_bias")):
    """``inference._diffusion`` at the default route's geometry (``sampler``
    with 50 steps, cond-free, T=896) at B=1 (the denoiser at 2 rows) and
    B=8 (16), under each of ``modes`` (``denoise_attention``), with the
    sampler loop eager
    (``_eager_sample_loop``) and captured (``gaussian.sample_loop``) on
    the same inputs and keys: each loop's ms a DDIM step (the captured
    one's capture included, its seconds apart, and its replays alone),
    device ms a step from the profiler (a second call of each), and the
    mels, which must be equal bit for bit: the graph replays the eager
    step's kernels on the same data, and no kernel of the step sums in a
    run-dependent order."""
    from torch.profiler import ProfilerActivity, profile
    from tortoise_tts_tpu_torch import inference
    from tortoise_tts_tpu_torch.models import gaussian
    from tortoise_tts_tpu_torch.utils.graphs import STATS
    dm = tts._model("diffusion")
    dev = tts.device
    diff_cond = tts.encode_audio(ref, seed=0)["latent"][1]
    captured_loop = gaussian.sample_loop
    auto_cfg = tts.cfg
    g = torch.Generator(device=dev).manual_seed(70)
    restore = _random_proj_out(torch, tts, 71)
    loop_s, profiled = [0.0], [None]

    def timed(loop):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if profiled[0] is None:
                x = loop(*a, **k)
            else:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    profiler_warmup(torch)
                    x = loop(*a, **k)
                    torch.cuda.synchronize()
                profiled[0] = prof
            torch.cuda.synchronize()
            loop_s[0] = time.perf_counter() - t0
            return x
        return run

    results = []
    try:
        for mode in modes:
            tts.cfg = _with_attention(auto_cfg, mode)
            n_lat, seq_len, pad_seq_len, uh = tts._diffusion_geometry(
                AR_STEPS, 0, ROUTE_KW["mel_pad_multiple"], DIFF_STEPS, True)
            for b in (1, BATCH_ROWS):
                latents = torch.randn(b, n_lat, 1024, generator=g,
                                      device=dev).to(torch.bfloat16)
                t_lat = torch.full((b,), n_lat, device=dev)
                keys = [np.asarray([7, r], np.uint32) for r in range(b)]
                args = (tts._denoiser_params(), latents, diff_cond, keys,
                        dm.config, DIFF_STEPS, sampler, seq_len, True, 1.0,
                        n_lat, t_lat, pad_seq_len, uh)
                pair, mels = {}, {}
                for name, loop in (("eager", _eager_sample_loop),
                                   ("captured", captured_loop)):
                    gaussian.sample_loop = timed(loop)
                    with torch.inference_mode():
                        s0 = dataclasses.replace(STATS)
                        profiled[0] = None
                        mels[name] = inference._diffusion(*args,
                                                          attention=mode)
                        wall = loop_s[0]
                        cap = STATS.capture_s - s0.capture_s
                        reps = STATS.replays - s0.replays
                        profiled[0] = True
                        inference._diffusion(*args, attention=mode)
                        events = _cuda_events(profiled[0])
                    assert reps == (DIFF_STEPS - 1 if name == "captured"
                                    else 0), reps
                    dev_ms = sum(e.device_time for e in events) / 1e3
                    pair[name] = dict(
                        ms_per_step=wall * 1e3 / DIFF_STEPS,
                        device_ms_per_step=dev_ms / DIFF_STEPS,
                        device_busy_share=dev_ms / (wall * 1e3),
                        cuda_kernels_per_step=len(events) / DIFF_STEPS,
                        capture_s=cap, replays=reps,
                        **({"replay_ms_per_step": (wall - cap) * 1e3
                            / (DIFF_STEPS - 1)} if reps else {}))
                same = torch.equal(mels["eager"], mels["captured"])
                err = float((mels["eager"] - mels["captured"]).abs().max())
                emit("diffusion_pair", sampler=sampler, mode=mode, rows=b,
                     model_rows=2 * b,
                     T=pad_seq_len, eager=pair["eager"],
                     captured=pair["captured"], mels_equal=same,
                     max_abs_diff=err,
                     speedup=pair["eager"]["ms_per_step"]
                     / pair["captured"]["ms_per_step"])
                results.append(same)
                assert same, (sampler, mode, b, err)
    finally:
        gaussian.sample_loop = captured_loop
        tts.cfg = auto_cfg
        restore()
    return results


# ---------------------------------------------------------------------------
# slice 12: DPM++, UnivNet, beam search, the growing stream and LoRA
# ---------------------------------------------------------------------------


def _route_run(torch, stages, route: str, call):
    """One route call with the launch counts at 0 just before it and read
    just after: (its result, wall seconds, launch counts, stage seconds
    with the rest as "other")."""
    from tortoise_tts_tpu_torch import kernels
    stages.reset()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    emit("launches", route=route, **counts)
    stage_s = dict(stages.seconds)
    stage_s["other"] = wall - sum(stage_s.values())
    return out, wall, counts, stage_s


def _check_wav(w, min_samples: int = 24000) -> None:
    """A float32 wav of at least ``min_samples``, finite and not silent."""
    assert w.ndim == 1 and w.dtype == np.float32
    assert w.size >= min_samples, w.size
    assert np.isfinite(w).all(), "non-finite audio"
    assert np.count_nonzero(w) > min(1000, w.size // 4)
    assert float(np.abs(w).mean()) > 1e-4


def _graphs_since(s0) -> dict:
    """CUDA graphs captured and replayed since ``s0``, a copy of
    ``utils.graphs.STATS``."""
    from tortoise_tts_tpu_torch.utils.graphs import STATS
    return dict(captures=STATS.captures - s0.captures,
                replays=STATS.replays - s0.replays,
                capture_s=STATS.capture_s - s0.capture_s)


def _assert_graphs(graphs, captures: int, replays: int) -> None:
    assert (graphs["captures"], graphs["replays"]) == (captures, replays), \
        (graphs, captures, replays)


def _launched(counts, need, route: str) -> None:
    missing = [k for k in need if counts[k] == 0]
    assert not missing, f"{route} route never launched: {missing}"


# the kernels of the default route's stages, which the new routes share
DEFAULT_ROUTE_KERNELS = ("flash_attention", "qgemv", "flash_decode",
                         "gn_conv", "ts_res_block")


def dpmpp_route(torch, tts, ref: str):
    """The default route with ``diffusion_sampler="dpm++"``
    (DPM-Solver++(2M), 50 steps, cond-free guidance), warm: stage seconds,
    RTF, ms a step (the stage's, capture included) and its capture
    seconds, one capture a call and a replay a step; then its sampler loop
    captured against the eager step at B=1 and B=8 (``diffusion_pairs``),
    mels equal bit for bit."""
    layers = tts._model("autoregressive").config.layers
    stages = Stages(torch)
    try:
        (wav, sr), wall, counts, stage_s = _route_run(
            torch, stages, "dpmpp", lambda: tts.inference(
                TEXT, ref, seed=0, diffusion_sampler="dpm++", **ROUTE_KW))
        _launched(counts, DEFAULT_ROUTE_KERNELS + ("snake",), "DPM++")
        _check_wav(wav)
        stages.assert_captured(1, counts["flash_decode"] // layers, 1)
        graph = stages.graphs["diffusion"]
        audio_s = wav.size / sr
        emit("dpmpp_route", card=nvidia_smi(), wall_s=wall, audio_s=audio_s,
             rtf_x_realtime=audio_s / wall, stage_s=stage_s,
             stage_launches=stages.launches, stage_graphs=stages.graphs,
             diffusion_ms_per_step=stage_s["diffusion"] * 1e3 / DIFF_STEPS,
             diffusion_capture_s=graph["capture_s"],
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    finally:
        stages.close()
    diffusion_pairs(torch, tts, ref, sampler="dpm++", modes=("auto",))
    return counts


def _univnet_reference(torch) -> tuple:
    """UnivNet at its shipped widths (random weights) on the card against
    the CPU, 64 frames of two rows, the same injected noise, in fp32 (the
    route's type): with TF32 off, within 1e-4 (the same fp32 arithmetic
    in another order); and with the card's default convolutions, as the
    route runs them (TF32), reported.  Returns both max abs errors."""
    from tortoise_tts_tpu_torch.models import _univnet_random, univnet
    from tortoise_tts_tpu_torch.models.common import tree_map
    cfg = univnet.UnivNetConfig()
    params = _univnet_random(torch.Generator().manual_seed(3), cfg)
    g = torch.Generator().manual_seed(4)
    mel = torch.randn(2, 100, 64, generator=g) * 2 - 5
    noise = torch.randn(2, *univnet.noise_shape(64, cfg), generator=g)
    want = univnet.inference(params, mel, noise=noise, cfg=cfg)
    on_card = tree_map(lambda t: t.cuda(), params)
    backends = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [b.allow_tf32 for b in backends]
    try:
        for b in backends:
            b.allow_tf32 = False
        strict = univnet.inference(on_card, mel.cuda(), noise=noise.cuda(),
                                   cfg=cfg)
    finally:
        for b, v in zip(backends, saved):
            b.allow_tf32 = v
    route = univnet.inference(on_card, mel.cuda(), noise=noise.cuda(),
                              cfg=cfg)
    err = bf16_err(torch, strict.cpu(), want, atol=1e-4, rtol=1e-4,
                   name="univnet fp32")
    return err, float((route.cpu() - want).abs().max())


def univnet_route(torch, tts, ref: str):
    """``TTS.inference(vocoder_type="vocoder")`` (the JAX package's host
    path: the codes read once, cleaned and trimmed on the host, the
    diffusion sized by the trim point, UnivNet in fp32 with the line's
    k_voc noise) cold (its diffusion length builds an unconditional
    integrator) and warm, and ``batch_inference`` of 8 texts through
    UnivNet warm: wall, RTF or audio seconds per wall second, stage
    seconds, graphs; then UnivNet at its widths on the card against the
    CPU."""
    layers = tts._model("autoregressive").config.layers
    stages = Stages(torch)
    total = None
    try:
        for run in ("cold", "warm", "batch"):
            if run == "batch":
                call = lambda: tts.batch_inference(  # noqa: E731
                    [TEXT] * BATCH_ROWS, ref, seed=1, top_p=0.9,
                    vocoder_type="vocoder", **ROUTE_KW)
            else:
                call = lambda: tts.inference(  # noqa: E731
                    TEXT, ref, seed=0, vocoder_type="vocoder", **ROUTE_KW)
            (out, sr), wall, counts, stage_s = _route_run(
                torch, stages, "univnet", call)
            wavs = out if run == "batch" else [out]
            for w in wavs:
                _check_wav(w)
            _launched(counts, DEFAULT_ROUTE_KERNELS, "UnivNet")
            assert counts["snake"] == 0, counts
            assert stages.launches["univnet"] == {}, stages.launches
            stages.assert_captured(1, counts["flash_decode"] // layers,
                                   len(stages.diffusion_calls))
            audio_s = sum(w.size for w in wavs) / sr
            emit("univnet_route", card=nvidia_smi(), run=run,
                 rows=len(wavs), wall_s=wall, audio_s=audio_s,
                 rtf_x_realtime=audio_s / wall, stage_s=stage_s,
                 diffusion_calls=list(stages.diffusion_calls),
                 stage_launches=stages.launches, stage_graphs=stages.graphs,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            if run != "cold":
                total = counts if total is None else {
                    k: total[k] + counts[k] for k in counts}
    finally:
        stages.close()
    err, tf32_err = _univnet_reference(torch)
    emit("univnet_reference", card=nvidia_smi(), max_abs_err=err,
         tol="1e-4 + 1e-4 |x| (TF32 off)", tf32_max_abs_err=tf32_err)
    return total


def _beam_inputs(torch, tts, ref: str):
    enc = tts.encode_audio(ref, seed=0)
    toks = tts.encode_text(TEXT)
    dev = tts.device
    tokens = torch.as_tensor(tts._bucket_text(toks)[None], device=dev)
    lengths = torch.tensor([len(toks)], device=dev)
    return enc["latent"][0].reshape(1, -1), tokens, lengths


def beam_route(torch, tts, ref: str, width: int = 4):
    """``TTS.inference(beam_width=4)`` at the 200-token budget, greedy and
    sampled (HF ``beam_sample``), warm: stage seconds, ms a token, one
    capture a call.  Then the beam decode alone at the route's shape,
    eager (``beam_step_fn`` run by ``advance``) and captured
    (``inference_speech_beam``) from the same generator seed: equal
    tokens and lengths and equal launches (K2 4 a layer and step, K3 one);
    from the profiler over 8 replayed steps the CUDA kernels and device ms
    a step; and the cache gather of a step (the decode region's K and V
    gathered by beam into the scratch and copied back) timed alone, with
    its share of the step's device time."""
    from torch.profiler import ProfilerActivity, profile
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.models import unified_voice as uv
    from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
    from tortoise_tts_tpu_torch.utils.graphs import STATS, StepGraph
    ar = tts._model("autoregressive")
    layers, dev = ar.config.layers, tts.device
    stages = Stages(torch)
    total = None
    try:
        for greedy in (True, False):
            (wav, sr), wall, counts, stage_s = _route_run(
                torch, stages, "beam", lambda: tts.inference(
                    TEXT, ref, seed=0, beam_width=width, greedy=greedy,
                    top_p=0.9, **ROUTE_KW))
            # random weights give every code about the same log-prob, so
            # the sampled beam's stop continuations, which join every
            # step's candidates, end its beams early: a short wav
            _check_wav(wav, 24000 if greedy else 1)
            _launched(counts, DEFAULT_ROUTE_KERNELS + ("snake",), "beam")
            steps = counts["flash_decode"] // layers
            assert stages.launches["ar_decode"]["qgemv"] == \
                4 * layers * steps, stages.launches
            stages.assert_captured(1, steps, 1)
            audio_s = wav.size / sr
            emit("beam_route", card=nvidia_smi(), width=width,
                 sampled=not greedy, wall_s=wall, audio_s=audio_s,
                 rtf_x_realtime=audio_s / wall, stage_s=stage_s,
                 decode_steps=steps,
                 decode_ms_per_step=stage_s["ar_decode"] * 1e3 / steps,
                 stage_launches=stages.launches, stage_graphs=stages.graphs,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
            total = counts if total is None else {
                k: total[k] + counts[k] for k in counts}
    finally:
        stages.close()

    lat, tokens, lengths = _beam_inputs(torch, tts, ref)
    qgpt = tts._ar_qgpt()
    args = (ar.params, lat, tokens, lengths)
    for greedy in (True, False):
        sampling = SamplingConfig(greedy=greedy, top_p=0.9)

        def gen():
            return torch.Generator(device=dev).manual_seed(5)
        runs = {}
        with torch.inference_mode():
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = uv.beam_start(*args, width, ar.config, AR_STEPS, gen())
            uv.advance(state, AR_STEPS, uv.beam_step_fn(
                ar.params, state, ar.config, sampling, not greedy, qgpt))
            eager = uv.beam_result(state, sampling.length_penalty)
            torch.cuda.synchronize()
            runs["eager"] = (time.perf_counter() - t0, state.step,
                             kernels.launch_counts())
            kernels.reset_launches()
            s0 = dataclasses.replace(STATS)
            t0 = time.perf_counter()
            got = uv.inference_speech_beam(*args, ar.config, width, AR_STEPS,
                                           sampling, gen(), not greedy, qgpt)
            torch.cuda.synchronize()
            runs["captured"] = (time.perf_counter() - t0, state.step,
                                kernels.launch_counts())
            graphs = _graphs_since(s0)
            same = (torch.equal(got.codes, eager.codes)
                    and torch.equal(got.lengths, eager.lengths))
            assert same, "captured beam differs from the eager step"
            _assert_graphs(graphs, 1, state.step - 1)
            assert runs["captured"][2] == runs["eager"][2], runs
            c = runs["eager"][2]
            assert c["qgemv"] == 4 * layers * state.step, c
            assert c["flash_decode"] == layers * state.step, c
            # the captured step alone: 8 replays profiled
            st = uv.beam_start(*args, width, ar.config, AR_STEPS, gen())
            step = uv.beam_step_fn(ar.params, st, ar.config, sampling,
                                   not greedy, qgpt)
            graph = StepGraph(step, dev, [] if greedy else [st.generator])
            for _ in range(8):
                graph.replay()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                profiler_warmup(torch)
                for _ in range(8):
                    graph.replay()
                torch.cuda.synchronize()
            events = _cuda_events(prof)
            step_ms = sum(e.device_time for e in events) / 1e3 / 8
            sel = torch.arange(width - 1, -1, -1, device=dev)
            gather_ms = device_ms(torch, lambda _: uv.gather_beams(st, sel))
            # the decode region's K and V, each read and written twice
            cache_mb = 2 * st.scratch.numel() * st.scratch.element_size() / 1e6
            del graph, st
        emit("beam_decode", card=nvidia_smi(), width=width,
             sampled=not greedy, steps=state.step,
             eager_ms_per_step=runs["eager"][0] * 1e3 / state.step,
             captured_ms_per_step=runs["captured"][0] * 1e3 / state.step,
             captured=graphs, captured_equals_eager=same,
             port_kernel_calls_per_step={
                 k: v / state.step for k, v in runs["eager"][2].items()
                 if v},
             cuda_kernels_per_step=len(events) / 8,
             device_ms_per_step=step_ms,
             gather_device_ms=gather_ms, gather_region_mb=cache_mb,
             gather_share_of_step_device=gather_ms / step_ms)
    return total


def stream_growing(torch, tts, ref: str):
    """``TTS.stream(mode="growing")`` at the 200-token budget: each chunk
    re-vocodes the whole prefix with HiFiGAN.  First-chunk latency, the
    chunks, wall; one decode capture a call and a replay a token."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.utils.graphs import STATS
    layers = tts._model("autoregressive").config.layers
    kernels.reset_launches()
    s0 = dataclasses.replace(STATS)
    chunks, first_s = [], None
    t0 = time.perf_counter()
    for c in tts.stream(TEXT, ref, max_ar_steps=AR_STEPS, seed=0,
                        mode="growing"):
        if first_s is None:
            first_s = time.perf_counter() - t0
        chunks.append(c)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    emit("launches", route="stream_growing", **counts)
    _launched(counts, ("flash_attention", "qgemv", "flash_decode"),
              "growing stream")
    tokens = counts["flash_decode"] // layers
    graphs = _graphs_since(s0)
    _assert_graphs(graphs, 1, tokens - 1)
    wav = np.concatenate(chunks)
    _check_wav(wav)
    emit("stream_growing", card=nvidia_smi(), first_chunk_s=first_s,
         chunks=len(chunks), chunk_samples=[c.size for c in chunks],
         wall_s=wall, audio_s=wav.size / 24000,
         rtf_x_realtime=wav.size / 24000 / wall, decode_tokens=tokens,
         graphs=graphs)
    return counts


def _write_safetensors(path: Path, tensors) -> None:
    """{name: tensor} as a float32 .safetensors file."""
    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        b = t.detach().float().cpu().contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def lora_route(torch, tts, ref: str, tmp: str):
    """LoRA on the full-width AR model: a random rank-16 adapter over the
    trunk's four linears written to disk, merged on the card by
    ``enable_lora`` (``cfg.loras``) and held against the same merge on the
    CPU in fp32; then 8 greedy tokens of a decode captured with the merged
    weights, ``disable_lora``, and 8 more of the same state with the base
    weights, which must capture again (the int8 decode weights made
    again), token for token as the eager step with the same switch."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.config import LoRAConfig
    from tortoise_tts_tpu_torch.models import lora
    from tortoise_tts_tpu_torch.models import unified_voice as uv
    from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
    from tortoise_tts_tpu_torch.utils.graphs import STATS
    base = tts._ar_base()
    cfg = base.config
    rank, alpha = 16, 32
    g = torch.Generator().manual_seed(9)
    adapter = {}
    for name in lora.GPT_TARGETS:
        n_layers, d_in, d_out = base.params["gpt"][name]["w"].shape
        adapter[name] = {
            "a": (torch.rand(n_layers, d_in, rank, generator=g) * 2 - 1)
            / d_in ** 0.5,
            "b": 0.02 * torch.randn(n_layers, rank, d_out, generator=g)}
    path = Path(tmp) / "lora.sft"
    _write_safetensors(path, {f"gpt/{n}/{k}": t for n, ab in adapter.items()
                              for k, t in ab.items()})
    cfg0 = tts.cfg
    tts.cfg = dataclasses.replace(cfg0, loras=(LoRAConfig(
        path=str(path), rank=rank, alpha=alpha, training=False),))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tts.enable_lora()
        merged = tts._model("autoregressive")
        torch.cuda.synchronize()
        merge_s = time.perf_counter() - t0
        assert tts._qgpt is None and merged.from_checkpoint
        cpu = lora.merge_lora(
            {"gpt": {n: {"w": base.params["gpt"][n]["w"].float().cpu()}
                     for n in lora.GPT_TARGETS}},
            {"gpt": adapter}, alpha, rank)
        err = max(bf16_err(torch, merged.params["gpt"][n]["w"].cpu(),
                           cpu["gpt"][n]["w"], atol=1e-4, rtol=2 ** -7,
                           name=f"lora {n}") for n in lora.GPT_TARGETS)
        lat, tokens, lengths = _beam_inputs(torch, tts, ref)
        sampling = SamplingConfig(greedy=True)
        out = {}
        with torch.inference_mode():
            q_merged = tts._ar_qgpt()
            for mode in ("eager", "captured"):
                tts.enable_lora()
                weights = [(merged.params, q_merged)]
                state = uv.decode_start(merged.params, lat, tokens, lengths,
                                        None, cfg, 32)
                s0 = dataclasses.replace(STATS)
                kernels.reset_launches()
                for i in range(2):
                    params, qgpt = weights[i]
                    if mode == "captured":
                        uv.decode_chunk(params, state, cfg, sampling,
                                        chunk=8, qgpt=qgpt)
                    else:
                        uv.advance(state, state.step + 8, uv.decode_step_fn(
                            params, state, cfg, sampling, qgpt=qgpt))
                    if i == 0:
                        tts.disable_lora()
                        assert tts._qgpt is None
                        assert tts._model("autoregressive") is base
                        weights.append((base.params, tts._ar_qgpt()))
                        assert weights[1][1] is not q_merged
                torch.cuda.synchronize()
                out[mode] = (state.tokens[:, :16].clone(), _graphs_since(s0),
                             kernels.launch_counts())
        # a capture (its warm-up the first token) and 7 replays a chunk
        _assert_graphs(out["captured"][1], 2, 14)
        _assert_graphs(out["eager"][1], 0, 0)
        same = torch.equal(out["eager"][0], out["captured"][0])
        assert same, "LoRA-toggled captured decode differs from eager"
    finally:
        tts.cfg = cfg0
        tts.disable_lora()
    emit("lora_route", card=nvidia_smi(), rank=rank, alpha=alpha,
         layers=cfg.layers, merge_s=merge_s, merge_max_abs_err=err,
         tol="1e-4 + 2^-7 |w|", graphs=out["captured"][1],
         captured_equals_eager=same,
         tokens_with_lora=out["captured"][0][0, :8].tolist(),
         tokens_after_disable=out["captured"][0][0, 8:].tolist())
    return out["captured"][2]


# ---------------------------------------------------------------------------
# phases 16-18: training
# ---------------------------------------------------------------------------

# a kernel's output and its gradients against the plain version's, row by
# row (``_rows``): a row's error norm within rtol of the row's norm plus
# one bf16 ulp (2^-7) of the tensor's RMS an element.  A row of K1's
# output averages up to S values and shrinks like sqrt(e/S), so a bound
# on the tensor's largest |value| would pass a lost key tile.  The
# gradients take one fixed upstream gradient for every version: through
# the bf16 plain backward, an upstream gradient that moves by an ulp moves
# some rows of K1's dq by more than this bound (the plain version's own dq
# is off fp32 by more; PERF.md, PR 13)
TRAIN_GRAD_TOL = dict(rtol=2e-2, rms_ulp=2.0 ** -7)
# the tiny fp32 step, card (kernels, TF32 off) against the CPU (plain
# versions): loss and gradient leaves relative to the leaf's largest
# |value|; the parameters after one SGD update
TINY_REL_TOL = 1e-3
TINY_PARAM_TOL = dict(atol=1e-6, rtol=1e-5)
# the resumed step against the uninterrupted one: one bf16 rounding of a
# parameter (2^-8 of it) plus what the backward's atomics reorder
RESUME_PARAM_RTOL = 2.0 ** -7
# K1 at the AR train steps' shapes: the README yaml's (B=16, S = 1 + 258
# + 514) and train_bench's (B=8, S = 1 + 130 + 258)
K1_TRAIN_SHAPES = ((16, 16, 773, 64), (8, 16, 389, 64))
# K4 and K5 at the diffusion step's (the README yaml's) shapes: T =
# mel_bucket 512 x 4 frames x 24000/22050, rounded up to 64
DIFF_TRAIN_T = 2240
DIFF_TRAIN_B = 16
TRAIN_KERNELS = ("flash_attention", "gn_conv", "ts_res_block")
# the vocoder GAN step: B segments of T samples (T / 256 mel frames) of
# the synthetic reference at 24 kHz, AdamW at VOC_LR (the BigVGAN
# recipe's rate) for VOC_STEPS steps
VOC_B = 8
VOC_T = 8192
VOC_STEPS = 8
VOC_LR = 1e-4
# CLVP at full width through train.main: batch CLVP_B (halved until it
# fits) of as many artifacts, so every batch is the same one; AdamW at
# CLVP_LR: at 1e-3 the full-width bf16 model overshoots within 6 steps
CLVP_B = 32
CLVP_STEPS = 6
CLVP_LR = 5e-5
# slice 14's optimizers and schedule-free, 3 micro-steps each on the AR
# finetune's shape
NEW_OPTIMIZERS = (("Adafactor", ""), ("Prodigy", ""), ("Muon", ""),
                  ("DAdaptation", ""), ("Apollo", ""), ("apollo-mini", ""),
                  ("AdamW", "schedulefree"))


def vocoder_snake_shapes() -> list:
    """K7's (C, T) in the shipped generator at the vocoder step's T: one
    stage an upsample (18 Snakes each: 3 resblocks of 6), the last
    stage's shape also activation_post's (one more)."""
    from tortoise_tts_tpu_torch.models.bigvgan import BigVGANConfig
    cfg = BigVGANConfig()
    t, out = VOC_T // cfg.hop_size, []
    for i, u in enumerate(cfg.upsample_rates):
        t *= u
        out.append((cfg.upsample_initial_channel // 2 ** (i + 1), t))
    return out


def vocoder_snakes(cfg=None) -> int:
    """K7 calls of one generator forward: 6 a resblock, one after."""
    from tortoise_tts_tpu_torch.models.bigvgan import BigVGANConfig
    cfg = cfg or BigVGANConfig()
    return (len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes) * 6
            + 1)


def train_launches(ar: int = 0, diffusion: int = 0, feeder: int = 0,
                   remat: bool = True) -> dict:
    """K1, K4 and K5 launches a micro-step: K1 a layer of an ``ar``-layer
    AR step, again in its remat recompute, and a layer of the diffusion
    feeder's ``feeder``-layer latent pass; in a ``diffusion``-layer
    diffusion step K4 in the latent conditioner's 4 attention heads, the
    integrator's 3 and the trunk's layers (a resblock in-half and an
    attention head each) and the 3 final resblocks, K5 in every resblock.
    The backwards recompute the plain versions and launch nothing."""
    return {"flash_attention": ar * (2 if remat else 1) + feeder,
            "gn_conv": 4 + 3 * 2 + 2 * diffusion + 3 if diffusion else 0,
            "ts_res_block": 3 + diffusion + 3 if diffusion else 0}


def _fwd_bwd(torch, fn, inputs, upstream):
    """fn(*inputs) and the gradients of <fn(*inputs), upstream>."""
    xs = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
    out = fn(*xs)
    grads = torch.autograd.grad(out, [x for x in xs if x.requires_grad],
                                upstream)
    return out.detach(), grads


def _rel_err(got, want, name, tol):
    d = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    assert math.isfinite(d), f"{name}: non-finite"
    assert d <= tol * scale + 1e-6, f"{name}: {d} > {tol} x {scale}"
    return d / max(scale, 1e-30)


def _rows(t):
    """t as rows: trailing dimensions folded in until a row holds 64
    elements or more (K1's head dim, K4's and K5's time axis, a weight's
    output channel; a vector is one row)."""
    n, i = 1, t.dim()
    while i > 0 and n < 64:
        i -= 1
        n *= t.shape[i]
    return t.reshape(-1, n)


def _row_err(got, want) -> dict:
    """``row``: the worst row's error norm over its TRAIN_GRAD_TOL bound
    (above 1 fails); ``global``: the largest |error| over the largest
    |want|, the tensor-wide reading, for comparison."""
    g, w = _rows(got.float()), _rows(want.float())
    d = g - w
    ulp = TRAIN_GRAD_TOL["rms_ulp"] * float(w.pow(2).mean().sqrt())
    bound = (TRAIN_GRAD_TOL["rtol"] * w.norm(dim=1)
             + ulp * math.sqrt(w.shape[1]))
    return {"row": float((d.norm(dim=1) / bound).max()),
            "global": float(d.abs().max() / w.abs().max().clamp_min(1e-30))}


def _held(name, out_k, g_k, out_p, g_p, names) -> dict:
    """_row_err of the output and of every gradient, by tensor name, and
    whether the gradient is the plain one bit for bit."""
    errs = {"out": _row_err(out_k, out_p)}
    for nm, a, b in zip(names, g_k, g_p):
        errs["d" + nm] = dict(_row_err(a, b), exact=bool((a == b).all()))
    for nm, e in errs.items():
        assert math.isfinite(e["row"]), f"{name} {nm}: non-finite"
    return errs


def _grad_case(torch, name, shape, kernel, plain, library, inputs, names,
               nbytes, flops, fault=None, n=10, peak=BF16_FLOPS):
    """One kernel's forward and every input's gradient against its plain
    version (TRAIN_GRAD_TOL, row by row), then fwd+bwd device ms of the
    kernel path, the plain version and the library's call (None where no
    library call computes the function); one ``train_grads`` line.  Every version's backward takes one upstream
    gradient, random from a seed.  ``fault``, a planted error (the plain
    version with one key tile dropped), must fail the same check."""
    with torch.no_grad():
        shape_out = kernel(*inputs).shape
    g = torch.Generator(device=inputs[0].device).manual_seed(7)
    up = torch.randn(shape_out, generator=g, device=inputs[0].device
                     ).to(inputs[0].dtype)
    out_k, g_k = _fwd_bwd(torch, kernel, inputs, up)
    out_p, g_p = _fwd_bwd(torch, plain, inputs, up)
    errs = _held(name, out_k, g_k, out_p, g_p, names)
    for nm, e in errs.items():
        assert e["row"] <= 1, f"{name} {nm}: {e} off TRAIN_GRAD_TOL"
    for nm, a in zip(names, g_k):
        assert float(a.float().abs().max()) > 0, f"{name}: d{nm} is zero"
    del out_k, g_k
    planted = {}
    if fault is not None:
        out_f, g_f = _fwd_bwd(torch, fault, inputs, up)
        planted = _held(name, out_f, g_f, out_p, g_p, names)
        assert max(e["row"] for e in planted.values()) > 1, \
            f"{name}: the check passes a dropped key tile: {planted}"
        del out_f, g_f
    del out_p, g_p
    t_ = {key: None if fn is None else
          device_ms(torch, lambda _, f=fn: _fwd_bwd(torch, f, inputs, up),
                    n=n, warmup=2)
          for key, fn in (("fwd_bwd_ms", kernel), ("plain_fwd_bwd_ms", plain),
                          ("library_fwd_bwd_ms", library))}
    bms, by = bound_ms(nbytes, flops, peak)
    emit("train_grads", name=name, shape=list(shape), err=errs,
         tol=TRAIN_GRAD_TOL, **({"planted_fault": planted} if planted
                                else {}),
         bound_ms=bms, bound_by=by, **t_)
    torch.cuda.empty_cache()
    return dict(row_err=max(e["row"] for e in errs.values()), bound_ms=bms,
                **t_)


def train_grads(torch, dev):
    """Phase 16: K1, K4, K5 and K7 differentiated on the card at the
    training shapes, in bf16: the kernel's autograd path (kernel forward,
    plain recompute backward) against the plain version's autograd, output
    and every input's gradient, and fwd+bwd device ms beside the library's
    (SDPA; F.group_norm + F.silu + F.conv1d; none for K7) and the bound."""
    from tortoise_tts_tpu_torch.kernels import flash_attention as k1
    from tortoise_tts_tpu_torch.kernels import gn_conv as k4
    from tortoise_tts_tpu_torch.kernels import ts_res_block as k5
    F = torch.nn.functional
    out = {}
    for i, (b, h, s, d) in enumerate(K1_TRAIN_SHAPES):
        g = torch.Generator(device=dev).manual_seed(70 + i)
        q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        # the planted fault: the last full key tile before the diagonal
        # one dropped for every query (a ring-buffer slot lost at S=773)
        drop = torch.ones(b, s, dtype=torch.bool, device=dev)
        lo = ((s - 1) // k1.KEY_TILE - 1) * k1.KEY_TILE
        drop[:, lo:lo + k1.KEY_TILE] = False
        # causal: every matmul does half its square
        out[("flash_attention", b)] = _grad_case(
            torch, "flash_attention", (b, h, s, d),
            lambda q, k, v: k1.flash_attention(q, k, v, causal=True),
            lambda q, k, v: k1.flash_attention_plain(q, k, v, causal=True),
            lambda q, k, v: F.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True),
            (q, k, v), ("q", "k", "v"), 8 * b * h * s * d * 2,
            7 * b * h * s * s * d,
            fault=lambda q, k, v: k1.flash_attention_plain(q, k, v, drop,
                                                           causal=True))
    b, c, t, groups = DIFF_TRAIN_B, 1024, DIFF_TRAIN_T, 32
    for i, (name, m, act) in enumerate((("resblock_in_half", c, True),
                                        ("attention_qkv_head", 3 * c,
                                         False))):
        x, norm, conv = _gn_conv_inputs(torch, dev, b, c, t, m, 1, 80 + i)
        inputs = (x, norm["scale"], norm["bias"], conv["w"], conv["b"])

        def kernel(x, ga, be, w, bi, act=act):
            return k4.gn_conv1x1(x, {"scale": ga, "bias": be},
                                 {"w": w, "b": bi}, groups, act)

        def plain(x, ga, be, w, bi, act=act):
            return k4.gn_conv1x1_plain(x, {"scale": ga, "bias": be},
                                       {"w": w, "b": bi}, groups, act)

        def library(x, ga, be, w, bi, act=act):
            y = F.group_norm(x, groups, ga.to(x.dtype), be.to(x.dtype))
            return F.conv1d(F.silu(y) if act else y, w, bi.to(x.dtype))
        out[("gn_conv", name)] = _grad_case(
            torch, "gn_conv", (b, c, t, m), kernel, plain, library, inputs,
            ("x", "gamma", "beta", "w", "b"),
            2 * (3 * b * c * t + 3 * b * m * t) + 2 * 2 * m * c,
            6 * b * m * c * t)
    h, norm, conv = _gn_conv_inputs(torch, dev, b, c, t, c, 3, 90)
    g = torch.Generator(device=dev).manual_seed(91)
    x = torch.randn(b, c, t, generator=g, device=dev).to(torch.bfloat16)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=dev)
           ).to(torch.bfloat16)

    def k5_kernel(h, x, emb, ga, be, w, bi):
        # the train step's way: the tap-major weight made from the live
        # weight inside the graph
        return k5.ts_res_block_out(h, x, emb, {"scale": ga, "bias": be},
                                   k5.prepare_conv({"w": w, "b": bi}),
                                   groups)

    def k5_plain(h, x, emb, ga, be, w, bi):
        return k5.ts_res_block_out_plain(h, x, emb, {"scale": ga,
                                                     "bias": be},
                                         {"w": w, "b": bi}, groups)

    def k5_library(h, x, emb, ga, be, w, bi):
        sc, sh = emb[..., None].chunk(2, dim=1)
        y = F.group_norm(h, groups, ga.to(h.dtype), be.to(h.dtype))
        return x + F.conv1d(F.silu(y * (1 + sc) + sh), w, bi.to(h.dtype),
                            padding=1)
    out[("ts_res_block", b)] = _grad_case(
        torch, "ts_res_block", (b, c, t), k5_kernel, k5_plain, k5_library,
        (h, x, emb, norm["scale"], norm["bias"], conv["w"], conv["b"]),
        ("h", "x", "emb", "gamma", "beta", "w", "b"),
        2 * 7 * b * c * t + 2 * 2 * 3 * c * c, 6 * b * c * 3 * c * t)
    # K7 at the vocoder step's shapes, bf16: the kernel forward with its
    # plain recompute backward against the plain version's autograd; no
    # library call computes it.  Bytes: the forward reads x and writes y,
    # the backward reads x and the upstream and writes dx (2 bytes each);
    # operations: the forward's 58 a sample (check_snake) and a backward
    # of twice as many
    from tortoise_tts_tpu_torch.kernels import snake as k7
    for i, (c, t) in enumerate(vocoder_snake_shapes()):
        g = torch.Generator(device=dev).manual_seed(100 + i)
        x = torch.randn(VOC_B, c, t, generator=g, device=dev
                        ).to(torch.bfloat16)
        alpha = torch.exp(0.3 * torch.randn(c, generator=g, device=dev))
        inv_beta = 1 / (torch.exp(0.3 * torch.randn(c, generator=g,
                                                    device=dev)) + 1e-9)
        n = VOC_B * c * t
        out[("snake", c)] = _grad_case(
            torch, "snake", (VOC_B, c, t), k7.snake_resample2,
            k7.snake_resample2_plain, None, (x, alpha, inv_beta),
            ("x", "alpha", "inv_beta"), 2 * 5 * n + 4 * 4 * c, 3 * 58 * n,
            peak=FP32_FLOPS)
    return out


def _tiny_train_models(torch):
    """Tiny fp32 AR (head dim 64, K1's), diffusion and DVAE models, random
    from seeds on the CPU."""
    from tortoise_tts_tpu_torch.models import diffusion, dvae, unified_voice
    cfgs = {"autoregressive": unified_voice.UnifiedVoiceConfig(
                layers=2, model_dim=128, heads=2, max_text_tokens=40,
                max_mel_tokens=48),
            "diffusion": diffusion.DiffusionConfig(
                model_channels=64, num_layers=2, in_latent_channels=128,
                num_heads=2),
            "dvae": dvae.DVAEConfig(codebook_dim=32, hidden_dim=32,
                                    num_tokens=256)}
    mods = {"autoregressive": unified_voice, "diffusion": diffusion,
            "dvae": dvae}
    params = {n: mods[n].init(torch.Generator().manual_seed(30 + i), cfgs[n])
              for i, n in enumerate(cfgs)}
    # zero-initialised proj_out would hide the attention from the loss
    g = torch.Generator().manual_seed(40)
    for blk in (params["diffusion"]["latent_conditioner_attn"]
                + [l["attn"] for l in params["diffusion"]["layers"]]):
        blk["proj_out"]["w"] = 0.05 * torch.randn(
            blk["proj_out"]["w"].shape, generator=g)
    return cfgs, params


def _tiny_batches(torch):
    rng = np.random.RandomState(5)
    lens = np.asarray([25, 11], np.int32)
    text = np.zeros((2, 40), np.int32)
    for i, n in enumerate(lens):
        text[i, :n] = rng.randint(3, 255, n)
    ar = {"latents": rng.randn(2, 128).astype(np.float32), "text": text,
          "text_lengths": lens,
          "codes": rng.randint(0, 8192, (2, 48)).astype(np.int32),
          "wav_lengths": np.asarray([40, 23], np.int32) * 1024}
    diff = {"mel": np.clip(rng.randn(2, 100, 64) * 0.3, -1, 1
                           ).astype(np.float32),
            "latents": rng.randn(2, 12, 128).astype(np.float32),
            "conditioning_latents": rng.randn(2, 128).astype(np.float32)}
    dv = {"mel": (rng.randn(2, 80, 64) * 0.5).astype(np.float32)}
    t = torch.as_tensor([17, 3210])
    noise = torch.as_tensor(rng.randn(2, 100, 64).astype(np.float32))
    return {"autoregressive": ar, "diffusion": diff, "dvae": dv}, (t, noise)


def train_tiny(torch, dev):
    """Phase 17: one train step of a tiny AR, diffusion and DVAE model,
    fp32 with TF32 off, on the card (K1, K4, K5) and on the CPU (their
    plain versions) from the same params, batch and (for the diffusion)
    the same t and noise: the loss and every gradient leaf within
    TINY_REL_TOL of the leaf's largest |value|, the params after one SGD
    update within TINY_PARAM_TOL, and the launches the code implies."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.config import Hyperparameters
    from tortoise_tts_tpu_torch.engine import optim, train_step as ts
    from tortoise_tts_tpu_torch.engine.state import (flatten_tree,
                                                     init_state)
    from tortoise_tts_tpu_torch.models import gaussian
    from tortoise_tts_tpu_torch.models.common import tree_map

    class Recording(optim.Optimizer):
        def step(self, params, grads, state, norm=None):
            self.grads = [g.detach().cpu() for g in grads]
            return super().step(params, grads, state, norm)

    cfgs, params = _tiny_train_models(torch)
    batches, (t_fix, noise_fix) = _tiny_batches(torch)
    draws = ts.diffusion_draws
    ts.diffusion_draws = lambda seed, step, b, shape, n, device: (
        t_fix.to(device), noise_fix.to(device))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hp = Hyperparameters(optimizer="SGD", learning_rate=1e-2,
                         warmup_steps=0, gradient_accumulation_steps=1,
                         gradient_clipping=1.0)
    sched = gaussian.get_schedule(steps=4000, cond_free=False)
    expect = {"autoregressive": train_launches(
                  ar=cfgs["autoregressive"].layers),
              "diffusion": train_launches(
                  diffusion=cfgs["diffusion"].num_layers),
              "dvae": train_launches()}
    report = {}
    try:
        for name in ("autoregressive", "diffusion", "dvae"):
            runs = []
            for device in (dev, torch.device("cpu")):
                tx = Recording("sgd", hp.learning_rate, hp.gradient_clipping,
                               1)
                if name == "autoregressive":
                    step = ts.make_ar_train_step(cfgs[name], tx, remat=True)
                elif name == "diffusion":
                    step = ts.make_diffusion_train_step(cfgs[name], tx, sched)
                else:
                    step = ts.make_dvae_train_step(cfgs[name], tx)
                p = tree_map(lambda x: x.clone().to(device), params[name])
                state = init_state(p, tx)
                kernels.reset_launches()
                state, m = step(state, ts.to_device(batches[name], device))
                runs.append((
                    {k: float(v) for k, v in m.items()}, tx.grads,
                    {k: v.detach().cpu()
                     for k, v in flatten_tree(state.params).items()},
                    kernels.launch_counts()))
            (mk, gk, pk, ck), (mc, gc, pc, _) = runs
            launched = {k: ck[k] for k in TRAIN_KERNELS}
            assert launched == expect[name], (name, launched, expect[name])
            loss_err = abs(mk["loss"] - mc["loss"]) / abs(mc["loss"])
            assert loss_err <= TINY_REL_TOL, (name, mk, mc)
            grad_err = max(_rel_err(a, b, f"{name} grad", TINY_REL_TOL)
                           for a, b in zip(gk, gc)
                           if float(b.abs().max()) > 0)
            param_err = 0.0
            for k in pc:
                d = (pk[k] - pc[k]).abs()
                bad = int((d > TINY_PARAM_TOL["atol"]
                           + TINY_PARAM_TOL["rtol"] * pc[k].abs()).sum())
                assert bad == 0, (name, k, float(d.max()))
                param_err = max(param_err, float(d.max()))
            report[name] = dict(loss_card=mk["loss"], loss_cpu=mc["loss"],
                                loss_rel_err=loss_err, grad_rel_err=grad_err,
                                param_max_abs_err=param_err,
                                launches=launched)
        report.update(_tiny_clvp_vocoder(torch, dev, Recording, hp))
    finally:
        ts.diffusion_draws = draws
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    emit("train_tiny", tol=dict(rel=TINY_REL_TOL, params=TINY_PARAM_TOL),
         optimizer="SGD momentum 0.9, lr 1e-2, clip 1.0", **report)
    # the tiny steps' cuFFT plans (their workspaces) and blocks leave the
    # card before the routes read their peaks
    if dev.type == "cuda":
        torch.backends.cuda.cufft_plan_cache[dev.index or 0].clear()
    _free(torch)


def _tiny_clvp_vocoder(torch, dev, Recording, hp) -> dict:
    """Train_tiny's CLVP step (64 wide, 2 + 2 layers, a batch of 4) and
    vocoder GAN step (BigVGAN 512 wide, MPD periods 2 and 3, one MRD
    resolution, 4096 samples), fp32, on the card
    (K7 forward with its plain recompute backward, cuDNN convs, cuFFT) and
    on the CPU: every metric and every gradient leaf (both optimizers'
    for the vocoder) within TINY_REL_TOL of the leaf's largest |value|,
    and each parameter's move by the SGD update within TINY_REL_TOL of
    the leaf's largest move (both plus 1e-6, ``_rel_err``); K7 launched
    twice a generator's Snakes, CLVP no kernel.  The
    generator is wider than the JAX package's 64-wide test generator,
    whose near-silent output sits on the training mel's log clamp and on
    the L1's kinks: there a one-ulp difference in a Snake moves its
    gradients by percents, on the CPU alone."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.engine import train_step as ts
    from tortoise_tts_tpu_torch.engine.state import (TrainState,
                                                     flatten_tree,
                                                     init_state)
    from tortoise_tts_tpu_torch.models import _bigvgan_random, bigvgan
    from tortoise_tts_tpu_torch.models import bigvgan_disc as bvd
    from tortoise_tts_tpu_torch.models import clvp
    from tortoise_tts_tpu_torch.models.common import tree_map
    ccfg = clvp.CLVPConfig(dim_text=64, dim_speech=64, dim_latent=64,
                           text_enc_depth=2, speech_enc_depth=2,
                           text_heads=2, speech_heads=2, dim_head=32)
    vcfg = bigvgan.BigVGANConfig(upsample_initial_channel=512)
    dcfg = bvd.DiscriminatorConfig(periods=(2, 3),
                                   resolutions=((512, 128, 512),))
    params = {"clvp": clvp.init(torch.Generator().manual_seed(50), ccfg),
              "bigvgan": {
                  "generator": _bigvgan_random(
                      torch.Generator().manual_seed(51), vcfg),
                  "discriminator": bvd.init(
                      torch.Generator().manual_seed(52), dcfg)}}
    rng = np.random.RandomState(6)
    x = np.linspace(0, 1, 4096)
    batches = {"clvp": {"text": rng.randint(0, 256, (4, 16)),
                        "codes": rng.randint(0, 8192, (4, 24))},
               "bigvgan": {"wav": (0.4 * np.sin(2 * np.pi * 220 * x)
                                   + 0.05 * rng.randn(4096))[None]
                           .astype(np.float32)}}
    expect = {"clvp": {}, "bigvgan": {"snake": 2 * vocoder_snakes(vcfg)}}
    report = {}
    for name in ("clvp", "bigvgan"):
        runs = []
        for device in (dev, torch.device("cpu")):
            txs = [Recording("sgd", hp.learning_rate, hp.gradient_clipping,
                             1) for _ in range(2)]
            p = tree_map(lambda t: t.clone().to(device), params[name])
            if name == "clvp":
                step = ts.make_clvp_train_step(ccfg, txs[0])
                state = init_state(p, txs[0])
            else:
                step = ts.make_vocoder_train_step(vcfg, txs[0], txs[1], dcfg)
                state = TrainState(p, {
                    "g": txs[0].init(p["generator"]),
                    "d": txs[1].init(p["discriminator"])})
            p0 = {k: v.detach().cpu().clone()
                  for k, v in flatten_tree(state.params).items()}
            kernels.reset_launches()
            state, m = step(state, ts.to_device(batches[name], device))
            runs.append(({k: float(v) for k, v in m.items()},
                         [g for tx in txs for g in getattr(tx, "grads", [])],
                         {k: v.detach().cpu() - p0[k]
                          for k, v in flatten_tree(state.params).items()},
                         kernels.launch_counts()))
        (mk, gk, dk, ck), (mc, gc, dc, _) = runs
        launched = {k: v for k, v in ck.items() if v}
        assert launched == expect[name], (name, launched, expect[name])
        loss_err = max(abs(mk[k] - mc[k]) / abs(mc[k]) for k in mc)
        assert loss_err <= TINY_REL_TOL, (name, mk, mc)
        grad_err = max(_rel_err(a, b, f"{name} grad", TINY_REL_TOL)
                       for a, b in zip(gk, gc) if float(b.abs().max()) > 0)
        move_err = max(_rel_err(dk[k], dc[k], f"{name} move {k}",
                                TINY_REL_TOL)
                       for k in dc if float(dc[k].abs().max()) > 0)
        report[name] = dict(metrics_card=mk, metrics_cpu=mc,
                            loss_rel_err=loss_err, grad_rel_err=grad_err,
                            move_rel_err=move_err, launches=launched)
    return report


def _train_artifacts(root: Path, n: int, seed: int, dim=None) -> Path:
    """n reference-format .mel artifacts of one speaker, 3-5 s each, with
    the AR and diffusion conditioning latents at the AR model's width
    ``dim`` (the shipped one by default) and the ``store_mels`` targets
    (80-bin mel, 100-bin diffusion mel)."""
    from tortoise_tts_tpu_torch.models.unified_voice import \
        UnifiedVoiceConfig
    dim = dim or UnifiedVoiceConfig().model_dim
    rng = np.random.RandomState(seed)
    d = root / "data" / "train" / "speaker"
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        dur = 3.0 + 2.0 * i / max(1, n - 1)
        nc = int(dur * 22050 / 1024)
        frames = nc * 4
        art = {
            "codes": rng.randint(0, 8192, (nc,)).astype(np.uint16),
            "conds": (rng.randn(1, 1, 80, 100).astype(np.float32),
                      rng.randn(1, 1, 100, 100).astype(np.float32)),
            "latent": (rng.randn(1, dim).astype(np.float32),
                       rng.randn(1, 2 * dim).astype(np.float32)),
            "text": rng.randint(3, 255, (int(12 * dur),)).astype(np.uint8),
            "mel": (rng.randn(80, frames) * 0.5 - 1).astype(np.float16),
            "mel_diff": np.clip(rng.randn(100, int(frames * 24000 / 22050))
                                * 0.3, -1, 1).astype(np.float16),
            "metadata": {"original_length": nc * 1024,
                         "sample_rate": 22050, "duration": nc * 1024 / 22050,
                         "text": "training sample"}}
        with open(d / f"utt{i:03d}.mel", "wb") as f:
            np.save(f, art)
    return d.parent.parent


def _train_cfg(root: Path, data: Path, models, batch: int, iters: int,
               **over):
    from tortoise_tts_tpu_torch.config import Config
    raw = {"models": models,
           "hyperparameters": {"batch_size": batch, "optimizer": "AdamW",
                               "learning_rate": 1e-4},
           "trainer": {"iterations": iters, "log_frequency": 1,
                       "export_on_save": False, "keep_last_checkpoints": 1,
                       "weight_dtype": "bfloat16", "async_checkpoint": True,
                       "gradient_checkpointing": True},
           "evaluation": {"frequency": 0, "kwargs": {"max_steps": 48}},
           "dataset": {"training": [str(data)], "validate": False,
                       "load_mels": True}}
    for group, kw in over.items():
        if isinstance(kw, dict):
            raw.setdefault(group, {}).update(kw)
        else:
            raw[group] = kw
    return Config.from_dict(raw, yaml_path=str(root / "cfg.yaml"))


def _counted(torch, fn):
    """fn() and the kernel launches it made."""
    from tortoise_tts_tpu_torch import kernels
    torch.cuda.synchronize()
    c0 = kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    c1 = kernels.launch_counts()
    return out, {k: c1[k] - c0[k] for k in c1}


def _fingerprint(torch, engines) -> dict:
    """Each engine's parameter sums, a leaf each (fp32 accumulation): two
    that differ say the parameters moved in between."""
    from tortoise_tts_tpu_torch.engine.state import flatten_tree
    return {n: torch.stack([p.sum(dtype=torch.float32) for p in
                            flatten_tree(engines[n].params).values()]).cpu()
            for n in engines.names()}


def _run_train(torch, cfg, dev):
    """``train.main(cfg=...)`` with every ``Engines.step`` timed: (the
    engines, per-step records of wall seconds, launches, metrics, tokens
    and which engines' parameters the step moved, the peak memory in
    GB)."""
    from tortoise_tts_tpu_torch import train
    from tortoise_tts_tpu_torch.engine import engines as eng_mod
    from tortoise_tts_tpu_torch.engine.factory import tokens_of
    orig = eng_mod.Engines.step
    steps = []

    def timed(self, batch, fetch_metrics=True):
        before = _fingerprint(torch, self)
        t0 = time.perf_counter()
        m, launches = _counted(torch, lambda: orig(self, batch,
                                                   fetch_metrics=True))
        s = time.perf_counter() - t0
        after = _fingerprint(torch, self)
        steps.append(dict(s=s, launches=launches, metrics=m,
                          tokens=tokens_of(batch),
                          moved={n: not torch.equal(before[n], after[n])
                                 for n in before}))
        return m
    eng_mod.Engines.step = timed
    torch.cuda.reset_peak_memory_stats()
    try:
        engines = train.main(cfg=cfg, device=dev)
    finally:
        eng_mod.Engines.step = orig
    return engines, steps, torch.cuda.max_memory_allocated() / 1e9


def _check_launches(name, launches, expect) -> None:
    """The launches of K1, K4, K5 and every kernel in ``expect`` are
    ``expect``'s (0 where it has none), and no other kernel ran."""
    from tortoise_tts_tpu_torch.kernels import KERNELS
    keys = set(TRAIN_KERNELS) | set(expect)
    got = {k: launches[k] for k in keys}
    want = {k: expect.get(k, 0) for k in keys}
    assert got == want, (name, got, want)
    others = [k for k in KERNELS if k not in keys and launches[k]]
    assert not others, (name, others)


def _route_report(name, steps, expect, every_k: int, warm: int = 2) -> dict:
    """Per-step checks (finite losses, no skipped step, the launches the
    code implies each micro-step, every engine's parameters moved by the
    k-th micro-steps' updates and by no other) and the steady window's
    means."""
    for i, st in enumerate(steps):
        m = st["metrics"]
        skipped = [k for k in m if k.endswith(".skipped")]
        assert not skipped, f"{name}: step {i} skipped {skipped}"
        losses = {k: v for k, v in m.items() if ".loss" in k}
        assert losses and all(math.isfinite(v) for v in losses.values()), \
            (name, i, losses)
        _check_launches(f"{name} step {i}", st["launches"], expect)
        update = (i + 1) % every_k == 0
        assert all(v == update for v in st["moved"].values()), \
            (name, i, update, st["moved"])
    steady = steps[warm:] or steps
    engines = sorted({k.rsplit(".", 1)[0] for st in steps
                      for k in st["metrics"] if k.endswith(".elapsed_time")})
    ms = {e: 1e3 * float(np.mean([st["metrics"][f"{e}.elapsed_time"]
                                  for st in steady])) for e in engines}
    wall = float(np.mean([st["s"] for st in steady]))
    return dict(ms_per_micro_step=ms, wall_ms_per_micro_step=1e3 * wall,
                tokens_per_s=float(np.mean([st["tokens"] for st in steady]))
                / wall, steps=len(steps), steady_steps=len(steady),
                launches_per_micro_step=expect)


def eval_launches(tokens: int, steps: int = 30) -> dict:
    """The launches of one ``run_eval`` sample whose decode took
    ``tokens`` steps: K1 a layer in the prefill and in the latent pass;
    K2 four GEMVs and K3 one attention a layer a token; K4 the latent
    conditioner's 4 heads once, then, as in the default route
    (``bigvgan_route``), K4 and K5 of a denoiser call a P step; K7 the
    vocoder's Snake calls (6 a resblock, 3 resblocks an upsample, one
    after)."""
    from tortoise_tts_tpu_torch.models.bigvgan import BigVGANConfig
    from tortoise_tts_tpu_torch.models.diffusion import DiffusionConfig
    from tortoise_tts_tpu_torch.models.unified_voice import \
        UnifiedVoiceConfig
    layers, nl = UnifiedVoiceConfig().layers, DiffusionConfig().num_layers
    voc = BigVGANConfig()
    return {"flash_attention": 2 * layers, "qgemv": 4 * layers * tokens,
            "flash_decode": layers * tokens,
            "gn_conv": 4 + steps * (2 * (3 + nl) + 3),
            "ts_res_block": steps * (3 + nl + 3),
            "snake": len(voc.upsample_rates)
            * len(voc.resblock_kernel_sizes) * 6 + 1}


def _kernel_group(name: str) -> str:
    for key, group in (("flash_attn", "K1"), ("gn_conv", "K4"),
                       ("ts_res_block", "K5"), ("group_norm_act", "K4/K5 "
                                                "normalise"),
                       ("group_stats", "K4/K5 normalise"),
                       ("gemm", "GEMM"), ("sm90", "GEMM"), ("cutlass", "GEMM"),
                       ("softmax", "softmax"), ("elementwise", "elementwise"),
                       ("reduce", "reduce"), ("index", "index")):
        if key in name.lower():
            return group
    return "other"


def _profile_step(torch, fn) -> dict:
    """One call of fn under torch.profiler: wall and device ms, the busy
    share, the CUDA kernels, and the device ms by kernel group."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiler_warmup(torch)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = _cuda_events(prof)
    groups: dict = {}
    for e in events:
        g = _kernel_group(e.name)
        groups[g] = groups.get(g, 0.0) + e.device_time / 1e3
    dev = sum(groups.values())
    return dict(wall_ms=wall, device_ms=dev, busy=dev / wall,
                cuda_kernels=len(events),
                device_ms_by_group=dict(sorted(groups.items(),
                                               key=lambda kv: -kv[1])))


def _shape(cfg) -> dict:
    """The batch and the sequence shapes a route's config gives the steps:
    the AR trunk's S (cond, the text bucket and the mel bucket with their
    start and stop tokens), the diffusion's T and the DVAE's mel frames."""
    ds, b = cfg.dataset, cfg.hyperparameters.batch_size
    f = int(ds.mel_bucket * 4 * 24000 / 22050)
    return dict(batch=b, accumulation=cfg.hyperparameters
                .gradient_accumulation_steps, text_bucket=ds.text_bucket,
                mel_bucket=ds.mel_bucket,
                ar_seq=1 + ds.text_bucket + 2 + ds.mel_bucket + 2,
                diffusion_t=(f + 63) // 64 * 64, dvae_frames=4 * ds.mel_bucket)


def _params_close(torch, a, b, name):
    from tortoise_tts_tpu_torch.engine.state import flatten_tree
    fa, fb = flatten_tree(a), flatten_tree(b)
    worst = 0.0
    for k in fa:
        d = (fa[k].float() - fb[k].float()).abs()
        lim = RESUME_PARAM_RTOL * fa[k].float().abs() + 1e-6
        bad = int((d > lim).sum())
        assert bad == 0, f"{name}: {k} off in {bad} elements"
        worst = max(worst, float(d.max()))
    return worst


def train_route(torch, dev, tmp: str):
    """Phase 18: training through ``train.main`` at full width (random bf16
    weights) on fabricated 3-5 s artifacts: the AR finetune at
    train_bench's shape (batch 8, buckets 128/256, one fixed batch:
    the AR loss must fall), with a checkpoint at its last step that a new
    ``load_engines`` resumes (its next step against the uninterrupted
    one's) and one ``run_eval`` sample; the README yaml (AR + diffusion
    co-trained at batch 16, buckets 256/512, halved until it fits; two
    updates of 4 micro-steps, the AR loss lower after the first); a
    rank-128 LoRA run; one DVAE step.  Every step and the eval are
    counted and checked against the launches the code implies.  Returns
    the launch counts."""
    import gc
    from tortoise_tts_tpu_torch import kernels, train
    from tortoise_tts_tpu_torch.data import Dataset
    from tortoise_tts_tpu_torch.engine.factory import load_engines
    from tortoise_tts_tpu_torch.models.diffusion import DiffusionConfig
    from tortoise_tts_tpu_torch.models.unified_voice import \
        UnifiedVoiceConfig
    counts = {k: 0 for k in kernels.launch_counts()}

    def add(launches):
        for k, v in launches.items():
            counts[k] += v

    def step(engines, batch, name, expect):
        m, c = _counted(torch, lambda: engines.step(batch))
        _check_launches(name, c, expect)
        add(c)
        return m

    layers = UnifiedVoiceConfig().layers
    k1_ar = train_launches(ar=layers)
    root = Path(tmp) / "train_ar"
    data = _train_artifacts(root, 8, seed=1)
    iters = 10
    cfg = _train_cfg(root, data, [{"name": "autoregressive",
                                   "training": True}], 8, iters,
                     hyperparameters={"gradient_accumulation_steps": 1,
                                      "warmup_steps": 0},
                     trainer={"save_frequency": iters},
                     dataset={"text_bucket": 128, "mel_bucket": 256,
                              "load_mels": False})
    engines, steps, peak = _run_train(torch, cfg, dev)
    for st in steps:
        add(st["launches"])
    rep = _route_report("ar_finetune", steps, k1_ar, 1)
    losses = [st["metrics"]["autoregressive.loss"] for st in steps]
    assert losses[-1] < losses[0], f"AR loss did not fall: {losses}"
    stall, write = engines.last_save_stall_s, engines.last_write_s
    batch = next(Dataset(cfg, cfg.dataset.training).batches())
    m1 = step(engines, batch, "uninterrupted next step", k1_ar)
    resumed = load_engines(cfg, device=dev)
    assert resumed.global_step == iters, resumed.global_step
    m2 = step(resumed, batch, "resumed next step", k1_ar)
    loss_diff = abs(m1["autoregressive.loss"] - m2["autoregressive.loss"])
    assert loss_diff <= 1e-2 * abs(m1["autoregressive.loss"]), (m1, m2)
    resume_err = _params_close(torch, engines["autoregressive"].params,
                               resumed["autoregressive"].params,
                               "resume vs uninterrupted")
    del resumed
    prof = _profile_step(torch, lambda: step(engines, batch, "profiled step",
                                             k1_ar))
    t0 = time.perf_counter()
    val = Dataset(cfg, cfg.dataset.training, training=False)
    ev, c = _counted(torch, lambda: train.run_eval(
        cfg, engines["autoregressive"], val, root / "logs", max_samples=1,
        prefix="val", device=dev))
    eval_s = time.perf_counter() - t0
    add(c)
    tokens = c["flash_decode"] // layers
    assert 0 < tokens <= cfg.evaluation.kwargs["max_steps"], c
    want = eval_launches(tokens)
    got = {k: v for k, v in c.items() if v}
    assert got == want, ("run_eval launches", got, want)
    wavs = sorted((root / "logs").rglob("val_0_hyp.wav"))
    assert wavs and wavs[0].stat().st_size > 1000, wavs
    import wave
    with wave.open(str(wavs[0])) as w:
        hyp_s = w.getnframes() / w.getframerate()
    emit("train_route", route="ar_finetune", **_shape(cfg), losses=losses,
         peak_mem_gb=peak,
         checkpoint_stall_s=stall, checkpoint_write_s=write,
         resume_next_loss=[m1["autoregressive.loss"],
                           m2["autoregressive.loss"]],
         resume_param_max_abs_diff=resume_err, eval=ev, eval_s=eval_s,
         eval_hyp_wav_s=hyp_s, eval_tokens=tokens, eval_launches=got,
         profiled_step=prof, **rep)
    del engines
    gc.collect()
    torch.cuda.empty_cache()

    # the README yaml: AR + diffusion co-trained, two updates of 4
    # micro-steps (no warm-up: optax's warm-up starts at lr 0)
    root = Path(tmp) / "train_readme"
    batch_size = 16
    data = _train_artifacts(root, batch_size, seed=2)
    co = train_launches(ar=layers, feeder=layers,
                        diffusion=DiffusionConfig().num_layers)
    while True:
        cfg = _train_cfg(
            root, data,
            [{"name": "autoregressive", "training": True},
             {"name": "diffusion", "training": True,
              "hyperparameters": {"learning_rate": 3e-5}}],
            batch_size, 8, hyperparameters={"warmup_steps": 0},
            trainer={"save_frequency": 0})
        try:
            engines, steps, peak = _run_train(torch, cfg, dev)
        except torch.cuda.OutOfMemoryError:
            steps = [{"metrics": {"oom.skipped": 1.0}}]
        if any(k.endswith(".skipped") for st in steps
               for k in st["metrics"]):
            emit("train_route_oom", route="readme_yaml", batch=batch_size)
            engines = steps = None
            gc.collect()
            torch.cuda.empty_cache()
            assert batch_size > 1, "README yaml: batch 1 does not fit"
            batch_size //= 2
            continue
        break
    for st in steps:
        add(st["launches"])
    k = cfg.hyperparameters.gradient_accumulation_steps
    assert len(steps) == 2 * k, (len(steps), k)
    rep = _route_report("readme_yaml", steps, co, k)
    ar_losses = [st["metrics"]["autoregressive.loss"] for st in steps]
    assert ar_losses[k] < ar_losses[0], \
        f"README yaml: AR loss did not fall after the update: {ar_losses}"
    batch = next(Dataset(cfg, cfg.dataset.training).batches())
    prof = _profile_step(torch, lambda: step(engines, batch,
                                             "README yaml profiled step", co))
    emit("train_route", route="readme_yaml", **_shape(cfg), peak_mem_gb=peak,
         profiled_step=prof, updates=len(steps) // k,
         losses={e: [st["metrics"][f"{e}.loss"] for st in steps]
                 for e in ("autoregressive", "diffusion")}, **rep)
    del engines
    gc.collect()
    torch.cuda.empty_cache()

    # a rank-128 LoRA adapter on the AR finetune's shape
    root = Path(tmp) / "train_lora"
    data = _train_artifacts(root, 8, seed=3)
    cfg = _train_cfg(root, data, [{"name": "autoregressive",
                                   "training": True}], 8, 6,
                     hyperparameters={"gradient_accumulation_steps": 1,
                                      "warmup_steps": 0},
                     trainer={"save_frequency": 0},
                     dataset={"text_bucket": 128, "mel_bucket": 256,
                              "load_mels": False},
                     loras=[{"name": "bench-lora", "rank": 128,
                             "alpha": 128, "training": True}])
    engines, steps, peak = _run_train(torch, cfg, dev)
    for st in steps:
        add(st["launches"])
    rep = _route_report("lora_r128", steps, k1_ar, 1)
    assert engines.names() == ["bench-lora-r128-a128"], engines.names()
    emit("train_route", route="lora_r128", **_shape(cfg), peak_mem_gb=peak,
         losses=[st["metrics"]["bench-lora-r128-a128.loss"]
                 for st in steps], **rep)
    del engines
    gc.collect()
    torch.cuda.empty_cache()

    # the DVAE engine, one update
    root = Path(tmp) / "train_dvae"
    data = _train_artifacts(root, 16, seed=4)
    cfg = _train_cfg(root, data, [{"name": "dvae", "training": True}], 16, 1,
                     hyperparameters={"gradient_accumulation_steps": 1,
                                      "warmup_steps": 0},
                     trainer={"save_frequency": 0})
    engines, steps, peak = _run_train(torch, cfg, dev)
    for st in steps:
        add(st["launches"])
    rep = _route_report("dvae", steps, train_launches(), 1, warm=0)
    emit("train_route", route="dvae", **_shape(cfg), peak_mem_gb=peak,
         loss=steps[0]["metrics"]["dvae.loss"], **rep)
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return counts



def _free(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def vocoder_route(torch, dev, tmp: str) -> dict:
    """Phase 19: the BigVGAN GAN engine at full width: ``load_engines``
    with ``bigvgan`` training (the shipped 24 kHz/100-band generator,
    random bf16 weights from seed 0; the MultiPeriod (periods 2, 3, 5, 7,
    11) and MultiResolution discriminators, fp32 from their seed; AdamW
    for each), VOC_STEPS steps through ``Engines.step`` on one fixed batch
    of VOC_B x VOC_T samples of the synthetic reference at 24 kHz (halved
    until it fits).  Every step launches K7 twice a generator forward
    (the detached fake, then the generator's loss) and no other kernel;
    the mel L1 falls; a checkpoint resumes the generator, the
    discriminator and both optimizer states bit for bit; one step
    profiled.  Returns the launch counts."""
    from tortoise_tts_tpu_torch.config import Config
    from tortoise_tts_tpu_torch.engine.factory import load_engines
    from tortoise_tts_tpu_torch.engine.state import flatten_tree
    from tortoise_tts_tpu_torch.kernels import launch_counts
    counts = {k: 0 for k in launch_counts()}
    expect = {"snake": 2 * vocoder_snakes()}
    root = Path(tmp) / "train_vocoder"
    cfg = Config.from_dict({
        "models": [{"name": "bigvgan", "training": True}],
        "hyperparameters": {"optimizer": "AdamW", "learning_rate": VOC_LR,
                            "warmup_steps": 0,
                            "gradient_accumulation_steps": 1},
        "trainer": {"weight_dtype": "bfloat16"}},
        yaml_path=str(root / "cfg.yaml"))
    signal = reference_signal(seconds=4.0, sr=24000, seed=5)
    b = VOC_B
    while True:
        hop = (signal.size - VOC_T) // max(1, b - 1)
        batch = {"wav": np.stack([signal[i * hop:i * hop + VOC_T]
                                  for i in range(b)])}
        engines = load_engines(cfg, device=dev)
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for _ in range(VOC_STEPS):
            t0 = time.perf_counter()
            m, c = _counted(torch, lambda: engines.step(batch))
            steps.append(dict(s=time.perf_counter() - t0, launches=c,
                              metrics=m))
            if "bigvgan.skipped" in m:
                break
        if any("bigvgan.skipped" in st["metrics"] for st in steps):
            emit("train_route_oom", route="vocoder_gan", batch=b)
            del engines
            _free(torch)
            assert b > 1, "vocoder GAN: batch 1 does not fit"
            b //= 2
            continue
        break
    peak = torch.cuda.max_memory_allocated() / 1e9
    for i, st in enumerate(steps):
        _check_launches(f"vocoder step {i}", st["launches"], expect)
        for k, v in st["launches"].items():
            counts[k] += v
        assert all(math.isfinite(v) for v in st["metrics"].values()), st
    mel = [st["metrics"]["bigvgan.loss.mel"] for st in steps]
    assert mel[-1] < mel[0], f"vocoder GAN: the mel L1 did not fall: {mel}"
    engines.save_checkpoint(cfg.ckpt_dir)
    resumed = load_engines(cfg, device=dev)
    assert resumed.global_step == VOC_STEPS, resumed.global_step
    mismatched = []
    for tree in ("params", "opt_state"):
        a = flatten_tree(getattr(engines["bigvgan"], tree))
        r = flatten_tree(getattr(resumed["bigvgan"], tree))
        assert set(a) == set(r), tree
        mismatched += [k for k in a if not torch.equal(a[k], r[k])]
    assert not mismatched, f"vocoder resume: {mismatched[:5]}"
    n_leaves = {t: len(flatten_tree(getattr(resumed["bigvgan"], t)))
                for t in ("params", "opt_state")}
    del resumed
    _free(torch)

    def one():
        m, c = _counted(torch, lambda: engines.step(batch))
        _check_launches("vocoder profiled step", c, expect)
        for k, v in c.items():
            counts[k] += v
    prof = _profile_step(torch, one)
    steady = steps[2:]
    emit("train_route", route="vocoder_gan", batch=b, samples=VOC_T,
         mel_frames=VOC_T // 256, lr=VOC_LR, steps=len(steps),
         ms_per_step=1e3 * float(np.mean([st["s"] for st in steady])),
         engine_ms_per_step=1e3 * float(np.mean(
             [st["metrics"]["bigvgan.elapsed_time"] for st in steady])),
         peak_mem_gb=peak, losses={k: [st["metrics"][f"bigvgan.{k}"]
                                       for st in steps]
                                   for k in ("loss", "loss.disc", "loss.adv",
                                             "loss.fm", "loss.mel")},
         launches_per_step=expect, resume_bit_equal=True,
         resume_leaves=n_leaves, profiled_step=prof)
    del engines
    _free(torch)
    return counts


def clvp_route(torch, dev, tmp: str) -> None:
    """Phase 20: CLVP through ``train.main`` at full width (768 wide,
    20 + 20 layers, random bf16 weights), a batch of CLVP_B artifacts
    (halved until it fits: as many artifacts as the batch, so every batch
    is the same one), text and mel buckets 64 / 128 (the artifacts hold
    36-60 text tokens and 64-107 codes: CLVP takes no mask, as in the JAX
    package, so the padding enters its mean pooling), AdamW at CLVP_LR,
    CLVP_STEPS steps: the InfoNCE loss falls; no kernel of the port runs
    (CLVP's attention is plain in both packages)."""
    b = CLVP_B
    while True:
        root = Path(tmp) / f"train_clvp_{b}"
        data = _train_artifacts(root, b, seed=6)
        cfg = _train_cfg(root, data, [{"name": "clvp", "training": True}],
                         b, CLVP_STEPS,
                         hyperparameters={"gradient_accumulation_steps": 1,
                                          "warmup_steps": 0,
                                          "learning_rate": CLVP_LR},
                         trainer={"save_frequency": 0},
                         dataset={"text_bucket": 64, "mel_bucket": 128,
                                  "load_mels": False})
        try:
            engines, steps, peak = _run_train(torch, cfg, dev)
        except torch.cuda.OutOfMemoryError:
            steps = [{"metrics": {"oom.skipped": 1.0}}]
        if any(k.endswith(".skipped") for st in steps
               for k in st["metrics"]):
            emit("train_route_oom", route="clvp", batch=b)
            engines = steps = None
            _free(torch)
            assert b > 1, "CLVP: batch 1 does not fit"
            b //= 2
            continue
        break
    rep = _route_report("clvp", steps, train_launches(), 1)
    losses = [st["metrics"]["clvp.loss"] for st in steps]
    assert losses[-1] < losses[0], f"CLVP loss did not fall: {losses}"
    emit("train_route", route="clvp", **_shape(cfg), peak_mem_gb=peak,
         lr=CLVP_LR, losses=losses, **rep)
    del engines
    _free(torch)


def optimizers_route(torch, dev, tmp: str) -> dict:
    """Phase 21: each optimizer of slice 14 and AdamW under schedule-free
    on the AR finetune's shape (batch 8, buckets 128/256, random bf16
    weights, remat), 3 micro-steps each through ``train.main``: finite
    losses, K1's launches, ms a micro-step (the last two) and peak GB,
    and every update moved the parameters (Prodigy and DAdaptation start
    from a step size of 1e-6 x the rate, so their losses barely move in
    3 steps).  Returns the launch counts."""
    from tortoise_tts_tpu_torch.kernels import launch_counts
    from tortoise_tts_tpu_torch.models.unified_voice import \
        UnifiedVoiceConfig
    counts = {k: 0 for k in launch_counts()}
    k1_ar = train_launches(ar=UnifiedVoiceConfig().layers)
    data = _train_artifacts(Path(tmp) / "train_opt_data", 8, seed=7)
    report = {}
    for opt, sched in NEW_OPTIMIZERS:
        name = opt + ("+" + sched if sched else "")
        root = Path(tmp) / f"train_opt_{name}"
        cfg = _train_cfg(root, data, [{"name": "autoregressive",
                                       "training": True}], 8, 3,
                         hyperparameters={"optimizer": opt,
                                          "scheduler": sched,
                                          "gradient_accumulation_steps": 1,
                                          "warmup_steps": 0},
                         trainer={"save_frequency": 0},
                         dataset={"text_bucket": 128, "mel_bucket": 256,
                                  "load_mels": False})
        engines, steps, peak = _run_train(torch, cfg, dev)
        for i, st in enumerate(steps):
            m = st["metrics"]
            assert not [k for k in m if k.endswith(".skipped")], (name, i)
            assert math.isfinite(m["autoregressive.loss"]), (name, i, m)
            _check_launches(f"{name} step {i}", st["launches"], k1_ar)
            for k, v in st["launches"].items():
                counts[k] += v
        assert all(st["moved"]["autoregressive"] for st in steps), name
        report[name] = dict(
            ms_per_micro_step=1e3 * float(np.mean(
                [st["metrics"]["autoregressive.elapsed_time"]
                 for st in steps[1:]])),
            peak_mem_gb=peak,
            losses=[st["metrics"]["autoregressive.loss"] for st in steps],
            moved=[st["moved"]["autoregressive"] for st in steps])
        del engines
        _free(torch)
    emit("train_route", route="optimizers", batch=8, text_bucket=128,
         mel_bucket=256, micro_steps=3, lr=1e-4, **report)
    return counts


def melbin_route(torch, dev, tmp: str) -> None:
    """Phase 22: the native melbin loader on the AR finetune's batches (32
    fabricated artifacts, batch 8, buckets 128/256): the library built
    from ``native/melbin.cpp``, the pack, 8 batches through the Dataset
    with ``use_melbin`` equal to the Python path's bit for bit, and ms to
    assemble a batch both ways (the same index lists)."""
    from tortoise_tts_tpu_torch.data import Dataset, native_loader
    root = Path(tmp) / "train_melbin"
    data = _train_artifacts(root, 32, seed=8)
    t0 = time.perf_counter()
    native_loader.build()
    build_s = time.perf_counter() - t0
    paths = sorted(Path(data).rglob("*.mel"))
    t0 = time.perf_counter()
    native_loader.pack_melbin(paths, root / "data.melbin")
    pack_s = time.perf_counter() - t0
    ds = {}
    for melbin in (True, False):
        cfg = _train_cfg(root, data, [{"name": "autoregressive",
                                       "training": True}], 8, 1,
                         dataset={"text_bucket": 128, "mel_bucket": 256,
                                  "load_mels": False, "use_melbin": melbin})
        ds[melbin] = Dataset(cfg, cfg.dataset.training)
    assert ds[True]._melbin is not None and ds[False]._melbin is None
    its = {k: d.batches() for k, d in ds.items()}
    for i in range(8):
        a, b = next(its[True]), next(its[False])
        assert set(a) == set(b), (set(a), set(b))
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), \
                f"melbin batch {i}: {k} differs"
    idx = [list(range(i, i + 8)) for i in range(0, 32, 8)]
    ms = {}
    for key, fn in (("native_ms_per_batch", ds[True]._native_batch),
                    ("python_ms_per_batch", lambda ix: ds[False].collate(
                        [ds[False][j] for j in ix]))):
        t0 = time.perf_counter()
        for _ in range(5):
            for ix in idx:
                fn(ix)
        ms[key] = 1e3 * (time.perf_counter() - t0) / (5 * len(idx))
    emit("train_route", route="melbin", artifacts=len(paths), batch=8,
         text_bucket=128, mel_bucket=256, batches_equal=8,
         build_s=build_s, pack_s=pack_s,
         pack_mb=(root / "data.melbin").stat().st_size / 1e6, **ms)

# ---------------------------------------------------------------------------
# phases 23-26: dataset preparation, the classifier, the web UI, the tools
# ---------------------------------------------------------------------------

CLF_B = 16
CLF_SECONDS = 9.28             # the default route's audio, at 24 kHz
# the voices tree of the prep route: (speaker, f0 Hz), two clips each
PREP_SPEAKERS = (("alice", 120.0), ("bob", 190.0))
PREP_CLIP_S = (4.0, 6.0)
# K4 a clip: the AR conditioning encoder's 6 attention heads and the
# contextual embedder's 5
PREP_K4_PER_CLIP = 6 + 5
PREP_TRAIN_STEPS = 2
# what the card's machine may lack, and the phases that need it
OPTIONAL_MODULES = {"h5py": "data --action hdf5",
                    "matplotlib": "plot",
                    "transformers": "emb.transcribe",
                    "gradio": "webui's gradio branch"}


def _dvae_codes(samples22: int) -> int:
    """The DVAE's code count for a 22.05 kHz clip: the centred mel's
    frames, halved by each of its two stride-2 convs (k=3, padding 1)."""
    n = samples22 // 256 + 1
    for _ in range(2):
        n = (n - 1) // 2 + 1
    return n


def classifier_route(torch, dev) -> dict:
    """Phase 23: the classifier at the published widths (``load_model(
    "classifier")``, random bf16 weights) over 16 clips of 9.28 s at 24
    kHz: finite logits, one K4 launch for each of its 4 attention heads
    at (16, 512, T) -> 1536 and no other kernel; K4 at that shape held
    against its plain version with its device ms, bound and the library
    call's (a ``kernel_detail`` line); the forward's ms.  Returns the
    forward's launch counts."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.kernels import gn_conv as k4
    from tortoise_tts_tpu_torch.models import load_model
    t0 = time.perf_counter()
    m = load_model("classifier", "bfloat16", device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = m.config
    assert (cfg.base_channels, cfg.depth, cfg.downsample_factor,
            cfg.kernel_size, cfg.embedding_dim, cfg.attn_blocks,
            cfg.num_attn_heads, cfg.classes) == (32, 5, 4, 5, 512, 4, 4, 2)
    clips = [reference_signal(CLF_SECONDS, 24000, seed=40 + i,
                              f0=100.0 + 10 * i) for i in range(CLF_B)]
    x = torch.from_numpy(np.stack(clips))[:, None].to(dev, torch.bfloat16)
    t = x.shape[-1]
    for _ in range(cfg.depth):
        t = (t - 1) // cfg.downsample_factor + 1
    def forward(_=None):
        return m.module.forward(m.params, x, cfg)
    with torch.inference_mode():
        forward()
        torch.cuda.synchronize()
        kernels.reset_launches()
        with recorded_heads() as heads:
            logits = forward()
            torch.cuda.synchronize()
        counts = kernels.launch_counts()
        emit("launches", route="classifier", **counts)
        assert counts["gn_conv"] == cfg.attn_blocks, counts
        assert not any(v for k, v in counts.items() if k != "gn_conv"), counts
        assert [k for k, _ in heads] == [(CLF_B, 512, t, 1536)] \
            * cfg.attn_blocks, heads
        assert logits.shape == (CLF_B, cfg.classes)
        assert bool(torch.isfinite(logits.float()).all()), logits
        del heads
        err, t_, nbytes, flops = _gn_conv_case(
            torch, k4, f"classifier_head_b{CLF_B}",
            *_gn_conv_inputs(torch, dev, CLF_B, 512, t, 1536, 1, 60), False)
        fwd_ms = call_ms(torch, forward, n=10, warmup=2)
        fwd_dev = device_ms(torch, forward, n=5, warmup=1)
    bms, by = bound_ms(nbytes, flops)
    emit("classifier_route", card=nvidia_smi(), batch=CLF_B,
         samples=x.shape[-1], attention_t=t, load_s=load_s,
         forward_ms=fwd_ms, forward_device_ms=fwd_dev,
         audio_s_per_s=CLF_B * CLF_SECONDS / (fwd_ms / 1e3),
         logits=logits.float().cpu().tolist()[:2],
         k4=dict(shape=[CLF_B, 512, t, 1536], max_abs_err=err,
                 tol=RESBLOCK_TOL, bound_ms=bms, bound_by=by, **t_),
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    del m, x
    _free(torch)
    return counts


def _pcm_ok(data: bytes, what: str) -> np.ndarray:
    """A 16-bit mono WAV's samples after its 44-byte header: present and
    not silent."""
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE", (what, data[:16])
    pcm = np.frombuffer(data[44:44 + (len(data) - 44) // 2 * 2], "<i2")
    assert pcm.size > 24000, (what, pcm.size)
    assert np.count_nonzero(pcm) > 1000, what
    assert float(np.abs(pcm.astype(np.float32)).mean()) > 3.0, what
    return pcm


def webui_route(torch, tts, ref: str, tmp: str) -> dict:
    """Phase 24: the stdlib web UI (``webui.make_server`` on port 0, in a
    thread) over the shipped-width ``TTS``: ``GET /``, ``POST /generate``
    with the default route's budgets and ``GET`` of its ``/audio/<name>``
    (no "error:" in the page, a non-silent wav), then ``GET /stream``
    (the seconds to the first PCM bytes, the total).  Each request's
    launches are read from 0; returns their sum."""
    import http.client
    import re
    import threading
    import urllib.parse
    from tortoise_tts_tpu_torch import kernels, webui
    srv = webui.make_server(tts, port=0, out_dir=Path(tmp) / "webui")
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    total = {k: 0 for k in kernels.launch_counts()}
    out = {}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_port,
                                          timeout=300)
        t0 = time.perf_counter()
        conn.request("GET", "/")
        r = conn.getresponse()
        page = r.read().decode()
        out["form_s"] = time.perf_counter() - t0
        assert r.status == 200 and 'name="text"' in page, r.status

        kernels.reset_launches()
        body = urllib.parse.urlencode({
            "text": TEXT, "references": ref, "max_ar_steps": AR_STEPS,
            "max_diffusion_steps": DIFF_STEPS, "seed": 0})
        t0 = time.perf_counter()
        conn.request("POST", "/generate", body, {
            "Content-Type": "application/x-www-form-urlencoded"})
        r = conn.getresponse()
        page = r.read().decode()
        out["generate_s"] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        emit("launches", route="webui_generate", **counts)
        assert r.status == 200 and "error:" not in page, page[-2000:]
        _launched(counts, DEFAULT_ROUTE_KERNELS + ("snake",),
                  "webui generate")
        total = {k: total[k] + counts[k] for k in total}
        m = re.search(r'src="(/audio/[0-9a-f]+\.wav)"', page)
        assert m, page[-2000:]
        conn.request("GET", m.group(1))
        r = conn.getresponse()
        wav = r.read()
        assert r.status == 200, r.status
        pcm = _pcm_ok(wav, "generated wav")
        out["generate_audio_s"] = pcm.size / 24000

        kernels.reset_launches()
        q = urllib.parse.urlencode({"text": TEXT, "references": ref})
        t0 = time.perf_counter()
        conn.request("GET", "/stream?" + q)
        r = conn.getresponse()
        assert r.status == 200 and \
            r.getheader("Transfer-Encoding") == "chunked", r.status
        data, first_s, reads = bytearray(), None, 0
        while True:
            piece = r.read1(1 << 16)
            if not piece:
                break
            reads += 1
            data += piece
            if first_s is None and len(data) > 44:
                first_s = time.perf_counter() - t0
        out["stream_s"] = time.perf_counter() - t0
        counts = kernels.launch_counts()
        emit("launches", route="webui_stream", **counts)
        _launched(counts, ("flash_attention", "qgemv", "flash_decode"),
                  "webui stream")
        total = {k: total[k] + counts[k] for k in total}
        pcm = _pcm_ok(bytes(data), "stream")
        out.update(stream_first_pcm_s=first_s, stream_bytes=len(data),
                   stream_reads=reads, stream_audio_s=pcm.size / 24000)
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    emit("webui_route", card=nvidia_smi(), **out)
    return total


def _trace_kernels(path: Path) -> dict:
    """The CUDA kernels of a Chrome trace, by name: their count."""
    names: dict = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "kernel":
            names[e["name"]] = names.get(e["name"], 0) + 1
    return names


def tools_trace(torch, tts, ref: str, tmp: str) -> dict:
    """Phase 25 (part): ``utils.profiling.trace`` around one default
    inference: the Chrome trace exists and names K2's (``qgemv_gemm``)
    and K7's (``snake_resample2``) CUDA kernels.  Returns the launches."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.utils import profiling
    log_dir = Path(tmp) / "trace"
    kernels.reset_launches()
    t0 = time.perf_counter()
    with profiling.trace(log_dir):
        wav, sr = tts.inference(TEXT, ref, seed=0, **ROUTE_KW)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    emit("launches", route="tools_trace", **counts)
    _check_wav(wav)
    path = log_dir / "trace.json"
    names = _trace_kernels(path)
    k2 = sum(n for k, n in names.items() if "qgemv_gemm" in k)
    k7 = sum(n for k, n in names.items() if "snake_resample2" in k)
    assert k2 > 0 and k7 > 0, sorted(names)[:50]
    emit("tools_route", tool="trace", card=nvidia_smi(), wall_s=wall,
         trace_mb=path.stat().st_size / 1e6,
         trace_cuda_kernels=sum(names.values()), trace_k2_kernels=k2,
         trace_k7_kernels=k7, k2_launches=counts["qgemv"],
         k7_launches=counts["snake"])
    return counts


def _voices(root: Path) -> Path:
    """The prep route's voices tree: each speaker's clips from the
    synthetic voice at its own f0, each with a .txt transcript."""
    from tortoise_tts_tpu_torch.utils.io import write_wav
    voices = root / "voices"
    for s, (spk, f0) in enumerate(PREP_SPEAKERS):
        d = voices / "group" / spk
        d.mkdir(parents=True, exist_ok=True)
        for c, secs in enumerate(PREP_CLIP_S):
            write_wav(d / f"clip{c}.wav", reference_signal(
                secs, 22050, seed=20 + 2 * s + c, f0=f0 + 15 * c), 22050)
            (d / f"clip{c}.txt").write_text(
                f"{spk} reads the sample number {c}.")
    return voices


def prep_route(torch, dev, tmp: str):
    """Phase 26: dataset preparation into training on the card: ``python
    -m tortoise_tts_tpu_torch.emb.process`` (its ``main``, CUDA, the CLI's
    default float32) over 2 speakers x 2 clips of 4 and 6 s with random
    full-width DVAE, AR and diffusion models; every artifact checked
    (numpy only, non-zero codes, the DVAE's code count for its length,
    the latents' widths, the training mels); K4 launched 11 times a clip,
    and held (fp32) against its plain version on the first inputs it
    took at each shape, with its device ms, bound and library ms; then ``python -m tortoise_tts_tpu_torch.data`` (its ``main``) with
    ``--action`` metadata, similar, validate (0 bad), sample (two finite,
    non-silent wavs) and melbin (hdf5 where h5py is installed); then
    ``train.main`` for 2 AR micro-steps at full width on the prepared
    data, which writes a checkpoint.  The stage seconds.  Returns (the
    route's launches, the config's path)."""
    import importlib.util
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.config import Config
    from tortoise_tts_tpu_torch.data import __main__ as data_cli
    from tortoise_tts_tpu_torch.data.dataset import load_artifact
    from tortoise_tts_tpu_torch.emb import process
    from tortoise_tts_tpu_torch.engine.state import latest_checkpoint
    from tortoise_tts_tpu_torch.kernels import gn_conv as k4
    from tortoise_tts_tpu_torch.models.unified_voice import \
        UnifiedVoiceConfig
    from tortoise_tts_tpu_torch.utils.io import read_wav
    missing = {m: use for m, use in OPTIONAL_MODULES.items()
               if importlib.util.find_spec(m) is None}
    emit("left_out", phases=sorted(missing.values()),
         reason="not installed here: " + ", ".join(sorted(missing)))
    root = Path(tmp) / "prep"
    voices = _voices(root)
    data = root / "data"
    stage_s = {}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with recorded_heads() as heads:
        n = process.main(["--input-audio", str(voices), "--output-dataset",
                          str(data)])
    torch.cuda.synchronize()
    stage_s["process"] = time.perf_counter() - t0
    c_proc = kernels.launch_counts()
    emit("launches", route="prep_process", **c_proc)
    clips = len(PREP_SPEAKERS) * len(PREP_CLIP_S)
    assert n == clips, n
    assert c_proc["gn_conv"] == clips * PREP_K4_PER_CLIP, c_proc
    assert len(heads) == c_proc["gn_conv"], len(heads)
    dim = UnifiedVoiceConfig().model_dim
    codes = {}
    for path in sorted(data.rglob("*.mel")):
        art = load_artifact(path)
        md = art["metadata"]
        c = art["codes"]
        want = _dvae_codes(md["original_length"])
        assert md["sample_rate"] == 22050 and md["text"], md
        assert c.dtype == np.uint16 and c.shape == (1, want), (c.shape, want)
        assert np.count_nonzero(c) > 0, path
        assert art["text"].dtype == np.uint8 and art["text"].size > 10
        assert [a.shape for a in art["latent"]] == [(1, dim), (1, 2 * dim)]
        assert all(a.dtype == np.float32 and np.isfinite(a).all()
                   for a in art["latent"] + art["conds"])
        assert art["mel"].dtype == np.float16 and \
            art["mel"].shape[-1] == md["original_length"] // 256 + 1
        assert art["mel_diff"].dtype == np.float16 and \
            np.isfinite(art["mel_diff"]).all()
        codes[str(path.relative_to(data))] = int(c.shape[-1])
    assert len(codes) == clips, codes
    raw = {"models": [{"name": "autoregressive", "training": True}],
           "hyperparameters": {"batch_size": 4, "optimizer": "AdamW",
                               "learning_rate": 1e-4, "warmup_steps": 0,
                               "gradient_accumulation_steps": 1},
           "trainer": {"iterations": PREP_TRAIN_STEPS, "log_frequency": 1,
                       "export_on_save": False, "keep_last_checkpoints": 1,
                       "weight_dtype": "bfloat16",
                       "gradient_checkpointing": True,
                       "save_frequency": PREP_TRAIN_STEPS},
           "evaluation": {"frequency": 0},
           "dataset": {"training": [str(data)], "validate": False,
                       "duration_range": [1.0, 10.0], "text_bucket": 128,
                       "mel_bucket": 256, "load_mels": False}}
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps(raw))
    results = {}
    actions = ["metadata", "similar", "validate", "sample", "melbin"]
    if "h5py" not in missing:
        actions.append("hdf5")
    for action in actions:
        t0 = time.perf_counter()
        results[action] = data_cli.main(
            ["--yaml", str(cfg_path), "--action", action, "--out",
             str(root / "samples")])
        torch.cuda.synchronize()
        stage_s[action] = time.perf_counter() - t0
    assert results["metadata"] == results["similar"] == clips, results
    assert results["validate"] == 0, results
    assert results["melbin"] == clips, results
    sample_s = []
    for p in results.pop("sample"):
        wav, sr = read_wav(p)
        assert sr == 22050
        _check_wav(wav, 4 * 256)
        sample_s.append(wav.size / sr)
    cfg = Config.load(cfg_path)
    layers = UnifiedVoiceConfig().layers
    t0 = time.perf_counter()
    engines, steps, peak = _run_train(torch, cfg, dev)
    stage_s["train"] = time.perf_counter() - t0
    assert len(steps) == PREP_TRAIN_STEPS, len(steps)
    rep = _route_report("prep_ar", steps, train_launches(ar=layers), 1,
                        warm=1)
    ckpt = latest_checkpoint(cfg.ckpt_dir, "autoregressive")
    assert ckpt is not None and (ckpt / "module.sft").exists(), ckpt
    counts = kernels.launch_counts()
    # K4 as the process stage ran it (fp32), on the inputs it was given
    k4_fp32 = []
    with torch.inference_mode():
        for (b, c, t, m), inputs in heads:
            if inputs is None:
                continue
            x, norm, conv, groups, act = inputs
            assert x.dtype == torch.float32, x.dtype
            err, t_, nbytes, flops = _gn_conv_case(
                torch, k4, f"prep_head_c{c}_t{t}", x, norm, conv, act, groups)
            k4_fp32.append(dict(
                shape=[b, c, t, m], max_abs_err=err, tol=F32_TOL,
                bound_ms=bound_ms(nbytes, flops, FP32_FLOPS)[0],
                **{k: t_[k] for k in ("ms", "plain_ms", "library_ms")}))
    del heads
    emit("prep_route", card=nvidia_smi(), clips=clips, codes=codes,
         stage_s=stage_s, k4_process=c_proc["gn_conv"],
         k4_expected=clips * PREP_K4_PER_CLIP, k4_fp32=k4_fp32,
         actions=results,
         sample_wav_s=sample_s,
         losses=[st["metrics"]["autoregressive.loss"] for st in steps],
         checkpoint=ckpt.name, peak_mem_gb=peak, **_shape(cfg), **rep)
    del engines
    _free(torch)
    return counts, cfg_path


def tools_export(torch, cfg_path: Path) -> None:
    """Phase 25 (part): ``python -m tortoise_tts_tpu_torch.export`` (its
    ``main``) of the prep route's checkpoint: fp32.sft, every floating
    leaf the checkpoint's in float32, the others as stored."""
    from tortoise_tts_tpu_torch import export
    from tortoise_tts_tpu_torch.config import Config
    from tortoise_tts_tpu_torch.engine.state import latest_checkpoint
    from tortoise_tts_tpu_torch.utils.io import load_state_dict
    t0 = time.perf_counter()
    out = export.main(["--yaml", str(cfg_path)])
    export_s = time.perf_counter() - t0
    ckpt = latest_checkpoint(Config.load(cfg_path).ckpt_dir,
                             "autoregressive")
    src, got = load_state_dict(ckpt / "module.sft"), load_state_dict(out)
    assert set(src) == set(got) and src, (len(src), len(got))
    kinds = {}
    for k, v in src.items():
        g = got[k]
        want = v.float() if v.is_floating_point() else v
        assert g.dtype == want.dtype and torch.equal(g, want), k
        kinds[str(v.dtype)] = kinds.get(str(v.dtype), 0) + 1
    emit("tools_route", tool="export", seconds=export_s, leaves=len(src),
         leaf_types=kinds, fp32_mb=out.stat().st_size / 1e6,
         checkpoint=ckpt.name)


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
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias_cm as k9b
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias_kq as k9a
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
    # each kernel's (mangled) name, then its registers and spills
    regs = {n: [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln
                or "Function properties for" in ln]
            for n, log in logs.items()}
    emit("build", seconds=time.time() - t0, built=sorted(logs),
         ptxas=regs)
    no_spills(BIAS_SOURCES)

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["TORTOISE_TPU_TOKENIZER"] = str(
            write_char_tokenizer(Path(tmp) / "tokenizer.json"))
        n_text = len(VoiceBpeTokenizer().encode(TEXT))
        assert n_text <= BUCKET, n_text
        with torch.inference_mode():
            r1 = check_flash_attention(torch, k1, dev, n_text)
            r2 = check_qgemv(torch, k2, dev)
            r8 = check_qgemv_w8a8(torch, k8, k2, dev)
            check_flash_attention(torch, k1, dev, n_text, b=BATCH_ROWS,
                                  report=False)
            r3 = check_flash_decode(torch, k3, dev,
                                    slots=1 + BUCKET + 2 + 1 + AR_STEPS)
            check_flash_decode(torch, k3, dev, slots=604, report=False)
            check_flash_decode(torch, k3, dev,
                               slots=1 + BUCKET + 2 + 1 + AR_STEPS,
                               b=BATCH_ROWS, report=False)
            r4 = check_gn_conv(torch, k4, dev)
            r5 = check_ts_res_block(torch, k5, dev)
            r7 = check_snake(torch, k7, dev)
            r6 = check_flash_attention_bias(torch, k6, dev)
            r9 = check_flash_attention_bias_k9(torch, k9a, k9b, dev)
            r3s = check_flash_decode_shared(torch, k3, dev)
        torch.cuda.empty_cache()

        ref = reference_wav(Path(tmp) / "reference.wav")
        check_reference(torch, ref)
        check_reference_batch(torch, ref)
        tts, counts, k1_shapes = main_path(torch, ref)
        latent = [(b, s) for b, s, masked in k1_shapes if not masked]
        assert len(latent) == 1 and latent[0][0] == 1, k1_shapes
        with torch.inference_mode():
            check_flash_attention(torch, k1, dev, n_text, s=latent[0][1],
                                  masked=False, report=False)
        for route in (batch_route, candidates_route, w8a8_route,
                      denoise_attention_routes, dpmpp_route, univnet_route,
                      beam_route, stream_growing):
            c = route(torch, tts, ref)
            counts = {k: counts[k] + c[k] for k in counts}
        c = lora_route(torch, tts, ref, tmp)
        counts = {k: counts[k] + c[k] for k in counts}
        for route in (webui_route, tools_trace):
            c = route(torch, tts, ref, tmp)
            counts = {k: counts[k] + c[k] for k in counts}
        diffusion_pairs(torch, tts, ref)
        for mode in ("int8", "w8a8"):
            decode_timing(torch, tts, ref, mode)
            decode_timing(torch, tts, ref, mode, rows=BATCH_ROWS)
            decode_timing(torch, tts, ref, mode, fan_out=CANDIDATES)
        # training: the serving models leave the card first
        t_train = time.perf_counter()
        del tts
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        train_grads(torch, dev)
        train_tiny(torch, dev)
        c = train_route(torch, dev, tmp)
        counts = {k: counts[k] + c[k] for k in counts}
        for route in (vocoder_route, optimizers_route):
            c = route(torch, dev, tmp)
            counts = {k: counts[k] + c[k] for k in counts}
        clvp_route(torch, dev, tmp)
        melbin_route(torch, dev, tmp)
        emit("train_total", seconds=time.perf_counter() - t_train)
        c = classifier_route(torch, dev)
        counts = {k: counts[k] + c[k] for k in counts}
        t_prep = time.perf_counter()
        c, cfg_path = prep_route(torch, dev, tmp)
        counts = {k: counts[k] + c[k] for k in counts}
        tools_export(torch, cfg_path)
        emit("prep_total", seconds=time.perf_counter() - t_prep)

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
        ("flash_attention_bias_kq", "flash_attention_bias_kq.cu",
         "tortoise_tts_tpu/ops/pallas_attention.py:507",
         r9["flash_attention_bias_kq"]),
        ("flash_attention_bias_cm", "flash_attention_bias_cm.cu",
         "tortoise_tts_tpu/ops/pallas_attention.py:73",
         r9["flash_attention_bias_cm"]),
    ]
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src + f, "replaces": rep,
         "launches": counts[n], **r} for n, f, rep, r in rows]}))
    emit("total", seconds=time.perf_counter() - T0)
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
