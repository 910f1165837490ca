#!/usr/bin/env python3
"""Time K1 (trunk flash attention), K3 (decode attention, both entries)
and the denoiser's biased attention (K6, K9a, K9b's fused entry) of a
checkout at the main paths' shapes on a CUDA card.

    python3 tools/attention_profile.py [--repo DIR] [--out FILE]
                                       [--which all|k1k3|bias]

Imports ``tortoise_tts_tpu_torch`` from ``--repo`` (default: this
checkout), so one call can time two checkouts of the port on one card in
turns; it calls the wrappers with a host int ``pos`` only, which every
checkout takes.  Prints one JSON line a shape, in bf16:

- K1: the AR prefill (B=1, S=68, the text's padded tail masked), the
  latent pass (B=1, S=269, no key mask) and the batch's prefill (B=8,
  S=68), on views of one fused qkv projection;
- K3: the decode's last step over 268 slots at B=1 and 8 and over 604
  slots at B=1, cycling over 30 layers of cache;
- K3's shared form: 16 candidates over a 68-slot prefix and a 200-slot
  region, 30 layers;
- K6, K9a (on the transposed bias) and K9b's fused entry at H=16, T=896
  and B = 1, 2 (the default route's integrator and trunk), 8 and 16 (the
  batch route's), cycling over 4 biases (every attention block has its
  own, 25.7 MB), beside SDPA with the bias as a float mask (views in,
  channels-major copy out, as chip_smoke times it).

Each line: the kernel's device ms a call and its CUDA kernels a call
(torch.profiler over 30 calls, as ``chip_smoke.device_ms``), SDPA's device
ms on the same inputs (K3's shared form: on the per-row concatenation,
built outside the timed call) and the bound (``chip_smoke.bound_ms``).
Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402  (helpers only: it imports no port)

LAYERS = 30
H, D = 16, 64


def profiled(fn, n: int = 30) -> tuple:
    """(device ms a call, CUDA kernels a call) of fn(i) over n calls."""
    from torch.profiler import ProfilerActivity, profile
    for i in range(5):
        fn(i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cs.profiler_warmup(torch)
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    ev = cs._cuda_events(prof)
    return sum(e.device_time for e in ev) / 1e3 / n, len(ev) / n


def k1_cases(k1, dev):
    F = torch.nn.functional
    for b, s, masked in ((1, 68, True), (1, 269, False), (8, 68, True)):
        g = torch.Generator(device=dev).manual_seed(0)
        qkv = torch.randn(b, s, 3 * H * D, generator=g, device=dev,
                          dtype=torch.bfloat16)
        q, k, v = (z.view(b, s, H, D).transpose(1, 2)
                   for z in qkv.split(H * D, dim=-1))
        allowed = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        mask = None
        if masked:
            mask = torch.ones(b, s, dtype=torch.bool, device=dev)
            mask[:, 47:s - 1] = False
            allowed = mask[:, None, None, :] & allowed
        ms, n = profiled(lambda i: k1.flash_attention(q, k, v, mask))
        sdpa, _ = profiled(lambda i: F.scaled_dot_product_attention(
            q, k, v, attn_mask=allowed))
        nbytes = 4 * b * H * s * D * 2 + (b * s if masked else 0)
        bound, by = cs.bound_ms(nbytes, 2 * 2 * b * H * D * s * (s + 1) / 2)
        yield dict(name="flash_attention", b=b, s=s, key_mask=masked, ms=ms,
                   cuda_kernels_per_call=n, sdpa_ms=sdpa, bound_ms=bound,
                   bound_by=by)


def k3_cases(k3, dev):
    F = torch.nn.functional
    for b, slots in ((1, 268), (1, 604), (8, 268)):
        pos = slots - 1
        g = torch.Generator(device=dev).manual_seed(2)
        ck, cv = (torch.randn(LAYERS, b, H, slots, D, generator=g,
                              device=dev, dtype=torch.bfloat16)
                  for _ in range(2))
        q = torch.randn(b, 3 * H * D, generator=g, device=dev,
                        dtype=torch.bfloat16)[:, :H * D].view(b, H, D)
        mask = torch.ones(b, slots, dtype=torch.bool, device=dev)
        mask[:, 55:67] = False
        am = mask[:, None, None, :]
        ms, n = profiled(lambda i: k3.flash_decode(
            q, ck[i % LAYERS], cv[i % LAYERS], pos, mask))
        sdpa, _ = profiled(lambda i: F.scaled_dot_product_attention(
            q[:, :, None], ck[i % LAYERS], cv[i % LAYERS], attn_mask=am))
        nbytes = 2 * b * H * slots * D * 2 + 2 * b * H * D * 2 + b * slots
        bound, by = cs.bound_ms(nbytes, 4 * b * H * slots * D)
        yield dict(name="flash_decode", b=b, slots=slots, pos=pos, ms=ms,
                   cuda_kernels_per_call=n, sdpa_ms=sdpa, bound_ms=bound,
                   bound_by=by)
    c, sp, sd = 16, 68, 200
    pos = sd - 1
    g = torch.Generator(device=dev).manual_seed(4)
    kp, vp = (torch.randn(LAYERS, 1, H, sp, D, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    kd, vd = (torch.randn(LAYERS, c, H, sd, D, generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn(c, 3 * H * D, generator=g, device=dev,
                    dtype=torch.bfloat16)[:, :H * D].view(c, H, D)
    pmask = torch.ones(1, sp, dtype=torch.bool, device=dev)
    pmask[:, 55:67] = False
    ms, n = profiled(lambda i: k3.flash_decode_shared(
        q, kp[i % LAYERS], vp[i % LAYERS], pmask, kd[i % LAYERS],
        vd[i % LAYERS], pos))
    kc = torch.cat([kp[0].expand(c, -1, -1, -1), kd[0]], 2)
    vc = torch.cat([vp[0].expand(c, -1, -1, -1), vd[0]], 2)
    am = torch.cat([pmask, torch.ones(1, sd, dtype=torch.bool, device=dev)],
                   1)[:, None, None]
    sdpa, _ = profiled(lambda i: F.scaled_dot_product_attention(
        q[:, :, None], kc, vc, attn_mask=am))
    nbytes = (2 * H * sp * D * 2 + 2 * c * H * sd * D * 2 + 2 * c * H * D * 2
              + sp)
    bound, by = cs.bound_ms(nbytes, 4 * c * H * (sp + sd) * D)
    yield dict(name="flash_decode_shared", g=1, c=c, sp=sp, sd=sd, pos=pos,
               ms=ms, cuda_kernels_per_call=n, sdpa_concat_ms=sdpa,
               bound_ms=bound, bound_by=by, bound_share=bound / ms)


def bias_cases(k6, k9a, k9b, dev):
    F = torch.nn.functional
    h, t = H, 896
    for b in (1, 2, 8, 16):
        g = torch.Generator(device=dev).manual_seed(6 + b)
        qkv = (torch.randn(b, h * 3 * D, t, generator=g, device=dev)
               * 0.5).to(torch.bfloat16)
        biases = [(torch.randn(h, t, t, generator=g, device=dev) * 2).to(
            torch.bfloat16) for _ in range(4)]
        bts = [x.transpose(1, 2).contiguous() for x in biases]
        qv, kv, vv = qkv.view(b, h, 3, D, t).unbind(2)
        nbytes = 4 * b * h * D * t * 2 + h * t * t * 2
        bound, by = cs.bound_ms(nbytes, 4 * b * h * t * t * D)
        row = dict(name="biased_attention", b=b, h=h, t=t, bound_ms=bound,
                   bound_by=by)
        fns = {"k6": lambda i: k6.flash_attention_bias(qkv, biases[i % 4], h),
               "k9a": lambda i: k9a.flash_attention_bias_kq(qkv, bts[i % 4],
                                                            h),
               "k9b_qkv": lambda i: k9b.flash_attention_bias_qkv(
                   qkv, biases[i % 4], h),
               "sdpa": lambda i: cs._sdpa_cm(F, qv, kv, vv, biases[i % 4])}
        for key, fn in fns.items():
            ms, n = profiled(fn)
            row[key + "_ms"] = ms
            row[key + "_cuda_kernels_per_call"] = n
        yield row
        del qkv, biases, bts
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--out", default=None)
    ap.add_argument("--which", default="all", choices=("all", "k1k3", "bias"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.repo).resolve()))
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.kernels import flash_attention as k1
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias as k6
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias_cm as k9b
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias_kq as k9a
    from tortoise_tts_tpu_torch.kernels import flash_decode as k3
    assert Path(k1.__file__).resolve().is_relative_to(
        Path(args.repo).resolve()), k1.__file__
    kernels.build([k.KERNEL.source for k in (k1, k3, k6, k9a, k9b)])
    dev = torch.device("cuda")
    out = open(args.out, "a") if args.out else None
    cases = []
    if args.which in ("all", "k1k3"):
        cases += [k1_cases(k1, dev), k3_cases(k3, dev)]
    if args.which in ("all", "bias"):
        cases.append(bias_cases(k6, k9a, k9b, dev))
    with torch.inference_mode():
        for row in (r for gen in cases for r in gen):
            line = json.dumps(dict(repo=args.repo, **row))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
    smi = cs.nvidia_smi()
    print(smi)
    if out:
        out.write(json.dumps({"nvidia_smi": smi}) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
