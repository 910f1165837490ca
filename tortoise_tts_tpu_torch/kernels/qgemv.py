"""K2: weight-only int8 GEMV (a GEMM of a few rows) with an optional fused
LayerNorm, for the UnifiedVoice decode step.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_gemv.py``
``qgemv_stacked`` (``_qgemv_kernel``, ``_qgemv_ln_kernel``,
``_gemv_body``).  The CUDA source is ``csrc/qgemv.cu``; its header gives
the bound on an H100 and the design.  The TPU kernel took the whole
``(L, K, N)`` stack and a scalar-prefetched layer index; here the caller
passes ``wq[li]``, a view.

A CUDA call is at most two kernels at any M: the LayerNorm's row kernel
(unless the GEMM fuses it, see ``LN_FUSED_MAX_M``), then one GEMM for all
rows that merges its split-K partials itself, counting arrivals in the
zeroed per-stream ``counters``.  ``ksplit`` is its K split; both are
shared with K8 (``kernels/qgemv_w8a8.py``).

``qgemv`` runs the plain PyTorch version for CPU tensors and the kernel
for CUDA tensors (it raises on what the kernel does not take).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ._build import I, P, Kernel

KERNEL = Kernel("qgemv", "tts_qgemv",
                [P, I, I, I] + [P] * 5 + [I, I] + [P] * 4 + [I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LN_EPS = 1e-5
TILE_N = 128        # output columns a block (TN in csrc/small_m_gemm.cuh)
KSTG = 32           # weight rows a ring stage: a K slice is a multiple
KC_MIN, KC_MAX = 128, 256   # rows of a K slice (KC_MAX bounds shared memory)
KS_MAX = 16         # K slices at most
# K2 in bf16 fuses the LayerNorm into the GEMM (every block takes its rows'
# statistics) up to this many rows; above it a row kernel writes LN(x).
# Fused, a call is one kernel: faster at M=1, as fast at M=8, slower at
# M=16 (chip_smoke's ln_fused_ms / ln_row_kernel_ms on an H100)
LN_FUSED_MAX_M = 8
FUSED_ROWS = 16     # the most rows the fused form takes


def ln_f32(xf: torch.Tensor, g: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 with the E[x²]−μ² variance
    (``pallas_gemv._ln_f32``)."""
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    return (xf - mu) * torch.rsqrt(var + LN_EPS) * g + b


def qgemv_plain(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                b: Optional[torch.Tensor] = None,
                ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """y = (LN?(x) @ wq) * s + b.  x: (M, K); wq: (K, N) int8; s, b:
    (N,) fp32; ln: ((K,), (K,)) gamma/beta.  LN(x) is rounded to x's
    type before the product; fp32 accumulation; output in x's type."""
    xf = x.float()
    if ln is not None:
        xf = ln_f32(xf, ln[0].float(), ln[1].float()).to(x.dtype).float()
    y = (xf @ wq.float()) * s.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def ksplit(k: int, n: int, m: int = 1, blocks: int = 264) -> int:
    """K slices of the kernel (K2 and K8): a power of two dividing K into
    slices of a multiple of KSTG rows, at most KC_MAX and at least KC_MIN
    rows each and at most KS_MAX slices (the last block of a column tile
    adds them all), as many as it takes to reach ``blocks`` blocks (two per
    SM of an H100), while the fp32/int32 partial sums they write, ks x M x
    N x 4 bytes, stay within the K x N bytes of the weights."""
    tiles, ks = n // TILE_N, 1

    def can_double():
        kc = k // (2 * ks)
        return k % (2 * ks) == 0 and kc % KSTG == 0

    while k // ks > KC_MAX and can_double():
        ks *= 2
    while tiles * ks < blocks and can_double() and k // (2 * ks) >= KC_MIN \
            and 2 * ks <= KS_MAX and 2 * ks * min(m, 64) * 4 <= k:
        ks *= 2
    return ks


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def counters(dev: torch.device, stream, n: int) -> torch.Tensor:
    """The split-K arrival counters of the device and stream: int32 zeros,
    one a column tile and row block, allocated once (again only for a
    larger call) and left at zero by every kernel that uses them.  Calls on
    one stream run in order, so K2 and K8 share them.  A CUDA graph's
    replays reuse the counters of its capture stream, so they must exist
    before the capture (``utils/graphs.StepGraph`` warms the step up on
    that stream): allocating them while the stream captures raises."""
    key = (dev.index, stream.cuda_stream)
    t = _COUNTERS.get(key)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("qgemv: split-K counters allocated during a "
                               "CUDA graph capture; run the step once on "
                               "the capture stream first")
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[key] = t
    return t


def _check_f32(name, t, n, dev):
    if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous() \
            or t.device != dev or t.data_ptr() % 16:
        raise ValueError(f"qgemv: {name} must be contiguous 16-byte aligned "
                         f"float32 ({n},) on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)}")


def check_operands(name, x, wq, s, b, ln):
    """Raise on what K2's and K8's kernels do not take; returns (m, k, n)."""
    if x.dim() != 2 or x.dtype not in _DTYPES or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError(f"{name} kernel takes contiguous 16-byte aligned "
                         "float32 or bfloat16 (M, K) activations, got "
                         f"{x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[0] != k \
            or not wq.is_contiguous() or wq.device != x.device:
        raise ValueError(f"{name} kernel takes contiguous int8 ({k}, N) "
                         f"weights on {x.device}, got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    n = wq.shape[1]
    if n % TILE_N or k % KSTG or wq.data_ptr() % 16:
        raise ValueError(f"{name} kernel takes N % {TILE_N} == 0, "
                         f"K % {KSTG} == 0 and 16-byte aligned weights "
                         f"(K={k}, N={n})")
    _check_f32("s", s, n, x.device)
    if b is not None:
        _check_f32("b", b, n, x.device)
    if ln is not None:
        _check_f32("ln gamma", ln[0], k, x.device)
        _check_f32("ln beta", ln[1], k, x.device)
    return m, k, n


def scratch(x, m, k, n, acc_dtype, ks):
    """The split-K partials (None for one slice) and the counters."""
    if k % (ks * KSTG):
        raise ValueError(f"{ks} K slices of {k} rows are no multiple of "
                         f"{KSTG}")
    stream = torch.cuda.current_stream(x.device)
    partial = (torch.empty((ks, m, n), dtype=acc_dtype, device=x.device)
               if ks > 1 else None)
    # row blocks of 64 (tensor cores) or at most 16 rows (fp32 FMAs)
    tiles = -(-m // 16) * (n // TILE_N)
    return partial, counters(x.device, stream, tiles), stream


def _launch(x, wq, s, b, ln, ks=None, ln_fused=None):
    m, k, n = check_operands("qgemv", x, wq, s, b, ln)
    ks = ksplit(k, n, m) if ks is None else ks
    if ln_fused is None:
        ln_fused = m <= LN_FUSED_MAX_M
    ln_fused = bool(ln_fused) and ln is not None and x.dtype == torch.bfloat16
    if ln_fused and m > FUSED_ROWS:
        raise ValueError(f"qgemv: the fused LayerNorm takes at most "
                         f"{FUSED_ROWS} rows, got {m}")
    partial, cnt, stream = scratch(x, m, k, n, torch.float32, ks)
    xn = torch.empty_like(x) if ln is not None and not ln_fused else None
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    KERNEL.launch(x.data_ptr(), m, k, n, wq.data_ptr(), s.data_ptr(), ptr(b),
                  ptr(ln[0]) if ln else None, ptr(ln[1]) if ln else None,
                  ks, int(ln_fused), ptr(xn), ptr(partial), cnt.data_ptr(),
                  out.data_ptr(), _DTYPES[x.dtype], stream.cuda_stream)
    return out


def qgemv(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
          b: Optional[torch.Tensor] = None,
          ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
          ) -> torch.Tensor:
    """Dequantised GEMV against one layer's int8 weight (see qgemv_plain).
    On CUDA, s, b and the LN parameters are contiguous fp32."""
    if x.device.type == "cpu":
        return qgemv_plain(x, wq, s, b, ln)
    if x.device.type != "cuda":
        raise ValueError(f"qgemv: no kernel for {x.device}")
    return _launch(x, wq, s, b, ln)
