"""K2: weight-only int8 GEMV with an optional fused LayerNorm, for the
UnifiedVoice decode step.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_gemv.py``
``qgemv_stacked`` (``_qgemv_kernel``, ``_qgemv_ln_kernel``,
``_gemv_body``).  The CUDA source is ``csrc/qgemv.cu``; its header gives
the bound on an H100 and the design.  The TPU kernel took the whole
``(L, K, N)`` stack and a scalar-prefetched layer index; here the caller
passes ``wq[li]``, a view.

``qgemv`` runs the plain PyTorch version for CPU tensors and the kernel
for CUDA tensors (it raises on what the kernel does not take).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import I, P, Kernel

KERNEL = Kernel("qgemv", "tts_qgemv", [P, I, I, I] + [P] * 5 + [I, P, P, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LN_EPS = 1e-5
TILE_N = 128        # output columns per block (TN in csrc/qgemv.cu)


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


def ksplit(k: int, n: int, blocks: int = 264) -> int:
    """K slices for the kernel: a power of two dividing K, each of at most
    1024 and at least 64 rows, as many as it takes to reach about
    ``blocks`` blocks (two per SM of an H100)."""
    tiles, ks = n // TILE_N, 1
    while k // ks > 1024 and k % (2 * ks) == 0:
        ks *= 2
    while tiles * ks < blocks and k % (2 * ks) == 0 and k // (2 * ks) >= 64:
        ks *= 2
    return ks


def _check_f32(name, t, n, dev):
    if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous() \
            or t.device != dev:
        raise ValueError(f"qgemv: {name} must be contiguous float32 ({n},) "
                         f"on {dev}, got {t.dtype} {tuple(t.shape)}")


def _launch(x, wq, s, b, ln):
    if x.dim() != 2 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError("qgemv kernel takes contiguous float32 or bfloat16 "
                         f"(M, K) activations, got {x.dtype} {tuple(x.shape)}")
    m, k = x.shape
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[0] != k \
            or not wq.is_contiguous() or wq.device != x.device:
        raise ValueError(f"qgemv kernel takes contiguous int8 ({k}, N) "
                         f"weights on {x.device}, got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    n = wq.shape[1]
    if n % TILE_N or wq.data_ptr() % 16:
        raise ValueError(f"qgemv kernel takes N % {TILE_N} == 0 and 16-byte "
                         f"aligned weights (N={n})")
    _check_f32("s", s, n, x.device)
    if b is not None:
        _check_f32("b", b, n, x.device)
    if ln is not None:
        _check_f32("ln gamma", ln[0], k, x.device)
        _check_f32("ln beta", ln[1], k, x.device)
    ks = ksplit(k, n)
    partial = (torch.empty((ks, m, n), dtype=torch.float32, device=x.device)
               if ks > 1 else None)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    KERNEL.launch(x.data_ptr(), m, k, n, wq.data_ptr(), s.data_ptr(), ptr(b),
                  ptr(ln[0]) if ln else None, ptr(ln[1]) if ln else None,
                  ks, ptr(partial), out.data_ptr(), _DTYPES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
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
