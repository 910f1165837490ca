"""K8: W8A8 GEMV (dynamic per-row int8 activations, int8 x int8 -> int32)
with an optional fused LayerNorm, for the UnifiedVoice decode step under
``Inference.decode_quant="w8a8"``.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_gemv.py``
``qgemv_stacked_w8a8`` (``_gemv_body``'s w8a8 branch, ``_stacked_call``)
and its ``quantize_rowwise``.  The CUDA source is ``csrc/qgemv_w8a8.cu``;
its header gives the bound on an H100 and the design.  As for K2 the
caller passes ``wq[li]``, a view, where the TPU kernel took the stack and
a scalar-prefetched layer index.

Rounding: the JAX package's off-TPU branch (``force_xla``, ``_ln_xla``)
rounds LN(x) to x's type before quantizing; its Pallas kernel quantizes
the fp32 LN output.  The plain version and the kernel here both follow the
off-TPU branch, as K2 does; in fp32 the two branches agree.

``qgemv_w8a8`` runs the plain PyTorch version for CPU tensors and the
kernel for CUDA tensors (it raises on what the kernel does not take).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import I, P, Kernel
from .qgemv import TILE_N, _check_f32, ksplit, ln_f32

KERNEL = Kernel("qgemv_w8a8", "tts_qgemv_w8a8",
                [P, I, I, I] + [P] * 5 + [I] + [P] * 4 + [I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_rowwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of activations
    (``pallas_gemv.quantize_rowwise``): x (M, K) -> (int8 (M, K) codes,
    fp32 (M, 1) scales).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: on CUDA, PyTorch divides by a Python number as a
    # product with its reciprocal, which can round the scale one bit off
    # the true division of the JAX package and of the kernel
    sx = amax / torch.full_like(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(xf / sx), -127, 127)
    return q.to(torch.int8), sx


def qgemv_w8a8_plain(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> torch.Tensor:
    """y = (float(quantize_rowwise(LN?(x)) @ wq) * sx) * s + b.  x: (M,
    K); wq: (K, N) int8; s, b: (N,) fp32; ln: ((K,), (K,)) gamma/beta.
    LN(x) is rounded to x's type before the quantization.  The integer
    product runs in float64, exact for these sums (< 2^53) on the CPU and
    on CUDA alike; output in x's type."""
    xn = x
    if ln is not None:
        xn = ln_f32(x.float(), ln[0].float(), ln[1].float()).to(x.dtype)
    xq, sx = quantize_rowwise(xn)
    acc = xq.double() @ wq.double()
    y = acc.float() * sx * s.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _launch(x, wq, s, b, ln, codes: bool):
    if x.dim() != 2 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError("qgemv_w8a8 kernel takes contiguous float32 or "
                         f"bfloat16 (M, K) activations, got {x.dtype} "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    if wq.dtype != torch.int8 or wq.dim() != 2 or wq.shape[0] != k \
            or not wq.is_contiguous() or wq.device != x.device:
        raise ValueError(f"qgemv_w8a8 kernel takes contiguous int8 ({k}, N) "
                         f"weights on {x.device}, got {wq.dtype} "
                         f"{tuple(wq.shape)}")
    n = wq.shape[1]
    if n % TILE_N or wq.data_ptr() % 16:
        raise ValueError(f"qgemv_w8a8 kernel takes N % {TILE_N} == 0 and "
                         f"16-byte aligned weights (N={n})")
    _check_f32("s", s, n, x.device)
    if b is not None:
        _check_f32("b", b, n, x.device)
    if ln is not None:
        _check_f32("ln gamma", ln[0], k, x.device)
        _check_f32("ln beta", ln[1], k, x.device)
    ks = ksplit(k, n)
    partial = (torch.empty((ks, m, n), dtype=torch.int32, device=x.device)
               if ks > 1 else None)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    xq = (torch.empty((m, k), dtype=torch.int8, device=x.device)
          if codes else None)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    KERNEL.launch(x.data_ptr(), m, k, n, wq.data_ptr(), s.data_ptr(), ptr(b),
                  ptr(ln[0]) if ln else None, ptr(ln[1]) if ln else None,
                  ks, ptr(partial), sx.data_ptr(), ptr(xq), out.data_ptr(),
                  _DTYPES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out, xq, sx


def qgemv_w8a8(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
               b: Optional[torch.Tensor] = None,
               ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
               ) -> torch.Tensor:
    """W8A8 GEMV against one layer's int8 weight (see qgemv_w8a8_plain).
    On CUDA, s, b and the LN parameters are contiguous fp32."""
    if x.device.type == "cpu":
        return qgemv_w8a8_plain(x, wq, s, b, ln)
    if x.device.type != "cuda":
        raise ValueError(f"qgemv_w8a8: no kernel for {x.device}")
    return _launch(x, wq, s, b, ln, codes=False)[0]


def qgemv_w8a8_codes(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, for checks: (y, the int8 activation
    codes (M, K) it multiplied, its fp32 row scales (M,))."""
    if x.device.type != "cuda":
        raise ValueError(f"qgemv_w8a8_codes: no kernel for {x.device}")
    return _launch(x, wq, s, b, ln, codes=True)
