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

A CUDA call is at most two kernels at any M: one block a row quantizes
(``w8a8_quantize``: LN, absmax, codes, scales), then one int8 tensor-core
GEMM for all rows merges its split-K partials itself.  Up to
``QUANT_FUSED_MAX_M`` rows the GEMM quantizes its rows in its prologue
instead, one kernel.  The K split and the counters are K2's
(``kernels/qgemv.py``).

``qgemv_w8a8`` runs the plain PyTorch version for CPU tensors and the
kernel for CUDA tensors (it raises on what the kernel does not take).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ._build import I, P, Kernel
from .qgemv import FUSED_ROWS, check_operands, ksplit, ln_f32, scratch

KERNEL = Kernel("qgemv_w8a8", "tts_qgemv_w8a8",
                [P, I, I, I] + [P] * 5 + [I, I] + [P] * 5 + [I, P])
# up to this many rows the GEMM quantizes the rows itself (one kernel a
# call); above it the quantize kernel runs first (fused is faster at M=1,
# twice as slow at M=8: chip_smoke's fused_ms / quantize_kernel_ms on an
# H100)
QUANT_FUSED_MAX_M = 1
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


def _launch(x, wq, s, b, ln, ks=None, fused=None):
    m, k, n = check_operands("qgemv_w8a8", x, wq, s, b, ln)
    ks = ksplit(k, n, m) if ks is None else ks
    fused = m <= QUANT_FUSED_MAX_M if fused is None else bool(fused)
    if fused and m > FUSED_ROWS:
        raise ValueError(f"qgemv_w8a8: the fused quantizer takes at most "
                         f"{FUSED_ROWS} rows, got {m}")
    partial, cnt, stream = scratch(x, m, k, n, torch.int32, ks)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    KERNEL.launch(x.data_ptr(), m, k, n, wq.data_ptr(), s.data_ptr(), ptr(b),
                  ptr(ln[0]) if ln else None, ptr(ln[1]) if ln else None,
                  ks, int(fused), ptr(partial), cnt.data_ptr(), sx.data_ptr(),
                  xq.data_ptr(), out.data_ptr(), _DTYPES[x.dtype],
                  stream.cuda_stream)
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
    return _launch(x, wq, s, b, ln)[0]


def qgemv_w8a8_codes(x: torch.Tensor, wq: torch.Tensor, s: torch.Tensor,
                     b: Optional[torch.Tensor] = None,
                     ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on CUDA tensors, for checks: (y, the int8 activation
    codes (M, K) it multiplied, its fp32 row scales (M,))."""
    if x.device.type != "cuda":
        raise ValueError(f"qgemv_w8a8_codes: no kernel for {x.device}")
    return _launch(x, wq, s, b, ln)
