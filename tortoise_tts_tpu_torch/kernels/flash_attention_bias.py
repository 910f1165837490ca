"""K6: non-causal flash attention with a per-head additive bias, the
diffusion denoiser's rel-pos attention at batch >= 8.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_attention.py``
``flash_attention_bias_qkv_vt`` (``_attn_bias_vt_kernel``, and the
head-group ``_attn_bias_vt_hg_kernel`` its default path takes).  The CUDA
source is ``csrc/flash_attention_bias.cu``; its header gives the bound on
an H100 and the design.  The TPU kernel padded T to a multiple of 128
and pre-transposed V; the CUDA kernel reads the fused channels-major qkv
as it is and masks the ragged end.  Its ones column for the softmax
normaliser survives as 8 rows of ones behind each V tile in shared
memory.

``flash_attention_bias`` runs the plain PyTorch version for CPU tensors
and the kernel for CUDA tensors (it raises on what the kernel does not
take).  The JAX function has no gradient, and neither has this one.
fp32 inputs run the same body in 3xTF32 on the tensor cores;
``attention_bias_3xtf32`` is that arithmetic in plain PyTorch.

The module also holds what the three biased attention wrappers (K6, K9a,
K9b) share: the bf16 launch plan (``plan``) and the launch itself.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ._build import F, I, P, Kernel
from .gn_conv import matmul_3xtf32

# q/k/v/bias/out pointers, B, H, T, scale, tma, dtype, nb, nq, stages, stream
KERNEL = Kernel("flash_attention_bias", "tts_flash_attention_bias",
                [P, P, P, I, I, I, F, I, I, I, I, I, P])
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

TILE_BYTES = 64 * 64 * 2   # one bf16 tile: 64 channels x 64 steps


class Plan(NamedTuple):
    """A bf16 launch of the shared body (``csrc/attention_bias.cuh``):
    ``nb`` batch rows x ``nq`` 64-query tiles a block, ``stages`` key steps
    in flight; ``tma``: T's rows are 16-byte aligned, so TMA copies the
    tiles (else warp 0's element copies).  The C entry takes the plan and
    refuses one its kernel is not: one warpgroup for one row and one query
    tile (so G = 1: a block that shares a bias tile across rows measured
    slower), two stages, four blocks an SM."""
    nb: int
    nq: int
    stages: int
    tma: bool


def plan(b: int, h: int, t: int) -> Plan:
    """The launch plan of a bf16 call at (B, H, T)."""
    return Plan(1, 1, 2, t % 8 == 0)


def smem_bytes(p: Plan) -> int:
    """Dynamic shared memory of a launch (``SMEM``): the ring of bias, K and
    V tiles (each V tile followed by 1 KB of ones, which make the PV
    product's row sums; the Q tile arrives in its last stage), its barriers
    and 1024 bytes of alignment slack."""
    stage = (p.nq + 2 * p.nb) * TILE_BYTES + p.nb * 1024
    return p.stages * stage + 16 * p.stages + 1024


def launch(kernel: Kernel, ptrs, tensors, b: int, h: int, t: int, dtype,
           entry=None, plan_: Plan = None) -> None:
    """One launch of a biased attention kernel: ``ptrs`` the C entry's
    pointer arguments, ``tensors`` every tensor the kernel reads or writes
    (TMA needs each 16-byte aligned, and T's rows 16 bytes: fp32 at T % 4
    == 0, bf16 as the plan says).  ``plan_`` overrides ``plan`` (the tests
    pin that the kernel refuses a plan it was not built for); the fp32
    kernel has one launch and takes no plan."""
    p = plan_ or plan(b, h, t)
    rows16 = p.tma if dtype == torch.bfloat16 else t % 4 == 0
    tma = int(rows16 and all(x.data_ptr() % 16 == 0 for x in tensors))
    kernel.launch(*ptrs, b, h, t, 1.0 / math.sqrt(64), tma, DTYPES[dtype],
                  p.nb, p.nq, p.stages,
                  torch.cuda.current_stream(tensors[0].device).cuda_stream,
                  entry=entry)


def flash_attention_bias_plain(qkv: torch.Tensor, bias: torch.Tensor,
                               n_heads: int) -> torch.Tensor:
    """The TPU kernel's arithmetic: fp32 scores ``q·k/√d + bias``, ``exp``
    against the row max rounded to qkv's type, then ``(Σ p·v) / Σ p`` with
    fp32 sums.  qkv: (B, H*3*D, T) with per-head [q;k;v] channel blocks;
    bias: (H, T, T) -> (B, H*D, T) in qkv's type."""
    b, width, t = qkv.shape
    d = width // (3 * n_heads)
    q, k, v = qkv.reshape(b, n_heads, 3 * d, t).float().split(d, dim=2)
    dots = (torch.einsum("bhct,bhcs->bhts", q, k) * (1.0 / math.sqrt(d))
            + bias.float()[None])
    p = torch.exp(dots - dots.amax(dim=-1, keepdim=True)).to(qkv.dtype)
    p = p.float()
    acc = torch.einsum("bhts,bhcs->bhct", p, v)
    out = acc / p.sum(dim=-1)[:, :, None, :]
    return out.to(qkv.dtype).reshape(b, n_heads * d, t)


def attention_bias_3xtf32(qkv: torch.Tensor, bias: torch.Tensor,
                          n_heads: int, transposed: bool = False,
                          matmul=matmul_3xtf32) -> torch.Tensor:
    """The fp32 kernel's arithmetic in plain PyTorch: S = Q^T K and
    O = P V^T each by ``matmul`` (default: three TF32 products on the
    operands' ``tf32_split``, lo lo dropped), the softmax in fp32 between
    them.  qkv: (B, H*3*D, T) fp32 with per-head [q;k;v] channel blocks;
    bias: (H, T, T), (query, key), or with ``transposed`` (key, query) ->
    (B, H*D, T)."""
    b, width, t = qkv.shape
    d = width // (3 * n_heads)
    q, k, v = qkv.reshape(b, n_heads, 3 * d, t).split(d, dim=2)
    if transposed:
        bias = bias.transpose(1, 2)
    s = matmul(q.transpose(2, 3), k) * (1.0 / math.sqrt(d)) + bias[None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = matmul(p, v.transpose(2, 3)) / p.sum(dim=-1, keepdim=True)
    return out.transpose(2, 3).reshape(b, n_heads * d, t)


def _launch(qkv: torch.Tensor, bias: torch.Tensor, n_heads: int,
            plan_: Plan = None):
    b, width, t = qkv.shape
    if width % (3 * n_heads) or width // (3 * n_heads) != 64:
        raise ValueError("flash_attention_bias kernel takes head dim 64, got "
                         f"width {width} for {n_heads} heads")
    if qkv.dtype not in DTYPES or bias.dtype != qkv.dtype:
        raise TypeError("flash_attention_bias kernel takes float32 or "
                        f"bfloat16 qkv and bias of one type, got "
                        f"{qkv.dtype}/{bias.dtype}")
    if bias.shape != (n_heads, t, t) or bias.device != qkv.device:
        raise ValueError(f"bias must be ({n_heads}, {t}, {t}) on "
                         f"{qkv.device}, got {tuple(bias.shape)}")
    if not (qkv.is_contiguous() and bias.is_contiguous()):
        raise ValueError("flash_attention_bias kernel takes contiguous qkv "
                         "and bias")
    out = torch.empty((b, width // 3, t), dtype=qkv.dtype, device=qkv.device)
    launch(KERNEL, (qkv.data_ptr(), bias.data_ptr(), out.data_ptr()),
           (qkv, bias, out), b, n_heads, t, qkv.dtype, plan_=plan_)
    return out


def flash_attention_bias(qkv: torch.Tensor, bias: torch.Tensor,
                         n_heads: int) -> torch.Tensor:
    """softmax(q·k/√d + bias[h]) v over channels-major qkv (B, H*3*D, T)
    and an (H, T, T) bias, already scaled -> (B, H*D, T)."""
    if qkv.device.type == "cpu":
        return flash_attention_bias_plain(qkv, bias, n_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_bias: no kernel for {qkv.device}")
    return _launch(qkv, bias, n_heads)
