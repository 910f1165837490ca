"""K7: BigVGAN's anti-aliased Snake activation, up2 -> snake -> down2 in
one pass.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_snake.py``
``snake_resample2`` (``_snake_kernel_mxu``, ``_snake_kernel``).  The CUDA
source is ``csrc/snake.cu``; its header gives the bound on an H100 and
the design: a thread keeps a run of 8 or 16 outputs (bf16; 4 in fp32) and
its polyphase window in registers, takes the neighbouring runs' pairs by
shuffle, and the bf16 snake takes cos(2 alpha v) with its argument
reduced by 2 pi (sin^2 has period pi).  The TPU kernel's band matrices
and patch blocks were TPU workarounds.

``plan`` gives the launch geometry: the run length, the grid over (row,
run) flat, 128 runs a block, and the multiply-shift constants with which
the kernel divides by the runs a row and by C.

``snake_resample2`` runs the plain PyTorch version for CPU tensors and
the kernel for CUDA tensors (it raises on what the kernel does not take).
On CUDA the call is a ``torch.autograd.Function`` whose backward
recomputes the plain version, as the JAX package's ``custom_vjp`` does
(``bigvgan.py:235-255``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ._build import I, P, U, Kernel

KERNEL = Kernel("snake", "tts_snake_resample2",
                [P] * 4 + [I] * 5 + [U, I, U, I] + [I, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 128                    # runs a block
# bf16 calls of at least this many samples take runs of 16 outputs, smaller
# ones runs of 8: 768 x 3624 at B=1 in runs of 16 is 1.5 waves of blocks on
# an H100, the last half empty (PERF.md has the times); fp32 takes runs of 4
BIG_CALL = 1 << 22


class Plan(NamedTuple):
    run: int                     # outputs a run: whole 16-byte vectors
    per_row: int                 # runs a row, ceil(T / run)
    tiles: int                   # ceil(runs / THREADS)
    per_row_div: Tuple[int, int]  # (m, l) of fastdiv(per_row)
    channel_div: Tuple[int, int]  # (m, l) of fastdiv(C)


def fastdiv(d: int) -> Tuple[int, int]:
    """(m, l) with n // d == (umulhi(n, m) + n) >> l for 0 <= n < 2**31,
    umulhi the high 32 bits of the 64-bit product (Granlund and
    Montgomery, "Division by invariant integers using multiplication",
    1994: l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1)."""
    if not 1 <= d < 2 ** 31:
        raise ValueError(f"fastdiv: divisor {d} out of range")
    l = (d - 1).bit_length()
    return (2 ** 32 * (2 ** l - d)) // d + 1, l


def plan(rows: int, c: int, t: int, dtype: torch.dtype) -> Plan:
    """The kernel's grid over ``rows`` rows of length ``t`` (row r is
    channel r % c): one thread a run of outputs, every row's runs back to
    back, a block a tile of 128 runs."""
    run = 4 if dtype == torch.float32 else 16 if rows * t >= BIG_CALL else 8
    per_row = -(-t // run)
    runs = rows * per_row
    if runs >= 2 ** 31:
        raise ValueError(f"snake_resample2: {runs} runs, over 2^31")
    return Plan(run, per_row, -(-runs // THREADS), fastdiv(per_row),
                fastdiv(c))


def snake_resample2_plain(x: torch.Tensor, alpha: torch.Tensor,
                          inv_beta: torch.Tensor) -> torch.Tensor:
    """up2 -> v + inv_beta sin²(alpha v) -> down2 in fp32 (the kernel's
    arithmetic type for every storage type), cast back to x's type.
    x: (B, C, T); alpha, inv_beta: (C,) fp32, alpha already exp'd."""
    from ..models.bigvgan import _down2, _up2
    u = _up2(x.float())
    a = alpha.float()[None, :, None]
    ib = inv_beta.float()[None, :, None]
    return _down2(u + ib * torch.square(torch.sin(u * a))).to(x.dtype)


def _launch(x, alpha, inv_beta):
    b, c, t = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"snake_resample2 kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if alpha.shape != (c,) or inv_beta.shape != (c,):
        raise ValueError(f"alpha, inv_beta must be ({c},)")
    x = x.contiguous()
    alpha = alpha.float().contiguous()
    inv_beta = inv_beta.float().contiguous()
    y = torch.empty_like(x)
    p = plan(b * c, c, t, x.dtype)
    KERNEL.launch(x.data_ptr(), alpha.data_ptr(), inv_beta.data_ptr(),
                  y.data_ptr(), b * c, c, t, p.run, p.per_row,
                  *p.per_row_div, *p.channel_div, p.tiles, _DTYPES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    return y


class _Snake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha, inv_beta):
        ctx.save_for_backward(x, alpha, inv_beta)
        return _launch(x, alpha, inv_beta)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = snake_resample2_plain(*ins)
        return torch.autograd.grad(out, ins, g)


def snake_resample2(x: torch.Tensor, alpha: torch.Tensor,
                    inv_beta: torch.Tensor) -> torch.Tensor:
    """Fused up2 -> snake -> down2 (ratio 2, 12-tap kaiser filters).
    x: (B, C, T); alpha, inv_beta: (C,) fp32 -- alpha already exp'd for
    logscale, inv_beta = 1 / (beta + 1e-9).  Returns (B, C, T) in x's
    type."""
    if x.device.type == "cpu":
        return snake_resample2_plain(x, alpha, inv_beta)
    if x.device.type != "cuda":
        raise ValueError(f"snake_resample2: no kernel for {x.device}")
    return _Snake.apply(x, alpha, inv_beta)
