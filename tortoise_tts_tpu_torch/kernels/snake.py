"""K7: BigVGAN's anti-aliased Snake activation, up2 -> snake -> down2 in
one pass.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_snake.py``
``snake_resample2`` (``_snake_kernel_mxu``, ``_snake_kernel``).  The CUDA
source is ``csrc/snake.cu``; its header gives the bound on an H100 and
the design.  The TPU kernel's band matrices, patch blocks and ``_sin2``
polynomial were TPU workarounds: the CUDA kernel sums the taps in
registers, clamps the edge indices and uses ``sinf``.

``snake_resample2`` runs the plain PyTorch version for CPU tensors and
the kernel for CUDA tensors (it raises on what the kernel does not take).
On CUDA the call is a ``torch.autograd.Function`` whose backward
recomputes the plain version, as the JAX package's ``custom_vjp`` does
(``bigvgan.py:235-255``).
"""

from __future__ import annotations

from typing import Dict

import torch

from ._build import I, P, Kernel

KERNEL = Kernel("snake", "tts_snake_resample2", [P] * 5 + [I] * 4 + [P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_TAPS: Dict[torch.device, torch.Tensor] = {}


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


def _taps(device: torch.device) -> torch.Tensor:
    if device not in _TAPS:
        from ..models.bigvgan import kaiser_sinc_filter
        _TAPS[device] = torch.as_tensor(kaiser_sinc_filter(0.25, 0.3, 12),
                                        device=device)
    return _TAPS[device]


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
    KERNEL.launch(x.data_ptr(), alpha.data_ptr(), inv_beta.data_ptr(),
                  _taps(x.device).data_ptr(), y.data_ptr(), b * c, c, t,
                  _DTYPES[x.dtype],
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
