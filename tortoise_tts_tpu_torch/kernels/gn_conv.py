"""K4: conv1x1(silu?(GroupNorm(x))) + b, the denoiser resblock's input
half (``act=True``) and every attention block's [GroupNorm + qkv conv]
head (``act=False``).

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_resblock.py``
``fused_gn_conv1x1`` (``_gn_conv_kernel``, ``_group_stats``).  The CUDA
source is ``csrc/resblock.cu``; its header gives the bound on an H100
and the design.  The TPU kernel's ``c % 128``/``t % 128`` guard and
its block size knob are Mosaic tiling limits: the CUDA kernel masks
ragged T and c_out itself and takes any C that is a multiple of 8.

``gn_conv1x1`` runs the plain PyTorch version for CPU tensors and the
kernel for CUDA tensors (it raises on what the kernel does not take).
On CUDA the call is a ``torch.autograd.Function`` whose backward
recomputes the plain version, as the JAX package's ``custom_vjp`` does
(``arch.py:52-71``).
"""

from __future__ import annotations

import torch

from ..models.common import Params, conv1d, group_norm, silu
from ._build import F, I, P, Kernel

KERNEL = Kernel("resblock", "tts_gn_conv1x1", [P] * 7 + [I] * 6 + [F, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gn_conv1x1_plain(x: torch.Tensor, norm: Params, conv: Params,
                     groups: int, act: bool, eps: float = 1e-5
                     ) -> torch.Tensor:
    """conv1d(conv, silu?(group_norm(norm, x))): x (B, C, T) -> (B, M, T)."""
    h = group_norm(norm, x, groups, eps)
    if act:
        h = silu(h)
    return conv1d(conv, h)


def _check(x: torch.Tensor, c: int, groups: int, name: str):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if c % 8 or c % groups:
        raise ValueError(f"{name} kernel needs C % 8 == 0 and C % groups "
                         f"== 0, got C={c}, groups={groups}")


def _launch(x, gamma, beta, w, bias, groups, act, eps):
    b, c, t = x.shape
    m = w.shape[0]
    _check(x, c, groups, "gn_conv1x1")
    x = x.contiguous()
    w = w.to(x.dtype).reshape(m, c).contiguous()
    out = torch.empty((b, m, t), dtype=x.dtype, device=x.device)
    stats = torch.empty(2 * b * groups, dtype=torch.float32, device=x.device)
    KERNEL.launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  stats.data_ptr(), b, c, t, m, groups, int(act), eps,
                  _DTYPES[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out


class _GnConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, groups, act, eps):
        ctx.save_for_backward(x, gamma, beta, w, bias)
        ctx.cfg = (groups, act, eps)
        return _launch(x, gamma, beta, w, bias, groups, act, eps)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        x, gamma, beta, w, bias = ins
        with torch.enable_grad():
            out = gn_conv1x1_plain(x, {"scale": gamma, "bias": beta},
                                   {"w": w, "b": bias}, *ctx.cfg)
        grads = torch.autograd.grad(out, ins, g, allow_unused=True)
        return (*grads, None, None, None)


def gn_conv1x1(x: torch.Tensor, norm: Params, conv: Params, groups: int,
               act: bool, eps: float = 1e-5) -> torch.Tensor:
    """conv1x1(silu?(GroupNorm(x))) + b.  x: (B, C, T); norm: {'scale',
    'bias'} (C,); conv: {'w' (M, C, 1), 'b' (M,)} -> (B, M, T) in x's
    type."""
    if x.device.type == "cpu":
        return gn_conv1x1_plain(x, norm, conv, groups, act, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_conv1x1: no kernel for {x.device}")
    m = conv["w"].shape[0]
    bias = conv["b"] if "b" in conv else torch.zeros(m, device=x.device)
    return _GnConv.apply(x, norm["scale"].float(), norm["bias"].float(),
                         conv["w"], bias.float(), groups, act, eps)
