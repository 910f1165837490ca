"""K5: the second half of the denoiser's timestep resblock,
x + conv3(silu(GroupNorm(h) * (1 + scale) + shift)) + b, with h from K4.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_resblock.py``
``fused_ts_res_block`` (``_rb_out_kernel``).  The CUDA source is
``csrc/resblock.cu`` (shared with K4); its header gives the bound on an
H100 and the design.  The TPU kernel's ``b <= 2 and t <= 1024`` envelope
was a VMEM limit and does not apply: the CUDA kernel takes any B and T.

``ts_res_block_out`` runs the plain PyTorch version for CPU tensors and
the kernel for CUDA tensors (it raises on what the kernel does not take).
On CUDA the call is a ``torch.autograd.Function`` whose backward
recomputes the plain version, as the JAX package's ``custom_vjp`` does
(``diffusion.py:77-98``).
"""

from __future__ import annotations

import torch

from ..models.common import Params, conv1d, group_norm, silu
from ._build import F, I, P, Kernel
from .gn_conv import _DTYPES, _check

KERNEL = Kernel("resblock", "tts_ts_res_block_out",
                [P] * 10 + [I] * 4 + [F, I, P])


def ts_res_block_out_plain(h: torch.Tensor, x: torch.Tensor,
                           emb_out: torch.Tensor, norm: Params, conv: Params,
                           groups: int, eps: float = 1e-5) -> torch.Tensor:
    """The XLA half of the JAX package's ``_ts_res_block_xla``
    (``diffusion.py:64-74``).  h, x: (B, C, T); emb_out: (B, 2C)
    [scale | shift]; conv: {'w' (C, C, 3), 'b' (C,)}."""
    scale, shift = emb_out[..., None].chunk(2, dim=1)
    hn = group_norm(norm, h, groups, eps) * (1 + scale) + shift
    return x + conv1d(conv, silu(hn), padding=1)


def _launch(h, x, scale, shift, gamma, beta, w, bias, groups, eps):
    b, c, t = h.shape
    _check(h, c, groups, "ts_res_block_out")
    if x.shape != h.shape or x.dtype != h.dtype or w.shape != (c, c, 3):
        raise ValueError(f"ts_res_block_out: x {tuple(x.shape)} {x.dtype} "
                         f"and weight {tuple(w.shape)} must match h "
                         f"{tuple(h.shape)} {h.dtype} and ({c}, {c}, 3)")
    h, x = h.contiguous(), x.contiguous()
    w = w.to(h.dtype).contiguous()
    out = torch.empty_like(h)
    stats = torch.empty(2 * b * groups, dtype=torch.float32, device=h.device)
    KERNEL.launch(h.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                  w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  stats.data_ptr(), b, c, t, groups, eps, _DTYPES[h.dtype],
                  torch.cuda.current_stream(h.device).cuda_stream)
    return out


class _TsResBlockOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x, emb_out, gamma, beta, w, bias, groups, eps):
        ctx.save_for_backward(h, x, emb_out, gamma, beta, w, bias)
        ctx.cfg = (groups, eps)
        c = h.shape[1]
        scale = emb_out[:, :c].float().contiguous()
        shift = emb_out[:, c:].float().contiguous()
        return _launch(h, x, scale, shift, gamma, beta, w, bias, groups, eps)

    @staticmethod
    def backward(ctx, g):
        ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        h, x, emb_out, gamma, beta, w, bias = ins
        with torch.enable_grad():
            out = ts_res_block_out_plain(
                h, x, emb_out, {"scale": gamma, "bias": beta},
                {"w": w, "b": bias}, *ctx.cfg)
        grads = torch.autograd.grad(out, ins, g, allow_unused=True)
        return (*grads, None, None)


def ts_res_block_out(h: torch.Tensor, x: torch.Tensor, emb_out: torch.Tensor,
                     norm: Params, conv: Params, groups: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """x + conv3(silu(GroupNorm(h) * (1 + scale) + shift)) + b.  h, x:
    (B, C, T); emb_out: (B, 2C) [scale | shift]; norm: {'scale', 'bias'}
    (C,); conv: {'w' (C, C, 3), 'b' (C,)} -> (B, C, T) in h's type."""
    if h.device.type == "cpu":
        return ts_res_block_out_plain(h, x, emb_out, norm, conv, groups, eps)
    if h.device.type != "cuda":
        raise ValueError(f"ts_res_block_out: no kernel for {h.device}")
    c = h.shape[1]
    bias = conv["b"] if "b" in conv else torch.zeros(c, device=h.device)
    return _TsResBlockOut.apply(h, x, emb_out, norm["scale"].float(),
                                norm["bias"].float(), conv["w"],
                                bias.float(), groups, eps)
