"""K5: the second half of the denoiser's timestep resblock,
x + conv3(silu(GroupNorm(h) * (1 + scale) + shift)) + b, with h from K4.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_resblock.py``
``fused_ts_res_block`` (``_rb_out_kernel``).  The CUDA source is
``csrc/resblock.cu`` (shared with K4); its header gives the bound on an
H100 and the design: the normalise kernel writes Y once (fp32: Y_hi and
Y_lo), then the ``wgmma`` GEMM (fp32: 3xTF32) takes the k=3 convolution as
three tap-shifted accumulations.  The TPU kernel's ``b <= 2 and t <= 1024`` envelope was a
VMEM limit and does not apply: the CUDA kernels take any B and T.

The kernels read the weight tap-major, (3, C, C) with ``w_taps[s] =
w[:, :, s]``: the TPU kernel's ``[W(-1) | W(0) | W(+1)]`` blocks.
``prepare_conv`` adds that copy to a conv's params once (the denoiser's
params are prepared once per ``TTS``, ``models.diffusion.prepare``); the
plain version, the CPU path and the backward keep the (C, C, 3) ``w``.
A CUDA call without ``w_taps`` raises.

``ts_res_block_out`` runs the plain PyTorch version for CPU tensors and
the kernel for CUDA tensors (it raises on what the kernel does not take).
Where autograd records a CUDA call the call is a
``torch.autograd.Function``: the forward also writes each (batch,
group)'s mean and rstd, and the backward is ``KERNEL_BWD`` (K4's
backward entry ``tts_resblock_bwd`` with three taps, counted here), which
replaces no Pallas kernel: the JAX package's ``custom_vjp``
differentiates its XLA formulation (``diffusion.py:77-98``).  In bf16
it reads the forward's tap-major ``w_taps`` (its da, ``bwd_da_pingpong``,
reverses the taps by TMA coordinate and transposes them by ``wgmma``'s
transpose bit: no per-call weight copy); in fp32 a reversed, transposed
copy of ``w``.  ``w`` gets the weight's gradient, ``w_taps`` none.  Its
plain version is ``gn_conv.ts_res_block_out_bwd_plain``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from ..models.common import Params, conv1d, group_norm, silu
from ._build import F, I, P, Kernel
from .flash_attention import records_grad
from .gn_conv import (BWD_ARGTYPES, _DTYPES, _aligned, _launch_bwd, _ptrs,
                      _scratch, _stream, _vectors, group_norm_act_plain, plan)

KERNEL = Kernel("resblock", "tts_ts_res_block_out",
                [P] * 11 + [I] * 4 + [F, I, I, I, I, I, P])
KERNEL_BWD = Kernel("resblock", "tts_resblock_bwd", BWD_ARGTYPES)


def ts_res_block_out_plain(h: torch.Tensor, x: torch.Tensor,
                           emb_out: torch.Tensor, norm: Params, conv: Params,
                           groups: int, eps: float = 1e-5) -> torch.Tensor:
    """The XLA half of the JAX package's ``_ts_res_block_xla``
    (``diffusion.py:64-74``).  h, x: (B, C, T); emb_out: (B, 2C)
    [scale | shift]; conv: {'w' (C, C, 3), 'b' (C,)}."""
    scale, shift = emb_out[..., None].chunk(2, dim=1)
    hn = group_norm(norm, h, groups, eps) * (1 + scale) + shift
    return x + conv1d(conv, silu(hn), padding=1)


def taps(w: torch.Tensor) -> torch.Tensor:
    """The (C, C, 3) conv weight tap-major: (3, C, C), ``[s] = w[:, :, s]``."""
    return w.permute(2, 0, 1).contiguous()


def prepare_conv(conv: Params) -> Params:
    """conv with its weight also in the kernels' tap-major layout
    (``w_taps``); made once per weight, not per call."""
    return {**conv, "w_taps": taps(conv["w"])}


def ts_res_block_out_taps_plain(h: torch.Tensor, x: torch.Tensor,
                                emb_out: torch.Tensor, norm: Params,
                                w_taps: torch.Tensor, bias: torch.Tensor,
                                groups: int, eps: float = 1e-5,
                                matmul=torch.matmul) -> torch.Tensor:
    """The kernels' decomposition in plain PyTorch: Y the normalise step
    (``group_norm_act_plain`` with the scale-shift and silu), then x +
    sum over taps s of w_taps[s] @ Y shifted by s - 1 (zeros outside
    [0, T)) + b, summed in fp32 and rounded once.  ``matmul``:
    ``gn_conv.matmul_3xtf32`` for the fp32 kernel's arithmetic."""
    c, t = h.shape[1], h.shape[2]
    y = group_norm_act_plain(h, norm["scale"], norm["bias"], groups, True,
                             eps, emb_out[:, :c], emb_out[:, c:])
    yp = Fn.pad(y.float(), (1, 1))
    acc = sum(matmul(w_taps[s].float(), yp[..., s:s + t]) for s in range(3))
    return (acc + bias.float()[:, None] + x.float()).to(h.dtype)


def da_taps_plain(w_taps: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The bf16 backward's da product (``bwd_da_pingpong``) in plain
    PyTorch, in fp32: the sum over taps s' of w_taps[2 - s']^T (the
    tap-major weight read transposed, its taps reversed) times the
    upstream g (B, C, T) shifted by s' - 1 steps (zeros outside [0, T)):
    the gradient of the k=3 convolution's input, (B, C, T)."""
    t = g.shape[-1]
    gp = Fn.pad(g.float(), (1, 1))
    return sum(torch.matmul(w_taps[2 - s].float().t(), gp[..., s:s + t])
               for s in range(3))


def _launch(h, x, emb_out, gamma, beta, w_taps, bias, groups, eps,
            with_stats=False):
    """K5 on CUDA h: (out, the statistics as ``gn_conv._launch``'s)."""
    b, c, t = h.shape
    p = plan(b, c, t, c, groups, h.dtype, "ts_res_block_out", taps=3)
    if x.shape != h.shape or x.dtype != h.dtype or w_taps.shape != (3, c, c):
        raise ValueError(f"ts_res_block_out: x {tuple(x.shape)} {x.dtype} "
                         f"and the tap-major weight {tuple(w_taps.shape)} "
                         f"must match h {tuple(h.shape)} {h.dtype} and "
                         f"(3, {c}, {c})")
    h, x = h.contiguous(), x.contiguous()
    w_taps = _aligned(w_taps.to(h.dtype))
    out = torch.empty_like(h)
    stats = (torch.empty(2 * b * groups, dtype=torch.float32, device=h.device)
             if with_stats else None)
    buf = _scratch(h)
    (gamma, beta, bias), vec_bf = _vectors(gamma, beta, bias)
    (emb_out,), emb_bf = _vectors(emb_out)
    KERNEL.launch(h.data_ptr(), x.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), emb_out.data_ptr(), w_taps.data_ptr(),
                  bias.data_ptr(), out.data_ptr(),
                  stats.data_ptr() if with_stats else None, *_ptrs(buf), b,
                  c, t, groups, eps, _DTYPES[h.dtype], vec_bf, emb_bf, p.bn,
                  p.split, _stream(h))
    return out, stats


class _TsResBlockOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x, emb_out, gamma, beta, w, w_taps, bias, groups,
                eps):
        out, stats = _launch(h, x, emb_out, gamma, beta, w_taps, bias,
                             groups, eps, with_stats=True)
        ctx.save_for_backward(h, emb_out, gamma, beta, w, w_taps, bias,
                              stats)
        ctx.cfg = (groups, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        h, emb_out, gamma, beta, w, w_taps, bias, stats = ctx.saved_tensors
        groups, eps = ctx.cfg
        if h.dtype == torch.bfloat16:   # the forward's tap-major weight
            wb = _aligned(w_taps.to(h.dtype))
        else:      # wb[s'] = w[:, :, 2 - s']^T: (3, C_in, C_out)
            wb = w.to(h.dtype).flip(2).permute(2, 1, 0).contiguous()
        dh, dga, dbe, dw, db, demb = _launch_bwd(
            KERNEL_BWD, h, gamma, beta, bias, wb, g, stats, groups, True,
            eps, emb=emb_out)
        return (dh, g, demb.to(emb_out.dtype), dga.to(gamma.dtype),
                dbe.to(beta.dtype), dw.view(w.shape).to(w.dtype), None,
                db.to(bias.dtype), None, None)


def _cuda_call(h, x, emb_out, norm, conv, groups, eps):
    """K5 on a CUDA h: the autograd Function where autograd records the
    call, else the kernel alone."""
    bias = conv["b"] if "b" in conv else torch.zeros(h.shape[1],
                                                     device=h.device)
    args = (h, x, emb_out, norm["scale"], norm["bias"], conv["w"],
            conv["w_taps"], bias)
    if records_grad(*args):
        return _TsResBlockOut.apply(*args, groups, eps)
    return _launch(h, x, emb_out, norm["scale"], norm["bias"],
                   conv["w_taps"], bias, groups, eps)[0]


def ts_res_block_out(h: torch.Tensor, x: torch.Tensor, emb_out: torch.Tensor,
                     norm: Params, conv: Params, groups: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """x + conv3(silu(GroupNorm(h) * (1 + scale) + shift)) + b.  h, x:
    (B, C, T); emb_out: (B, 2C) [scale | shift]; norm: {'scale', 'bias'}
    (C,); conv: {'w' (C, C, 3), 'b' (C,)}, and on CUDA also 'w_taps'
    (3, C, C) from ``prepare_conv`` -> (B, C, T) in h's type."""
    if h.device.type == "cpu":
        return ts_res_block_out_plain(h, x, emb_out, norm, conv, groups, eps)
    if h.device.type != "cuda":
        raise ValueError(f"ts_res_block_out: no kernel for {h.device}")
    if "w_taps" not in conv:
        raise ValueError("ts_res_block_out: the CUDA kernel reads the weight "
                         "tap-major; add it once with "
                         "ts_res_block.prepare_conv(conv) (the denoiser: "
                         "models.diffusion.prepare(params))")
    return _cuda_call(h, x, emb_out, norm, conv, groups, eps)
