"""K4: conv1x1(silu?(GroupNorm(x))) + b, the denoiser resblock's input
half (``act=True``) and every attention block's [GroupNorm + qkv conv]
head (``act=False``).

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_resblock.py``
``fused_gn_conv1x1`` (``_gn_conv_kernel``, ``_group_stats``).  The CUDA
source is ``csrc/resblock.cu``; its header gives the bound on an H100
and the design: in bf16 a normalise kernel writes Y = act(GroupNorm(x))
once, time-major, then a TMA-fed ``wgmma`` GEMM multiplies the weight by
Y; in fp32 (the parity runs) a CUDA-core GEMM makes Y as it loads x.  The
TPU kernel's ``c % 128``/``t % 128`` guard and its block size knob are
Mosaic tiling limits: the CUDA kernels take ragged T and c_out and any C
that is a multiple of 8.

``gn_conv1x1`` runs the plain PyTorch version for CPU tensors and the
kernel for CUDA tensors (it raises on what the kernel does not take).
On CUDA the call is a ``torch.autograd.Function`` whose backward
recomputes the plain version, as the JAX package's ``custom_vjp`` does
(``arch.py:52-71``).  ``group_norm_act`` runs the bf16 path's normalise
kernel alone, for checks; ``group_norm_act_plain`` is its plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.common import Params, conv1d, group_norm, silu
from ._build import F, I, P, Kernel

KERNEL = Kernel("resblock", "tts_gn_conv1x1",
                [P] * 8 + [I] * 6 + [F, I, I, I, P])
# the normalise kernel alone; its launches are not K4's
NORMALISE = Kernel("resblock", "tts_group_norm_act",
                   [P] * 6 + [I] * 5 + [F, I, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # also: 1 = bf16 vectors
SMS = 132          # streaming multiprocessors of an H100 SXM
GEMM_ROWS = 128    # output channels a GEMM block


def plan(b: int, c: int, t: int, m: int, groups: int, dtype: torch.dtype,
         name: str = "gn_conv1x1") -> int:
    """Check the shapes of a call (B, C, T) -> (B, M, T) against what the
    kernels take and return the time steps a bf16 GEMM block covers: 128,
    or 64 where a grid of 128-wide blocks would fill less than half the
    SMs (the faster of the two at the denoiser's shapes on an H100,
    ``tools/resblock_tiles.py``).  Raises
    TypeError for a dtype other than float32 or bfloat16, ValueError for
    an empty dimension, C % 8 != 0 (the weight's and Y's rows are read in
    16-byte pieces) or C % groups != 0."""
    if dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{dtype}")
    if min(b, c, t, m, groups) < 1:
        raise ValueError(f"{name} kernel needs non-empty shapes, got "
                         f"B={b}, C={c}, T={t}, M={m}, groups={groups}")
    if c % 8 or c % groups:
        raise ValueError(f"{name} kernel needs C % 8 == 0 and C % groups "
                         f"== 0, got C={c}, groups={groups}")
    wide = b * -(-m // GEMM_ROWS) * -(-t // 128)
    return 128 if 2 * wide > SMS else 64


def gn_conv1x1_plain(x: torch.Tensor, norm: Params, conv: Params,
                     groups: int, act: bool, eps: float = 1e-5
                     ) -> torch.Tensor:
    """conv1d(conv, silu?(group_norm(norm, x))): x (B, C, T) -> (B, M, T)."""
    h = group_norm(norm, x, groups, eps)
    if act:
        h = silu(h)
    return conv1d(conv, h)


def group_stats_plain(x: torch.Tensor, groups: int, eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass GroupNorm statistics of x (B, C, T) in fp32: (mu, rstd),
    each (B * groups,)."""
    xf = x.float().reshape(x.shape[0] * groups, -1)
    mu = xf.mean(dim=1)
    var = ((xf - mu[:, None]) ** 2).mean(dim=1)
    return mu, torch.rsqrt(var + eps)


def group_norm_act_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, groups: int, act: bool,
                         eps: float = 1e-5,
                         scale: Optional[torch.Tensor] = None,
                         shift: Optional[torch.Tensor] = None,
                         stats: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                         ) -> torch.Tensor:
    """The normalise kernel's Y in plain PyTorch, step for step: ((x - mu)
    * rstd) * gamma + beta in fp32, (times 1 + scale, plus shift: (B, C)
    fp32), rounded to x's type, then silu as the TPU kernel takes it (the
    fp32 sigmoid rounded to x's type, the product in x's type).  ``stats``:
    (mu, rstd) to use instead of ``group_stats_plain``'s."""
    b, c, _ = x.shape
    mu, rstd = stats if stats is not None else group_stats_plain(x, groups,
                                                                 eps)
    per = c // groups
    mu = mu.float().reshape(b, groups, 1).repeat_interleave(per, dim=1)
    rstd = rstd.float().reshape(b, groups, 1).repeat_interleave(per, dim=1)
    yn = (x.float() - mu) * rstd * gamma.float()[:, None] \
        + beta.float()[:, None]
    if scale is not None:
        yn = yn * (1 + scale.float()[..., None]) + shift.float()[..., None]
    y = yn.to(x.dtype)
    if act:
        y = y * torch.sigmoid(y.float()).to(x.dtype)
    return y


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _vectors(*vs: torch.Tensor):
    """The per-channel vectors as the kernels read them: as stored where
    they share fp32 or bf16 (no conversion launched), else all in fp32;
    and the kernels' flag for their type."""
    dt = vs[0].dtype
    if dt not in _DTYPES or any(v.dtype != dt for v in vs):
        vs, dt = tuple(v.float() for v in vs), torch.float32
    return tuple(v.contiguous() for v in vs), _DTYPES[dt]


def _scratch(x: torch.Tensor, groups: int):
    """The kernels' scratch for x (B, C, T): in bf16 Y's time-major
    (B, T, C) buffer, and no statistics kept; in fp32 the statistics the
    GEMM's prologue reads.  Returns the buffer (alive across the launch)
    and the (statistics, Y) pointers."""
    b, c, t = x.shape
    if x.dtype == torch.bfloat16:
        buf = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
        return buf, (None, buf.data_ptr())
    buf = torch.empty(2 * b * groups, dtype=torch.float32, device=x.device)
    return buf, (buf.data_ptr(), None)


def _aligned(w: torch.Tensor) -> torch.Tensor:
    """w contiguous on a 16-byte boundary, as TMA reads it."""
    w = w.contiguous()
    return w if w.data_ptr() % 16 == 0 else w.clone()


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int, act: bool, eps: float = 1e-5,
                   emb: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """The bf16 path's normalise kernel alone: (Y (B, C, T), a view of the
    kernel's time-major scratch, and (mu, rstd)).  emb: (B, 2C) [scale |
    shift] or None.  A CPU tensor takes ``group_norm_act_plain`` and
    ``group_stats_plain``; on CUDA only bf16 has this kernel."""
    b, c, t = x.shape
    scale, shift = (None, None) if emb is None else (emb[:, :c].float(),
                                                     emb[:, c:].float())
    if x.device.type == "cpu":
        stats = group_stats_plain(x, groups, eps)
        return group_norm_act_plain(x, gamma, beta, groups, act, eps, scale,
                                    shift, stats), stats
    plan(b, c, t, c, groups, x.dtype, "group_norm_act")
    if x.dtype != torch.bfloat16:
        raise TypeError("group_norm_act: the normalise kernel is the bf16 "
                        f"path's, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    stats = torch.empty(2 * b * groups, dtype=torch.float32, device=x.device)
    (gamma, beta), vec_bf = _vectors(gamma, beta)
    (emb,), emb_bf = _vectors(emb) if emb is not None else ((None,), 0)
    NORMALISE.launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     None if emb is None else emb.data_ptr(), y.data_ptr(),
                     stats.data_ptr(), b, c, t, groups, int(act), eps,
                     vec_bf, emb_bf, _stream(x))
    return y.transpose(1, 2), (stats[:b * groups], stats[b * groups:])


def _launch(x, gamma, beta, w, bias, groups, act, eps):
    b, c, t = x.shape
    m = w.shape[0]
    bn = plan(b, c, t, m, groups, x.dtype)
    x = x.contiguous()
    w = _aligned(w.to(x.dtype).reshape(m, c))
    out = torch.empty((b, m, t), dtype=x.dtype, device=x.device)
    scratch, (stats, ybuf) = _scratch(x, groups)
    (gamma, beta, bias), vec_bf = _vectors(gamma, beta, bias)
    KERNEL.launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  w.data_ptr(), bias.data_ptr(), out.data_ptr(), stats, ybuf,
                  b, c, t, m, groups, int(act), eps, _DTYPES[x.dtype], vec_bf,
                  bn, _stream(x))
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
    return _GnConv.apply(x, norm["scale"], norm["bias"], conv["w"], bias,
                         groups, act, eps)
