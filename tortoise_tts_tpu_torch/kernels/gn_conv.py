"""K4: conv1x1(silu?(GroupNorm(x))) + b, the denoiser resblock's input
half (``act=True``) and every attention block's [GroupNorm + qkv conv]
head (``act=False``).

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_resblock.py``
``fused_gn_conv1x1`` (``_gn_conv_kernel``, ``_group_stats``).  The CUDA
source is ``csrc/resblock.cu``; its header gives the bound on an H100
and the design: a normalise kernel writes Y = act(GroupNorm(x)) once,
time-major, then a TMA-fed ``wgmma`` GEMM multiplies the weight by Y.  In
fp32 Y leaves as Y_hi (TF32) and Y_lo = Y - Y_hi, and the GEMM sums three
TF32 products a step (3xTF32: fp32 accuracy on the tensor cores), with K
split over a cluster where the output tiles are too few for the SMs.  The
TPU kernel's ``c % 128``/``t % 128`` guard and its block size knob are
Mosaic tiling limits: the CUDA kernels take ragged T and c_out and any C
that is a multiple of 8.

``gn_conv1x1`` runs the plain PyTorch version for CPU tensors and the
kernel for CUDA tensors (it raises on what the kernel does not take).
Where autograd records a CUDA call (``records_grad``) the call is a
``torch.autograd.Function``: the forward also writes each (batch,
group)'s mean and rstd, and the backward is a kernel of its own,
``KERNEL_BWD`` (``tts_resblock_bwd`` in ``csrc/resblock.cu``, one count a
call), which replaces no Pallas kernel: the JAX package's ``custom_vjp``
differentiates its XLA formulation (``arch.py:52-69``).  Its plain
version is ``gn_conv1x1_bwd_plain``, the gradients written out, with the
kernel's rounding points; ``bwd_plan`` is its launch.
``group_norm_act`` runs the normalise kernel
alone, for checks (``group_norm_split``: the fp32 kernel's Y_hi and
Y_lo); ``group_norm_act_plain`` is its plain version, and ``tf32_split``
of it the fp32 kernel's (Y_hi, Y_lo).  ``matmul_3xtf32`` is
the fp32 GEMM's arithmetic in plain PyTorch (the TF32 rounding emulated on
the bits).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

import torch.nn.functional as Fn

from ..models.common import Params, conv1d, group_norm, silu
from ._build import F, I, P, Kernel
from .flash_attention import records_grad

KERNEL = Kernel("resblock", "tts_gn_conv1x1",
                [P] * 9 + [I] * 6 + [F, I, I, I, I, P])
# K4's and K5's backward (one entry; ``ts_res_block`` has its own count)
BWD_ARGTYPES = [P] * 20 + [I] * 7 + [F] + [I] * 6 + [P]
KERNEL_BWD = Kernel("resblock", "tts_resblock_bwd", BWD_ARGTYPES)
# the normalise kernel alone; its launches are not K4's
NORMALISE = Kernel("resblock", "tts_group_norm_act",
                   [P] * 7 + [I] * 5 + [F, I, I, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # also: 1 = bf16 vectors
SMS = 132          # streaming multiprocessors of an H100 SXM
GEMM_ROWS = 128    # output channels a GEMM block
# fp32 (3xTF32) GEMM: its tile widths, the K step (channels), the K
# splits (clusters of 3, 5, 6 or 7 blocks ran slower than the next power
# of two on an H100), the fewest K steps a slice keeps, and the plan's
# cost model, in units of one time step's K step: a step of a block costs
# its tile width plus A_COST (the weight tile's load and split), a split
# block SPLIT_COST more (the cluster's sum), and the blocks run in waves
# of one an SM.  Fitted to ``tools/resblock_tiles.py`` on an H100 (every
# width and split at emb.process's heads and TTS(dtype="float32")'s
# denoiser: one wave of 96-120 blocks beat every grid of two waves).
F32_TILES = (64, 104, 128)
F32_K_STEP = 32
F32_SPLITS = (1, 2, 4, 8)
MIN_SLICE_STEPS = 4
A_COST = 32
SPLIT_COST = 600
# the fp32 backward's dW GEMM: rows of M a block (DWF_BN in resblock.cu)
DW_F32_ROWS = 64


class Plan(NamedTuple):
    """The GEMM's launch: ``bn`` time steps a block, ``split`` blocks (a
    cluster) sharing an output tile, each over a slice of K."""
    bn: int
    split: int


def _plan_f32(b: int, k: int, t: int, m: int) -> Plan:
    """The fp32 GEMM's tile width and K split for (B, K) x (K, T) -> M
    rows: the least modelled time (see ``A_COST``)."""
    steps = -(-k // F32_K_STEP)
    best = None
    for bn in F32_TILES:
        tiles = b * -(-m // GEMM_ROWS) * -(-t // bn)
        for split in F32_SPLITS:
            if split > 1 and steps // split < MIN_SLICE_STEPS:
                break
            waves = -(-tiles * split // SMS)
            cost = waves * (-(-steps // split) * (bn + A_COST)
                            + (SPLIT_COST if split > 1 else 0))
            key = (cost, split, bn)
            best = min(best, key) if best else key
    return Plan(best[2], best[1])


def plan(b: int, c: int, t: int, m: int, groups: int, dtype: torch.dtype,
         name: str = "gn_conv1x1", taps: int = 1) -> Plan:
    """Check the shapes of a call (B, C, T) -> (B, M, T) (``taps`` = 3:
    K5's k=3 convolution, K = 3C) against what the kernels take and return
    the GEMM's launch.  bf16: 128 time steps a block, or 64 where a grid
    of 128-wide blocks would fill less than half the SMs (the faster of
    the two at the denoiser's shapes on an H100,
    ``tools/resblock_tiles.py``), no split.  fp32: ``_plan_f32``.  Raises
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
    if dtype == torch.float32:
        return _plan_f32(b, taps * c, t, m)
    wide = b * -(-m // GEMM_ROWS) * -(-t // 128)
    return Plan(128 if 2 * wide > SMS else 64, 1)


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


def silu_grad(z: torch.Tensor) -> torch.Tensor:
    """d silu(z) / dz = sigmoid(z) (1 + z (1 - sigmoid(z)))."""
    sg = torch.sigmoid(z)
    return sg * (1 + z * (1 - sg))


def _normalised(x, gamma, beta, groups, stats):
    """x^ = (x - mu) rstd and n = gamma x^ + beta, fp32 (B, C, T)."""
    b, c, _ = x.shape
    per = c // groups
    mu, rstd = (v.float().reshape(b, groups, 1).repeat_interleave(per, dim=1)
                for v in stats)
    xh = (x.float() - mu) * rstd
    return xh, xh * gamma.float()[:, None] + beta.float()[:, None]


def _gn_backward(x, xh, dn, gamma, stats, groups):
    """GroupNorm's backward from dn = dL/dn (fp32, n = gamma x^ + beta):
    (dx, dgamma, dbeta) in fp32.  The channel sums take dn in fp32; dx
    takes dn rounded to x's type, as the kernels store it: dx = rstd
    (gamma dn - mean_g(gamma dn) - x^ mean_g(gamma dn x^))."""
    b, c, t = x.shape
    per = c // groups
    s1, s2 = dn.sum(2), (dn * xh).sum(2)                 # (B, C)
    gam = gamma.float()
    m1 = (gam * s1).reshape(b, groups, per, 1).sum(2, keepdim=True) / (per * t)
    m2 = (gam * s2).reshape(b, groups, per, 1).sum(2, keepdim=True) / (per * t)
    rstd = stats[1].float().reshape(b, groups, 1, 1)
    u = (gam[:, None] * dn.to(x.dtype).float()).reshape(b, groups, per, t)
    dx = rstd * (u - m1 - xh.reshape(b, groups, per, t) * m2)
    return dx.reshape(b, c, t), s2.sum(0), s1.sum(0)


def gn_conv1x1_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, g: torch.Tensor, groups: int,
                         act: bool, eps: float = 1e-5,
                         stats: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None):
    """The gradients of ``gn_conv1x1`` for the upstream g (B, M, T),
    written out as the kernel computes them: (dx, dgamma, dbeta, dw, db)
    in x's, gamma's, beta's, w's and bias's types.  With x^ = (x - mu)
    rstd and n = gamma x^ + beta (fp32, ``stats`` or the two-pass
    statistics), a = the normalise kernel's rounded Y (act: silu(n)):
    db = sum g, dW = sum_b g a^T, da = W^T g (w in x's type, sums in
    fp32), dn = da silu'(n) (act) or da, then ``_gn_backward``."""
    b, c, _ = x.shape
    m = w.shape[0]
    stats = stats if stats is not None else group_stats_plain(x, groups, eps)
    xh, n = _normalised(x, gamma, beta, groups, stats)
    a = group_norm_act_plain(x, gamma, beta, groups, act, eps, stats=stats)
    gf = g.float()
    wf = w.to(x.dtype).float().reshape(m, c)
    dw = torch.einsum("bmt,bct->mc", gf, a.float())
    dn = torch.einsum("mc,bmt->bct", wf, gf)
    if act:
        dn = dn * silu_grad(n)
    dx, dgamma, dbeta = _gn_backward(x, xh, dn, gamma, stats, groups)
    return (dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
            dw.reshape(w.shape).to(w.dtype), gf.sum((0, 2)).to(bias.dtype))


def ts_res_block_out_bwd_plain(h: torch.Tensor, emb_out: torch.Tensor,
                               gamma: torch.Tensor, beta: torch.Tensor,
                               w: torch.Tensor, bias: torch.Tensor,
                               g: torch.Tensor, groups: int,
                               eps: float = 1e-5,
                               stats: Optional[Tuple[torch.Tensor,
                                                     torch.Tensor]] = None):
    """The gradients of ``ts_res_block.ts_res_block_out`` for the upstream
    g (B, C, T), written out as the kernel computes them: (dh, demb,
    dgamma, dbeta, dw, db) in their inputs' types; dx is g itself.  With
    n as in ``gn_conv1x1_bwd_plain``, z = n (1 + scale) + shift and a the
    rounded silu(z): dW_s = sum_{b,t} g[:, t] a[:, t + s - 1]^T, da[:, t]
    = sum_s W_s^T g[:, t - s + 1] (zero padding), dz = da silu'(z), dn =
    dz (1 + scale), d(scale) = sum_t dz n, d(shift) = sum_t dz."""
    c, t = h.shape[1], h.shape[2]
    stats = stats if stats is not None else group_stats_plain(h, groups, eps)
    scale = emb_out[:, :c].float()[..., None]
    shift = emb_out[:, c:].float()[..., None]
    xh, n = _normalised(h, gamma, beta, groups, stats)
    z = n * (1 + scale) + shift
    a = group_norm_act_plain(h, gamma, beta, groups, True, eps,
                             emb_out[:, :c], emb_out[:, c:], stats)
    gf = g.float()
    wf = w.to(h.dtype).float()
    ap, gp = Fn.pad(a.float(), (1, 1)), Fn.pad(gf, (1, 1))
    dw = torch.stack([torch.einsum("bmt,bct->mc", gf, ap[..., s:s + t])
                      for s in range(3)], dim=2)
    da = sum(torch.einsum("mc,bmt->bct", wf[:, :, s], gp[..., 2 - s:2 - s + t])
             for s in range(3))
    dz = da * silu_grad(z)
    dn = dz * (1 + scale)
    demb = torch.cat([(dz * n).sum(2), dz.sum(2)], dim=1)
    dh, dgamma, dbeta = _gn_backward(h, xh, dn, gamma, stats, groups)
    return (dh.to(h.dtype), demb.to(emb_out.dtype), dgamma.to(gamma.dtype),
            dbeta.to(beta.dtype), dw.to(w.dtype),
            gf.sum((0, 2)).to(bias.dtype))


def tf32_split(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 y as (hi, lo): hi = y rounded to TF32 as ``cvt.rna.tf32.f32``
    rounds (to nearest, ties away from zero; the 13 low bits cleared, on
    the bits), lo = y - hi (exact)."""
    bits = y.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, y - hi


def _tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """a as the tensor cores read a TF32 operand: the 13 low bits
    ignored."""
    return (a.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def matmul_3xtf32(w: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """w @ y as the fp32 GEMM computes it: each operand split by
    ``tf32_split``, the lo parts read truncated to TF32, and W_lo Y_hi +
    W_hi Y_lo + W_hi Y_hi summed in fp32 (W_lo Y_lo dropped)."""
    wh, wl = tf32_split(w.float())
    yh, yl = tf32_split(y.float())
    return (torch.matmul(_tf32_trunc(wl), yh)
            + torch.matmul(wh, _tf32_trunc(yl)) + torch.matmul(wh, yh))


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


def _scratch(x: torch.Tensor) -> torch.Tensor:
    """The kernels' time-major scratch for x (B, C, T): Y (B, T, C) in
    bf16; Y_hi and Y_lo, (2, B, T, C), in fp32."""
    b, c, t = x.shape
    if x.dtype == torch.bfloat16:
        return torch.empty((1, b, t, c), dtype=x.dtype, device=x.device)
    return torch.empty((2, b, t, c), dtype=torch.float32, device=x.device)


def _ptrs(buf: torch.Tensor):
    """(Y or Y_hi, Y_lo or None) pointers of a ``_scratch`` buffer."""
    return buf[0].data_ptr(), buf[1].data_ptr() if len(buf) == 2 else None


def _aligned(w: torch.Tensor) -> torch.Tensor:
    """w contiguous on a 16-byte boundary, as TMA reads it."""
    w = w.contiguous()
    return w if w.data_ptr() % 16 == 0 else w.clone()


def _normalise(x, gamma, beta, groups, act, eps, emb):
    """Launches the normalise kernel alone on CUDA x: (its ``_scratch``
    buffer, (mu, rstd))."""
    b, c, t = x.shape
    plan(b, c, t, c, groups, x.dtype, "group_norm_act")
    x = x.contiguous()
    buf = _scratch(x)
    stats = torch.empty(2 * b * groups, dtype=torch.float32, device=x.device)
    (gamma, beta), vec_bf = _vectors(gamma, beta)
    (emb,), emb_bf = _vectors(emb) if emb is not None else ((None,), 0)
    NORMALISE.launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                     None if emb is None else emb.data_ptr(), *_ptrs(buf),
                     stats.data_ptr(), b, c, t, groups, int(act), eps,
                     vec_bf, emb_bf, _DTYPES[x.dtype], _stream(x))
    return buf, (stats[:b * groups], stats[b * groups:])


def _plain_normalise(x, gamma, beta, groups, act, eps, emb):
    c = x.shape[1]
    scale, shift = (None, None) if emb is None else (emb[:, :c].float(),
                                                     emb[:, c:].float())
    stats = group_stats_plain(x, groups, eps)
    return group_norm_act_plain(x, gamma, beta, groups, act, eps, scale,
                                shift, stats), stats


def group_norm_act(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int, act: bool, eps: float = 1e-5,
                   emb: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor,
                                                  torch.Tensor]]:
    """The normalise kernel alone: (Y (B, C, T), a view of the kernel's
    time-major scratch (fp32: Y_hi + Y_lo, which is Y exactly), and (mu,
    rstd)).  emb: (B, 2C) [scale | shift] or None.  A CPU tensor takes
    ``group_norm_act_plain`` and ``group_stats_plain``."""
    if x.device.type == "cpu":
        return _plain_normalise(x, gamma, beta, groups, act, eps, emb)
    buf, stats = _normalise(x, gamma, beta, groups, act, eps, emb)
    y = buf[0] if len(buf) == 1 else buf[0] + buf[1]
    return y.transpose(1, 2), stats


def group_norm_split(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, groups: int, act: bool,
                     eps: float = 1e-5, emb: Optional[torch.Tensor] = None
                     ) -> Tuple[Tuple[torch.Tensor, torch.Tensor],
                                Tuple[torch.Tensor, torch.Tensor]]:
    """The fp32 normalise kernel alone: ((Y_hi, Y_lo), (mu, rstd)), Y_hi
    and Y_lo (B, C, T) views of its two time-major arrays, for checks.  A
    CPU tensor takes ``tf32_split`` of ``group_norm_act_plain``."""
    if x.dtype != torch.float32:
        raise TypeError(f"group_norm_split: fp32 only, got {x.dtype}")
    if x.device.type == "cpu":
        y, stats = _plain_normalise(x, gamma, beta, groups, act, eps, emb)
        return tf32_split(y), stats
    buf, stats = _normalise(x, gamma, beta, groups, act, eps, emb)
    return (buf[0].transpose(1, 2), buf[1].transpose(1, 2)), stats


class BwdPlan(NamedTuple):
    """The backward's launch: ``bn`` time steps a block of the da GEMM,
    ``split`` K slices (of the B * T reduction) a dW tile, and
    ``transpose``: whether the upstream goes time-major first
    (``bwd_transpose``) or the GEMMs read it as it comes."""
    bn: int
    split: int
    transpose: bool = True


def bwd_plan(b: int, c: int, t: int, m: int, groups: int, taps: int,
             dtype: torch.dtype) -> BwdPlan:
    """Check a backward (B, C, T) -> (B, M, T) (``taps`` = 3: K5) against
    what its kernels take, as ``plan``, and M % 8 == 0 (the time-major
    upstream's rows are read in 16-byte pieces), and return its launch.
    bf16: da's tile width by ``plan``'s rule over its C x T outputs; dW's
    split the least waves of 128 x 128 tiles (one block an SM) times the
    64-step K steps a slice.  fp32 (3xTF32): da's tile 128 steps where the
    128 x 128 tiles fill the SMs, else 64; dW's split the least waves of
    128 x 64 tiles times the 32-step K steps a slice.  bf16's da tile: 64
    steps (two blocks an SM, one's epilogue beside the other's products)
    where the reduction taps * M is at most 1024 or where 128-step blocks
    would fill less than half the SMs, else 128 (at (16, 1024, 2240) on
    an H100: 0.255 against 0.320 ms for K4 -> 1024; 0.564 against 0.500
    ms for the qkv head, ``tools/resblock_backward_profile.py``); K5's
    (three taps) always 128: its da is ``bwd_da_pingpong``, whose
    warpgroups each take whole 128 x 128 tiles in turn.  The
    upstream goes time-major first (``transpose``) where K5's three taps
    shift it along an outer TMA coordinate, in fp32 (split into TF32 hi
    and lo parts, time-major and as it comes, ``bwd_upstream_floats``),
    and where T % 8 != 0 (g's rows off 16 bytes, which TMA cannot read);
    K4 in bf16 at T % 8 == 0 reads it as it comes."""
    plan(b, c, t, m, groups, dtype, "resblock backward", taps)
    if m % 8:
        raise ValueError(f"resblock backward kernel needs M % 8 == 0, got "
                         f"M={m}")
    wide = b * -(-c // GEMM_ROWS) * -(-t // 128)
    if dtype == torch.float32:
        tiles = taps * -(-m // DW_F32_ROWS) * -(-c // GEMM_ROWS)
        return BwdPlan(128 if wide >= SMS else 64,
                       _dw_split(tiles, b * -(-t // F32_K_STEP)))
    tiles = taps * -(-m // 128) * -(-c // 128)
    wide_bn = taps == 3 or (2 * wide > SMS and taps * m > 1024)
    return BwdPlan(128 if wide_bn else 64,
                   _dw_split(tiles, b * -(-t // 64)), taps != 1 or t % 8 != 0)


def _dw_split(tiles: int, kt: int) -> int:
    """dW's K slices: the fewest waves of ``tiles`` output tiles (one
    block an SM) times the ``kt`` K steps a slice, 1 to 8."""
    return min(range(1, min(8, kt) + 1),
               key=lambda s: (-(-tiles * s // SMS) * -(-kt // s), s))


def bwd_upstream_floats(b: int, m: int, t: int) -> int:
    """The fp32 backward's split upstream (``bwd_split_upstream``): g's
    TF32 hi and lo parts time-major, (B, T, M) each, then as it comes, (B,
    M, Tp) each with Tp = T rounded up to 4."""
    return 2 * b * t * m + 2 * b * m * -(-t // 4) * 4


def _launch(x, gamma, beta, w, bias, groups, act, eps, with_stats=False):
    """K4 on CUDA x: (out, (B * G * 2,) fp32 mu then rstd where
    ``with_stats``, else None: the kernel writes no statistics)."""
    b, c, t = x.shape
    m = w.shape[0]
    p = plan(b, c, t, m, groups, x.dtype)
    x = x.contiguous()
    w = _aligned(w.to(x.dtype).reshape(m, c))
    out = torch.empty((b, m, t), dtype=x.dtype, device=x.device)
    stats = (torch.empty(2 * b * groups, dtype=torch.float32, device=x.device)
             if with_stats else None)
    buf = _scratch(x)
    (gamma, beta, bias), vec_bf = _vectors(gamma, beta, bias)
    KERNEL.launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  stats.data_ptr() if with_stats else None,
                  *_ptrs(buf), b, c, t, m, groups, int(act), eps,
                  _DTYPES[x.dtype], vec_bf, p.bn, p.split, _stream(x))
    return out, stats


def _launch_bwd(kernel, x, gamma, beta, bias, wb, g, stats, groups, act,
                eps, emb=None):
    """K4's (emb None) or K5's backward on CUDA x: (dx, dgamma, dbeta, dw,
    db, demb).  wb: ``tts_resblock_bwd``'s weight, (taps, C, M): K4's W^T,
    K5's reversed taps W[:, :, 2 - s]^T in fp32; K5 in bf16 takes the
    forward's tap-major weight instead, (3, M, C), w_taps[s] = W[:, :, s],
    that ``bwd_da_pingpong`` reads transposed.  stats: the forward's.  dw
    comes flat in the weight's layout, in x's type; dgamma, dbeta and db
    in ``_vectors``' type; demb in emb's (or None)."""
    b, c, t = x.shape
    wtaps = wb.shape[0] == 3 and x.dtype == torch.bfloat16
    taps, m = wb.shape[0], wb.shape[1 if wtaps else 2]
    p = bwd_plan(b, c, t, m, groups, taps, x.dtype)
    if g.shape != (b, m, t) or g.dtype != x.dtype \
            or wb.shape != ((taps, m, c) if wtaps else (taps, c, m)) \
            or wb.dtype != x.dtype \
            or stats is None or stats.shape != (2 * b * groups,):
        raise ValueError(f"resblock backward: upstream {tuple(g.shape)} "
                         f"{g.dtype}, weight {tuple(wb.shape)} {wb.dtype} "
                         f"and the forward's statistics must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    x, g, wb = x.contiguous(), _aligned(g), _aligned(wb)
    f32 = dict(dtype=torch.float32, device=x.device)
    ybuf = torch.empty((b, t, c), dtype=x.dtype, device=x.device)
    gt = (None if not p.transpose else
          torch.empty(bwd_upstream_floats(b, m, t), **f32)
          if x.dtype == torch.float32 else
          torch.empty((b, t, m), dtype=x.dtype, device=x.device))
    dn = torch.empty_like(x)
    part = torch.empty((b, -(-t // p.bn), 2 if emb is None else 4, c), **f32)
    dbp = torch.empty((b, -(-t // 64), m) if p.transpose else (p.split, m),
                      **f32)
    wpart = torch.empty((p.split, taps, m, c), **f32)
    sgb = torch.empty((b, 2, c), **f32)
    (gamma, beta, bias), vec_bf = _vectors(gamma, beta, bias)
    (emb,), emb_bf = _vectors(emb) if emb is not None else ((None,), 0)
    dx = torch.empty_like(x)
    dw = torch.empty(taps * m * c, dtype=x.dtype, device=x.device)
    dgamma, dbeta = torch.empty_like(gamma), torch.empty_like(beta)
    db = torch.empty_like(bias)
    demb = torch.empty_like(emb) if emb is not None else None
    kernel.launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  None if emb is None else emb.data_ptr(), wb.data_ptr(),
                  g.data_ptr(), stats.data_ptr(), ybuf.data_ptr(),
                  None if gt is None else gt.data_ptr(), dn.data_ptr(),
                  part.data_ptr(), dbp.data_ptr(),
                  wpart.data_ptr(), sgb.data_ptr(), dx.data_ptr(),
                  dw.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                  db.data_ptr(), None if demb is None else demb.data_ptr(),
                  b, c, t, m, groups, taps, int(act), eps, _DTYPES[x.dtype],
                  vec_bf, emb_bf, p.bn, p.split, int(not p.transpose),
                  _stream(x))
    return dx, dgamma, dbeta, dw, db, demb


class _GnConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, groups, act, eps):
        out, stats = _launch(x, gamma, beta, w, bias, groups, act, eps,
                             with_stats=True)
        ctx.save_for_backward(x, gamma, beta, w, bias, stats)
        ctx.cfg = (groups, act, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta, w, bias, stats = ctx.saved_tensors
        groups, act, eps = ctx.cfg
        m, c = w.shape[0], x.shape[1]
        wb = w.to(x.dtype).reshape(m, c).t().contiguous()[None]
        dx, dga, dbe, dw, db, _ = _launch_bwd(KERNEL_BWD, x, gamma, beta,
                                              bias, wb, g, stats, groups,
                                              act, eps)
        return (dx, dga.to(gamma.dtype), dbe.to(beta.dtype),
                dw.view(w.shape).to(w.dtype), db.to(bias.dtype), None, None,
                None)


def _cuda_call(x, norm, conv, groups, act, eps):
    """K4 on a CUDA x: the autograd Function where autograd records the
    call (the forward then keeps the statistics), else the kernel alone."""
    m = conv["w"].shape[0]
    bias = conv["b"] if "b" in conv else torch.zeros(m, device=x.device)
    args = (x, norm["scale"], norm["bias"], conv["w"], bias)
    if records_grad(*args):
        return _GnConv.apply(*args, groups, act, eps)
    return _launch(*args, groups, act, eps)[0]


def gn_conv1x1(x: torch.Tensor, norm: Params, conv: Params, groups: int,
               act: bool, eps: float = 1e-5) -> torch.Tensor:
    """conv1x1(silu?(GroupNorm(x))) + b.  x: (B, C, T); norm: {'scale',
    'bias'} (C,); conv: {'w' (M, C, 1), 'b' (M,)} -> (B, M, T) in x's
    type."""
    if x.device.type == "cpu":
        return gn_conv1x1_plain(x, norm, conv, groups, act, eps)
    if x.device.type != "cuda":
        raise ValueError(f"gn_conv1x1: no kernel for {x.device}")
    return _cuda_call(x, norm, conv, groups, act, eps)
