"""K3: flash decoding for the UnifiedVoice decode step.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_decode_attn.py``
``flash_decode_stacked`` (``_fd_kernel``), opt-in there and the default
decode attention of the port on CUDA.  The CUDA source is
``csrc/flash_decode.cu``; its header gives the bound on an H100 and the
design: one ``fd_cluster`` launch a call, whose grid (``plan``) depends on
the cache's size and not on ``pos``.  The TPU kernel took the whole
``(L, B, H, S, Dh)`` cache and a layer index; here the caller passes the
layer's view.  It needed S padded to a multiple of 128; this kernel masks
the ragged end itself, so the cache has one layout with no pad gap.

``pos`` is a host ``int`` or, as the TPU kernel takes it by scalar
prefetch, a 0-d int32 tensor on the query's device, read by the kernel
(clamped to the cache there; the host int is checked here).  The eager
decode passes the int.

``flash_decode_shared`` is the second entry of the same kernel, for the
candidate fan-out's shared-prefix decode (the JAX package's
``_mha_shared``, ``models/unified_voice.py``): rows of one group share a
prefix K/V held once per group beside each row's decode region, and one
merge takes the joint softmax over both.

Both wrappers run the plain PyTorch version for CPU tensors and the
kernel for CUDA tensors (they raise on what the kernel does not take).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from ..ops.attention import NEG_INF, mha
from ._build import F, I, LL, P, Kernel

KERNEL = Kernel("flash_decode", "tts_flash_decode",
                [P, LL, LL, P, P, P] + [I] * 4 + [P, I, I, I, F, P, I, P])
KERNEL_SHARED = Kernel("flash_decode", "tts_flash_decode_shared",
                       [P, LL, LL, P, P, P, I, I, P, P] + [I] * 4
                       + [P, I, I, I, F, P, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132           # streaming multiprocessors of an H100 SXM
SPLIT_MAX = 8       # blocks a cluster (the portable cluster size)
MIN_SLOTS = 16      # a block's run is split no finer
STEP = 8            # slots a warp step
WARPS = 8           # warps a block
RING_STEPS = 2      # steps a warp keeps in flight (its ring of buffers)


def plan(rows: int, h: int, slots: int) -> Tuple[int, int, int]:
    """Launch plan for ``rows`` x ``h`` (row, head) pairs over ``slots``
    cache slots (the prefix's and the region's together for the shared
    form): (split, chunk, nbuf).  ``split`` blocks of a (row, head) form a
    cluster: doubled while the grid still fits the SMs (so 16 row-heads
    take 8 blocks each and 128 or more take one) and each block keeps
    MIN_SLOTS slots or more; ``chunk`` slots a block (each block has one
    when pos is the last slot); ``nbuf`` steps in flight a warp, RING_STEPS
    or fewer (more in flight only queue behind each other in the copy
    engine while the warp could compute).  None of it depends on
    ``pos``."""
    split = 1
    while split < SPLIT_MAX and 2 * split * rows * h <= SMS \
            and slots >= 2 * split * MIN_SLOTS:
        split *= 2
    chunk = -(-slots // split)
    return split, chunk, min(-(-chunk // (STEP * WARPS)), RING_STEPS)


Pos = Union[int, torch.Tensor]


def flash_decode_plain(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                       pos: Pos, key_mask: torch.Tensor) -> torch.Tensor:
    """q: (B, H, Dh); ck, cv: (B, H, S, Dh); key_mask: (B, S) bool; pos
    an int or a 0-d integer tensor.  Attends to the slots j <= pos whose
    mask is set -> (B, H, Dh)."""
    s = ck.shape[2]
    valid = key_mask & (torch.arange(s, device=q.device) <= pos)[None]
    return mha(q[:, :, None], ck, cv, mask=valid[:, None, None, :])[:, :, 0]


def flash_decode_shared_plain(q: torch.Tensor, kp: torch.Tensor,
                              vp: torch.Tensor, prefix_mask: torch.Tensor,
                              kd: torch.Tensor, vd: torch.Tensor, pos: Pos
                              ) -> torch.Tensor:
    """The JAX package's grouped ``_mha_shared``: q (B=G*C, H, Dh), row
    b in group b // C; kp, vp: (G, H, Sp, Dh) prefix; prefix_mask (G, Sp)
    bool; kd, vd: (B, H, Sd, Dh) decode region, valid up to ``pos`` (an
    int or a 0-d integer tensor).  Two
    partial fp32 dot products, one joint softmax, fp32 accumulation of
    the two partial AV products -> (B, H, Dh)."""
    g, sp = prefix_mask.shape
    b, h, dh = q.shape
    c = b // g
    qg = q.reshape(g, c, h, dh).float()
    dp = torch.einsum("gchd,ghkd->gchk", qg, kp.float())
    dd = torch.einsum("gchd,gchkd->gchk", qg,
                      kd.reshape(g, c, h, -1, dh).float())
    dots = torch.cat([dp, dd], dim=-1) * (1.0 / math.sqrt(dh))
    valid = torch.cat([prefix_mask, (torch.arange(
        kd.shape[2], device=q.device) <= pos)[None].expand(g, -1)], dim=1)
    dots = dots.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(dots, dim=-1).to(q.dtype).float()
    out = (torch.einsum("gchk,ghkd->gchd", w[..., :sp], vp.float())
           + torch.einsum("gchk,gchkd->gchd", w[..., sp:],
                          vd.reshape(g, c, h, -1, dh).float()))
    return out.reshape(b, h, dh).to(q.dtype)


def _check_q(q, name):
    b, h, dh = q.shape
    if dh != 64 or q.stride(-1) != 1:
        raise ValueError(f"{name} kernel takes head dim 64 with a unit "
                         f"stride, got {tuple(q.shape)} {q.stride()}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    elems = 16 // q.element_size()
    if q.data_ptr() % 16 or q.stride(0) % elems or q.stride(1) % elems:
        raise ValueError(f"{name} kernel reads q rows by 16-byte loads: "
                         f"they must be 16-byte aligned")


def _check_cache(q, rows, tensors, name):
    _, h, dh = q.shape
    s = tensors[0].shape[2]
    for t in tensors:
        if t.shape != (rows, h, s, dh) or not t.is_contiguous() \
                or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: cache must be contiguous "
                             f"({rows}, {h}, S, {dh}) {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: cache must be 16-byte aligned (the "
                             f"kernel copies 16-byte chunks)")
    return s


def _check_mask(mask, rows, s, device, name):
    if mask.shape != (rows, s) or mask.dtype != torch.bool \
            or mask.device != device:
        raise ValueError(f"{name}: mask must be bool ({rows}, {s}) on "
                         f"{device}")
    return mask.contiguous().view(torch.uint8)


def _pos_args(pos, s, device, name):
    """(int, pointer) kernel arguments of ``pos``: a host int checked
    against the S slots, or a 0-d int32 tensor on the device, read by the
    kernel."""
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int32 \
                or pos.device != device:
            raise ValueError(f"{name}: a tensor pos must be a 0-d int32 "
                             f"tensor on {device}, got {tuple(pos.shape)} "
                             f"{pos.dtype} on {pos.device}")
        return 0, pos.data_ptr()
    if not 0 <= pos < s:
        raise ValueError(f"pos {pos} outside the cache of {s} slots")
    return int(pos), None


def _launch(q, ck, cv, pos, key_mask):
    _check_q(q, "flash_decode")
    b, h, dh = q.shape
    s = _check_cache(q, b, (ck, cv), "flash_decode")
    mask = _check_mask(key_mask, b, s, q.device, "flash_decode")
    pos_i, pos_p = _pos_args(pos, s, q.device, "flash_decode")
    split, chunk, nbuf = plan(b, h, s)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    KERNEL.launch(q.data_ptr(), q.stride(0), q.stride(1), ck.data_ptr(),
                  cv.data_ptr(), mask.data_ptr(), b, h, s, pos_i, pos_p,
                  split, chunk, nbuf, 1.0 / math.sqrt(dh), out.data_ptr(),
                  _DTYPES[q.dtype],
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out


def _launch_shared(q, kp, vp, prefix_mask, kd, vd, pos):
    name = "flash_decode_shared"
    _check_q(q, name)
    b, h, dh = q.shape
    g = kp.shape[0]
    if g == 0 or b % g:
        raise ValueError(f"{name}: {b} rows do not split into {g} groups")
    sp = _check_cache(q, g, (kp, vp), name)
    sd = _check_cache(q, b, (kd, vd), name)
    pmask = _check_mask(prefix_mask, g, sp, q.device, name)
    pos_i, pos_p = _pos_args(pos, sd, q.device, name)
    split, chunk, nbuf = plan(b, h, sp + sd)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    KERNEL_SHARED.launch(
        q.data_ptr(), q.stride(0), q.stride(1), kp.data_ptr(), vp.data_ptr(),
        pmask.data_ptr(), sp, b // g, kd.data_ptr(), vd.data_ptr(), b, h, sd,
        pos_i, pos_p, split, chunk, nbuf, 1.0 / math.sqrt(dh),
        out.data_ptr(), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


def flash_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 pos: Pos, key_mask: torch.Tensor) -> torch.Tensor:
    """Decode attention of one layer (see flash_decode_plain); ``pos``,
    the slot the current step wrote, is a host int or a 0-d int32 tensor
    on q's device."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, ck, cv, pos, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for {q.device}")
    return _launch(q, ck, cv, pos, key_mask)


def flash_decode_shared(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        prefix_mask: torch.Tensor, kd: torch.Tensor,
                        vd: torch.Tensor, pos: Pos) -> torch.Tensor:
    """Decode attention of one layer over a shared per-group prefix and
    each row's region (see flash_decode_shared_plain); ``pos``, the region
    slot the current step wrote, is a host int or a 0-d int32 tensor on
    q's device."""
    if q.device.type == "cpu":
        return flash_decode_shared_plain(q, kp, vp, prefix_mask, kd, vd, pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_shared: no kernel for {q.device}")
    return _launch_shared(q, kp, vp, prefix_mask, kd, vd, pos)
