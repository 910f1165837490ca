"""K3: split-KV flash decoding for the UnifiedVoice decode step.

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_decode_attn.py``
``flash_decode_stacked`` (``_fd_kernel``), opt-in there and the default
decode attention of the port on CUDA.  The CUDA source is
``csrc/flash_decode.cu``; its header gives the bound on an H100 and the
design.  The TPU kernel took the whole ``(L, B, H, S, Dh)`` cache and a
layer index; here the caller passes the layer's view.  It needed S padded
to a multiple of 128; this kernel masks the ragged end itself, so the
cache has one layout with no pad gap.

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

import torch

from ..ops.attention import NEG_INF, mha
from ._build import F, I, LL, P, Kernel

KERNEL = Kernel("flash_decode", "tts_flash_decode",
                [P, LL, LL, P, P, P] + [I] * 5 + [F, P, P, I, P])
KERNEL_SHARED = Kernel("flash_decode", "tts_flash_decode_shared",
                       [P, LL, LL, P, P, P, I, I, P, P] + [I] * 5
                       + [F, P, P, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT = 32          # cache slots per block
_REC = 66           # partial record: 64 accumulators, max, sum


def flash_decode_plain(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                       pos: int, key_mask: torch.Tensor) -> torch.Tensor:
    """q: (B, H, Dh); ck, cv: (B, H, S, Dh); key_mask: (B, S) bool.
    Attends to the slots j <= pos whose mask is set -> (B, H, Dh)."""
    s = ck.shape[2]
    valid = key_mask & (torch.arange(s, device=q.device) <= pos)[None]
    return mha(q[:, :, None], ck, cv, mask=valid[:, None, None, :])[:, :, 0]


def flash_decode_shared_plain(q: torch.Tensor, kp: torch.Tensor,
                              vp: torch.Tensor, prefix_mask: torch.Tensor,
                              kd: torch.Tensor, vd: torch.Tensor, pos: int
                              ) -> torch.Tensor:
    """The JAX package's grouped ``_mha_shared``: q (B=G*C, H, Dh), row
    b in group b // C; kp, vp: (G, H, Sp, Dh) prefix; prefix_mask (G, Sp)
    bool; kd, vd: (B, H, Sd, Dh) decode region, valid up to ``pos``.  Two
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


def _check_cache(q, rows, tensors, name):
    _, h, dh = q.shape
    s = tensors[0].shape[2]
    for t in tensors:
        if t.shape != (rows, h, s, dh) or not t.is_contiguous() \
                or t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: cache must be contiguous "
                             f"({rows}, {h}, S, {dh}) {q.dtype} on "
                             f"{q.device}, got {tuple(t.shape)} {t.dtype}")
    return s


def _check_mask(mask, rows, s, device, name):
    if mask.shape != (rows, s) or mask.dtype != torch.bool \
            or mask.device != device:
        raise ValueError(f"{name}: mask must be bool ({rows}, {s}) on "
                         f"{device}")
    return mask.contiguous().view(torch.uint8)


def _launch(q, ck, cv, pos, key_mask):
    _check_q(q, "flash_decode")
    b, h, dh = q.shape
    s = _check_cache(q, b, (ck, cv), "flash_decode")
    mask = _check_mask(key_mask, b, s, q.device, "flash_decode")
    if not 0 <= pos < s:
        raise ValueError(f"pos {pos} outside the cache of {s} slots")
    nsplit = (pos + SPLIT) // SPLIT
    part = torch.empty((b * h, nsplit, _REC), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    KERNEL.launch(q.data_ptr(), q.stride(0), q.stride(1), ck.data_ptr(),
                  cv.data_ptr(), mask.data_ptr(), b, h, s, int(pos), SPLIT,
                  1.0 / math.sqrt(dh), part.data_ptr(), out.data_ptr(),
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
    if not 0 <= pos < sd:
        raise ValueError(f"pos {pos} outside the region of {sd} slots")
    nsplit = (sp + SPLIT - 1) // SPLIT + (pos + SPLIT) // SPLIT
    part = torch.empty((b * h, nsplit, _REC), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    KERNEL_SHARED.launch(
        q.data_ptr(), q.stride(0), q.stride(1), kp.data_ptr(), vp.data_ptr(),
        pmask.data_ptr(), sp, b // g, kd.data_ptr(), vd.data_ptr(), b, h, sd,
        int(pos), SPLIT, 1.0 / math.sqrt(dh), part.data_ptr(),
        out.data_ptr(), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    return out


def flash_decode(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 pos: int, key_mask: torch.Tensor) -> torch.Tensor:
    """Decode attention of one layer (see flash_decode_plain); ``pos`` is
    a host int, the slot the current step wrote."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, ck, cv, pos, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for {q.device}")
    return _launch(q, ck, cv, pos, key_mask)


def flash_decode_shared(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        prefix_mask: torch.Tensor, kd: torch.Tensor,
                        vd: torch.Tensor, pos: int) -> torch.Tensor:
    """Decode attention of one layer over a shared per-group prefix and
    each row's region (see flash_decode_shared_plain); ``pos`` is a host
    int, the region slot the current step wrote."""
    if q.device.type == "cpu":
        return flash_decode_shared_plain(q, kp, vp, prefix_mask, kd, vd, pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_shared: no kernel for {q.device}")
    return _launch_shared(q, kp, vp, prefix_mask, kd, vd, pos)
