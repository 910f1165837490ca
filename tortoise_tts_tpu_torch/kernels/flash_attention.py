"""K1: causal flash attention for the UnifiedVoice trunk (the AR prefill
and the latent pass).

Replaces the TPU kernel ``tortoise_tts_tpu/ops/pallas_attention.py``
``flash_attention`` (``_attn_kernel``).  The CUDA source is
``csrc/flash_attention.cu``; its header gives the bound on an H100 and
the design: in bf16 one ``flash_attn_mma`` launch (tensor cores,
``mma.sync``), in fp32 one ``flash_attn_f32`` launch (tensor cores in
3xTF32 on ``wgmma``: persistent, TMA-fed, the TF32 splits made in shared
memory).  ``plan`` is the bf16 kernel's launch plan, ``fwd_f32_plan``
the fp32 kernel's (``fwd_f32_items`` its work items in order), and
``flash_attention_3xtf32`` the fp32 kernel's arithmetic in plain
PyTorch.

``flash_attention`` runs the plain PyTorch version for CPU tensors (and
autograd of it) and the kernel for CUDA tensors (it raises on what the
kernel does not take).  On CUDA, when autograd records the call, it is a
``torch.autograd.Function`` whose forward also writes each row's
log-sum-exp and whose backward is K1's backward kernel
(``flash_attention_bwd``, ``csrc/flash_attention_bwd.cu``: two launches,
one count on ``KERNEL_BWD``).  That kernel replaces no Pallas kernel: it
computes what the JAX package's ``custom_vjp`` backward
(``unified_voice.py:44-64``, XLA's ``jax.vjp`` of ``mha``) computes.  Its
bound on an H100 at the AR steps' shapes is the five S x S products of
the causal half or the bytes of q, k, v, dO, dq, dk, dv (0.050 ms of
operations, 0.053 of bytes at (16, 16, 773, 64)); in bf16 its two kernels
are warp-specialised and persistent, TMA-fed, every product on ``wgmma``
(the source's header), launched by ``bwd_plan``; in fp32 the same two
on ``wgmma`` in 3xTF32 (hi and lo TF32 parts of every operand, three
products summed), after ``bwd_split_f32`` writes the split operands as
the products read them, three launches and one count a call.
A call under ``no_grad`` or ``inference_mode``, as every serving route
makes it, writes no log-sum-exp.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..ops.attention import NEG_INF, mha
from ._build import F, I, LL, P, Kernel

KERNEL = Kernel("flash_attention", "tts_flash_attention_fwd",
                [P] * 6 + [I] * 4 + [LL] * 12 + [I, F, I, I, I, I, I, P])
KERNEL_BWD = Kernel("flash_attention_bwd", "tts_flash_attention_bwd",
                    [P] * 11 + [I] * 4 + [LL] * 21 + [I, F, I, P])
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132           # streaming multiprocessors of an H100 SXM
KEY_TILE = 64       # keys a shared-memory tile (KT in the source)
MAX_TILES = 8       # key tiles resident at once: 8 x 16 KB of K and V
MAX_WAVES = 3       # blocks an SM that a key split may cost (see plan)
SMEM_MAX = 232448   # dynamic shared memory a block may use on an H100
MERGE_BYTES = 4 * 36 * 32 * 4   # 4 warps' partial softmax states
BWD_TILE = 64       # rows a streamed tile of the bf16 backward (BT)
BWD_ROWS = 128      # resident rows a work item: two warpgroups' (RT)
BWD_F32_TILE = 32   # rows a streamed tile of the fp32 backward (FT)
BWD_F32_ROWS = 64   # resident rows a work item: one warpgroup's (FR)
BWD_F32_ARRAYS = 14  # the fp32 split operands: 8 as they come, 6 transposed
FWD_F32_TILE = 64   # queries a work item and keys a step of the fp32 forward
FWD_F32_BLOCKS = 2  # its blocks an SM (96 KB of shared memory each)
FWD_F32_ROUNDS = 4  # items a block up to which it takes the heaviest first


def plan(b: int, h: int, s: int) -> Tuple[int, int, int]:
    """Launch plan of the bf16 kernel for (B, H, S): (wk, query blocks a
    (batch, head), key-tile buffers).  A block is 4 warps; ``wk`` of them
    (4, 2 or 1) share the keys of one 16-query tile, so a block holds 4 /
    wk query tiles.  Splitting the keys shortens the heaviest (diagonal)
    block's chain of tiles, but every query block loads its own K/V prefix:
    ``wk`` is the widest split whose grid stays within MAX_WAVES blocks an
    SM (the prefill and latent pass at B=1 split 4 ways, the batch's
    prefill 2, its latent pass not; ``tools/attention_profile.py``'s
    shapes).  Every key tile of the heaviest (last) query block stays
    resident up to MAX_TILES; beyond that they stream through a ring of
    MAX_TILES."""
    for wk in (4, 2, 1):
        tiles = -(-s // (16 * 4 // wk))
        if tiles * b * h <= MAX_WAVES * SMS:
            break
    return wk, tiles, min(-(-s // KEY_TILE), MAX_TILES)


def smem_bytes(s: int, nbuf: int, masked: bool) -> int:
    """Dynamic shared memory of a bf16 launch: nbuf K and V tiles (or the
    warps' partial states after the key loop, MERGE_BYTES), and the key
    mask's S bytes rounded up to 16."""
    tiles = max(2 * nbuf * KEY_TILE * 64 * 2, MERGE_BYTES)
    return tiles + (-(-s // 16) * 16 if masked else 0)


class FwdF32Plan(NamedTuple):
    """The fp32 forward's launch: ``items`` work items (one (batch,
    head)'s 64-query tile each), the persistent ``grid`` and the items'
    ``order`` (``fwd_f32_items``)."""
    items: int
    grid: int
    order: int


def fwd_f32_plan(b: int, h: int, s: int) -> FwdF32Plan:
    """FWD_F32_BLOCKS blocks an SM, never more blocks than work items;
    block i takes items i, i + grid, ... (``fwd_f32_items``).  The order
    is heaviest tiles first (1) where each block takes two to
    FWD_F32_ROUNDS items, so the last round is the light tiles'; else
    (batch, head)-major (0), whose blocks that run together read one
    (batch, head)'s K and V.  On an H100 (``tools/flash_backward_profile.py
    --fp32``, the chosen order first): (8, 16, 389) 0.0695-0.0697 against
    0.0772-0.0794 ms; (16, 16, 773) 0.3626-0.3631 against 0.3651-0.3678;
    (1, 16, 269) 0.0167 against 0.0171."""
    items = b * h * -(-s // FWD_F32_TILE)
    grid = min(items, FWD_F32_BLOCKS * SMS)
    return FwdF32Plan(items, grid,
                      int(grid < items <= FWD_F32_ROUNDS * grid))


def fwd_f32_items(b: int, h: int, s: int, causal: bool = True,
                  order: int = 0) -> List[Tuple[int, int, int]]:
    """The fp32 forward's work items in the kernel's order, as (64-query
    tile, (batch, head) index, key tiles walked): ``order`` 0 takes each
    (batch, head)'s tiles heaviest (last) first, one (batch, head) after
    another; 1 the last tiles of every (batch, head) first.  A causal item
    walks the key tiles 0 .. its own (the diagonal), else every one."""
    bh, nq = b * h, -(-s // FWD_F32_TILE)
    out = []
    for w in range(bh * nq):
        t, j = (nq - 1 - w % nq, w // nq) if order == 0 else \
            (nq - 1 - w // bh, w % bh)
        out.append((t, j, t + 1 if causal else nq))
    return out


class BwdPlan(NamedTuple):
    """The backward's launch: ``items`` work items a kernel (resident rows
    of one (batch, head): query rows in ``bwd_dq_*``, key rows in
    ``bwd_dkdv_*``; 128 in bf16, 64 in fp32) and both kernels' persistent
    grid."""
    items: int
    grid: int


def _bwd_rows(dtype: torch.dtype) -> Tuple[int, int]:
    """(resident rows a work item, rows a streamed tile) of the backward
    in ``dtype``."""
    if dtype == torch.bfloat16:
        return BWD_ROWS, BWD_TILE
    return BWD_F32_ROWS, BWD_F32_TILE


def bwd_plan(b: int, h: int, s: int, dtype: torch.dtype = torch.bfloat16
             ) -> BwdPlan:
    """One block an SM (bf16: two consumer warpgroups and a producer
    warpgroup, 384 threads at 168 registers; fp32: two consumer
    warpgroups and a producer warp with 162-194 KB of shared memory: one
    fits an SM), never more blocks than work items; block i takes items
    i, i + grid, ... of ``bwd_items``' order."""
    items = b * h * -(-s // _bwd_rows(dtype)[0])
    return BwdPlan(items, min(items, SMS))


def bwd_items(b: int, h: int, s: int, kind: str, causal: bool = True,
              dtype: torch.dtype = torch.bfloat16
              ) -> List[Tuple[int, int, int]]:
    """The backward's work items in the kernels' order, as (tile, (batch,
    head) index, streamed tiles), a tile of rows R and streamed tiles of
    R / 2 (bf16: 128 and 64; fp32: 64 and 32): ``kind`` "dq" takes the
    query tiles last first, streaming the key tiles up to the last
    resident row's diagonal (twice: Delta's pass, then dQ's); "dkdv" the
    key tiles first first, streaming the query tiles from the first
    resident row's diagonal down.  Heaviest first, for the blocks' round
    robin: in bf16 over all items, in fp32 within each (batch, head),
    which go in order (the blocks that run together then share their
    streamed tiles in L2)."""
    rows, tile = _bwd_rows(dtype)
    bh, nq, nt = b * h, -(-s // rows), -(-s // tile)
    out = []
    for w in range(bh * nq):
        i, j = (w // bh, w % bh) if dtype == torch.bfloat16 else \
            (w % nq, w // nq)
        t = nq - 1 - i if kind == "dq" else i
        if kind == "dq":
            n = 2 * (min(2 * t + 2, nt) if causal else nt)
        else:
            n = nt - (2 * t if causal else 0)
        out.append((t, j, n))
    return out


def bwd_rowdata_floats(b: int, h: int, s: int) -> int:
    """The backward's fp32 row-data scratch: each 64-row (bf16) or 32-row
    (fp32) query tile's LSE in base 2 and Delta."""
    return b * h * -(-s // BWD_TILE) * 2 * BWD_TILE


def bwd_split_floats(b: int, h: int, s: int) -> int:
    """The fp32 backward's split operands (``bwd_split_f32``): q, k, v and
    dO as TF32 hi and lo parts, rows as they come, and k, q and dO
    transposed, each (B*H, Sp, 64) floats with Sp = S rounded up to 64."""
    sp = -(-s // BWD_F32_ROWS) * BWD_F32_ROWS
    return BWD_F32_ARRAYS * b * h * sp * 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          key_mask: Optional[torch.Tensor] = None,
                          causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, S, D); key_mask: (B, S) bool, True = valid key."""
    mask = key_mask[:, None, None, :] if key_mask is not None else None
    return mha(q, k, v, mask=mask, causal=causal)


def _allowed(s: int, key_mask: Optional[torch.Tensor], causal: bool,
             device) -> Optional[torch.Tensor]:
    """Which (query, key) pairs attend, broadcastable to (B, H, S, S), or
    None for all."""
    ok = None
    if causal:
        ok = torch.ones(s, s, dtype=torch.bool, device=device).tril()
    if key_mask is not None:
        km = key_mask.to(torch.bool)[:, None, None, :]
        ok = km if ok is None else ok & km
    return ok


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              key_mask: Optional[torch.Tensor] = None,
                              causal: bool = True) -> torch.Tensor:
    """(B, H, S) fp32: each row's natural log-sum-exp of the scaled scores,
    a masked or causally excluded key at NEG_INF as ``mha`` sets it (what
    the kernel's forward writes for the backward)."""
    s = _scores(q, k)
    ok = _allowed(q.shape[2], key_mask, causal, q.device)
    if ok is not None:
        s = s.masked_fill(~ok, NEG_INF)
    return torch.logsumexp(s, dim=-1)


def flash_attention_3xtf32(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           key_mask: Optional[torch.Tensor] = None,
                           causal: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 kernel's arithmetic in plain PyTorch: for each 64-query
    tile, the 64-key steps up to its diagonal (causal) or all, each step's
    S = Q K^T and P V by ``gn_conv.matmul_3xtf32`` (three TF32 products of
    the operands' splits, lo lo dropped), P V summed apart and added to O
    in fp32, the online softmax in base 2 whose base moves only where a
    row's max passes it by 8.  q, k, v: (B, H, S, D) fp32; key_mask: (B,
    S) bool.  Returns (o, lse), lse the natural log-sum-exp (B, H, S)."""
    from .gn_conv import matmul_3xtf32   # gn_conv imports this module
    b, h, s, d = q.shape
    t = FWD_F32_TILE
    scale, log2e = 1.0 / math.sqrt(d), 1.0 / math.log(2.0)
    o = torch.empty_like(q)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    for q0 in range(0, s, t):
        qt = q[:, :, q0:q0 + t]
        rows = torch.arange(q0, q0 + qt.shape[2], device=q.device)
        acc = torch.zeros_like(qt)
        m = torch.full(qt.shape[:3], -math.inf, device=q.device)
        lsum = torch.zeros(qt.shape[:3], device=q.device)
        for k0 in range(0, min(q0 + t, s) if causal else s, t):
            kt, vt = k[:, :, k0:k0 + t], v[:, :, k0:k0 + t]
            x = matmul_3xtf32(qt, kt.transpose(-1, -2)) * scale
            keys = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            out = torch.zeros(x.shape[-2:], dtype=torch.bool,
                              device=q.device)
            if causal:
                out = keys[None, :] > rows[:, None]
            if key_mask is not None:
                out = out | ~key_mask.to(torch.bool)[:, None, None,
                                                     k0:k0 + t]
            x = x.masked_fill(out, NEG_INF)
            mx = x.amax(-1) * log2e
            new = torch.where(mx > m + 8, mx, m)
            alpha = torch.exp2(m - new)
            m = new
            p = torch.exp2(x * log2e - m[..., None])
            lsum = lsum * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + matmul_3xtf32(p, vt)
        o[:, :, q0:q0 + t] = acc / lsum[..., None]
        lse[:, :, q0:q0 + t] = (m + torch.log2(lsum)) * math.log(2.0)
    return o, lse


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lse: torch.Tensor,
                              do: torch.Tensor,
                              key_mask: Optional[torch.Tensor] = None,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernel's function in plain PyTorch, fp32 inside: with
    P = exp(S - LSE) (0 at a masked or causally excluded key), dP = dO
    V^T and Delta = rowsum(P dP) (autograd's softmax backward: rowsum(dO
    o) for the exact o), dV = P^T dO, dS = P (dP - Delta), dQ = scale dS
    K, dK = scale dS^T Q.  q, k, v, do: (B, H, S, D); lse: (B, H, S) fp32.
    Returns (dq, dk, dv) in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (t.float() for t in (q, k, v, do))
    p = torch.exp(_scores(q, k) - lse.float()[..., None])
    ok = _allowed(q.shape[2], key_mask, causal, q.device)
    if ok is not None:
        p = p.masked_fill(~ok, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", gf, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, gf)
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


def _aligned(t: torch.Tensor, elems: int) -> bool:
    """Base pointer and the three outer strides on ``elems`` elements."""
    return t.data_ptr() % (elems * t.element_size()) == 0 \
        and all(st % elems == 0 for st in t.stride()[:3])


def _check_qkv(name, q, tensors, key_mask):
    """Head dim 64, one dtype the kernel takes, one shape and device, a
    unit head-dim stride; returns the key mask as (B, S) uint8 or None."""
    b, h, s, d = q.shape
    if d != 64:
        raise ValueError(f"{name} kernel takes head dim 64, got {d}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name} kernel takes float32 or bfloat16 tensors "
                        f"of one type, got "
                        f"{[t.dtype for t in (q, *tensors)]}")
    for t in tensors:
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name}: q, k, v (and do) must share shape "
                             f"and device")
    if any(t.stride(-1) != 1 for t in (q, *tensors)):
        raise ValueError(f"{name}: the tensors need a unit head-dim stride")
    if key_mask is None:
        return None
    if key_mask.shape != (b, s) or key_mask.device != q.device:
        raise ValueError(f"key_mask must be ({b}, {s}) on {q.device}")
    return key_mask.to(torch.bool).contiguous().view(torch.uint8)


def _launch(q, k, v, key_mask, causal, with_lse=False):
    """The forward kernel: the output, a (B, H, S, D) view of (B, S, H, D)
    memory, and with ``with_lse`` each row's log-sum-exp (B, H, S) fp32
    (else None)."""
    mask = _check_qkv("flash_attention", q, (k, v), key_mask)
    b, h, s, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    # bf16: 16-byte copies of k and v rows, 4-byte reads of q; fp32: TMA
    # reads k and v (16-byte base and strides), q element by element
    kv_elems, q_elems = (8, 2) if bf16 else (4, 1)
    if not all(_aligned(t, kv_elems) for t in (k, v)) \
            or not _aligned(q, q_elems):
        raise ValueError(
            f"flash_attention kernel needs k, v rows aligned to "
            f"{kv_elems * q.element_size()} bytes and q to "
            f"{q_elems * q.element_size()} (base pointers and strides)")
    wk, tiles, nbuf = plan(b, h, s)
    f32 = fwd_f32_plan(b, h, s)
    if bf16 and smem_bytes(s, nbuf, mask is not None) > SMEM_MAX:
        raise ValueError(f"flash_attention kernel: S={s} key mask does not "
                         f"fit in shared memory")
    # (B, S, H, D) memory returned as a (B, H, S, D) view: the caller's
    # transpose back to (B, S, H*D) is then free
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  mask.data_ptr() if mask is not None else None,
                  out.data_ptr(), lse.data_ptr() if with_lse else None,
                  b, h, s, _DTYPES[q.dtype],
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], int(causal), 1.0 / math.sqrt(d),
                  wk, tiles, nbuf, f32.grid, f32.order,
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


def _launch_bwd(q, k, v, lse, do, key_mask, causal):
    mask = _check_qkv("flash_attention_bwd", q, (k, v, do), key_mask)
    b, h, s, d = q.shape
    if lse.dtype != torch.float32 or lse.shape != (b, h, s) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"({b}, {h}, {s}) float32 tensor on {q.device}")
    # bf16: 16-byte copies and loads of every row (fp32: bwd_split_f32
    # reads element by element)
    bf16 = q.dtype == torch.bfloat16
    elems = 8 if bf16 else 1
    if not all(_aligned(t, elems) for t in (q, k, v, do)):
        raise ValueError(
            f"flash_attention_bwd kernel needs q, k, v, do rows aligned "
            f"to {elems * q.element_size()} bytes (base pointers and "
            f"strides)")
    # (B, S, H, D) memory as (B, H, S, D) views, as the forward's output
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
                  .transpose(1, 2) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=q.device)
    rows = torch.empty(bwd_rowdata_floats(b, h, s), **f32)
    split = None if bf16 else torch.empty(bwd_split_floats(b, h, s), **f32)
    p = bwd_plan(b, h, s, q.dtype)
    KERNEL_BWD.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), rows.data_ptr(),
        None if split is None else split.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, s,
        _DTYPES[q.dtype],
        *(st for t in (q, k, v, do, dq, dk, dv) for st in t.stride()[:3]),
        int(causal), 1.0 / math.sqrt(d), p.grid,
        torch.cuda.current_stream(q.device).cuda_stream)
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor,
                        key_mask: Optional[torch.Tensor] = None,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_attention`` given its log-sum-exp (B, H, S)
    and the upstream gradient do, (B, H, S, D) as q, k, v.  CPU tensors:
    ``flash_attention_bwd_plain``; CUDA tensors: the backward kernel
    (raises on what it does not take)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, do, key_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    return _launch_bwd(q, k, v, lse, do, key_mask, causal)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, causal):
        out, lse = _launch(q, k, v, key_mask, causal, with_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.key_mask, ctx.causal = key_mask, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, lse = ctx.saved_tensors
        # autograd hands any layout: the kernel reads rows on 16 bytes
        if g.stride(-1) != 1 or not _aligned(g, 8):
            g = g.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, g, ctx.key_mask,
                                         ctx.causal)
        return dq, dk, dv, None, None


def records_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records a call on these inputs (not under
    ``no_grad`` or ``inference_mode``, and one of them requires grad)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q kᵀ/√D + key mask [+ causal]) v.  q, k, v: (B, H, S, D)
    -> (B, H, S, D); key_mask: (B, S) bool, True = valid key."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_mask, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if records_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, key_mask, causal)
    return _launch(q, k, v, key_mask, causal)[0]
