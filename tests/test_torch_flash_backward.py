"""K1's backward on the CPU: ``flash_attention_bwd`` (its plain version
on CPU tensors) against the backward of the JAX package's trunk attention
``custom_vjp`` (``unified_voice._flash_trunk_bwd``: ``jax.vjp`` of
``_xla_trunk_attention``, i.e. of ``ops/attention.mha``), the plain
log-sum-exp against the JAX function's masked scores, and the plain
backward against autograd of ``flash_attention_plain``.

fp32 throughout, inputs and the upstream gradient from numpy with a seed.
Tolerance: |got - want| <= 1e-5 |want| + 1e-6 of the largest |gradient|
(of dq, dk and dv together: a row with one valid key, every row at S=1,
has a dq of exactly 0, which fp32 rounding leaves at 1e-7 of the rest) an
element: the same fp32 math, only the order of the sums and where the
softmax is normalised (exp(S - LSE) against exp(S - max) / sum) differ.
The CUDA kernel is held against the plain version on the card by
``tests/test_torch_cuda.py::test_flash_attention_backward_cuda`` and
``chip_smoke.py``'s ``train_grads``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models.unified_voice import _xla_trunk_attention
from tortoise_tts_tpu.ops.attention import NEG_INF
from tortoise_tts_tpu.ops.attention import mha as jax_mha
from tortoise_tts_tpu_torch.kernels import flash_attention as k1

RTOL, ATOL_OF_MAX = 1e-5, 1e-6
CASES = [(s, causal, holes) for s in (1, 17, 64, 65, 130)
         for causal in (True, False) for holes in (False, True)]


def _close(got, want, name, scale=None):
    """``scale``: the largest |value| the atol is a share of (default
    want's own)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = ATOL_OF_MAX * (np.abs(want).max() if scale is None else scale)
    bad = np.abs(got - want) > RTOL * np.abs(want) + atol
    assert not bad.any(), (name, float(np.abs(got - want).max()), atol)


def _inputs(s, holes, seed, b=2, h=2, d=64):
    """q, k, v, the upstream gradient and a key mask (None, or holes with
    key 0 valid, as the card tests make it)."""
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(4))
    mask = None
    if holes:
        mask = rng.rand(b, s) > 0.2
        mask[:, 0] = True
    return q, k, v, g, mask


def _jax_fn(mask, causal):
    """The JAX function whose vjp is the reference: the trunk's
    ``_xla_trunk_attention`` (causal) or the same ``mha`` without the
    causal test."""
    km = None if mask is None else jnp.asarray(mask)
    if causal:
        return lambda q, k, v: _xla_trunk_attention(q, k, v, km)
    m = None if km is None else km[:, None, None, :]
    return lambda q, k, v: jax_mha(q, k, v, mask=m, causal=False)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("s,causal,holes", CASES)
def test_backward_matches_jax_vjp(s, causal, holes):
    q, k, v, g, mask = _inputs(s, holes, seed=s)
    out, vjp = jax.vjp(_jax_fn(mask, causal), jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q), _t(k), _t(v)
    o = k1.flash_attention(tq, tk, tv, _t(mask), causal)
    _close(o.numpy(), out, "out")
    lse = k1.flash_attention_lse_plain(tq, tk, _t(mask), causal)
    got = k1.flash_attention_bwd(tq, tk, tv, lse, _t(g), _t(mask), causal)
    top = max(float(np.abs(w).max()) for w in want)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == tq.shape
        _close(a.numpy(), w, name, top)


@pytest.mark.parametrize("s,causal,holes", CASES)
def test_lse_plain_matches_jax_scores(s, causal, holes):
    """The plain log-sum-exp against jax.nn.logsumexp of the scores as the
    JAX ``mha`` masks them (NEG_INF at a masked or later key)."""
    q, k, _, _, mask = _inputs(s, holes, seed=100 + s)
    dots = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        dots = jnp.where(jnp.tril(jnp.ones((s, s), bool)), dots, NEG_INF)
    if mask is not None:
        dots = jnp.where(jnp.asarray(mask)[:, None, None, :], dots, NEG_INF)
    want = jax.nn.logsumexp(dots, axis=-1)
    got = k1.flash_attention_lse_plain(_t(q), _t(k), _t(mask), causal)
    assert got.dtype == torch.float32 and got.shape == q.shape[:3]
    _close(got.numpy(), want, "lse")


@pytest.mark.parametrize("s,causal,holes", CASES)
def test_backward_plain_matches_autograd(s, causal, holes):
    """The plain backward against torch autograd of flash_attention_plain
    on the same inputs and upstream gradient."""
    q, k, v, g, mask = _inputs(s, holes, seed=200 + s)
    xs = [_t(a).requires_grad_() for a in (q, k, v)]
    o = k1.flash_attention_plain(*xs, _t(mask), causal)
    want = torch.autograd.grad(o, xs, _t(g))
    lse = k1.flash_attention_lse_plain(_t(q), _t(k), _t(mask), causal)
    got = k1.flash_attention_bwd_plain(_t(q), _t(k), _t(v), lse, _t(g),
                                       _t(mask), causal)
    top = max(float(w.abs().max()) for w in want)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _close(a.numpy(), w.numpy(), name, top)


def test_backward_plain_of_strided_views_and_bf16():
    """q, k, v as views of one fused qkv (the trunk's layout) give the
    contiguous tensors' gradients; bf16 inputs give bf16 gradients, the
    fp32 computation rounded once."""
    q, k, v, g, mask = _inputs(33, True, seed=7)
    qkv = torch.from_numpy(np.concatenate(
        [a.transpose(0, 2, 1, 3) for a in (q, k, v)], axis=2).copy())
    views = qkv.split(2, dim=2)
    views = [t.transpose(1, 2) for t in views]
    assert not views[0].is_contiguous()
    lse = k1.flash_attention_lse_plain(_t(q), _t(k), _t(mask))
    want = k1.flash_attention_bwd(_t(q), _t(k), _t(v), lse, _t(g), _t(mask))
    got = k1.flash_attention_bwd(*views, lse, _t(g), _t(mask))
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    bf = [t.to(torch.bfloat16) for t in (_t(q), _t(k), _t(v), _t(g))]
    got = k1.flash_attention_bwd(*bf[:3], lse, bf[3], _t(mask))
    want = k1.flash_attention_bwd(*(t.float() for t in bf[:3]), lse,
                                  bf[3].float(), _t(mask))
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and torch.equal(a, w.bfloat16())


def test_records_grad_only_under_autograd():
    """The forward writes the log-sum-exp only for a call autograd records:
    never under no_grad or inference_mode, as every serving route runs."""
    x = torch.zeros(1, requires_grad=True)
    y = torch.zeros(1)
    assert k1.records_grad(y, x)
    assert not k1.records_grad(y, y)
    with torch.no_grad():
        assert not k1.records_grad(x)
    with torch.inference_mode():
        assert not k1.records_grad(x)


PLAN_SHAPES = [(16, 16, 773), (8, 16, 389), (2, 3, 17), (1, 2, 129),
               (1, 1, 64)]


@pytest.mark.parametrize("b,h,s", PLAN_SHAPES)
def test_bwd_plan_grid(b, h, s):
    """The bf16 backward's launch: a work item is 128 rows of one (batch,
    head), one block an SM and never more blocks than items (the C entry
    refuses a grid outside 1 .. items)."""
    p = k1.bwd_plan(b, h, s)
    assert p.items == b * h * -(-s // k1.BWD_ROWS)
    assert p.grid == min(p.items, k1.SMS)
    # the row-data scratch holds a 64-row tile's LSE2 and Delta each (the
    # fp32 kernels' 32-row tiles in the same floats: test_bwd_plan_grid_fp32)
    assert k1.bwd_rowdata_floats(b, h, s) == \
        b * h * -(-s // k1.BWD_TILE) * 2 * k1.BWD_TILE >= b * h * s


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["dq", "dkdv"])
@pytest.mark.parametrize("b,h,s", PLAN_SHAPES)
def test_bwd_items_cover_each_tile_once_heaviest_first(b, h, s, kind, causal):
    """Each (128-row tile, (batch, head)) is one work item; items go
    heaviest first (the blocks' round robin then ends evenly); each item
    streams every 64-row tile its rows attend to: dq's two warpgroups the
    key tiles up to the second one's diagonal (twice: Delta's pass, then
    dQ's), dkdv's the query tiles from the first one's diagonal down."""
    items = k1.bwd_items(b, h, s, kind, causal)
    nt = -(-s // k1.BWD_TILE)
    assert sorted((t, bh) for t, bh, _ in items) == sorted(
        (t, bh) for t in range(-(-s // k1.BWD_ROWS)) for bh in range(b * h))
    loads = [n for _, _, n in items]
    assert loads == sorted(loads, reverse=True)
    for t, _, n in items:
        for wg in range(2):
            first = 2 * t + wg          # the warpgroup's own 64-row tile
            if first >= nt:
                continue                # every row past S: nothing to do
            if kind == "dq":
                need = first + 1 if causal else nt
                assert n == 2 * min(2 * t + 2 if causal else nt, nt) \
                    and n // 2 >= need
            else:
                need = nt - first if causal else nt
                assert n == nt - (2 * t if causal else 0) and n >= need


@pytest.mark.parametrize("b,h,s", [(16, 16, 773), (8, 16, 389)])
def test_bwd_items_balance_the_blocks(b, h, s):
    """At the AR steps' shapes the blocks' round robin over the
    heaviest-first items gives no block more than 1.05x the mean of the
    streamed tiles."""
    p = k1.bwd_plan(b, h, s)
    for kind in ("dq", "dkdv"):
        loads = [0] * p.grid
        for w, (_, _, n) in enumerate(k1.bwd_items(b, h, s, kind)):
            loads[w % p.grid] += n
        assert max(loads) <= 1.05 * sum(loads) / p.grid, (kind, loads)


@pytest.mark.parametrize("b,h,s", PLAN_SHAPES)
def test_bwd_plan_grid_fp32(b, h, s):
    """The fp32 backward's launch: a work item is 64 rows of one (batch,
    head), one block an SM and never more blocks than items; its scratch:
    the row data of each 32-row query tile (LSE2 and Delta, 64 floats) in
    the bf16 buffer's size, and the 14 split arrays of (B*H, Sp, 64)
    floats, Sp = S rounded up to 64."""
    p = k1.bwd_plan(b, h, s, torch.float32)
    assert p.items == b * h * -(-s // k1.BWD_F32_ROWS)
    assert p.grid == min(p.items, k1.SMS)
    tiles = 2 * -(-s // k1.BWD_F32_ROWS)   # what bwd_dq_tf32 writes
    assert tiles * 2 * k1.BWD_F32_TILE * b * h == \
        k1.bwd_rowdata_floats(b, h, s)
    sp = -(-s // 64) * 64
    assert k1.bwd_split_floats(b, h, s) == 14 * b * h * sp * 64


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["dq", "dkdv"])
@pytest.mark.parametrize("b,h,s", PLAN_SHAPES)
def test_bwd_items_fp32_cover_each_tile_once(b, h, s, kind, causal):
    """fp32: each (64-row tile, (batch, head)) is one work item, the
    (batch, head)s in order and each one's items heaviest first; dq's
    streams the 32-key tiles up to its last row's diagonal (twice),
    dkdv's the 32-query tiles from its first row's diagonal down."""
    items = k1.bwd_items(b, h, s, kind, causal, torch.float32)
    nq, nt = -(-s // k1.BWD_F32_ROWS), -(-s // k1.BWD_F32_TILE)
    assert sorted((t, bh) for t, bh, _ in items) == sorted(
        (t, bh) for t in range(nq) for bh in range(b * h))
    assert [bh for _, bh, _ in items] == sorted(bh for _, bh, _ in items)
    for j in range(b * h):
        loads = [n for _, bh, n in items if bh == j]
        assert loads == sorted(loads, reverse=True)
    for t, _, n in items:
        first, last = 2 * t, min(2 * t + 1, nt - 1)   # its 32-row tiles
        if kind == "dq":
            assert n == 2 * (last + 1 if causal else nt)
        else:
            assert n == nt - (first if causal else 0)


@pytest.mark.parametrize("b,h,s", [(16, 16, 773), (8, 16, 389)])
def test_bwd_items_fp32_balance_the_blocks(b, h, s):
    """At the AR steps' shapes the fp32 blocks' round robin gives no block
    more than 1.05x the mean of the streamed tiles."""
    p = k1.bwd_plan(b, h, s, torch.float32)
    for kind in ("dq", "dkdv"):
        loads = [0] * p.grid
        for w, (_, _, n) in enumerate(k1.bwd_items(b, h, s, kind,
                                                   dtype=torch.float32)):
            loads[w % p.grid] += n
        assert max(loads) <= 1.05 * sum(loads) / p.grid, (kind, loads)


def _mm3(a, b):
    """a @ b as the 3xTF32 products sum it (``gn_conv.matmul_3xtf32``)."""
    from tortoise_tts_tpu_torch.kernels.gn_conv import matmul_3xtf32
    return matmul_3xtf32(a, b)


@pytest.mark.parametrize("s", [17, 130])
def test_bwd_3xtf32_arithmetic_holds_fp32(s):
    """The fp32 kernels' arithmetic in plain PyTorch: every product split
    in 3xTF32 (S, dP, then dQ, dK, dV over 32-row tiles, each tile's
    product summed apart and added in fp32) keeps the gradients within
    1e-6 of the largest |value| of the fp32 plain backward's: well inside
    the card check's 1e-4."""
    rng = np.random.RandomState(s)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, s, 64)
                                    .astype(np.float32)) for _ in range(4))
    lse = k1.flash_attention_lse_plain(q, k)
    want = k1.flash_attention_bwd_plain(q, k, v, lse, do)
    scale = 1 / 8
    sc = _mm3(q, k.transpose(-1, -2))
    p = torch.exp(sc * scale - lse[..., None]).tril()
    dp = _mm3(do, v.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    got = [torch.zeros_like(q) for _ in range(3)]
    for t0 in range(0, s, k1.BWD_F32_TILE):
        sl = slice(t0, t0 + k1.BWD_F32_TILE)
        got[0] += _mm3(ds[..., sl], k[..., sl, :])
        got[1] += _mm3(ds[..., sl, :].transpose(-1, -2), q[..., sl, :])
        got[2] += _mm3(p[..., sl, :].transpose(-1, -2), do[..., sl, :])
    got[0], got[1] = got[0] * scale, got[1] * scale
    top = max(float(w.abs().max()) for w in want)
    for a, w in zip(got, want):
        assert float((a - w).abs().max()) <= 1e-6 * top


def test_bwd_wrapper_refuses_before_any_launch():
    """The backward wrapper's checks run before the launch, on any
    device: head dim 64 only, one dtype, a (B, H, S) fp32 lse."""
    q = torch.zeros(1, 2, 5, 64)
    lse = torch.zeros(1, 2, 5)
    before = k1.KERNEL_BWD.launches
    with pytest.raises(ValueError, match="head dim"):
        k1._launch_bwd(*(t[..., :32] for t in (q, q, q)), lse, q[..., :32],
                       None, True)
    with pytest.raises(TypeError):
        k1._launch_bwd(q, q, q, lse, q.double(), None, True)
    with pytest.raises(ValueError, match="lse"):
        k1._launch_bwd(q, q, q, lse[..., 1:], q, None, True)
    assert k1.KERNEL_BWD.launches == before
