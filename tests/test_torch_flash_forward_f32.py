"""K1's fp32 forward on the CPU: the persistent kernel's launch plan and
work items (``fwd_f32_plan``, ``fwd_f32_items``, which mirror
``csrc/flash_attention.cu``'s ``f32::item_of``), the wrapper's refusal of
rows the kernel's TMA cannot read, and the kernel's 3xTF32 arithmetic in
plain PyTorch (``flash_attention_3xtf32``) against the JAX package's
trunk attention (``unified_voice._xla_trunk_attention``, i.e.
``ops/attention.mha``) and the log-sum-exp of its masked scores.

fp32, inputs from numpy with a seed.  Tolerance 1e-5 an element (absolute
and relative), the card check's (``tests/test_torch_cuda.py``
``test_flash_attention_kernel_cuda``): three TF32 products of the splits
keep each score and each P V within about 1e-6 of fp32.  The CUDA kernel
itself is held against the plain version on the card by that test and by
``chip_smoke.py``.
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

TOL = 1e-5


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > TOL + TOL * np.abs(want)
    assert not bad.any(), (name, float(np.abs(got - want).max()))


@pytest.mark.parametrize("b,h,s", [(16, 16, 773), (8, 16, 389), (1, 16, 68),
                                   (1, 16, 269), (2, 3, 1), (1, 2, 64),
                                   (3, 2, 65), (2, 5, 130)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("order", [0, 1])
def test_fwd_items_cover_each_tile_once(b, h, s, causal, order):
    """Every (64-query tile, batch*head) is one work item; a causal item
    walks the key tiles up to its diagonal and none above it, a
    non-causal one every key tile; blocks take items i, i + grid, ...,
    so the grid never exceeds the items or two blocks an SM."""
    items = k1.fwd_f32_items(b, h, s, causal, order)
    nq = -(-s // k1.FWD_F32_TILE)
    assert sorted((t, j) for t, j, _ in items) == \
        [(t, j) for t in range(nq) for j in range(b * h)]
    for t, _, walked in items:
        # key tile i holds keys 64 i .. 64 i + 63: tile t's last query is
        # under key tile t's first key only from tile t on
        assert walked == (t + 1 if causal else nq)
        assert walked <= nq
    plan = k1.fwd_f32_plan(b, h, s)
    assert plan.items == len(items)
    assert 1 <= plan.grid <= min(plan.items, k1.FWD_F32_BLOCKS * k1.SMS)


@pytest.mark.parametrize("b,h,s,order", [(16, 16, 773, 0), (8, 16, 389, 1),
                                         (1, 16, 269, 0), (1, 16, 68, 0),
                                         (2, 16, 1000, 1), (1, 1, 64, 0)])
def test_fwd_plan_order(b, h, s, order):
    """The plan takes the heaviest tiles first where each block takes two
    to FWD_F32_ROUNDS items (the batch's AR step, S=389: 3.4 a block), else
    one (batch, head) after another (S=773: 12.6 a block; the serving
    shapes: one item a block)."""
    assert k1.fwd_f32_plan(b, h, s).order == order


@pytest.mark.parametrize("order", [0, 1])
def test_fwd_items_order(order):
    """Order 0 walks one (batch, head) at a time, its tiles heaviest
    first; order 1 takes every (batch, head)'s last tile first."""
    items = k1.fwd_f32_items(2, 2, 130, order=order)
    if order == 0:
        assert [(t, j) for t, j, _ in items[:4]] == [(2, 0), (1, 0), (0, 0),
                                                     (2, 1)]
    else:
        assert [(t, j) for t, j, _ in items[:5]] == [(2, 0), (2, 1), (2, 2),
                                                     (2, 3), (1, 0)]
    walked = [n for _, _, n in items]
    if order == 1:
        assert walked == sorted(walked, reverse=True)


def test_fwd_wrapper_refuses_rows_off_16_bytes():
    """The fp32 kernel reads k and v by TMA: rows (base pointers and
    strides) off 16 bytes raise before any launch, on any device."""
    b, h, s = 1, 2, 9
    buf = torch.zeros(b * s * 3 * h * 64 + 2)
    qkv = buf[2:].view(b, s, 3 * h * 64)
    q, k, v = (z.view(b, s, h, 64).transpose(1, 2)
               for z in qkv.split(h * 64, dim=-1))
    before = k1.KERNEL.launches
    with pytest.raises(ValueError, match="aligned"):
        k1._launch(q, k, v, None, True)
    assert k1.KERNEL.launches == before


def _inputs(b, h, s, holes, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, s, 64).astype(np.float32) for _ in range(3))
    mask = None
    if holes:
        mask = rng.rand(b, s) > 0.2
        mask[:, 0] = True
    return q, k, v, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("s,causal,holes", [(130, True, True),
                                            (130, True, False),
                                            (97, False, True),
                                            (64, True, True), (1, True, False)])
def test_fwd_3xtf32_arithmetic_matches_jax(s, causal, holes):
    """The kernel's arithmetic (each 64-key step's S and P V in 3xTF32,
    P V summed apart and added in fp32, the online softmax in base 2 with
    its lazy base) against the JAX trunk attention, with a key mask, and
    its log-sum-exp against jax.nn.logsumexp of the masked scores."""
    q, k, v, mask = _inputs(2, 2, s, holes, seed=s)
    km = None if mask is None else jnp.asarray(mask)
    args = [jnp.asarray(a) for a in (q, k, v)]
    if causal:
        want = _xla_trunk_attention(*args, km)
    else:
        want = jax_mha(*args, mask=None if km is None
                       else km[:, None, None, :], causal=False)
    dots = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(64.0)
    if causal:
        dots = jnp.where(jnp.tril(jnp.ones((s, s), bool)), dots, NEG_INF)
    if km is not None:
        dots = jnp.where(km[:, None, None, :], dots, NEG_INF)
    want_lse = jax.nn.logsumexp(dots, axis=-1)
    o, lse = k1.flash_attention_3xtf32(_t(q), _t(k), _t(v), _t(mask),
                                       causal)
    assert o.dtype == torch.float32 and lse.shape == (2, 2, s)
    _close(o.numpy(), want, "out")
    _close(lse.numpy(), want_lse, "lse")
