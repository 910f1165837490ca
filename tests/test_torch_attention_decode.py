"""K1 (trunk flash attention) and K3 (decode attention, both entries)
against the JAX package at the shapes their Hopper kernels take, and the
kernels' launch plans at every main-path shape.

On the CPU each wrapper runs its plain PyTorch version, which must match
the JAX Pallas kernel in interpret mode (or the JAX XLA function) at 1e-5:
the same fp32 math, only the summation order differs.  The launch plans
are pure functions of the shapes that the wrappers pass to the CUDA
kernels; the kernels themselves are held against the plain versions on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu.ops.attention import mha as jax_mha
from tortoise_tts_tpu.ops.pallas_attention import flash_attention as jax_fa
from tortoise_tts_tpu.ops.pallas_decode_attn import flash_decode_stacked
from tortoise_tts_tpu_torch.kernels import flash_attention as k1
from tortoise_tts_tpu_torch.kernels import flash_decode as k3

TOL = dict(atol=1e-5, rtol=1e-5)
H = 16              # the trunk's heads
# (B, S) of K1 on the main paths: the prefill (1 + 66 + 1) and the latent
# pass (1 + 66 + 200 + 2) of the single route, and both for the batch of 8
K1_SHAPES = [(1, 68), (1, 269), (8, 68), (8, 269)]
# (rows, slots) of K3 on the main paths: the single route's last step
# (268 slots) and a long cache (604), the batch (8 rows), the candidates'
# shared form (16 rows over 68 + 200 slots), the batch with 4 candidates
# a text (32 rows); and 2 rows, where the clusters shrink to 4 blocks
K3_SHAPES = [(1, 268), (1, 604), (8, 268), (16, 268), (32, 268), (2, 268)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _pos(p):
    return torch.tensor(p, dtype=torch.int32)


@pytest.mark.parametrize("s", [269, 101])
def test_flash_attention_plain_latent_pass_matches_jax(s):
    """The latent pass: causal, no key mask, S a multiple of neither the
    16-query warp tile nor the 64-key tile."""
    rng = np.random.RandomState(s)
    q, k, v = (rng.randn(1, 4, s, 64).astype(np.float32) for _ in range(3))
    got = k1.flash_attention(_t(q), _t(k), _t(v), None, True).numpy()
    assert np.isfinite(got).all()
    pallas = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    key_mask=None, causal=True, block_q=128, interpret=True)
    xla = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)


@pytest.mark.parametrize("b,s", K1_SHAPES)
def test_flash_attention_plan_at_main_path_shapes(b, s):
    """K1's bf16 launch plan: blocks of 4 warps, ``wk`` of which share a
    16-query tile's keys; the widest split (4, 2, 1) whose grid stays
    within MAX_WAVES blocks an SM; every key tile of a block resident up to
    MAX_TILES, within the shared memory of an H100."""
    wk, tiles, nbuf = k1.plan(b, H, s)
    assert wk in (1, 2, 4) and tiles == math.ceil(s / (64 // wk))
    assert tiles * b * H <= k1.MAX_WAVES * k1.SMS or wk == 1
    if wk < 4:
        assert math.ceil(s / (32 // wk)) * b * H > k1.MAX_WAVES * k1.SMS
    assert nbuf == min(math.ceil(s / k1.KEY_TILE), k1.MAX_TILES)
    assert k1.smem_bytes(s, nbuf, True) <= k1.SMEM_MAX
    assert {(1, 68): (4, 5, 2), (1, 269): (4, 17, 5), (8, 68): (2, 3, 2),
            (8, 269): (1, 5, 5)}[(b, s)] == (wk, tiles, nbuf)


def _cache(rng, B, S, L=2, Dh=64, h=4):
    ck = rng.randn(L, B, h, S, Dh).astype(np.float32)
    cv = rng.randn(L, B, h, S, Dh).astype(np.float32)
    q = rng.randn(B, h, Dh).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[0, 5:9] = False                # text padding holes
    mask[1, 2 * S // 3:S - 10] = False  # a masked region
    return q, ck, cv, mask


@pytest.mark.parametrize("pos", [0, 130, 255])
def test_flash_decode_plain_device_pos_matches_jax(pos):
    """``pos`` as a 0-d int32 tensor, the form the TPU kernel takes by
    scalar prefetch: the same result as the int, and as the JAX kernel."""
    rng = np.random.RandomState(pos)
    q, ck, cv, mask = _cache(rng, 2, 256)
    for li in range(ck.shape[0]):
        got = k3.flash_decode(_t(q), _t(ck[li]), _t(cv[li]), _pos(pos),
                              _t(mask))
        assert torch.equal(got, k3.flash_decode(_t(q), _t(ck[li]),
                                                _t(cv[li]), pos, _t(mask)))
        pallas = flash_decode_stacked(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), li,
            jnp.asarray(pos, jnp.int32), jnp.asarray(mask), interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("g,c,pos", [(1, 16, 0), (2, 3, 39)])
def test_flash_decode_shared_plain_device_pos_matches_jax(g, c, pos):
    """The shared form with ``pos`` as a 0-d int32 tensor against the JAX
    package's ``_mha_shared`` (grouped form), text-padding holes in the
    prefix."""
    rng = np.random.RandomState(7 + pos)
    b, h, dh, sp, sd = g * c, 4, 64, 23, 40
    q = rng.randn(b, h, dh).astype(np.float32)
    kp, vp = (rng.randn(g, h, sp, dh).astype(np.float32) for _ in range(2))
    kd, vd = (rng.randn(b, h, sd, dh).astype(np.float32) for _ in range(2))
    pmask = rng.rand(g, sp) > 0.3
    pmask[:, 0] = True
    got = k3.flash_decode_shared(_t(q), _t(kp), _t(vp), _t(pmask), _t(kd),
                                 _t(vd), _pos(pos))
    assert torch.equal(got, k3.flash_decode_shared(
        _t(q), _t(kp), _t(vp), _t(pmask), _t(kd), _t(vd), pos))
    valid = np.concatenate([pmask, np.broadcast_to(np.arange(sd) <= pos,
                                                   (g, sd))], axis=1)
    want = juv._mha_shared(jnp.asarray(q)[:, :, None], jnp.asarray(kp),
                           jnp.asarray(vp), jnp.asarray(kd), jnp.asarray(vd),
                           jnp.asarray(valid)[:, None, None, None, :], False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, 0], **TOL)


def test_flash_decode_pos_arguments():
    """What the wrappers hand the kernel for ``pos``: a host int checked
    against the cache, or a 0-d int32 tensor on the query's device, read
    there; anything else raises."""
    dev = torch.device("cpu")
    assert k3._pos_args(5, 10, dev, "k3") == (5, None)
    dpos = _pos(3)
    assert k3._pos_args(dpos, 10, dev, "k3") == (0, dpos.data_ptr())
    for bad in (10, -1, torch.tensor(3), _pos([3])):
        with pytest.raises(ValueError):
            k3._pos_args(bad, 10, dev, "k3")


@pytest.mark.parametrize("rows,slots", K3_SHAPES)
def test_flash_decode_plan_at_main_path_shapes(rows, slots):
    """K3's launch plan depends on the cache's size and not on ``pos``:
    clusters of up to 8 blocks only where the row-heads leave SMs idle (8
    at B=1), one block a row-head from 8 rows up; every block with a slot
    when pos is the last; RING_STEPS steps in flight a warp at most."""
    split, chunk, nbuf = k3.plan(rows, H, slots)
    assert split in (1, 2, 4, 8)
    assert split == 1 or split * rows * H <= k3.SMS
    assert split == {1: 8, 2: 4}.get(rows, 1)
    assert (split - 1) * chunk < slots <= split * chunk
    steps = math.ceil(chunk / (k3.STEP * k3.WARPS))
    assert nbuf == min(steps, k3.RING_STEPS) >= 1
