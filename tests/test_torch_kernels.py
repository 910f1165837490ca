"""The port's three kernel modules against the JAX package.

On the CPU each wrapper runs its plain PyTorch version, which must match
the JAX Pallas kernel in interpret mode and the JAX XLA path at 1e-5: the
same fp32 math, only the summation order differs.  The CUDA kernels
themselves are held against these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tts_tpu.ops.attention import mha as jax_mha
from tortoise_tts_tpu.ops.pallas_attention import flash_attention as jax_fa
from tortoise_tts_tpu.ops.pallas_decode_attn import flash_decode_stacked
from tortoise_tts_tpu.ops.pallas_gemv import qgemv_stacked
from tortoise_tts_tpu_torch.kernels import flash_attention as k1
from tortoise_tts_tpu_torch.kernels import flash_decode as k3
from tortoise_tts_tpu_torch.kernels import qgemv as k2

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _attn_inputs(rng, b, h, s, d=64, holes=True):
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    mask = rng.rand(b, s) > 0.2 if holes else np.ones((b, s), bool)
    mask[:, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("s,causal,holes", [(256, True, True),
                                            (300, True, True),
                                            (77, True, False),
                                            (256, False, True)])
def test_flash_attention_plain_matches_jax(s, causal, holes):
    """Text-padding holes (padded query rows included) and a ragged S."""
    rng = np.random.RandomState(s)
    q, k, v, mask = _attn_inputs(rng, 2, 4, s, holes=holes)
    got = k1.flash_attention(_t(q), _t(k), _t(v), _t(mask), causal).numpy()
    assert np.isfinite(got).all()
    pallas = jax_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    key_mask=jnp.asarray(mask), causal=causal, block_q=128,
                    interpret=True)
    xla = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  mask=jnp.asarray(mask)[:, None, None, :], causal=causal)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(xla), **TOL)


def _quantized(rng, L, K, N):
    w = rng.randn(L, K, N).astype(np.float32) * 0.02
    s = np.abs(w).max(axis=1) / 127.0 + 1e-12
    wq = np.round(w / s[:, None, :]).astype(np.int8)
    return wq, s.astype(np.float32)


@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("bias", [True, False])
def test_qgemv_plain_matches_jax(ln, bias):
    rng = np.random.RandomState(3)
    L, K, N, M = 2, 256, 512, 2
    wq, s = _quantized(rng, L, K, N)
    b = rng.randn(L, N).astype(np.float32) * 0.1 if bias else None
    g = (1.0 + 0.1 * rng.randn(L, K)).astype(np.float32)
    be = (0.1 * rng.randn(L, K)).astype(np.float32)
    x = rng.randn(M, K).astype(np.float32)
    jln = (jnp.asarray(g), jnp.asarray(be)) if ln else None
    jb = jnp.asarray(b) if bias else None
    for li in range(L):
        got = k2.qgemv(_t(x), _t(wq[li]), _t(s[li]),
                       _t(b[li]) if bias else None,
                       ln=(_t(g[li]), _t(be[li])) if ln else None).numpy()
        pallas = qgemv_stacked(jnp.asarray(x), jnp.asarray(wq),
                               jnp.asarray(s), jb, li, interpret=True, ln=jln)
        xla = qgemv_stacked(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s),
                            jb, li, ln=jln)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
        np.testing.assert_allclose(got, np.asarray(xla), **TOL)


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("k,n", [(1024, 3072), (1024, 1024), (1024, 4096),
                                 (4096, 1024)])
def test_qgemv_ksplit_at_main_path_shapes(k, n, m):
    """The K split of K2 and K8 (one rule): slices of a multiple of the
    ring's 32-row stage, KC_MIN..KC_MAX rows each, at most KS_MAX of them;
    at M=1 the grid has a block per SM of an H100 (132) or more, unless
    the slices reached KC_MIN rows;
    the split-K partials (ks x M x N fp32/int32) never outweigh the int8
    weights."""
    ks = k2.ksplit(k, n, m)
    kc = k // ks
    assert k % ks == 0 and kc % k2.KSTG == 0
    assert k2.KC_MIN <= kc <= k2.KC_MAX and ks <= k2.KS_MAX
    if m == 1:
        assert (n // k2.TILE_N) * ks >= 128 or kc == k2.KC_MIN
    assert ks == 1 or ks * m * n * 4 <= k * n


def _cache(rng, B, H, S, L=2, Dh=64):
    ck = rng.randn(L, B, H, S, Dh).astype(np.float32)
    cv = rng.randn(L, B, H, S, Dh).astype(np.float32)
    q = rng.randn(B, H, Dh).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[0, 5:9] = False                # text padding holes
    mask[1, 2 * S // 3:S - 10] = False  # a masked region
    return q, ck, cv, mask


@pytest.mark.parametrize("pos", [0, 7, 127, 128, 200, 255])
def test_flash_decode_plain_matches_jax(pos):
    rng = np.random.RandomState(0)
    q, ck, cv, mask = _cache(rng, 2, 4, 256)
    for li in range(ck.shape[0]):
        got = k3.flash_decode(_t(q), _t(ck[li]), _t(cv[li]), pos,
                              _t(mask)).numpy()
        args = (jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), li, pos,
                jnp.asarray(mask))
        pallas = flash_decode_stacked(*args, interpret=True)
        xla = flash_decode_stacked(*args)
        np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
        np.testing.assert_allclose(got, np.asarray(xla), **TOL)


@pytest.mark.parametrize("pos", [0, 150, 299])
def test_flash_decode_plain_ragged_cache(pos):
    """S = 300 is no multiple of the TPU kernel's 128-slot block: the JAX
    function takes its masked XLA path, and the port needs no padding."""
    rng = np.random.RandomState(1)
    q, ck, cv, mask = _cache(rng, 2, 4, 300, L=1)
    got = k3.flash_decode(_t(q), _t(ck[0]), _t(cv[0]), pos, _t(mask)).numpy()
    valid = mask & (np.arange(300)[None] <= pos)
    want = jax_mha(jnp.asarray(q)[:, :, None], jnp.asarray(ck[0]),
                   jnp.asarray(cv[0]),
                   mask=jnp.asarray(valid)[:, None, None, :])[:, :, 0]
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    fd = flash_decode_stacked(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                              0, pos, jnp.asarray(mask))
    np.testing.assert_allclose(got, np.asarray(fd), **TOL)
