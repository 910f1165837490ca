"""K6, the denoiser's biased attention, against the JAX package.

On the CPU the wrapper runs its plain version, which must match the JAX
Pallas kernel in interpret mode (the head-group path at H=4, the
per-head kernel at H=2) and the JAX XLA path at 1e-5 in fp32: the same
math, only the summation order differs.  ``qkv_attention`` must route
exactly the calls the JAX package routes to its kernel (bias, batch >= 8,
T >= 256) to K6 and keep the rest on its plain path.  The CUDA kernel is
held against the plain version on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tts_tpu.ops.attention import qkv_attention as jax_qkv_attention
from tortoise_tts_tpu.ops.pallas_attention import flash_attention_bias_qkv_vt
from tortoise_tts_tpu_torch.kernels import flash_attention_bias as k6
from tortoise_tts_tpu_torch.kernels import flash_attention_bias_cm as k9b
from tortoise_tts_tpu_torch.kernels import flash_attention_bias_kq as k9a
from tortoise_tts_tpu_torch.kernels import gn_conv
from tortoise_tts_tpu_torch.ops import attention

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed, b, h, t, d=64):
    rng = np.random.RandomState(seed)
    qkv = (rng.randn(b, h * 3 * d, t) * 0.5).astype(np.float32)
    bias = (rng.randn(h, t, t) * 2.0).astype(np.float32)
    return qkv, bias


@pytest.mark.parametrize("h", [4, 2])
def test_plain_matches_jax_pallas_interpret(h):
    """T=200 is no multiple of the TPU kernel's 128-lane padding: its
    padded keys are masked and the ragged end is sliced off; the port's
    plain version (and kernel) take T as it is."""
    qkv, bias = _inputs(h, 2, h, 200)
    got = k6.flash_attention_bias(torch.from_numpy(qkv),
                                  torch.from_numpy(bias), h).numpy()
    assert got.shape == (2, h * 64, 200) and np.isfinite(got).all()
    want = flash_attention_bias_qkv_vt(jnp.asarray(qkv), jnp.asarray(bias),
                                       h, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_plain_matches_jax_qkv_attention():
    qkv, bias = _inputs(7, 3, 2, 130)
    got = k6.flash_attention_bias_plain(torch.from_numpy(qkv),
                                        torch.from_numpy(bias), 2).numpy()
    want = jax_qkv_attention(jnp.asarray(qkv), 2, bias=jnp.asarray(bias))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("b,t,biased,routed", [(8, 256, True, True),
                                               (9, 300, True, True),
                                               (7, 256, True, False),
                                               (8, 255, True, False),
                                               (8, 256, False, False)])
def test_qkv_attention_routes_k6_like_jax(monkeypatch, b, t, biased, routed):
    """The JAX package's dispatch (ops/attention.py:103-112): a bias, no
    mask, batch >= 8 and T >= 256 take the kernel; the rest stays plain.
    Counted with the wrapper swapped for a counting one; the output is
    the JAX package's at 1e-5 either way."""
    calls = []
    wrapper = k6.flash_attention_bias

    def counting(*args):
        calls.append(args[0].shape)
        return wrapper(*args)

    monkeypatch.setattr(k6, "flash_attention_bias", counting)
    h = 2
    qkv, bias = _inputs(b + t, b, h, t, d=16)
    rel_w = np.random.RandomState(1).randn(32, h).astype(np.float32)
    if biased:
        got = attention.qkv_attention(torch.from_numpy(qkv), h,
                                      bias=torch.from_numpy(bias))
        want = jax_qkv_attention(jnp.asarray(qkv), h, bias=jnp.asarray(bias))
    else:
        got = attention.qkv_attention(torch.from_numpy(qkv), h,
                                      rel_pos_w=torch.from_numpy(rel_w),
                                      rel_pos_scale=4.0)
        want = jax_qkv_attention(jnp.asarray(qkv), h,
                                 rel_pos_w=jnp.asarray(rel_w),
                                 rel_pos_scale=4.0)
    assert calls == ([(b, h * 3 * 16, t)] if routed else [])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_plain_rounds_probabilities_like_the_tpu_kernel():
    """bf16: the weights are rounded to bf16 before the AV product and the
    normaliser sums the rounded weights, as the TPU kernel's ones column
    does; the result is within a few bf16 steps of the fp32 math."""
    qkv, bias = _inputs(3, 1, 2, 96)
    q16, b16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (qkv, bias))
    got = k6.flash_attention_bias_plain(q16, b16, 2)
    assert got.dtype == torch.bfloat16
    want = k6.flash_attention_bias_plain(q16.float(), b16.float(), 2)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)


# Every shape the routes give the three biased kernels (H=16: the trunk's
# and the integrator's batches on the default route, 1 and 2, and on the
# batch route, 8 and 16, at T=896 and the denoiser's other padded lengths)
# and the ragged ones of the card tests.
PLAN_SHAPES = ([(b, 16, t) for b in (1, 2, 8, 16) for t in (256, 416, 896)]
               + [(b, 4, t) for b in (3, 9) for t in (64, 257, 300)])
SMEM_MAX = 232448    # an H100 block's shared memory (227 KB)
SM_SHARED = 233472   # an H100 SM's (228 KB), 1 KB of it kept a block


@pytest.mark.parametrize("b,h,t", PLAN_SHAPES)
def test_plan_fits_every_shape(b, h, t):
    """plan(b, h, t): the kernel's one shape (one warpgroup for one batch
    row and one query tile, G = 1, two stages); the grid's blocks cover
    the batch and the query tiles with no block left empty; the ring fits
    a block's shared memory and four blocks an SM (the kernel's
    __launch_bounds__); T's rows off 16 bytes (T = 257, 300) take warp 0's
    element copies, the others TMA."""
    p = k6.plan(b, h, t)
    assert (p.nb, p.nq, p.stages) == (1, 1, 2)
    tiles = -(-t // 64)
    grid_b, grid_q = -(-b // p.nb), -(-tiles // p.nq)
    assert (grid_b - 1) * p.nb < b <= grid_b * p.nb
    assert (grid_q - 1) * p.nq < tiles <= grid_q * p.nq
    assert k6.smem_bytes(p) == 2 * (3 * 8192 + 1024) + 32 + 1024
    assert k6.smem_bytes(p) <= SMEM_MAX
    assert SM_SHARED // (k6.smem_bytes(p) + 1024) >= 4
    assert p.tma == (t % 8 == 0)


@pytest.mark.parametrize("b,t", [(1, 64), (3, 130), (9, 257)])
def test_plain_versions_agree(b, t):
    """The three plain versions compute one function: K6's, K9a's on the
    transposed bias and both of K9b's agree at 1e-5 in fp32 (where the
    weights' rounding to the input type is exact)."""
    h = 2
    qkv, bias = (torch.from_numpy(x) for x in _inputs(b * t, b, h, t))
    want = k6.flash_attention_bias_plain(qkv, bias, h)
    q, k, v = qkv.view(b, h, 3, 64, t).unbind(2)
    for got in (k9a.flash_attention_bias_kq_plain(
                    qkv, bias.transpose(1, 2).contiguous(), h),
                k9b.flash_attention_bias_qkv_plain(qkv, bias, h),
                k9b.flash_attention_bias_cm_plain(q, k, v, bias).reshape(
                    b, h * 64, t)):
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("transposed", [False, True])
def test_3xtf32_decomposition_matches_fp32(transposed):
    """The fp32 kernels' arithmetic (both products on three TF32 products
    of the operands' hi/lo split, lo lo dropped) holds 1e-5 against the
    fp32 plain version at a ragged T, in both bias orientations; one TF32
    product alone does not hold a tenth of the 3xTF32 error's margin."""
    b, h, t = 3, 2, 257
    qkv, bias = (torch.from_numpy(x) for x in _inputs(17, b, h, t))
    want = k6.flash_attention_bias_plain(qkv, bias, h)
    given = bias.transpose(1, 2).contiguous() if transposed else bias
    got = k6.attention_bias_3xtf32(qkv, given, h, transposed=transposed)
    torch.testing.assert_close(got, want, **TOL)
    err3 = float((got - want).abs().max())

    def one(x, y):
        return torch.matmul(gn_conv.tf32_split(x)[0], gn_conv.tf32_split(y)[0])
    one_tf32 = k6.attention_bias_3xtf32(qkv, given, h, transposed=transposed,
                                        matmul=one)
    assert float((one_tf32 - want).abs().max()) > 10 * err3
