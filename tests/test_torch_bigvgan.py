"""The port's BigVGAN against the JAX package, on the CPU in fp32: K7's
plain version against the XLA reference (1e-5: the same fp32 FIR and
sine, only the summation order differs) and against the Pallas kernel
in interpret mode (1e-4: the Pallas kernel takes sin² from a degree-5
polynomial, about 2e-5 off the real sine), the resamplers, and the
generator's ``inference`` at a tiny width (1e-4).  TF32 is off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models import _bigvgan_random as jax_bigvgan_random
from tortoise_tts_tpu.models import bigvgan as jbv
from tortoise_tts_tpu.ops.pallas_snake import snake_resample2 as jax_snake
from tests.torch_tiny import one_torch_thread  # noqa: F401
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.kernels import snake as k7
from tortoise_tts_tpu_torch.models import _bigvgan_random
from tortoise_tts_tpu_torch.models import bigvgan as tbv

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _t(a):
    return torch.from_numpy(np.array(a))


def _snake_inputs(b, c, t, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, c, t).astype(np.float32)
    a = np.exp(0.3 * rng.randn(c)).astype(np.float32)
    ib = (1.0 / (np.exp(0.3 * rng.randn(c)) + 1e-9)).astype(np.float32)
    return x, a, ib


@pytest.mark.parametrize("b,c,t", [(1, 5, 224), (2, 3, 513), (1, 8, 8),
                                   (1, 2, 3)])
def test_snake_plain_matches_xla_ref(b, c, t):
    x, a, ib = _snake_inputs(b, c, t, t)
    got = k7.snake_resample2(_t(x), _t(a), _t(ib)).numpy()
    want = jbv._snake_xla_ref(jnp.asarray(x), jnp.asarray(a),
                              jnp.asarray(ib))
    assert got.shape == (b, c, t)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,c,t", [(1, 8, 300), (2, 4, 1025)])
def test_snake_plain_matches_pallas_interpret(b, c, t):
    x, a, ib = _snake_inputs(b, c, t, c)
    got = k7.snake_resample2(_t(x), _t(a), _t(ib)).numpy()
    want = jax_snake(jnp.asarray(x), jnp.asarray(a), jnp.asarray(ib),
                     interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)



# K7's call shapes at 906 mel frames, (C, T) by stage; activation_post
# repeats the last
_STAGES = [(768, 3624), (384, 14496), (192, 28992), (96, 57984),
           (48, 115968), (24, 231936)]


@pytest.mark.parametrize("b,c,t", [(b, c, t) for b in (1, 8)
                                   for c, t in _STAGES]
                         + [(2, 3, t) for t in (1, 3, 5, 7, 9, 255, 257,
                                                2049)]
                         + [(1, 1, 8), (3, 7, 3620), (8, 768, 3620),
                            (4096, 3, 341), (93207, 3, 15)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_snake_plan_covers_every_run(b, c, t, dtype):
    """The CUDA kernel's launch geometry (``kernels/snake.plan``): blocks
    of 128 runs cover every run of every row, a row's runs cover T, and
    the multiply-shift division the kernel does on the flat run index
    (by the runs a row) and on the row (by C) is exact for every index
    the grid reaches, as the kernel's 32-bit arithmetic computes it."""
    p = k7.plan(b * c, c, t, dtype)
    v = p.run
    if dtype == torch.float32:
        assert v == 4
    else:   # runs of 16 outputs but for the small calls: stage 0 at B=1
        assert v == (16 if b * c * t >= k7.BIG_CALL else 8)
        assert v == 8 or (b, c, t) != (1, 768, 3624)
    runs = b * c * p.per_row
    assert (p.per_row - 1) * v < t <= p.per_row * v
    assert (p.tiles - 1) * k7.THREADS < runs <= p.tiles * k7.THREADS

    def div(n, ml):
        m, l = ml
        assert 0 <= m < 2 ** 32 and l < 32
        t_hi = (n * np.uint64(m)) >> np.uint64(32)
        q = (t_hi + n) >> np.uint64(l)
        assert int((t_hi + n).max()) < 2 ** 32     # no 32-bit overflow
        return q

    g = np.arange(runs, dtype=np.uint64)
    row = div(g, p.per_row_div)
    assert np.array_equal(row, g // np.uint64(p.per_row))
    rows = np.arange(b * c, dtype=np.uint64)
    assert np.array_equal(div(rows, p.channel_div), rows // np.uint64(c))


def test_snake_kernel_taps_are_the_filter():
    """The CUDA kernel's taps, constants in ``csrc/snake.cu`` (``F(i)``,
    i = 0..5, mirrored), are kaiser_sinc_filter(0.25, 0.3, 12) bit for
    bit, which is symmetric."""
    import re
    from pathlib import Path
    src = (Path(k7.__file__).parent.parent / "csrc" / "snake.cu").read_text()
    body = src[src.index("constexpr float F(int i)"):]
    body = body[:body.index("}")]
    lits = re.findall(r"(-?0x[0-9a-f.]+p[-+]?\d+)f", body)
    f = tbv.kaiser_sinc_filter(0.25, 0.3, 12)
    assert len(lits) == 6 and np.array_equal(f, f[::-1])
    assert [np.float32(float.fromhex(s)) for s in lits] == list(f[:6])

def test_resamplers_match_jax():
    assert np.array_equal(tbv.kaiser_sinc_filter(0.25, 0.3, 12),
                          jbv.kaiser_sinc_filter(0.25, 0.3, 12))
    x = np.random.RandomState(1).randn(2, 3, 37).astype(np.float32)
    up = tbv._up2(_t(x)).numpy()
    np.testing.assert_allclose(up, np.asarray(jbv._up2(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    assert up.shape == (2, 3, 74)
    down = tbv._down2(_t(up)).numpy()
    np.testing.assert_allclose(down,
                               np.asarray(jbv._down2(jnp.asarray(up))),
                               atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module")
def tiny_bigvgan():
    jcfg = jbv.BigVGANConfig(upsample_initial_channel=64)
    jp = jax.tree_util.tree_map(
        np.asarray, jax_bigvgan_random(jax.random.PRNGKey(0), jcfg))
    # snake parameters away from their 0 init, so alpha and beta differ
    rng = np.random.RandomState(1)

    def perturb(a):
        return {k: (0.3 * rng.randn(*v.shape)).astype(np.float32)
                for k, v in a.items()}
    for rb in jp["resblocks"]:
        rb["activations"] = [perturb(a) for a in rb["activations"]]
    jp["activation_post"] = perturb(jp["activation_post"])
    return jcfg, jp, tbv.BigVGANConfig(upsample_initial_channel=64), \
        bridge.bigvgan_from_jax(jp, dtype=torch.float32)


def test_bigvgan_inference_matches_jax(tiny_bigvgan):
    jcfg, jp, tcfg, tp = tiny_bigvgan
    mel = (np.random.RandomState(2).randn(1, 100, 12) - 5).astype(np.float32)
    got = tbv.inference(tp, _t(mel), tcfg).numpy()
    want = jbv.inference(jax.tree_util.tree_map(jnp.asarray, jp),
                         jnp.asarray(mel), jcfg)
    assert got.shape == (1, 1, 12 * 256)
    assert np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)


def test_bigvgan_random_init_has_jax_structure():
    cfg = dict(upsample_initial_channel=64)
    jp = jax_bigvgan_random(jax.random.PRNGKey(0), jbv.BigVGANConfig(**cfg))
    own = _bigvgan_random(torch.Generator().manual_seed(0),
                          tbv.BigVGANConfig(**cfg))
    shapes = lambda tree: jax.tree_util.tree_map(np.shape, tree)  # noqa
    assert shapes(bridge.to_numpy(own)) == shapes(
        jax.tree_util.tree_map(np.asarray, jp))
