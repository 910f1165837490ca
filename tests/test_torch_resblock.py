"""K4's and K5's decomposition on the card, checked on the CPU in fp32
against the JAX package: the normalise step's plain version
(``group_norm_act_plain``, the Y the bf16 normalise kernel writes), the
GEMM over it (K4: W @ Y + b; K5: the sum over the three taps of the
tap-major weight against Y shifted by s - 1, + b + x), the tap-major
reorder, the denoiser with its prepared params, ``TTS``'s once-per-model
preparation and the wrappers' shape checks.

Tolerances: 1e-5 where both sides compute the same fp32 expression and
only the order of a sum differs (3e-5 against the Pallas kernels in
interpret mode, as in test_torch_diffusion.py); the reorder is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models import diffusion as jdiff
from tortoise_tts_tpu.models.common import (group_norm as jgroup_norm,
                                            linear as jlinear,
                                            silu as jsilu)
from tortoise_tts_tpu.ops.pallas_resblock import (fused_gn_conv1x1,
                                                  fused_ts_res_block)
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.kernels import gn_conv as k4
from tortoise_tts_tpu_torch.kernels import ts_res_block as k5
from tortoise_tts_tpu_torch.models import diffusion as tdiff
from tortoise_tts_tpu_torch.models.common import linear, norm_groups, silu

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TINY = dict(model_channels=64, num_layers=2, num_heads=4,
            in_latent_channels=64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _in_half_taps(tp, x, groups):
    """K4's decomposition (act): Y = group_norm_act_plain(x), W @ Y + b."""
    n, c = tp["in_norm"], tp["in_conv"]
    y = k4.group_norm_act_plain(x, n["scale"], n["bias"], groups, True)
    return torch.matmul(c["w"][:, :, 0], y) + c["b"][:, None]


def _block_taps(tp, x, emb, groups):
    """The whole timestep resblock through both decompositions."""
    h = _in_half_taps(tp, x, groups)
    emb_out = linear(tp["emb"], silu(emb))
    return k5.ts_res_block_out_taps_plain(
        h, x, emb_out, tp["out_norm"], k5.taps(tp["out_conv"]["w"]),
        tp["out_conv"]["b"], groups)


@pytest.mark.parametrize("b,c,t", [(3, 64, 45), (3, 64, 1), (1, 32, 7),
                                   (2, 128, 130)])
def test_ts_res_block_decomposition_matches_xla(b, c, t):
    """Ragged T, T = 1 and B = 3 against ``_ts_res_block_xla``."""
    rng = np.random.RandomState(b * 1000 + c + t)
    jp = jdiff._ts_res_block_init(jax.random.PRNGKey(c + t), c, c)
    x = rng.randn(b, c, t).astype(np.float32)
    emb = rng.randn(b, c).astype(np.float32)
    want = jdiff._ts_res_block_xla(jp, jnp.asarray(x), jlinear(
        jp["emb"], jsilu(jnp.asarray(emb))))
    got = _block_taps(bridge.to_torch(_np(jp)), _t(x), _t(emb),
                      norm_groups(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("b", [1, 2])
def test_ts_res_block_decomposition_matches_pallas_interpret(b):
    """T % 128 == 0 and B <= 2, where the TPU kernels run."""
    rng = np.random.RandomState(20 + b)
    c, t = 128, 128
    jp = jdiff._ts_res_block_init(jax.random.PRNGKey(b), c, c)
    x = rng.randn(b, c, t).astype(np.float32)
    emb = rng.randn(b, c).astype(np.float32)
    emb_out = jlinear(jp["emb"], jsilu(jnp.asarray(emb)))
    want = fused_ts_res_block(jp, jnp.asarray(x), emb_out, 32,
                              interpret=True)
    got = _block_taps(bridge.to_torch(_np(jp)), _t(x), _t(emb), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("act", [True, False])
def test_gn_conv_decomposition_matches_pallas_interpret(act):
    rng = np.random.RandomState(30 + act)
    x = (rng.randn(2, 128, 128) * 2 + 0.5).astype(np.float32)
    norm = {"scale": (1 + 0.1 * rng.randn(128)).astype(np.float32),
            "bias": (0.1 * rng.randn(128)).astype(np.float32)}
    conv = {"w": rng.uniform(-0.09, 0.09, (384, 128, 1)).astype(np.float32),
            "b": rng.uniform(-0.09, 0.09, 384).astype(np.float32)}
    tn, tc = bridge.to_torch(norm), bridge.to_torch(conv)
    y = k4.group_norm_act_plain(_t(x), tn["scale"], tn["bias"], 32, act)
    got = torch.matmul(tc["w"][:, :, 0], y) + tc["b"][:, None]
    want = fused_gn_conv1x1(jax.tree_util.tree_map(jnp.asarray, norm),
                            jax.tree_util.tree_map(jnp.asarray, conv),
                            jnp.asarray(x), 32, act=act, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("b,c,t,film", [(3, 64, 45, True), (1, 32, 1, False),
                                        (2, 64, 9, False)])
def test_group_norm_act_plain_matches_jax(b, c, t, film):
    """The normalise step alone: group_norm (* (1 + scale) + shift), then
    silu, as the JAX package's XLA path computes it in fp32; its
    statistics are the two-pass mean and variance."""
    rng = np.random.RandomState(40 + t)
    x = (rng.randn(b, c, t) * 3 + 1).astype(np.float32)
    norm = {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
            "bias": (0.1 * rng.randn(c)).astype(np.float32)}
    emb = rng.randn(b, 2 * c).astype(np.float32) if film else None
    g = norm_groups(c)
    want = jgroup_norm(jax.tree_util.tree_map(jnp.asarray, norm),
                       jnp.asarray(x), g)
    if film:
        want = want * (1 + emb[:, :c, None]) + emb[:, c:, None]
    want = jsilu(want)
    tn = bridge.to_torch(norm)
    got, (mu, rstd) = k4.group_norm_act(
        _t(x), tn["scale"], tn["bias"], g, True,
        emb=None if emb is None else _t(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    xg = x.reshape(b * g, -1).astype(np.float64)
    np.testing.assert_allclose(mu.numpy(), xg.mean(1), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(xg.var(1) + 1e-5),
                               rtol=1e-5)


@pytest.mark.parametrize("c", [8, 64])
def test_taps_equal_tpu_kernel_w3_exactly(c):
    """The tap-major weight is the TPU kernel's [W(-1) | W(0) | W(+1)]
    (``pallas_resblock.py:217-218``), bit for bit, and ``prepare_conv``
    keeps the (C, C, 3) weight it came from."""
    w = np.random.RandomState(c).randn(c, c, 3).astype(np.float32)
    w3 = jnp.concatenate([jnp.asarray(w)[:, :, s] for s in range(3)], axis=1)
    got = k5.taps(_t(w))
    assert got.shape == (3, c, c) and got.is_contiguous()
    np.testing.assert_array_equal(
        got.permute(1, 0, 2).reshape(c, 3 * c).numpy(), np.asarray(w3))
    conv = {"w": _t(w), "b": torch.zeros(c)}
    prepared = k5.prepare_conv(conv)
    assert prepared["w"] is conv["w"] and "w_taps" not in conv
    assert torch.equal(prepared["w_taps"], got)


@pytest.fixture(scope="module")
def models():
    jcfg = jdiff.DiffusionConfig(**TINY)
    jp = jdiff.init(jax.random.PRNGKey(0), jcfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 16))
    for lyr in jp["conditioning_timestep_integrator"] + jp["layers"]:
        lyr["attn"]["proj_out"]["w"] = 0.1 * jax.random.normal(
            next(keys), lyr["attn"]["proj_out"]["w"].shape)
    tp = bridge.diffusion_from_jax(_np(jp))
    return jcfg, jp, tdiff.DiffusionConfig(**TINY), tp


def _resblocks(params):
    return ([lyr["resblk"] for lyr in
             params["conditioning_timestep_integrator"] + params["layers"]]
            + list(params["final_res"]))


def test_prepare_adds_taps_to_every_resblock(models):
    _, _, _, tp = models
    prepared = tdiff.prepare(tp)
    blocks = _resblocks(prepared)
    assert len(blocks) == 3 + TINY["num_layers"] + 3
    for rb, orig in zip(blocks, _resblocks(tp)):
        assert torch.equal(rb["out_conv"]["w_taps"],
                           k5.taps(orig["out_conv"]["w"]))
        assert rb["out_conv"]["w"] is orig["out_conv"]["w"]
        assert rb["in_conv"] is orig["in_conv"]
    # the source params are left as they were
    assert all("w_taps" not in rb["out_conv"] for rb in _resblocks(tp))
    assert prepared["inp_block"] is tp["inp_block"]


def test_forward_with_prepared_params_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.RandomState(4)
    x = rng.randn(2, 100, 37).astype(np.float32)
    code = rng.randn(2, 64, 37).astype(np.float32)
    ts = np.array([3, 2500], np.int32)
    got = tdiff.forward(tdiff.prepare(tp), _t(x), _t(ts), _t(code), tcfg)
    want = jdiff.forward(jp, jnp.asarray(x), jnp.asarray(ts),
                         jnp.asarray(code), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_tts_prepares_the_denoiser_once(tmp_path, monkeypatch):
    """``TTS`` reorders the K5 weights once per loaded denoiser (as it
    quantizes the decode's weights once) and hands the prepared params to
    every diffusion call; a replaced model is prepared anew."""
    from tortoise_tts_tpu_torch import inference
    from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer
    from tests.torch_tiny import tiny_models
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER",
                       str(write_char_tokenizer(tmp_path / "tok.json")))
    tts = inference.TTS(device="cpu")
    tts._models = tiny_models()
    calls = []
    prepare = tdiff.prepare
    monkeypatch.setattr(tdiff, "prepare",
                        lambda p: calls.append(p) or prepare(p))
    first = tts._denoiser_params()
    assert tts._denoiser_params() is first and len(calls) == 1
    assert all("w_taps" in rb["out_conv"] for rb in _resblocks(first))
    seen = []
    diffusion = inference._diffusion
    monkeypatch.setattr(inference, "_diffusion",
                        lambda p, *a, **k: seen.append(p)
                        or diffusion(p, *a, **k))
    tts.inference("Hi.", max_ar_steps=8, max_diffusion_steps=2, seed=0)
    assert seen and all(p is first for p in seen) and len(calls) == 1
    tts._models = tiny_models(seed=1)
    assert tts._denoiser_params() is not first and len(calls) == 2


@pytest.mark.parametrize("args,err,match", [
    ((2, 64, 45, 128, 16, torch.float16), TypeError, "float32 or bfloat16"),
    ((2, 60, 45, 128, 4, torch.bfloat16), ValueError, "C % 8"),
    ((2, 64, 45, 128, 24, torch.float32), ValueError, "C % groups"),
    ((0, 64, 45, 128, 16, torch.bfloat16), ValueError, "non-empty"),
    ((2, 64, 0, 128, 16, torch.bfloat16), ValueError, "non-empty"),
    ((2, 64, 45, 0, 16, torch.bfloat16), ValueError, "non-empty")])
def test_plan_refuses_what_the_kernels_do_not_take(args, err, match):
    with pytest.raises(err, match=match):
        k4.plan(*args)


@pytest.mark.parametrize("b,c,t,m,bn", [
    (2, 1024, 896, 1024, 128),   # 112 blocks of 128: more than half the SMs
    (1, 1024, 896, 1024, 64),    # 56: narrower tiles
    (1, 1024, 517, 3072, 128), (1, 2048, 101, 6144, 64),
    (16, 512, 218, 1536, 128), (1, 512, 218, 1536, 64),   # the classifier
    (16, 1024, 896, 3072, 128), (2, 64, 45, 192, 64)])
def test_plan_picks_the_gemm_tile(b, c, t, m, bn):
    assert k4.plan(b, c, t, m, 32 if c > 64 else 16, torch.bfloat16) == \
        (bn, 1)


# fp32 (3xTF32): emb.process's two heads and TTS(dtype="float32")'s K5,
# with the plan measured fastest on an H100 (tools/resblock_tiles.py)
@pytest.mark.parametrize("b,c,t,m,taps,want", [
    (1, 1024, 517, 3072, 1, (104, 1)), (1, 2048, 101, 6144, 1, (104, 2)),
    (2, 1024, 896, 1024, 3, (128, 1))])
def test_fp32_plan_fills_the_card(b, c, t, m, taps, want):
    """The fp32 GEMM's tile and K split: one wave of blocks on at least
    70% of the SMs, each cluster a power of two up to 8, every K slice at
    least ``MIN_SLICE_STEPS`` steps, a tile width the kernel has, and a
    ragged T tile at least half full."""
    p = k4.plan(b, c, t, m, 32, torch.float32, taps=taps)
    assert p == want
    assert p.bn in k4.F32_TILES and p.split in k4.F32_SPLITS
    blocks = b * -(-m // k4.GEMM_ROWS) * -(-t // p.bn) * p.split
    assert 0.7 * k4.SMS <= blocks <= k4.SMS
    steps = taps * c // k4.F32_K_STEP
    assert steps // p.split >= k4.MIN_SLICE_STEPS
    assert t % p.bn == 0 or t % p.bn >= p.bn // 2


def test_fp32_plan_keeps_small_shapes_whole():
    """Where K is too short to split, the plan takes the grid it has."""
    assert k4.plan(2, 64, 45, 192, 16, torch.float32) == (64, 1)


F32_TOL = dict(atol=1e-4, rtol=1e-4)   # chip_smoke.F32_TOL


def test_tf32_split_rounds_as_cvt_rna():
    """hi is y rounded to TF32 (10 mantissa bits) to nearest with ties
    away from zero, its 13 low bits clear; hi + lo is y exactly."""
    one = 1.0
    ulp = 2.0 ** -10
    y = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp, 3.0, 0.0, -2.5e-30, 1e30],
                     dtype=torch.float32)
    hi, lo = k4.tf32_split(y)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0,
                         0.0], dtype=torch.float32)
    assert torch.equal(hi[:6], want)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert torch.equal(hi + lo, y)
    g = torch.Generator().manual_seed(0)
    r = torch.randn(4096, generator=g) * 10
    hi, lo = k4.tf32_split(r)
    assert torch.equal(hi + lo, r)
    assert bool((lo.abs() <= hi.abs() * 2.0 ** -11).all())


def _gn_inputs(b, c, t, m, k, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, t, generator=g) * 2 + 0.5
    norm = {"scale": 1 + 0.1 * torch.randn(c, generator=g),
            "bias": 0.1 * torch.randn(c, generator=g)}
    bound = (c * k) ** -0.5
    conv = {"w": (torch.rand(m, c, k, generator=g) * 2 - 1) * bound,
            "b": (torch.rand(m, generator=g) * 2 - 1) * bound}
    return x, norm, conv


@pytest.mark.parametrize("act", [True, False])
def test_3xtf32_decomposition_matches_fp32(act):
    """The fp32 kernels' arithmetic (Y, its TF32 split, three TF32
    products a step) holds chip_smoke's F32_TOL against the fp32 plain
    version at a ragged shape; one TF32 product alone does not hold a
    tenth of the 3xTF32 error's margin."""
    x, norm, conv = _gn_inputs(2, 136, 45, 200, 1, 3)
    want = k4.gn_conv1x1_plain(x, norm, conv, 8, act)
    y = k4.group_norm_act_plain(x, norm["scale"], norm["bias"], 8, act)
    got = k4.matmul_3xtf32(conv["w"][:, :, 0], y) + conv["b"][:, None]
    torch.testing.assert_close(got, want, **F32_TOL)
    err3 = float((got - want).abs().max())
    wh, _ = k4.tf32_split(conv["w"][:, :, 0])
    yh, _ = k4.tf32_split(y)
    one = torch.matmul(wh, yh) + conv["b"][:, None]
    assert float((one - want).abs().max()) > 10 * err3


def test_3xtf32_ts_res_block_matches_fp32():
    """K5's decomposition on the 3xTF32 products against its fp32 plain
    version at a ragged shape."""
    h, norm, conv = _gn_inputs(2, 136, 45, 136, 3, 4)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 136, 45, generator=g)
    emb = 0.3 * torch.randn(2, 272, generator=g)
    want = k5.ts_res_block_out_plain(h, x, emb, norm, conv, 8)
    got = k5.ts_res_block_out_taps_plain(h, x, emb, norm, k5.taps(conv["w"]),
                                         conv["b"], 8,
                                         matmul=k4.matmul_3xtf32)
    torch.testing.assert_close(got, want, **F32_TOL)


def test_fp32_normalise_on_the_cpu_is_the_split():
    """``group_norm_split`` on an fp32 CPU tensor gives the fp32 kernel's
    (Y_hi, Y_lo) from the plain version: hi + lo is Y."""
    x, norm, _ = _gn_inputs(2, 64, 33, 8, 1, 6)
    (hi, lo), stats = k4.group_norm_split(x, norm["scale"], norm["bias"], 16,
                                          True)
    y = k4.group_norm_act_plain(x, norm["scale"], norm["bias"], 16, True)
    assert torch.equal(hi + lo, y)
    assert torch.equal(hi, k4.tf32_split(y)[0])
