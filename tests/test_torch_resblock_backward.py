"""K4's and K5's backwards on the CPU: the plain backwards written out
(``gn_conv.gn_conv1x1_bwd_plain``, ``gn_conv.ts_res_block_out_bwd_plain``),
which the CUDA backward kernel computes, against

- ``jax.vjp`` of the JAX package's functions: ``arch._gn_qkv_xla`` (the
  attention head, K4 with ``act=False``), the package's own
  ``group_norm``, ``silu`` and ``conv1d`` composed (the resblock's
  in-half, K4 with ``act=True``), and ``diffusion._ts_res_block_xla`` (K4
  then K5, every leaf of ``p``, ``x`` and ``emb_out``);
- torch autograd of the port's plain forwards, in fp32 and in bf16;

and the forward's statistics recorded only where autograd records a call.

Inputs and upstream gradients from numpy with a seed: B=2, C=64 (16
groups, ``norm_groups``), T in {1, 17, 130}, fp32.  Tolerances:

- fp32 against JAX and against autograd: |got - want| <= 1e-5 |want| +
  2e-5 of the tensor's largest |want| an element.  The same fp32 math;
  only the order of the sums differs, and GroupNorm's backward subtracts
  two group means from gamma dn, which leaves a few ulps of the largest
  term where a gradient nearly cancels.
- bf16 against the port's plain forward under autograd, row by row (a
  row: a channel's T steps, a weight's output channel, a vector): ||got -
  want|| <= 2e-2 ||want|| plus one bf16 ulp (2^-7) of the tensor's RMS an
  element.  Both take the same bf16 inputs and upstream; they round at
  other points (autograd rounds each op's result to bf16, the written-out
  backward keeps fp32 to its end and rounds dn once, as the kernel does).

The CUDA kernel is held against these plain versions on the card by
``tests/test_torch_cuda.py::test_gn_conv_backward_cuda``,
``::test_ts_res_block_backward_reaches_the_live_weight_cuda`` and
``chip_smoke.py``'s ``train_grads``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models import arch as jarch
from tortoise_tts_tpu.models import common as jcommon
from tortoise_tts_tpu.models import diffusion as jdiff
from tortoise_tts_tpu_torch.kernels import gn_conv as k4
from tortoise_tts_tpu_torch.kernels import ts_res_block as k5
from tortoise_tts_tpu_torch.models.common import norm_groups

B, C = 2, 64
G = norm_groups(C)
TS = (1, 17, 130)
RTOL, ATOL_OF_MAX = 1e-5, 2e-5
BF16_ROW_RTOL, BF16_ULP = 2e-2, 2.0 ** -7


def _close(got, want, name):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = ATOL_OF_MAX * np.abs(want).max()
    err = np.abs(got - want)
    assert not (err > RTOL * np.abs(want) + atol).any(), \
        (name, float(err.max()), atol)


def _rows_close(got, want, name):
    n, i = 1, want.dim()
    while i > 0 and n < 64:
        i -= 1
        n *= want.shape[i]
    g, w = got.float().reshape(-1, n), want.float().reshape(-1, n)
    bound = (BF16_ROW_RTOL * w.norm(dim=1)
             + BF16_ULP * w.pow(2).mean().sqrt() * n ** 0.5)
    worst = float(((g - w).norm(dim=1) / bound).max())
    assert worst <= 1, (name, worst)


def _params(rng, m, k):
    """GroupNorm scale/bias (C,) and a conv weight (M, C, k) and bias."""
    bound = (C * k) ** -0.5
    return {"scale": (1 + 0.1 * rng.randn(C)).astype(np.float32),
            "bias": (0.1 * rng.randn(C)).astype(np.float32)}, \
        {"w": rng.uniform(-bound, bound, (m, C, k)).astype(np.float32),
         "b": rng.uniform(-bound, bound, m).astype(np.float32)}


def _x(rng, t):
    return (2 * rng.randn(B, C, t) + 0.5).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _jax_in_half(pn, pc, x):
    h = jcommon.group_norm(pn, x, G)
    return jcommon.conv1d(pc, jcommon.silu(h))


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("t", TS)
def test_gn_conv_backward_matches_jax_vjp(t, act):
    """act=False: ``arch._gn_qkv_xla`` (M = 3C, the qkv head); act=True:
    group_norm, silu, conv1d of the JAX package (M = C, the in-half)."""
    rng = np.random.RandomState(t + 10 * act)
    m = C if act else 3 * C
    pn, pc = _params(rng, m, 1)
    x = _x(rng, t)
    g = rng.randn(B, m, t).astype(np.float32)
    fn = _jax_in_half if act else jarch._gn_qkv_xla
    out, vjp = jax.vjp(fn, _jnp(pn), _jnp(pc), jnp.asarray(x))
    dpn, dpc, dx = vjp(jnp.asarray(g))
    got = k4.gn_conv1x1_bwd_plain(_t(x), _t(pn["scale"]), _t(pn["bias"]),
                                  _t(pc["w"]), _t(pc["b"]), _t(g), G, act)
    want = (dx, dpn["scale"], dpn["bias"], dpc["w"], dpc["b"])
    for name, a, w in zip(("x", "gamma", "beta", "w", "b"), got, want):
        _close(a.numpy(), w, name)
    fwd = k4.gn_conv1x1(_t(x), {"scale": _t(pn["scale"]),
                               "bias": _t(pn["bias"])},
                        {"w": _t(pc["w"]), "b": _t(pc["b"])}, G, act)
    _close(fwd.numpy(), out, "out")


@pytest.mark.parametrize("t", TS)
def test_res_block_backward_matches_jax_vjp(t):
    """``diffusion._ts_res_block_xla``: K4 (in-half) then K5, through the
    two plain backwards; x's gradient is K5's residual g plus K4's dx."""
    rng = np.random.RandomState(100 + t)
    in_norm, in_conv = _params(rng, C, 1)
    out_norm, out_conv = _params(rng, C, 3)
    p = {"in_norm": in_norm, "in_conv": in_conv, "out_norm": out_norm,
         "out_conv": out_conv}
    x = _x(rng, t)
    emb = (0.3 * rng.randn(B, 2 * C)).astype(np.float32)
    g = rng.randn(B, C, t).astype(np.float32)
    out, vjp = jax.vjp(jdiff._ts_res_block_xla, _jnp(p), jnp.asarray(x),
                       jnp.asarray(emb))
    dp, dx_want, demb_want = vjp(jnp.asarray(g))

    tp = jax.tree_util.tree_map(_t, p)
    tx, te, tg = _t(x), _t(emb), _t(g)
    h = k4.gn_conv1x1_plain(tx, tp["in_norm"], tp["in_conv"], G, True)
    _close(k5.ts_res_block_out(h, tx, te, tp["out_norm"], tp["out_conv"],
                               G).numpy(), out, "out")
    dh, demb, dga2, dbe2, dw2, db2 = k4.ts_res_block_out_bwd_plain(
        h, te, tp["out_norm"]["scale"], tp["out_norm"]["bias"],
        tp["out_conv"]["w"], tp["out_conv"]["b"], tg, G)
    dx1, dga1, dbe1, dw1, db1 = k4.gn_conv1x1_bwd_plain(
        tx, tp["in_norm"]["scale"], tp["in_norm"]["bias"],
        tp["in_conv"]["w"], tp["in_conv"]["b"], dh, G, True)
    pairs = [("x", tg + dx1, dx_want), ("emb_out", demb, demb_want),
             ("in_norm.scale", dga1, dp["in_norm"]["scale"]),
             ("in_norm.bias", dbe1, dp["in_norm"]["bias"]),
             ("in_conv.w", dw1, dp["in_conv"]["w"]),
             ("in_conv.b", db1, dp["in_conv"]["b"]),
             ("out_norm.scale", dga2, dp["out_norm"]["scale"]),
             ("out_norm.bias", dbe2, dp["out_norm"]["bias"]),
             ("out_conv.w", dw2, dp["out_conv"]["w"]),
             ("out_conv.b", db2, dp["out_conv"]["b"])]
    for name, a, w in pairs:
        _close(a.numpy(), w, name)


def _k4_case(rng, t, act, dtype):
    m = C if act else 3 * C
    pn, pc = _params(rng, m, 1)
    ins = [_t(_x(rng, t)), _t(pn["scale"]), _t(pn["bias"]), _t(pc["w"]),
           _t(pc["b"])]
    ins[0], ins[3] = ins[0].to(dtype), ins[3].to(dtype)
    g = _t(rng.randn(B, m, t).astype(np.float32)).to(dtype)
    xs = [v.detach().requires_grad_() for v in ins]
    out = k4.gn_conv1x1_plain(xs[0], {"scale": xs[1], "bias": xs[2]},
                              {"w": xs[3], "b": xs[4]}, G, act)
    want = torch.autograd.grad(out, xs, g)
    got = k4.gn_conv1x1_bwd_plain(*ins, g, G, act)
    return got, want, ("x", "gamma", "beta", "w", "b")


def _k5_case(rng, t, _act, dtype):
    pn, pc = _params(rng, C, 3)
    h, x = _t(_x(rng, t)).to(dtype), _t(rng.randn(B, C, t)).float().to(dtype)
    emb = _t(0.3 * rng.randn(B, 2 * C)).float().to(dtype)
    ins = [h, x, emb, _t(pn["scale"]), _t(pn["bias"]), _t(pc["w"]).to(dtype),
           _t(pc["b"])]
    g = _t(rng.randn(B, C, t).astype(np.float32)).to(dtype)
    xs = [v.detach().requires_grad_() for v in ins]
    out = k5.ts_res_block_out_plain(xs[0], xs[1], xs[2],
                                    {"scale": xs[3], "bias": xs[4]},
                                    {"w": xs[5], "b": xs[6]}, G)
    want = torch.autograd.grad(out, xs, g)
    dh, demb, dga, dbe, dw, db = k4.ts_res_block_out_bwd_plain(
        h, emb, *ins[3:], g, G)
    return ((dh, g, demb, dga, dbe, dw, db), want,
            ("h", "x", "emb", "gamma", "beta", "w", "b"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", TS)
@pytest.mark.parametrize("case,act", [(_k4_case, False), (_k4_case, True),
                                      (_k5_case, True)],
                         ids=["k4_qkv", "k4_in_half", "k5"])
def test_plain_backward_matches_autograd(case, act, t, dtype):
    got, want, names = case(np.random.RandomState(200 + t), t, act, dtype)
    for name, a, w in zip(names, got, want):
        assert a.dtype == w.dtype and a.shape == w.shape, name
        if dtype == torch.float32:
            _close(a.numpy(), w.numpy(), name)
        else:
            _rows_close(a, w, name)


class _Recorder:
    """A kernel's ``launch`` that records its arguments and launches
    nothing (the CPU has no kernel)."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args, entry=None):
        self.calls.append(args)


@pytest.mark.parametrize("which", ["gn_conv", "ts_res_block"])
def test_stats_recorded_only_under_autograd(monkeypatch, which):
    """The CUDA dispatch (``_cuda_call``), run here on CPU tensors with the
    launches recorded: the forward passes the statistics pointer only
    where autograd records the call, and the backward kernel reads the
    very buffer the forward wrote."""
    fwd, bwd = _Recorder(), _Recorder()
    mod = k4 if which == "gn_conv" else k5
    monkeypatch.setattr(mod.KERNEL, "launch", fwd)
    monkeypatch.setattr(mod.KERNEL_BWD, "launch", bwd)
    monkeypatch.setattr(k4, "_stream", lambda x: 0)
    monkeypatch.setattr(k5, "_stream", lambda x: 0)
    rng = np.random.RandomState(3)
    t = 17
    if which == "gn_conv":
        pn, pc = _params(rng, 3 * C, 1)
        x = _t(_x(rng, t))
        norm = {k: _t(v) for k, v in pn.items()}
        conv = {k: _t(v) for k, v in pc.items()}

        def call(x, norm, conv):
            return k4._cuda_call(x, norm, conv, G, False, 1e-5)
        stats_arg = 6
    else:
        pn, pc = _params(rng, C, 3)
        x = _t(_x(rng, t))
        norm = {k: _t(v) for k, v in pn.items()}
        conv = k5.prepare_conv({k: _t(v) for k, v in pc.items()})
        emb = _t(0.3 * rng.randn(B, 2 * C)).float()

        def call(x, norm, conv):
            return k5._cuda_call(x, x, emb, norm, conv, G, 1e-5)
        stats_arg = 8
    with torch.no_grad():
        call(x, norm, conv)
    call(x, norm, conv)                       # nothing requires grad
    assert [a[stats_arg] for a in fwd.calls] == [None, None]
    xg = x.detach().requires_grad_()
    out = call(xg, norm, conv)
    assert fwd.calls[-1][stats_arg] is not None
    assert not bwd.calls
    out.backward(torch.zeros_like(out))
    assert len(bwd.calls) == 1
    assert bwd.calls[0][6] == fwd.calls[-1][stats_arg]


@pytest.mark.parametrize("b,c,t,m,taps,dtype,transpose", [
    (16, 1024, 2240, 3072, 1, torch.bfloat16, False),   # the qkv head
    (16, 1024, 2240, 1024, 1, torch.bfloat16, False),   # the resblock in-half
    (2, 1024, 896, 1024, 1, torch.bfloat16, False),
    (2, 256, 283, 768, 1, torch.bfloat16, True),        # g's rows off 16 B
    (2, 256, 130, 256, 1, torch.bfloat16, True),
    (16, 1024, 2240, 1024, 3, torch.bfloat16, True),    # K5's taps
    (16, 1024, 2240, 3072, 1, torch.float32, True),     # fp32: split
])
def test_bwd_plan_transpose_choice(b, c, t, m, taps, dtype, transpose):
    """The backward makes the upstream time-major first (bwd_transpose)
    for K5 (its taps shift it along an outer TMA coordinate), in fp32
    (bwd_split_upstream: split, time-major and as it comes), and where
    T % 8 != 0; K4 in bf16 at T % 8 == 0 reads it as it comes.  The tile
    width and split stay the plan's."""
    p = k4.bwd_plan(b, c, t, m, 32, taps, dtype)
    assert p.transpose is transpose
    assert p.bn in (64, 128) and p.split >= 1


@pytest.mark.parametrize("b,c,t,m,taps,bn,split", [
    (16, 1024, 2240, 3072, 1, 128, 1),   # the qkv head: 384 dW tiles
    (16, 1024, 2240, 1024, 1, 128, 1),   # the resblock in-half: 128
    (16, 1024, 2240, 1024, 3, 128, 1),   # K5
    (2, 256, 283, 768, 1, 64, 5),        # the card tests' ragged T
    (2, 256, 130, 256, 3, 64, 5),
    (1, 64, 1, 64, 3, 64, 1),            # one K step
])
def test_bwd_plan_fp32(b, c, t, m, taps, bn, split):
    """fp32 (3xTF32): da's tile 128 steps where 128 x 128 tiles fill the
    SMs, else 64; dW's K split the fewest waves of 128 x 64 tiles (one
    block an SM) times the 32-step K steps a slice, the smaller split on
    a tie; the split upstream's floats: g's hi and lo time-major (B, T, M)
    and as it comes with T padded to 4."""
    p = k4.bwd_plan(b, c, t, m, 32 if c % 32 == 0 else 8, taps,
                    torch.float32)
    assert (p.bn, p.split, p.transpose) == (bn, split, True)
    tiles = taps * -(-m // k4.DW_F32_ROWS) * -(-c // k4.GEMM_ROWS)
    kt = b * -(-t // k4.F32_K_STEP)
    cost = [(-(-tiles * s // k4.SMS) * -(-kt // s), s)
            for s in range(1, min(8, kt) + 1)]
    assert min(cost)[1] == split
    tp = -(-t // 4) * 4
    assert k4.bwd_upstream_floats(b, m, t) == 2 * b * t * m + 2 * b * m * tp


def test_bwd_plan_refuses_m_off_8():
    """The backward's upstream rows are read in 16-byte pieces: M % 8 != 0
    raises before any launch, in both types."""
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="M % 8"):
            k4.bwd_plan(2, 64, 130, 12, 16, 1, dtype)


def test_k5_da_from_the_tap_major_weight():
    """K5's bf16 da reads the forward's tap-major weight with its taps
    reversed and transposed (``ts_res_block.da_taps_plain``): the same
    products, bit for bit, as the reversed, transposed copy the backward
    made before (wb[s'] = W[:, :, 2 - s']^T against the upstream shifted
    by s' - 1), and the convolution's input gradient (autograd of conv1d)
    within fp32's sums."""
    rng = np.random.RandomState(5)
    w = _t(0.1 * rng.randn(C, C, 3)).float()
    g = _t(rng.randn(B, C, 37)).float()
    wb = w.flip(2).permute(2, 1, 0).contiguous()
    gp = torch.nn.functional.pad(g, (1, 1))
    flipped = sum(torch.matmul(wb[s], gp[..., s:s + 37]) for s in range(3))
    got = k5.da_taps_plain(k5.taps(w), g)
    assert torch.equal(got, flipped)
    y = torch.zeros(B, C, 37, requires_grad=True)
    (want,) = torch.autograd.grad(
        torch.nn.functional.conv1d(y, w, padding=1), y, g)
    _close(got.numpy(), want.numpy(), "da")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_backward_takes_the_tap_major_weight(monkeypatch, dtype):
    """K5's CUDA dispatch on CPU tensors, launches recorded: in bf16 the
    backward passes the forward's tap-major weight itself (no per-call
    copy) with the 128-step da tiles of ``bwd_da_pingpong``; in fp32 a
    reversed, transposed copy of ``w``."""
    fwd, bwd = _Recorder(), _Recorder()
    monkeypatch.setattr(k5.KERNEL, "launch", fwd)
    monkeypatch.setattr(k5.KERNEL_BWD, "launch", bwd)
    monkeypatch.setattr(k4, "_stream", lambda x: 0)
    monkeypatch.setattr(k5, "_stream", lambda x: 0)
    rng = np.random.RandomState(4)
    pn, pc = _params(rng, C, 3)
    x = _t(_x(rng, 40)).to(dtype).requires_grad_()
    norm = {k: _t(v) for k, v in pn.items()}
    conv = k5.prepare_conv({k: _t(v).to(dtype) if k == "w" else _t(v)
                            for k, v in pc.items()})
    emb = _t(0.3 * rng.randn(B, 2 * C)).float()
    out = k5._cuda_call(x, x, emb, norm, conv, G, 1e-5)
    out.backward(torch.zeros_like(out))
    (args,) = bwd.calls
    bf16 = dtype == torch.bfloat16
    assert (args[4] == conv["w_taps"].data_ptr()) is bf16
    if bf16:
        assert args[-4] == 128

