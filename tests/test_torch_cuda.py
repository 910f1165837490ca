"""Each CUDA kernel of the port against its plain PyTorch version, in
bf16 on the card.  CUDA kernels have no CPU mode, so every test here is
marked ``cuda`` and skips where there is no card.  The file imports no
JAX, so it also runs on the GPU machine, which has none:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from tortoise_tts_tpu_torch.kernels import flash_attention as k1
from tortoise_tts_tpu_torch.kernels import flash_attention_bias as k6
from tortoise_tts_tpu_torch.kernels import flash_decode as k3
from tortoise_tts_tpu_torch.kernels import gn_conv as k4
from tortoise_tts_tpu_torch.kernels import qgemv as k2
from tortoise_tts_tpu_torch.kernels import qgemv_w8a8 as k8
from tortoise_tts_tpu_torch.kernels import snake as k7
from tortoise_tts_tpu_torch.kernels import ts_res_block as k5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16_close(got, want, atol, rtol=2e-2):
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
def test_flash_attention_kernel_cuda(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(1, 16, 131, 64, generator=g, device=cuda,
                           dtype=torch.bfloat16) for _ in range(3))
    mask = torch.rand(1, 131, generator=g, device=cuda) > 0.2
    mask[:, 0] = True
    before = k1.KERNEL.launches
    got = k1.flash_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert k1.KERNEL.launches == before + 1
    _bf16_close(got, k1.flash_attention_plain(q, k, v, mask), atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,m,ln", [(1024, 3072, 1, True),
                                      (4096, 1024, 1, False),
                                      (1024, 4096, 5, True),
                                      (1024, 3072, 32, True),
                                      (4096, 1024, 32, False)])
def test_qgemv_kernel_cuda(cuda, k, n, m, ln):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=cuda,
                       dtype=torch.int8)
    s = torch.rand(n, generator=g, device=cuda) * 1e-3
    b = torch.randn(n, generator=g, device=cuda) * 0.1
    lnp = ((1 + 0.1 * torch.randn(k, generator=g, device=cuda),
            0.1 * torch.randn(k, generator=g, device=cuda)) if ln else None)
    got = k2.qgemv(x, wq, s, b, ln=lnp)
    torch.cuda.synchronize()
    _bf16_close(got, k2.qgemv_plain(x, wq, s, b, ln=lnp), atol=2e-2)


DECODE_SHAPES = [(1024, 3072, True), (1024, 1024, False), (1024, 4096, True),
                 (4096, 1024, False)]


def _w8a8_inputs(dev, m, k, n, ln, dtype, seed=9):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev,
                       dtype=torch.int8)
    s = torch.rand(n, generator=g, device=dev) * 2e-4
    b = torch.randn(n, generator=g, device=dev) * 0.1
    lnp = ((1 + 0.1 * torch.randn(k, generator=g, device=dev),
            0.1 * torch.randn(k, generator=g, device=dev)) if ln else None)
    return x, wq, s, b, lnp


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 32])
@pytest.mark.parametrize("k,n,ln", DECODE_SHAPES)
def test_qgemv_w8a8_kernel_cuda(cuda, k, n, ln, m):
    """K8 at the four decode GEMVs.  In fp32 without the LN the codes, the
    scales and the output are bit-equal to the plain version.  With the
    LN (and in bf16) the row sums run in another order, so a code on a
    rounding edge may move by one step: at most one step, on few codes,
    and the output is the plain epilogue of the kernel's own codes."""
    for dtype in (torch.float32, torch.bfloat16):
        x, wq, s, b, lnp = _w8a8_inputs(cuda, m, k, n, ln, dtype)
        before = k8.KERNEL.launches
        got = k8.qgemv_w8a8(x, wq, s, b, ln=lnp)
        torch.cuda.synchronize()
        assert k8.KERNEL.launches == before + 1
        y, codes, sx = k8.qgemv_w8a8_codes(x, wq, s, b, ln=lnp)
        assert torch.equal(y, got)
        xn = x if lnp is None else k8.ln_f32(x.float(), *lnp).to(dtype)
        want_codes, want_sx = k8.quantize_rowwise(xn)
        want = k8.qgemv_w8a8_plain(x, wq, s, b, ln=lnp)
        if lnp is None:
            ndiff = int((codes != want_codes).sum())
            assert ndiff == 0, f"{dtype}: {ndiff} codes differ"
            assert torch.equal(sx, want_sx[:, 0]), dtype
            err = float((got.float() - want.float()).abs().max())
            assert torch.equal(got, want), f"{dtype}: max abs err {err}"
            continue
        step = (codes.int() - want_codes.int()).abs()
        assert int(step.max()) <= 1 and int(step.sum()) <= m * k // 100
        torch.testing.assert_close(sx, want_sx[:, 0], atol=0, rtol=1e-6)
        own = ((codes.double() @ wq.double()).float() * sx[:, None] * s
               + b).to(dtype)
        torch.testing.assert_close(got, own, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 31, 32, 599])
def test_flash_decode_kernel_cuda(cuda, pos):
    g = torch.Generator(device=cuda).manual_seed(2)
    ck, cv = (torch.randn(1, 16, 600, 64, generator=g, device=cuda,
                          dtype=torch.bfloat16) for _ in range(2))
    q = torch.randn(1, 16, 64, generator=g, device=cuda,
                    dtype=torch.bfloat16)
    mask = torch.ones(1, 600, dtype=torch.bool, device=cuda)
    mask[:, 3:7] = False
    got = k3.flash_decode(q, ck, cv, pos, mask)
    torch.cuda.synchronize()
    _bf16_close(got, k3.flash_decode_plain(q, ck, cv, pos, mask), atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("g,c,sp,pos", [(1, 16, 68, 0), (1, 16, 68, 199),
                                        (2, 3, 37, 64), (3, 1, 5, 31)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_shared_kernel_cuda(cuda, g, c, sp, pos, dtype):
    """K3's shared-prefix form: G groups of C rows over a per-group prefix
    with text-padding holes and a 200-slot region up to pos."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, h, sd = g * c, 16, 200
    q = torch.randn(b, h, 64, generator=gen, device=cuda, dtype=dtype)
    kp, vp = (torch.randn(g, h, sp, 64, generator=gen, device=cuda,
                          dtype=dtype) for _ in range(2))
    kd, vd = (torch.randn(b, h, sd, 64, generator=gen, device=cuda,
                          dtype=dtype) for _ in range(2))
    pmask = torch.rand(g, sp, generator=gen, device=cuda) > 0.2
    pmask[:, 0] = True
    before = k3.KERNEL_SHARED.launches
    got = k3.flash_decode_shared(q, kp, vp, pmask, kd, vd, pos)
    torch.cuda.synchronize()
    assert k3.KERNEL_SHARED.launches == before + 1
    want = k3.flash_decode_shared_plain(q, kp, vp, pmask, kd, vd, pos)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(got, want, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,dtype", [(16, 16, 896, torch.bfloat16),
                                         (8, 16, 896, torch.bfloat16),
                                         (8, 4, 300, torch.bfloat16),
                                         (8, 2, 257, torch.float32),
                                         (9, 2, 64, torch.float32)])
def test_flash_attention_bias_kernel_cuda(cuda, monkeypatch, b, h, t, dtype):
    """K6 at the batch route's shapes (trunk B=16, integrator B=8, T=896),
    at ragged T (no multiple of the 64-key tile, odd T: the unvectorised
    loads) and in fp32."""
    _fp32_exact(monkeypatch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(8)
    qkv = (torch.randn(b, h * 192, t, generator=gen, device=cuda)
           * 0.5).to(dtype)
    bias = (torch.randn(h, t, t, generator=gen, device=cuda) * 2).to(dtype)
    before = k6.KERNEL.launches
    got = k6.flash_attention_bias(qkv, bias, h)
    torch.cuda.synchronize()
    assert k6.KERNEL.launches == before + 1
    want = k6.flash_attention_bias_plain(qkv, bias, h)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(got, want, atol=3e-2)


def _fp32_exact(monkeypatch, dtype):
    """fp32 comparisons run the plain version in full fp32: cuDNN's
    convolutions default to TF32."""
    if dtype == torch.float32:
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


def _gn_conv_inputs(dev, b, c, t, m, k, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(b, c, t, generator=g, device=dev) * 2 + 0.5).to(dtype)
    norm = {"scale": 1 + 0.1 * torch.randn(c, generator=g, device=dev),
            "bias": 0.1 * torch.randn(c, generator=g, device=dev)}
    bound = (c * k) ** -0.5
    conv = {"w": ((torch.rand(m, c, k, generator=g, device=dev) * 2 - 1)
                  * bound).to(dtype),
            "b": (torch.rand(m, generator=g, device=dev) * 2 - 1) * bound}
    return x, norm, conv


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t,m,act,dtype", [
    (2, 1024, 896, 1024, True, torch.bfloat16),    # resblock in-half
    (2, 1024, 896, 3072, False, torch.bfloat16),   # attention qkv head
    (1, 1024, 517, 3072, False, torch.bfloat16),   # AR conditioning head
    (1, 2048, 101, 6144, False, torch.bfloat16),   # contextual embedder
    (2, 64, 45, 192, True, torch.float32)])        # fp32 reference runs
def test_gn_conv_kernel_cuda(cuda, monkeypatch, b, c, t, m, act, dtype):
    _fp32_exact(monkeypatch, dtype)
    x, norm, conv = _gn_conv_inputs(cuda, b, c, t, m, 1, dtype, 3)
    before = k4.KERNEL.launches
    got = k4.gn_conv1x1(x, norm, conv, 32 if c > 64 else 16, act)
    torch.cuda.synchronize()
    assert k4.KERNEL.launches == before + 1
    want = k4.gn_conv1x1_plain(x, norm, conv, 32 if c > 64 else 16, act)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(got, want, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t,dtype", [(2, 1024, 896, torch.bfloat16),
                                         (1, 1024, 896, torch.bfloat16),
                                         (2, 64, 45, torch.float32)])
def test_ts_res_block_kernel_cuda(cuda, monkeypatch, b, c, t, dtype):
    _fp32_exact(monkeypatch, dtype)
    h, norm, conv = _gn_conv_inputs(cuda, b, c, t, c, 3, dtype, 4)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=cuda)).to(dtype)
    groups = 32 if c > 64 else 16
    got = k5.ts_res_block_out(h, x, emb, norm, conv, groups)
    torch.cuda.synchronize()
    want = k5.ts_res_block_out_plain(h, x, emb, norm, conv, groups)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(got, want, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t,dtype", [(1, 768, 3624, torch.bfloat16),
                                         (1, 24, 231936, torch.bfloat16),
                                         (2, 5, 8, torch.float32),
                                         (1, 3, 2049, torch.float32),
                                         (1, 4, 3, torch.float32),
                                         (1, 3, 1, torch.float32)])
def test_snake_kernel_cuda(cuda, monkeypatch, b, c, t, dtype):
    _fp32_exact(monkeypatch, dtype)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    alpha = torch.exp(0.3 * torch.randn(c, generator=g, device=cuda))
    inv_beta = 1 / (torch.exp(0.3 * torch.randn(c, generator=g, device=cuda))
                    + 1e-9)
    got = k7.snake_resample2(x, alpha, inv_beta)
    torch.cuda.synchronize()
    want = k7.snake_resample2_plain(x, alpha, inv_beta)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(got, want, atol=5e-2)
