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
from tortoise_tts_tpu_torch.kernels import flash_attention_bias_cm as k9b
from tortoise_tts_tpu_torch.kernels import flash_attention_bias_kq as k9a
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


def _fused_qkv(dev, b, h, s, dtype, seed):
    """q, k, v as views of one fused qkv projection (as _gpt_prefill passes
    them) and a key mask with text-padding holes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * 64, generator=g, device=dev, dtype=dtype)
    q, k, v = (z.view(b, s, h, 64).transpose(1, 2)
               for z in qkv.split(h * 64, dim=-1))
    mask = torch.rand(b, s, generator=g, device=dev) > 0.2
    mask[:, 0] = True
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 63, 65, 68, 269])
def test_flash_attention_kernel_cuda(cuda, s, b, dtype, causal):
    """K1 with and without the key mask, ragged S around the 16-query and
    64-key tiles, the prefill (68) and the latent pass (269): one launch
    and one CUDA kernel a call (tensor cores in bf16, CUDA cores in
    fp32)."""
    q, k, v, mask = _fused_qkv(cuda, b, 16, s, dtype, seed=s)
    for km in (mask, None):
        before = k1.KERNEL.launches
        got = k1.flash_attention(q, k, v, km, causal)
        torch.cuda.synchronize()
        assert k1.KERNEL.launches == before + 1
        want = k1.flash_attention_plain(q, k, v, km, causal)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        else:
            _bf16_close(got, want, atol=2e-2)
    names = _cuda_kernel_names(
        lambda: k1.flash_attention(q, k, v, mask, causal))
    kernel = "flash_attn_mma" if dtype == torch.bfloat16 else "flash_attn_f32"
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_misaligned_cuda(cuda):
    """No fallback: bf16 q/k/v rows off the 16 bytes the kernel's copies
    need raise."""
    b, h, s = 1, 16, 68
    buf = torch.randn(b * s * 3 * h * 64 + 1, device=cuda,
                      dtype=torch.bfloat16)
    qkv = buf[1:].view(b, s, 3 * h * 64)
    q, k, v = (z.view(b, s, h, 64).transpose(1, 2)
               for z in qkv.split(h * 64, dim=-1))
    before = k1.KERNEL.launches
    with pytest.raises(ValueError, match="aligned"):
        k1.flash_attention(q, k, v, None)
    assert k1.KERNEL.launches == before


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


def _check_w8a8(x, wq, s, b, lnp, **launch):
    """One K8 call (through ``_launch`` with ``launch``'s options if
    given) against its plain version.  In fp32 without the LN the
    codes, the scales and the output are bit-equal to the plain version.
    With the LN (and in bf16) the row sums run in another order, so a code
    on a rounding edge may move by one step: at most one step, on few
    codes, and the output is the plain epilogue of the kernel's own
    codes."""
    m, k = x.shape
    dtype = x.dtype
    before = k8.KERNEL.launches
    if launch:
        got = k8._launch(x, wq, s, b, lnp, **launch)[0]
    else:
        got = k8.qgemv_w8a8(x, wq, s, b, ln=lnp)
    torch.cuda.synchronize()
    assert k8.KERNEL.launches == before + 1
    y, codes, sx = (k8._launch(x, wq, s, b, lnp, **launch) if launch
                    else k8.qgemv_w8a8_codes(x, wq, s, b, ln=lnp))
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
        return
    step = (codes.int() - want_codes.int()).abs()
    assert int(step.max()) <= 1 and int(step.sum()) <= m * k // 100
    torch.testing.assert_close(sx, want_sx[:, 0], atol=0, rtol=1e-6)
    own = ((codes.double() @ wq.double()).float() * sx[:, None] * s
           + b).to(dtype)
    torch.testing.assert_close(got, own, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 16, 32])
@pytest.mark.parametrize("k,n,ln", DECODE_SHAPES)
def test_qgemv_w8a8_kernel_cuda(cuda, k, n, ln, m):
    """K8 at the four decode GEMVs, in fp32 and bf16 (``_check_w8a8``)."""
    for dtype in (torch.float32, torch.bfloat16):
        _check_w8a8(*_w8a8_inputs(cuda, m, k, n, ln, dtype))


# M across the kernels' 16-row tiles and 64-row blocks
ROW_COUNTS = [1, 3, 16, 17, 32, 33]


@pytest.mark.cuda
@pytest.mark.parametrize("m", ROW_COUNTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ln", [False, True])
def test_qgemv_w8a8_rows_cuda(cuda, m, dtype, ln):
    """K8 at row counts that cross its tiles, as ``_check_w8a8`` holds it
    (fp32 without the LN bit-equal); up to 16 rows both forms, the
    quantize kernel first and the quantizer in the GEMM."""
    inputs = _w8a8_inputs(cuda, m, 1024, 3072, ln, dtype, seed=m)
    _check_w8a8(*inputs)
    if m <= k8.FUSED_ROWS:
        for fused in (False, True):
            _check_w8a8(*inputs, fused=fused)


def _qgemv_close(got, want):
    if got.dtype == torch.float32:
        # fp32 on both sides: only the order of the sums differs
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(got, want, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("m", ROW_COUNTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ln", [False, True])
def test_qgemv_rows_cuda(cuda, m, dtype, ln):
    """K2 at row counts that cross its tiles; in bf16 with the LN both of
    its forms (in the GEMM's prologue and in the row kernel)."""
    x, wq, s, b, lnp = _w8a8_inputs(cuda, m, 1024, 3072, ln, dtype,
                                    seed=100 + m)
    s = s * 5
    want = k2.qgemv_plain(x, wq, s, b, ln=lnp)
    before = k2.KERNEL.launches
    _qgemv_close(k2.qgemv(x, wq, s, b, ln=lnp), want)
    assert k2.KERNEL.launches == before + 1
    if ln and dtype == torch.bfloat16 and m <= k2.FUSED_ROWS:
        for fused in (False, True):
            _qgemv_close(k2._launch(x, wq, s, b, lnp, ln_fused=fused), want)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_qgemv_split_k_counters_cuda(cuda):
    """The split-K arrival counters: successive calls of different shapes
    and splits on one stream, and a call after one that raised at launch
    (a K slice too large for shared memory), all right."""
    cases = [(32, 1024, 4096, True), (1, 4096, 1024, False),
             (17, 1024, 1024, False), (33, 4096, 1024, True),
             (1, 1024, 3072, True)]
    inputs = [_w8a8_inputs(cuda, m, k, n, ln, torch.bfloat16, seed=i)
              for i, (m, k, n, ln) in enumerate(cases)]
    for _ in range(2):
        for x, wq, s, b, lnp in inputs:
            _bf16_close(k2.qgemv(x, wq, s, b, ln=lnp),
                        k2.qgemv_plain(x, wq, s, b, ln=lnp), atol=2e-2)
            _check_w8a8(x, wq, s, b, lnp)
    x, wq, s, b, lnp = _w8a8_inputs(cuda, 64, 4096, 1024, False,
                                    torch.bfloat16)
    with pytest.raises(RuntimeError):
        k2._launch(x, wq, s, b, None, ks=1)     # 530 KB of shared memory
    for ks in (4, 8, 16):   # splits of this shape after the failure
        _bf16_close(k2._launch(x, wq, s, b, None, ks=ks),
                    k2.qgemv_plain(x, wq, s, b), atol=2e-2)
    for x, wq, s, b, lnp in inputs:
        _check_w8a8(x, wq, s, b, lnp)


def _kernel_base(name):
    """A CUDA kernel's demangled name without its namespace, template
    arguments and parameters: "bwd_da_wgmma"."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].split("<")[0].split("::")[-1]


def _cuda_kernel_names(fn):
    """The CUDA kernels one call of fn launches, by torch.profiler (after
    a pause and spin kernels: the profiler can drop a window's first
    kernels; a window in which it saw none is profiled again, up to three
    times)."""
    import time

    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(16):
                torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if "CUDA" in str(e.device_type)
                 and "spin_kernel" not in e.name]
        if names:
            return names
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 32, 33])
@pytest.mark.parametrize("k,n,ln", DECODE_SHAPES)
def test_qgemv_kernels_per_call_cuda(cuda, m, k, n, ln):
    """One K2 or K8 call is at most two CUDA kernels at every M: one GEMM
    for all rows (no merge kernel), and a row kernel (K2's LN rows, K8's
    quantize) unless the GEMM does its work."""
    x, wq, s, b, lnp = _w8a8_inputs(cuda, m, k, n, ln, torch.bfloat16)
    names = _cuda_kernel_names(lambda: k2.qgemv(x, wq, s, b, ln=lnp))
    assert len(names) <= 2 and sum("qgemv_gemm" in n for n in names) == 1, \
        names
    names = _cuda_kernel_names(lambda: k8.qgemv_w8a8(x, wq, s, b, ln=lnp))
    quantize = 0 if m <= k8.QUANT_FUSED_MAX_M else 1
    assert len(names) <= 2 and sum("w8a8_gemm" in n for n in names) == 1 \
        and sum("w8a8_quantize" in n for n in names) == quantize, names


def _decode_inputs(dev, b, s, dtype, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    ck, cv = (torch.randn(b, 16, s, 64, generator=g, device=dev, dtype=dtype)
              for _ in range(2))
    qkv = torch.randn(b, 3 * 16 * 64, generator=g, device=dev, dtype=dtype)
    q = qkv[:, :16 * 64].view(b, 16, 64)
    mask = torch.ones(b, s, dtype=torch.bool, device=dev)
    mask[:, 3:7] = False
    return q, ck, cv, mask


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("pos", [0, 31, 32, 267, 599])
def test_flash_decode_kernel_cuda(cuda, pos, b):
    """K3 over 268 slots (the decode's last step at pos 267) or 600, with
    key-mask holes: pos from device memory gives the int's result bit for
    bit; one launch and one CUDA kernel a call."""
    s = 268 if pos == 267 else 600
    q, ck, cv, mask = _decode_inputs(cuda, b, s, torch.bfloat16)
    dpos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = k3.KERNEL.launches
    got = k3.flash_decode(q, ck, cv, pos, mask)
    got_dev = k3.flash_decode(q, ck, cv, dpos, mask)
    torch.cuda.synchronize()
    assert k3.KERNEL.launches == before + 2
    assert torch.equal(got, got_dev)
    _bf16_close(got, k3.flash_decode_plain(q, ck, cv, pos, mask), atol=2e-2)
    names = _cuda_kernel_names(
        lambda: k3.flash_decode(q, ck, cv, dpos, mask))
    assert len(names) == 1 and "fd_cluster" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("pos", [0, 32, 267])
def test_flash_decode_kernel_fp32_cuda(cuda, pos):
    """The fp32 entry keeps fp32 arithmetic: within 1e-5 of the plain
    version."""
    q, ck, cv, mask = _decode_inputs(cuda, 1, 268, torch.float32)
    got = k3.flash_decode(q, ck, cv, pos, mask)
    torch.testing.assert_close(got, k3.flash_decode_plain(q, ck, cv, pos,
                                                          mask),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
def test_flash_decode_kernel_refuses_bad_pos_cuda(cuda):
    """No fallback: a pos the kernel cannot take raises before a launch."""
    q, ck, cv, mask = _decode_inputs(cuda, 1, 64, torch.bfloat16)
    before = k3.KERNEL.launches
    for pos in (64, -1, torch.tensor(3, device=cuda),
                torch.tensor([3], dtype=torch.int32, device=cuda)):
        with pytest.raises(ValueError):
            k3.flash_decode(q, ck, cv, pos, mask)
    assert k3.KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("g,c,sp,pos", [(1, 16, 68, 0), (1, 16, 68, 199),
                                        (2, 16, 68, 199), (2, 3, 37, 64),
                                        (3, 1, 5, 31)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_shared_kernel_cuda(cuda, g, c, sp, pos, dtype):
    """K3's shared-prefix form: G groups of C rows over a per-group prefix
    with text-padding holes and a 200-slot region up to pos; pos from
    device memory bit-equal to the int; one launch and one CUDA kernel a
    call."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, h, sd = g * c, 16, 200
    q = torch.randn(b, h, 64, generator=gen, device=cuda, dtype=dtype)
    kp, vp = (torch.randn(g, h, sp, 64, generator=gen, device=cuda,
                          dtype=dtype) for _ in range(2))
    kd, vd = (torch.randn(b, h, sd, 64, generator=gen, device=cuda,
                          dtype=dtype) for _ in range(2))
    pmask = torch.rand(g, sp, generator=gen, device=cuda) > 0.2
    pmask[:, 0] = True
    dpos = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = k3.KERNEL_SHARED.launches
    got = k3.flash_decode_shared(q, kp, vp, pmask, kd, vd, pos)
    got_dev = k3.flash_decode_shared(q, kp, vp, pmask, kd, vd, dpos)
    torch.cuda.synchronize()
    assert k3.KERNEL_SHARED.launches == before + 2
    assert torch.equal(got, got_dev)
    want = k3.flash_decode_shared_plain(q, kp, vp, pmask, kd, vd, pos)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(got, want, atol=2e-2)
    names = _cuda_kernel_names(
        lambda: k3.flash_decode_shared(q, kp, vp, pmask, kd, vd, dpos))
    assert len(names) == 1 and "fd_cluster" in names[0], names


# The biased attention kernels (K6, K9a, K9b) at B = 1 and 2 (the default
# route's integrator and trunk), 8 and 16 (the batch route's), 3 and 9
# (odd), T = 64 (one tile), 257 and 300 (ragged, rows off 16 bytes: warp
# 0's element copies) and 896 (the routes, at H=16; the others at H=4),
# in bf16 and fp32.
BIAS_B = [1, 2, 3, 8, 9, 16]
BIAS_T = [64, 257, 300, 896]
BIAS_DTYPES = [torch.bfloat16, torch.float32]
# each kernel's CUDA kernel in bf16 and fp32 (both on the tensor cores)
BIAS_KERNELS = {"k6": ("attn_bias_tc", "attn_bias_f32"),
                "k9a": ("attn_bias_kq_tc", "attn_bias_kq_f32"),
                "k9b": ("attn_bias_cm_tc", "attn_bias_cm_f32")}


def _bias_inputs(dev, b, t, dtype, seed=9):
    h = 16 if t == 896 else 4
    gen = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn(b, h * 192, t, generator=gen, device=dev)
           * 0.5).to(dtype)
    bias = (torch.randn(h, t, t, generator=gen, device=dev) * 2).to(dtype)
    return qkv, bias, h


def _bias_close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(got, want, atol=3e-2)


def _one_bias_kernel(fn, kernel, dtype):
    """fn() is one CUDA kernel, the named kernel's bf16 or fp32 one."""
    names = _cuda_kernel_names(fn)
    want = BIAS_KERNELS[kernel][dtype == torch.float32]
    assert len(names) == 1 and want in names[0], names
    if kernel == "k6":   # "attn_bias_tc" is no part of the others' names
        assert "_kq_" not in names[0] and "_cm_" not in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BIAS_DTYPES)
@pytest.mark.parametrize("t", BIAS_T)
@pytest.mark.parametrize("b", BIAS_B)
def test_flash_attention_bias_kernel_cuda(cuda, monkeypatch, b, t, dtype):
    """K6 against its plain version: one launch and one CUDA kernel a
    call."""
    _fp32_exact(monkeypatch, dtype)
    qkv, bias, h = _bias_inputs(cuda, b, t, dtype, seed=8)
    before = k6.KERNEL.launches
    got = k6.flash_attention_bias(qkv, bias, h)
    torch.cuda.synchronize()
    assert k6.KERNEL.launches == before + 1
    _bias_close(got, k6.flash_attention_bias_plain(qkv, bias, h), dtype)
    _one_bias_kernel(lambda: k6.flash_attention_bias(qkv, bias, h), "k6",
                     dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BIAS_DTYPES)
@pytest.mark.parametrize("t", BIAS_T)
@pytest.mark.parametrize("b", BIAS_B)
def test_flash_attention_bias_kq_kernel_cuda(cuda, monkeypatch, b, t, dtype):
    """K9a against its plain version, the bias transposed, (H, S, Tq),
    read in place: one launch and one CUDA kernel a call."""
    _fp32_exact(monkeypatch, dtype)
    qkv, bias, h = _bias_inputs(cuda, b, t, dtype)
    bias_t = bias.transpose(1, 2).contiguous()
    before = k9a.KERNEL.launches
    got = k9a.flash_attention_bias_kq(qkv, bias_t, h)
    torch.cuda.synchronize()
    assert k9a.KERNEL.launches == before + 1
    _bias_close(got, k9a.flash_attention_bias_kq_plain(qkv, bias_t, h),
                dtype)
    _one_bias_kernel(lambda: k9a.flash_attention_bias_kq(qkv, bias_t, h),
                     "k9a", dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", BIAS_DTYPES)
@pytest.mark.parametrize("t", BIAS_T)
@pytest.mark.parametrize("b", BIAS_B)
def test_flash_attention_bias_cm_kernel_cuda(cuda, monkeypatch, b, t, dtype):
    """K9b's two entries, fused qkv and split q, k, v, against their plain
    versions; both add to one launch count, each call one CUDA kernel."""
    _fp32_exact(monkeypatch, dtype)
    qkv, bias, h = _bias_inputs(cuda, b, t, dtype)
    before = k9b.KERNEL.launches
    got = k9b.flash_attention_bias_qkv(qkv, bias, h)
    torch.cuda.synchronize()
    assert k9b.KERNEL.launches == before + 1
    _bias_close(got, k9b.flash_attention_bias_qkv_plain(qkv, bias, h), dtype)
    q, k, v = (x.contiguous() for x in
               qkv.view(b, h, 3, 64, t).unbind(2))
    got = k9b.flash_attention_bias_cm(q, k, v, bias)
    torch.cuda.synchronize()
    assert k9b.KERNEL.launches == before + 2
    _bias_close(got, k9b.flash_attention_bias_cm_plain(q, k, v, bias), dtype)
    _one_bias_kernel(lambda: k9b.flash_attention_bias_qkv(qkv, bias, h),
                     "k9b", dtype)
    _one_bias_kernel(lambda: k9b.flash_attention_bias_cm(q, k, v, bias),
                     "k9b", dtype)


@pytest.mark.cuda
def test_flash_attention_bias_refuses_other_plans_cuda(cuda):
    """The C entries take the wrapper's launch plan and refuse one their
    kernel was not built for: no silent fallback to another shape."""
    qkv, bias, h = _bias_inputs(cuda, 2, 896, torch.bfloat16)
    bias_t = bias.transpose(1, 2).contiguous()
    for p in (k6.Plan(2, 1, 2, True), k6.Plan(1, 2, 2, True),
              k6.Plan(1, 1, 3, True)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            k6._launch(qkv, bias, h, plan_=p)
        with pytest.raises(RuntimeError, match="CUDA error"):
            k9a._launch(qkv, bias_t, h, plan_=p)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [300, 896])
@pytest.mark.parametrize("b", BIAS_B)
def test_flash_attention_bias_entries_bit_equal_cuda(cuda, b, t):
    """K6, K9a (given the transposed bias) and both entries of K9b run one
    body (csrc/attention_bias.cuh): on the same bf16 data their outputs
    are equal bit for bit, by TMA (T=896) and by warp 0's element copies
    (T=300)."""
    qkv, bias, h = _bias_inputs(cuda, b, t, torch.bfloat16, seed=10)
    want = k6.flash_attention_bias(qkv, bias, h)
    q, k, v = (x.contiguous() for x in qkv.view(b, h, 3, 64, t).unbind(2))
    for got in (k9a.flash_attention_bias_kq(
                    qkv, bias.transpose(1, 2).contiguous(), h),
                k9b.flash_attention_bias_qkv(qkv, bias, h),
                k9b.flash_attention_bias_cm(q, k, v, bias).view(b, h * 64,
                                                                 t)):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [300, 416, 896])
@pytest.mark.parametrize("b", [2, 16])
def test_flash_attention_bias_f32_same_bits_cuda(cuda, monkeypatch, b, t):
    """The fp32 (3xTF32) body: two calls of each entry give the same bits
    (no atomics, one summation order), and K6, K9a (given the transposed
    bias) and both entries of K9b, which run that one body, give equal
    bits on the same fp32 data, by element copies (T=300) and by TMA (T=416,
    whose last step's second 32-key box lies wholly past T, and 896); each
    within 1e-5 of the plain version."""
    _fp32_exact(monkeypatch, torch.float32)
    qkv, bias, h = _bias_inputs(cuda, b, t, torch.float32, seed=11)
    bias_t = bias.transpose(1, 2).contiguous()
    q, k, v = (x.contiguous() for x in qkv.view(b, h, 3, 64, t).unbind(2))
    calls = (lambda: k6.flash_attention_bias(qkv, bias, h),
             lambda: k9a.flash_attention_bias_kq(qkv, bias_t, h),
             lambda: k9b.flash_attention_bias_qkv(qkv, bias, h),
             lambda: k9b.flash_attention_bias_cm(q, k, v, bias).view(
                 b, h * 64, t))
    want = calls[0]()
    _bias_close(want, k6.flash_attention_bias_plain(qkv, bias, h),
                torch.float32)
    for call in calls:
        got = call()
        assert torch.equal(got.view(torch.int32), call().view(torch.int32))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
@pytest.mark.parametrize("b,c,t,m,act,dtype,groups", [
    (2, 1024, 896, 1024, True, torch.bfloat16, 32),    # resblock in-half
    (2, 1024, 896, 3072, False, torch.bfloat16, 32),   # attention qkv head
    (1, 1024, 517, 3072, False, torch.bfloat16, 32),   # AR conditioning head
    (1, 2048, 101, 6144, False, torch.bfloat16, 32),   # contextual embedder
    # the classifier's heads at 9.28 s of 24 kHz audio: C = 512 in 32
    # groups of 16, T = 218 (128-wide T tiles at B = 16, 64-wide at B = 1)
    (16, 512, 218, 1536, False, torch.bfloat16, 32),
    (1, 512, 218, 1536, False, torch.bfloat16, 32),
    # ragged T, M and K (136 = 2 x 64 + 8) at B = 16; 17 channels a group
    (16, 136, 1, 192, True, torch.bfloat16, 8),
    (16, 136, 7, 192, False, torch.bfloat16, 8),
    (16, 136, 45, 192, True, torch.bfloat16, 8),
    (16, 136, 517, 192, False, torch.bfloat16, 8),
    (2, 64, 45, 192, True, torch.float32, 16),         # fp32 reference runs
    # the conditioning heads as ``emb.process`` runs them (float32: K
    # split over a cluster of 2 and 5 blocks)
    (1, 1024, 517, 3072, False, torch.float32, 32),
    (1, 2048, 101, 6144, False, torch.float32, 32),
    # TTS(dtype="float32")'s denoiser, ragged T, M and K in fp32
    (2, 1024, 896, 1024, True, torch.float32, 32),
    (2, 1024, 896, 3072, False, torch.float32, 32),
    (1, 1024, 896, 1024, True, torch.float32, 32),
    (16, 136, 45, 192, True, torch.float32, 8),
    (3, 136, 1, 200, False, torch.float32, 8)])
def test_gn_conv_kernel_cuda(cuda, monkeypatch, b, c, t, m, act, dtype,
                             groups):
    _fp32_exact(monkeypatch, dtype)
    x, norm, conv = _gn_conv_inputs(cuda, b, c, t, m, 1, dtype, 3)
    before = k4.KERNEL.launches
    got = k4.gn_conv1x1(x, norm, conv, groups, act)
    torch.cuda.synchronize()
    assert k4.KERNEL.launches == before + 1
    want = k4.gn_conv1x1_plain(x, norm, conv, groups, act)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(got, want, atol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t,dtype,groups", [
    (2, 1024, 896, torch.bfloat16, 32), (1, 1024, 896, torch.bfloat16, 32),
    (16, 1024, 896, torch.bfloat16, 32), (8, 1024, 896, torch.bfloat16, 32),
    (2, 1024, 517, torch.bfloat16, 32), (3, 136, 1, torch.bfloat16, 8),
    (16, 136, 45, torch.bfloat16, 8), (2, 64, 45, torch.float32, 16),
    # TTS(dtype="float32")'s trunk and integrator; ragged in fp32
    (2, 1024, 896, torch.float32, 32), (1, 1024, 896, torch.float32, 32),
    (3, 136, 1, torch.float32, 8), (16, 136, 45, torch.float32, 8)])
def test_ts_res_block_kernel_cuda(cuda, monkeypatch, b, c, t, dtype, groups):
    _fp32_exact(monkeypatch, dtype)
    h, norm, conv = _gn_conv_inputs(cuda, b, c, t, c, 3, dtype, 4)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=cuda)).to(dtype)
    before = k5.KERNEL.launches
    got = k5.ts_res_block_out(h, x, emb, norm, k5.prepare_conv(conv), groups)
    torch.cuda.synchronize()
    assert k5.KERNEL.launches == before + 1
    want = k5.ts_res_block_out_plain(h, x, emb, norm, conv, groups)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(got, want, atol=3e-2)


@pytest.mark.cuda
def test_ts_res_block_prepared_weight_cuda(cuda):
    """The tap-major weight is the (C, C, 3) weight's taps, exactly; a CUDA
    call without it raises and launches nothing."""
    h, norm, conv = _gn_conv_inputs(cuda, 2, 128, 33, 128, 3, torch.bfloat16,
                                    6)
    prepared = k5.prepare_conv(conv)
    assert prepared["w"] is conv["w"]
    for s in range(3):
        assert torch.equal(prepared["w_taps"][s], conv["w"][:, :, s])
    emb = torch.zeros(2, 256, device=cuda, dtype=torch.bfloat16)
    before = k5.KERNEL.launches
    with pytest.raises(ValueError, match="prepare_conv"):
        k5.ts_res_block_out(h, h, emb, norm, conv, 32)
    assert k5.KERNEL.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,c,t,groups,act,film", [
    (2, 1024, 896, 32, True, False), (2, 1024, 896, 32, False, False),
    (2, 1024, 896, 32, True, True), (3, 136, 45, 8, True, True),
    (1, 128, 1, 32, True, True),
    (1, 64, 4000, 2, True, False)])    # 256 KB a group: read twice
def test_group_norm_act_kernel_cuda(cuda, b, c, t, groups, act, film, dtype):
    """The normalise kernel's Y is bit-equal to its plain version given the
    kernel's statistics (every fp32 step rounded on its own, the same
    sigmoid; fp32: Y_hi and Y_lo equal to ``tf32_split`` of it); the
    statistics agree with the plain two-pass ones in fp32; in fp32
    ``group_norm_act``'s Y_hi + Y_lo is the plain Y."""
    x, norm, _ = _gn_conv_inputs(cuda, b, c, t, 8, 1, dtype, 7)
    g = torch.Generator(device=cuda).manual_seed(8)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=cuda)).to(
        dtype) if film else None
    fp32 = dtype == torch.float32
    y, stats = (k4.group_norm_split if fp32 else k4.group_norm_act)(
        x, norm["scale"], norm["bias"], groups, act, emb=emb)
    torch.cuda.synchronize()
    for got, want in zip(stats, k4.group_stats_plain(x, groups)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    scale, shift = (emb[:, :c].float(), emb[:, c:].float()) if film \
        else (None, None)
    want = k4.group_norm_act_plain(x, norm["scale"], norm["bias"], groups,
                                   act, scale=scale, shift=shift,
                                   stats=stats)
    if fp32:
        assert all(torch.equal(a.view(torch.int32), w.view(torch.int32))
                   for a, w in zip(y, k4.tf32_split(want)))
        y, _ = k4.group_norm_act(x, norm["scale"], norm["bias"], groups,
                                 act, emb=emb)
        assert torch.equal(y, want)
    else:
        assert y.shape == want.shape and torch.equal(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,b,c,t,m", [
    ("k4", 1, 1024, 517, 3072), ("k4", 1, 2048, 101, 6144),
    ("k5", 2, 1024, 896, 1024)])
def test_fp32_kernels_give_the_same_bits_twice_cuda(cuda, kernel, b, c, t, m):
    """The fp32 GEMM's split-K sums its K slices in rank order through the
    cluster's shared memory, no atomics: two calls, the same bits."""
    x, norm, conv = _gn_conv_inputs(cuda, b, c, t, m, 1 if kernel == "k4"
                                    else 3, torch.float32, 9)
    if kernel == "k4":
        def run():
            return k4.gn_conv1x1(x, norm, conv, 32, False)
    else:
        emb = 0.3 * torch.randn(b, 2 * c, device=cuda)
        prepared = k5.prepare_conv(conv)

        def run():
            return k5.ts_res_block_out(x, x, emb, norm, prepared, 32)
    first = run()
    for _ in range(3):
        assert torch.equal(run().view(torch.int32), first.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [64, 104, 128])
@pytest.mark.parametrize("split", [1, 2, 3, 8])
def test_fp32_gemm_every_tile_and_split_cuda(cuda, monkeypatch, bn, split):
    """Each fp32 tile width and K split the wrapper may pass, K4 and K5,
    against their plain versions at a ragged T and M."""
    _fp32_exact(monkeypatch, torch.float32)
    monkeypatch.setattr(k4, "plan", lambda *a, **kw: k4.Plan(bn, split))
    monkeypatch.setattr(k5, "plan", lambda *a, **kw: k4.Plan(bn, split))
    x, norm, conv = _gn_conv_inputs(cuda, 2, 1024, 141, 200, 1,
                                    torch.float32, 11)
    torch.testing.assert_close(k4.gn_conv1x1(x, norm, conv, 32, True),
                               k4.gn_conv1x1_plain(x, norm, conv, 32, True),
                               atol=1e-4, rtol=1e-4)
    h, norm, conv = _gn_conv_inputs(cuda, 2, 256, 141, 256, 3,
                                    torch.float32, 12)
    emb = 0.3 * torch.randn(2, 512, device=cuda)
    torch.testing.assert_close(
        k5.ts_res_block_out(h, h, emb, norm, k5.prepare_conv(conv), 32),
        k5.ts_res_block_out_plain(h, h, emb, norm, conv, 32),
        atol=1e-4, rtol=1e-4)


# BigVGAN's six stage shapes at 906 mel frames (activation_post repeats the
# last), each (C, T)
SNAKE_STAGES = [(768, 3624), (384, 14496), (192, 28992), (96, 57984),
                (48, 115968), (24, 231936)]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,c,t,dtype",
    [(1, c, t, torch.bfloat16) for c, t in SNAKE_STAGES]
    + [(8, 768, 3624, torch.bfloat16),
       (2, 5, 8, torch.float32),
       (1, 3, 2049, torch.float32),
       (1, 3, 2049, torch.bfloat16),
       (1, 4, 3, torch.float32),
       (1, 3, 1, torch.float32)]
    # T around a run and a warp of 32 runs: runs of 8 (small bf16 calls),
    # of 16 (bf16 calls of k7.BIG_CALL samples or more) and of 4 (fp32)
    + [(2, 3, t, torch.bfloat16) for t in (7, 9, 255, 257)]
    + [(-(-k7.BIG_CALL // (3 * t)), 3, t, torch.bfloat16)
       for t in (15, 17, 511, 513)]
    + [(2, 3, t, torch.float32) for t in (3, 5, 255, 257)])
def test_snake_kernel_cuda(cuda, monkeypatch, b, c, t, dtype):
    """K7 at every BigVGAN stage shape (B=1 and, at the first, B=8, so row
    % C wraps across the batch), ragged T around a run and a warp at each
    run length, rows off 16 bytes, and T below a run.  fp32 within 1e-5 (sinf, fp32 FIRs: only the
    summation order differs); bf16 within atol 5e-2, rtol 2e-2 (|y| <~ 6:
    one bf16 ulp is at most 3.1e-2; the reduced sine is within 1e-6)."""
    _fp32_exact(monkeypatch, dtype)
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    alpha = torch.exp(0.3 * torch.randn(c, generator=g, device=cuda))
    inv_beta = 1 / (torch.exp(0.3 * torch.randn(c, generator=g, device=cuda))
                    + 1e-9)
    before = k7.KERNEL.launches
    got = k7.snake_resample2(x, alpha, inv_beta)
    torch.cuda.synchronize()
    assert k7.KERNEL.launches == before + 1
    want = k7.snake_resample2_plain(x, alpha, inv_beta)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    else:
        _bf16_close(got, want, atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("c,t", [(768, 3624), (24, 231936)])
def test_snake_kernel_large_argument_cuda(cuda, c, t):
    """bf16 K7 with alpha near 300, so |alpha v| reaches about 1000: the
    kernel's sine reduced by pi against torch.sin in the plain version,
    within the bf16 tolerance (the kernel's and the plain version's fp32
    products alpha v differ by about |alpha v| 2^-23, 1.2e-4 at 1000).
    One CUDA kernel a call."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(1, c, t, generator=g, device=cuda).to(torch.bfloat16)
    alpha = 300 * torch.exp(0.3 * torch.randn(c, generator=g, device=cuda))
    inv_beta = 1 / (torch.exp(0.3 * torch.randn(c, generator=g, device=cuda))
                    + 1e-9)
    got = k7.snake_resample2(x, alpha, inv_beta)
    torch.cuda.synchronize()
    want = k7.snake_resample2_plain(x, alpha, inv_beta)
    assert float((alpha[:, None] * x[0].float()).abs().max()) > 900
    _bf16_close(got, want, atol=5e-2)
    names = _cuda_kernel_names(lambda: k7.snake_resample2(x, alpha, inv_beta))
    assert len(names) == 1 and "snake_resample2" in names[0], names


# CUDA graphs (``utils/graphs.StepGraph``): each kernel entry captured
# alone and replayed, then the decode and sampler loops captured against
# their eager steps.  Replays run the captured kernels on the same inputs,
# so every comparison is bit for bit.

GRAPH_CASES = ["flash_attention", "qgemv", "qgemv_w8a8", "flash_decode",
               "flash_decode_shared", "gn_conv", "ts_res_block",
               "flash_attention_bias", "flash_attention_bias_kq",
               "flash_attention_bias_cm", "flash_attention_bias_cm_split",
               "snake"]


def _graph_case(dev, case):
    """(the KERNELS name the call counts under, a call of that entry at a
    main-path shape in bf16 that returns its output)."""
    bf = torch.bfloat16
    if case == "flash_attention":
        q, k, v, mask = _fused_qkv(dev, 1, 16, 68, bf, seed=3)
        return case, lambda: k1.flash_attention(q, k, v, mask, True)
    if case in ("qgemv", "qgemv_w8a8"):
        x, wq, s, b, lnp = _w8a8_inputs(dev, 1, 1024, 3072, True, bf)
        fn = k2.qgemv if case == "qgemv" else k8.qgemv_w8a8
        return case, lambda: fn(x, wq, s, b, ln=lnp)
    if case == "flash_decode":
        q, ck, cv, mask = _decode_inputs(dev, 1, 268, bf)
        pos = torch.tensor(200, dtype=torch.int32, device=dev)
        return case, lambda: k3.flash_decode(q, ck, cv, pos, mask)
    if case == "flash_decode_shared":
        g = torch.Generator(device=dev).manual_seed(7)
        q = torch.randn(16, 16, 64, generator=g, device=dev, dtype=bf)
        kp, vp = (torch.randn(1, 16, 68, 64, generator=g, device=dev,
                              dtype=bf) for _ in range(2))
        kd, vd = (torch.randn(16, 16, 200, 64, generator=g, device=dev,
                              dtype=bf) for _ in range(2))
        pmask = torch.rand(1, 68, generator=g, device=dev) > 0.2
        pos = torch.tensor(150, dtype=torch.int32, device=dev)
        return case, lambda: k3.flash_decode_shared(q, kp, vp, pmask, kd, vd,
                                                    pos)
    if case == "gn_conv":
        x, norm, conv = _gn_conv_inputs(dev, 2, 1024, 896, 1024, 1, bf, 3)
        return case, lambda: k4.gn_conv1x1(x, norm, conv, 32, True)
    if case == "ts_res_block":
        h, norm, conv = _gn_conv_inputs(dev, 2, 1024, 896, 1024, 3, bf, 4)
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(2, 1024, 896, generator=g, device=dev).to(bf)
        emb = (0.3 * torch.randn(2, 2048, generator=g, device=dev)).to(bf)
        conv = k5.prepare_conv(conv)
        return case, lambda: k5.ts_res_block_out(h, x, emb, norm, conv, 32)
    qkv, bias, h = _bias_inputs(dev, 8 if case == "flash_attention_bias"
                                else 2, 896, bf)
    if case == "flash_attention_bias":
        return case, lambda: k6.flash_attention_bias(qkv, bias, h)
    if case == "flash_attention_bias_kq":
        bias_t = bias.transpose(1, 2).contiguous()
        return case, lambda: k9a.flash_attention_bias_kq(qkv, bias_t, h)
    if case == "flash_attention_bias_cm":
        return case, lambda: k9b.flash_attention_bias_qkv(qkv, bias, h)
    if case == "flash_attention_bias_cm_split":
        q, k, v = (x.contiguous() for x in
                   qkv.view(2, h, 3, 64, 896).unbind(2))
        return ("flash_attention_bias_cm",
                lambda: k9b.flash_attention_bias_cm(q, k, v, bias))
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(1, 768, 3624, generator=g, device=dev).to(bf)
    alpha = torch.exp(0.3 * torch.randn(768, generator=g, device=dev))
    inv_beta = 1 / torch.exp(0.3 * torch.randn(768, generator=g, device=dev))
    return "snake", lambda: k7.snake_resample2(x, alpha, inv_beta)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GRAPH_CASES)
def test_kernel_captured_alone_cuda(cuda, case):
    """Each kernel entry captured alone in a graph (after its warm-up
    call, which the capture helper makes) and replayed: every replay
    writes the eager call's output bit for bit, and ``launch_counts()``
    counts one launch a replay and none for the capture."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.utils.graphs import STATS, StepGraph
    name, fn = _graph_case(cuda, case)
    want = fn()
    torch.cuda.synchronize()
    out = torch.empty_like(want)
    before = kernels.launch_counts()
    replays = STATS.replays
    graph = StepGraph(lambda: out.copy_(fn()), cuda)
    torch.cuda.synchronize()
    assert torch.equal(out, want)       # the warm-up, an eager call
    for n in range(1, 4):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), f"replay {n}"
    after = kernels.launch_counts()
    assert after[name] - before[name] == 1 + 3, (before, after)
    assert all(after[k] == before[k] for k in after if k != name)
    assert STATS.replays == replays + 3
    # K2/K8: every launch, replays included, leaves the split-K counters
    # at zero for the next
    assert not any(bool(t.any()) for t in k2._COUNTERS.values())


@pytest.mark.cuda
def test_split_k_counters_refuse_allocation_under_capture(cuda):
    """The split-K counters of a stream come from its warm-up; a K2 call
    captured on a stream without them raises (no counters from the
    graph's pool, which replays would share with nothing)."""
    x, wq, s, b, lnp = _w8a8_inputs(cuda, 1, 1024, 3072, True,
                                    torch.bfloat16)
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="counters"):
                k2.qgemv(x, wq, s, b, ln=lnp)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)


@pytest.mark.cuda
def test_step_graph_refuses_cpu_and_raises_on_failed_capture(cuda):
    """No fallback: a CPU step is refused, and a step that cannot be
    captured (a host read) raises."""
    from tortoise_tts_tpu_torch.utils.graphs import StepGraph
    x = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        StepGraph(lambda: None, torch.device("cpu"))
    with pytest.raises(RuntimeError):
        StepGraph(lambda: x.add_(float(x.sum())), cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_step_graph_leaves_the_generators_usable_after_a_failed_capture_cuda(
        cuda):
    """A capture that fails (a host read) leaves no generator in capture
    mode: afterwards the default generator and the step's own draw
    outside a capture, and a new StepGraph over the same generator
    captures and replays."""
    from tortoise_tts_tpu_torch.utils.graphs import StepGraph
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        StepGraph(lambda: x.add_(float(torch.rand(1, generator=g,
                                                  device=cuda))), cuda, [g])
    torch.randn(4, device=cuda)
    torch.randn(4, generator=g, device=cuda)
    out = torch.zeros(4, device=cuda)
    graph = StepGraph(lambda: out.copy_(torch.rand(4, generator=g,
                                                   device=cuda)), cuda, [g])
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert not torch.equal(out, first)


class _Stop(Exception):
    pass


@pytest.mark.cuda
def test_step_graph_orders_the_current_stream_after_a_failed_step(cuda):
    """The warm-up runs on the capture stream; what it wrote before a step
    raised is read on the current stream in order (the current stream
    waits for the capture stream whatever happens)."""
    from tortoise_tts_tpu_torch.utils.graphs import StepGraph
    g = torch.Generator(device=cuda).manual_seed(3)
    big = torch.randn(4096, 4096, generator=g, device=cuda)
    out = torch.zeros_like(big)

    def failing():
        for _ in range(4):
            torch.matmul(big, big, out=out)
        raise _Stop
    with pytest.raises(_Stop):
        StepGraph(failing, cuda)
    assert torch.equal(out, big @ big)


def _tiny_decode(dev, quant):
    """A 2-layer, 128-wide UnifiedVoice in bf16 on the card (head dim 64,
    the decode kernels' shapes), its int8 decode weights and its config;
    the mel head scaled up so sampled and greedy paths vary."""
    from tortoise_tts_tpu_torch.models import unified_voice as uv
    from tortoise_tts_tpu_torch.models.common import tree_cast
    cfg = uv.UnifiedVoiceConfig(layers=2, model_dim=128, heads=2,
                                max_text_tokens=40, max_mel_tokens=160)
    params = uv.init(torch.Generator(device=dev).manual_seed(0), cfg)
    params["mel_head"]["w"] *= 8.0
    params = tree_cast(params, torch.bfloat16)
    return cfg, params, uv.quantize_decode_weights(params)


DECODE_SAMPLING = {
    "greedy": dict(greedy=True, repetition_penalty=1.3),
    "sampled": dict(temperature=0.9, top_p=0.9, repetition_penalty=1.2),
    "length_penalty": dict(temperature=0.9, top_k=50,
                           length_penalty_factor=1.5),
    "mirostat": dict(mirostat_tau=3.0, mirostat_eta=0.2)}


def _decode_pair(dev, route, quant, sampling, chunks=(None,), max_len=48):
    """The same decode twice from the same generator seeds: eager (the
    step function run by ``advance``) and through ``decode_chunk``
    (captured on CUDA).  route: "single" (B=1), "batch" (M=8) or "shared"
    (one prefill fanned out to 16 rows through K3's shared form)."""
    from tortoise_tts_tpu_torch.models import unified_voice as uv
    from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
    from tortoise_tts_tpu_torch.utils.graphs import STATS
    cfg, params, qgpt = _tiny_decode(dev, quant)
    sampling = SamplingConfig(**DECODE_SAMPLING[sampling])
    rows = {"single": 1, "batch": 8, "shared": 1}[route]
    fan = 16 if route == "shared" else 0
    g = torch.Generator(device=dev).manual_seed(1)
    text = torch.randint(1, 200, (rows, 12), generator=g, device=dev)
    lengths = torch.tensor([12 - r % 5 for r in range(rows)], device=dev)
    cond = torch.randn(rows, 128, generator=g, device=dev).to(torch.bfloat16)
    kw = dict(collect_latents=True, qgpt=qgpt, quant_mode=quant)
    out = []
    for captured in (False, True):
        gens = [torch.Generator(device=dev).manual_seed(100 + r)
                for r in range(fan or rows)]
        st = uv.decode_start(params, cond, text, lengths, gens, cfg, max_len,
                             shared_rows=fan)
        state, prefix = st if fan else (st, None)
        replays = STATS.replays
        for chunk in chunks:
            if captured:
                uv.decode_chunk(params, state, cfg, sampling, chunk=chunk,
                                prefix=prefix, **kw)
            else:
                limit = max_len if chunk is None else min(state.step + chunk,
                                                          max_len)
                uv.advance(state, limit, uv.decode_step_fn(
                    params, state, cfg, sampling, prefix=prefix, **kw))
        torch.cuda.synchronize()
        if captured:    # one capture, whose warm-up was the first step
            assert state.graph is not None
            assert STATS.replays - replays == state.step - 1
        out.append(state)
    return out


def _same_decode(eager, captured):
    assert eager.step == captured.step
    assert int(captured.step_dev) == captured.step
    assert torch.equal(eager.tokens, captured.tokens)
    assert torch.equal(eager.lengths, captured.lengths)
    assert torch.equal(eager.finished, captured.finished)
    assert torch.equal(eager.latents, captured.latents)
    assert torch.equal(eager.counts, captured.counts)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("quant", ["int8", "w8a8"])
@pytest.mark.parametrize("route", ["single", "batch", "shared"])
def test_captured_decode_equals_eager_cuda(cuda, route, quant, sampling):
    """The captured decode against the eager step on the card, token for
    token with the lengths and latents, from the same per-row generator
    seeds: B=1, M=8, the shared prefix at M=16, K2 and K8."""
    _same_decode(*_decode_pair(cuda, route, quant, sampling))


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["sampled", "length_penalty",
                                      "mirostat"])
def test_captured_decode_chunks_and_processors_cuda(cuda, sampling):
    """The stream route's chunks (60 tokens, then 40s that replay the
    state's graph), the length penalty on the device step and Mirostat's
    first-step branch, captured against eager."""
    _same_decode(*_decode_pair(cuda, "single", "int8", sampling,
                               chunks=(60, 40, 40, None), max_len=150))


def _tiny_denoiser(dev, mode):
    """A 2-layer, 128-channel DiffusionTTS (2 heads of 64) in bf16 on the
    card, prepared for K5, with random attention outputs so the biased
    attention reaches the result, and its rel-pos biases at T=256 (the
    kernels' T) for ``mode``."""
    from tortoise_tts_tpu_torch.models import diffusion
    from tortoise_tts_tpu_torch.models.common import tree_cast
    cfg = diffusion.DiffusionConfig(model_channels=128, num_layers=2,
                                    num_heads=2, in_latent_channels=128)
    g = torch.Generator(device=dev).manual_seed(0)
    params = diffusion.init(g, cfg)
    for blk in params["conditioning_timestep_integrator"] + params["layers"]:
        w = blk["attn"]["proj_out"]["w"]
        w.copy_(torch.randn(w.shape, generator=g, device=dev) * 0.1)
    params = diffusion.prepare(tree_cast(params, torch.bfloat16))
    rel = diffusion.precompute_rel_biases(
        params, 256, cfg, torch.bfloat16, transposed=mode == "kq",
        flash_bias=mode == "flash_bias")
    return cfg, params, rel


@pytest.mark.cuda
@pytest.mark.parametrize("sampler", ["ddim", "p", "dpm++"])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("mode", ["auto", "kq", "flash_bias"])
def test_captured_sample_loop_equals_eager_cuda(cuda, mode, b, sampler):
    """The captured sampler loop against the eager step on the card, bit
    for bit, cond-free (the denoiser at 2B rows), under each
    ``denoise_attention`` mode, DDIM, the P sampler (its per-row
    generators registered with the graph) and DPM++ (its last x_0 and step
    carried in device buffers)."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.models import diffusion, gaussian
    from tortoise_tts_tpu_torch.utils.graphs import STATS
    cfg, params, rel = _tiny_denoiser(cuda, mode)
    sched = gaussian.get_schedule(steps=6)
    g = torch.Generator(device=cuda).manual_seed(2)
    code = torch.randn(2 * b, 128, 256, generator=g, device=cuda).to(
        torch.bfloat16)
    noise = torch.randn(b, 100, 256, generator=g, device=cuda)

    def model_fn(x, ts, _):
        return diffusion.forward(params, x.to(torch.bfloat16), ts, code, cfg,
                                 rel)

    def gens():
        return [torch.Generator(device=cuda).manual_seed(50 + r)
                for r in range(b)]

    kernels.reset_launches()
    x = noise.clone()
    t = torch.tensor([sched.num_timesteps - 1], device=cuda)
    step = gaussian.sampler_step_fn(model_fn, x, t,
                                    gaussian.step_tables(sched, cuda),
                                    gens(), sched, sampler)
    for _ in range(sched.num_timesteps):
        step()
    eager_counts = kernels.launch_counts()
    kernels.reset_launches()
    replays = STATS.replays
    got = gaussian.sample_loop(model_fn, noise, gens(), sched, sampler)
    torch.cuda.synchronize()
    assert STATS.replays - replays == sched.num_timesteps - 1
    assert torch.equal(got, x)
    assert kernels.launch_counts() == eager_counts
    assert eager_counts["gn_conv"] and eager_counts["ts_res_block"]


BEAM_SAMPLING = {
    "greedy": dict(greedy=True, repetition_penalty=1.3, typical_mass=0.9,
                   length_penalty=2.0, length_penalty_factor=-0.5),
    "sampled": dict(temperature=0.9, top_p=0.9, repetition_penalty=1.2,
                    length_penalty=1.5)}


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["greedy", "sampled"])
@pytest.mark.parametrize("quant", ["int8", "w8a8"])
def test_captured_beam_equals_eager_cuda(cuda, quant, sampling):
    """Beam search (B=2 rows of W=3 beams) captured against its step run
    eagerly on the card, from the same generator seed: the same beams,
    tokens and lengths, one capture and a replay a step, and the same
    kernel launches (K2 or K8, then K3, at M = 6)."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.models import unified_voice as uv
    from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
    from tortoise_tts_tpu_torch.utils.graphs import STATS
    cfg, params, qgpt = _tiny_decode(cuda, quant)
    params["mel_head"]["b"][cfg.stop_mel_token] = 3.0
    knobs = SamplingConfig(**BEAM_SAMPLING[sampling])
    do_sample = sampling == "sampled"
    g = torch.Generator(device=cuda).manual_seed(1)
    text = torch.randint(1, 200, (2, 12), generator=g, device=cuda)
    lengths = torch.tensor([12, 9], device=cuda)
    cond = torch.randn(2, 128, generator=g, device=cuda).to(torch.bfloat16)
    max_len = 48

    def gen():
        return torch.Generator(device=cuda).manual_seed(7)
    kernels.reset_launches()
    state = uv.beam_start(params, cond, text, lengths, 3, cfg, max_len,
                          gen())
    uv.advance(state, max_len, uv.beam_step_fn(
        params, state, cfg, knobs, do_sample, qgpt, quant))
    eager = uv.beam_result(state, knobs.length_penalty)
    eager_counts = kernels.launch_counts()
    kernels.reset_launches()
    captures, replays = STATS.captures, STATS.replays
    got = uv.inference_speech_beam(params, cond, text, lengths, cfg, 3,
                                   max_len, knobs, gen(), do_sample, qgpt,
                                   quant)
    torch.cuda.synchronize()
    assert STATS.captures - captures == 1
    assert STATS.replays - replays == state.step - 1
    assert torch.equal(got.codes, eager.codes)
    assert torch.equal(got.lengths, eager.lengths)
    gemv = "qgemv" if quant == "int8" else "qgemv_w8a8"
    assert kernels.launch_counts() == eager_counts
    assert eager_counts[gemv] == 4 * cfg.layers * (state.step + 0)
    assert eager_counts["flash_decode"] == cfg.layers * state.step


@pytest.mark.cuda
def test_univnet_cuda_matches_cpu(cuda, monkeypatch):
    """UnivNet (fp32, the route's type) on the card against the CPU, the
    same injected noise, TF32 off."""
    from tortoise_tts_tpu_torch.models import _univnet_random, univnet
    from tortoise_tts_tpu_torch.models.common import tree_map
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = univnet.UnivNetConfig(channel_size=16, kpnet_hidden=32)
    params = _univnet_random(torch.Generator().manual_seed(0), cfg)
    g = torch.Generator().manual_seed(1)
    mel = torch.randn(2, 100, 40, generator=g) * 2 - 5
    noise = torch.randn(2, *univnet.noise_shape(40, cfg), generator=g)
    want = univnet.inference(params, mel, noise=noise, cfg=cfg)
    got = univnet.inference(tree_map(lambda t: t.to(cuda), params),
                            mel.to(cuda), noise=noise.to(cuda), cfg=cfg)
    assert got.shape == (2, 1, 40 * 256)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_lora_toggle_recaptures_decode_cuda(cuda):
    """A decode captured with LoRA-merged weights is captured again when a
    later chunk of the same state runs with the base weights (the graph is
    keyed by the weights), and its tokens are the eager step's with the
    same weight switch."""
    from tortoise_tts_tpu_torch.models import lora
    from tortoise_tts_tpu_torch.models import unified_voice as uv
    from tortoise_tts_tpu_torch.ops.sampling import SamplingConfig
    from tortoise_tts_tpu_torch.utils.graphs import STATS
    cfg, base, _ = _tiny_decode(cuda, "int8")
    g = torch.Generator(device=cuda).manual_seed(4)
    adapter = lora.init_lora(g, base, rank=8)
    for ab in adapter["gpt"].values():
        ab["b"].normal_(0.0, 0.05, generator=g)
    merged = lora.merge_lora(base, adapter, alpha=16, rank=8)
    weights = [(merged, uv.quantize_decode_weights(merged)),
               (base, uv.quantize_decode_weights(base))]
    text = torch.randint(1, 200, (1, 12), generator=g, device=cuda)
    lengths = torch.tensor([12], device=cuda)
    cond = torch.randn(1, 128, generator=g, device=cuda).to(torch.bfloat16)
    sampling = SamplingConfig(greedy=True)
    out = []
    for captured in (False, True):
        state = uv.decode_start(merged, cond, text, lengths, None, cfg, 24)
        captures = STATS.captures
        for params, qgpt in weights:
            if captured:
                uv.decode_chunk(params, state, cfg, sampling, chunk=8,
                                qgpt=qgpt)
            else:
                uv.advance(state, state.step + 8, uv.decode_step_fn(
                    params, state, cfg, sampling, qgpt=qgpt))
        if captured:
            assert STATS.captures - captures == 2
        out.append(state.tokens[:, :16].clone())
    assert torch.equal(out[0], out[1])


# training: the kernels differentiated on the card

def _grads_of(fn, inputs, up_dtype=None):
    """fn(*inputs) and every input's gradient of <out, G>, G one upstream
    gradient drawn from a seed (rounded to ``up_dtype``, default the
    output's): the kernel's and the plain version's backwards take the
    same G, so their gradients differ only where the backwards do
    (through the bf16 plain backward, an upstream gradient that moves by
    an ulp moves some rows of K1's dq by more than 2%)."""
    xs = [t.detach().requires_grad_() for t in inputs]
    out = fn(*xs)
    g = torch.Generator(device=out.device).manual_seed(7)
    up = torch.randn(out.shape, generator=g, device=out.device).to(
        up_dtype or out.dtype).to(out.dtype)
    return out.detach(), torch.autograd.grad(out, xs, up)


def _rel_close(got, want, tol):
    """Row by row (trailing dims folded until a row holds 64 elements or
    more; a vector is one row): ||got - want|| <= tol ||want|| plus, an
    element, one bf16 ulp (2^-7) of want's RMS in bf16 or tol of it in
    fp32.  A row of K1's output averages up to S values, so a bound on the
    tensor's largest |value| would pass a lost key tile."""
    n, i = 1, want.dim()
    while i > 0 and n < 64:
        i -= 1
        n *= want.shape[i]
    g, w = got.float().reshape(-1, n), want.float().reshape(-1, n)
    rms = w.pow(2).mean().sqrt()
    assert rms > 0
    floor = (2.0 ** -7 if want.dtype == torch.bfloat16 else tol) * rms
    bound = tol * w.norm(dim=1) + floor * n ** 0.5
    worst = float(((g - w).norm(dim=1) / bound).max())
    assert worst <= 1, worst


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,s", [(2, 389), (1, 773), (2, 17), (4, 773)])
def test_flash_attention_backward_cuda(cuda, b, s, dtype, tol):
    """K1's autograd path (kernel forward with its log-sum-exp, then the
    backward kernel: one count on each, two CUDA kernels) against autograd
    of the plain version computed in fp32 from the same inputs, at the AR
    train step's S (ring path), with and without the key mask, q, k, v as
    views of the fused projection, as the trunk passes them; the same
    bits in two calls.  bf16 is held against the fp32 plain version (its
    gradients rounded once to bf16), not the bf16 one: the kernel keeps dP
    in fp32, where the bf16 plain backward rounds it.  At (4, 773) the bf16
    kernels' 448 work items outnumber the 132 blocks, so a block takes
    several (its resident buffers reused)."""
    q, k, v, mask = _fused_qkv(cuda, b, 16, s, dtype, seed=s)
    for km in (None, mask):
        def kernel(q, k, v):
            return k1.flash_attention(q, k, v, km)

        fwd, bwd = k1.KERNEL.launches, k1.KERNEL_BWD.launches
        out_k, g_k = _grads_of(kernel, (q, k, v))
        torch.cuda.synchronize()
        assert (k1.KERNEL.launches, k1.KERNEL_BWD.launches) == (fwd + 1,
                                                                bwd + 1)
        _, again = _grads_of(kernel, (q, k, v))
        assert all(torch.equal(a, b) for a, b in zip(g_k, again))
        out_p, g_p = _grads_of(
            lambda q, k, v: k1.flash_attention_plain(q, k, v, km),
            (q.float(), k.float(), v.float()), up_dtype=dtype)
        _rel_close(out_k, out_p.to(dtype), tol)
        for a, p in zip(g_k, g_p):
            assert a.dtype == dtype
            _rel_close(a, p.to(dtype), tol)
    o, lse = k1._launch(q, k, v, mask, True, with_lse=True)
    names = _cuda_kernel_names(
        lambda: k1.flash_attention_bwd(q, k, v, lse, o, mask))
    want = (["bwd_dq_ws", "bwd_dkdv_ws"] if dtype == torch.bfloat16 else
            ["bwd_split_f32", "bwd_dq_tf32", "bwd_dkdv_tf32"])
    assert [_kernel_base(n) for n in names] == want, names


@pytest.mark.cuda
def test_flash_attention_backward_repeats_its_bits_cuda(cuda):
    """At the AR step's (16, 16, 773, 64), where a block of the bf16
    kernels takes about 14 work items and reuses its resident buffers,
    forty calls give the first call's bits: a resident buffer released
    right after the warpgroup's ldmatrix (a barrier between), not after
    its products, was refilled while a read was still in flight and
    changed some calls' dk and dv far past the training check's row
    bound."""
    g = torch.Generator(device=cuda).manual_seed(70)
    shape = (16, 16, 773, 64)
    q, k, v, up = (torch.randn(shape, generator=g, device=cuda)
                   .to(torch.bfloat16) for _ in range(4))
    _, lse = k1._launch(q, k, v, None, True, with_lse=True)
    first = k1.flash_attention_bwd(q, k, v, lse, up)
    for _ in range(40):
        again = k1.flash_attention_bwd(q, k, v, lse, up)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked,calls", [
    ((16, 16, 773, 64), False, 40),     # 3328 work items, ~25 a block
    ((3, 16, 389, 64), True, 10)])      # 336 items over 132 blocks
def test_flash_attention_backward_fp32_repeats_its_bits_cuda(
        cuda, shape, masked, calls):
    """The fp32 (3xTF32) backward, where its 64-row work items outnumber
    the blocks and each block reuses its resident buffer and ring for
    several: repeated calls give the first call's bits (every sum in a
    fixed order, no atomics), with and without a key mask."""
    g = torch.Generator(device=cuda).manual_seed(71)
    q, k, v, up = (torch.randn(shape, generator=g, device=cuda)
                   for _ in range(4))
    mask = None
    if masked:
        mask = torch.rand(shape[0], shape[2], generator=g, device=cuda) > 0.2
        mask[:, 0] = True
    _, lse = k1._launch(q, k, v, mask, True, with_lse=True)
    assert k1.bwd_plan(*shape[:3], torch.float32).items > k1.SMS
    first = k1.flash_attention_bwd(q, k, v, lse, up, mask)
    for _ in range(calls):
        again = k1.flash_attention_bwd(q, k, v, lse, up, mask)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def _on_a_new_thread(fn):
    """fn() on a thread of its own, which has made no CUDA call before;
    its result, or its exception raised here."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:   # re-raised on the calling thread
            box["err"] = e
    th = threading.Thread(target=run)
    th.start()
    th.join()
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tma_kernels_on_a_new_thread_cuda(cuda, dtype):
    """Kernels whose C entry encodes TMA maps on the host (K1's backward,
    K4's forward and backward) called first on a new thread, as autograd's
    device thread calls a backward: the thread has made no CUDA call and
    its allocations come from the caching allocator's free blocks, so no
    runtime call has made a context current on it before the maps are
    encoded.  Each gives the bits of the same call on this thread."""
    g = torch.Generator(device=cuda).manual_seed(73)
    shape = (2, 16, 389, 64)
    q, k, v, up = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                   for _ in range(4))
    _, lse = k1._launch(q, k, v, None, True, with_lse=True)
    b, c, t = 2, 256, 288
    x = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    ga = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    be = 0.1 * torch.randn(c, generator=g, device=cuda)
    w = (0.05 * torch.randn(c, c, 1, generator=g, device=cuda)).to(dtype)
    bi = 0.05 * torch.randn(c, generator=g, device=cuda)
    g4 = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    _, st = k4._launch(x, ga, be, w, bi, 32, True, 1e-5, with_stats=True)
    wb = w.reshape(c, c).t().contiguous()[None]
    calls = {
        "K1 backward": lambda: k1.flash_attention_bwd(q, k, v, lse, up),
        "K4 forward": lambda: k4._launch(x, ga, be, w, bi, 32, True,
                                         1e-5)[:1],
        "K4 backward": lambda: k4._launch_bwd(
            k4.KERNEL_BWD, x, ga, be, bi, wb, g4, st, 32, True, 1e-5)[:5]}
    for name, call in calls.items():
        # copied out, so the call's blocks are free for the thread's
        want = [r.cpu() for r in call()]
        got = _on_a_new_thread(lambda: [r.cpu() for r in call()])
        assert all(torch.equal(a, r) for a, r in zip(want, got)), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 16, 773, 64), (8, 16, 389, 64)])
def test_flash_attention_fp32_forward_training_shapes_cuda(cuda, shape):
    """K1's fp32 forward (3xTF32, persistent: at these shapes the 64-query
    work items outnumber the blocks, so each block takes several and
    reuses its stage) on views of a fused qkv with a key mask, at the AR
    training steps' shapes: the output row by row within 1e-5 of the
    plain fp32 version's (``_rel_close``), the log-sum-exp within 1e-5 an
    element, and five more calls give the first call's bits."""
    b, h, s, _ = shape
    q, k, v, mask = _fused_qkv(cuda, b, h, s, torch.float32, seed=s)
    assert k1.fwd_f32_plan(b, h, s).items > k1.fwd_f32_plan(b, h, s).grid
    out, lse = k1._launch(q, k, v, mask, True, with_lse=True)
    _rel_close(out, k1.flash_attention_plain(q, k, v, mask), 1e-5)
    torch.testing.assert_close(
        lse, k1.flash_attention_lse_plain(q, k, mask), atol=1e-5, rtol=0)
    for _ in range(5):
        again, lse2 = k1._launch(q, k, v, mask, True, with_lse=True)
        assert torch.equal(out, again) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_flash_attention_fp32_forward_on_a_new_thread_cuda(cuda):
    """K1's fp32 forward encodes its TMA maps on the host at every call:
    called first on a new thread (no CUDA call made there, as autograd's
    device thread), it gives the bits of the same call on this thread."""
    q, k, v, mask = _fused_qkv(cuda, 2, 16, 389, torch.float32, seed=5)

    def call():
        return [r.cpu() for r in k1._launch(q, k, v, mask, True,
                                            with_lse=True)]
    want = call()
    got = _on_a_new_thread(call)
    assert all(torch.equal(a, r) for a, r in zip(want, got))


_PROFILED_THEN_AUTOGRAD = """
import sys
import torch
from torch.profiler import ProfilerActivity, profile
from tortoise_tts_tpu_torch.kernels import flash_attention as k1

dtype = getattr(torch, sys.argv[1])
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(72)
shape = (16, 16, 773, 64)
q, k, v, up = (torch.randn(shape, generator=g, device=dev).to(dtype)
               for _ in range(4))
with torch.no_grad():
    _, lse = k1._launch(q, k, v, None, True, with_lse=True)
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
    for _ in range(3):
        k1.flash_attention_bwd(q, k, v, lse, up)
    torch.cuda.synchronize()
# two direct calls' blocks freed at once: enough for the autograd path's
# forward and backward, so its device thread allocates nothing anew
held = [k1.flash_attention_bwd(q, k, v, lse, up) for _ in range(2)]
direct = [r.cpu() for r in held[0]]
del held
xs = [t.detach().requires_grad_() for t in (q, k, v)]
grads = torch.autograd.grad(k1.flash_attention(*xs), xs, up)
assert all(torch.equal(a, r.cpu()) for a, r in zip(direct, grads))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_attention_backward_after_a_profiled_window_cuda(cuda, dtype):
    """In a fresh process at (16, 16, 773, 64): a torch.profiler window of
    direct backward calls, then direct calls, then the autograd path (the
    backward on autograd's device thread, its first CUDA work, every
    allocation served from the direct calls' freed blocks): the autograd
    path runs and gives the direct call's bits."""
    import subprocess
    import sys
    from pathlib import Path
    r = subprocess.run([sys.executable, "-c", _PROFILED_THEN_AUTOGRAD,
                        dtype], cwd=Path(__file__).resolve().parent.parent,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.cuda
def test_flash_attention_backward_refuses_cuda(cuda):
    """No fallback: the backward kernel raises, before any launch, on bf16
    rows off 16 bytes, another head dim, mixed dtypes or a wrong lse."""
    q, k, v, mask = _fused_qkv(cuda, 1, 16, 68, torch.bfloat16, seed=3)
    o, lse = k1._launch(q, k, v, mask, True, with_lse=True)
    before = k1.KERNEL_BWD.launches
    buf = torch.randn(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    off = buf[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        k1.flash_attention_bwd(q, k, v, lse, off, mask)
    with pytest.raises(ValueError, match="head dim"):
        k1.flash_attention_bwd(*(t[..., :32] for t in (q, k, v)), lse,
                               o[..., :32], mask)
    with pytest.raises(TypeError):
        k1.flash_attention_bwd(q, k, v, lse, o.float(), mask)
    with pytest.raises(ValueError, match="lse"):
        k1.flash_attention_bwd(q, k, v, lse[:, :, 1:], o, mask)
    assert k1.KERNEL_BWD.launches == before


def _f32(t):
    return t.float() if t.is_floating_point() else t


def _resblock_bwd_names(dtype, taps, t):
    """The CUDA kernels of one K4 (taps 1) or K5 (taps 3) backward call, in
    launch order: K4 in bf16 at T % 8 == 0 reads the upstream as it comes,
    every other bf16 backward first makes it time-major (bwd_transpose),
    and K5's da is bwd_da_pingpong;
    fp32 splits it, time-major and as it comes (bwd_split_upstream), for
    its two 3xTF32 GEMMs."""
    if dtype == torch.float32:
        return ["bwd_apply_norm", "bwd_split_upstream", "bwd_da_tf32",
                "bwd_norm", "bwd_dw_tf32", "bwd_reduce"]
    names = ["bwd_apply_norm", "bwd_da_wgmma", "bwd_norm", "bwd_dw_wgmma",
             "bwd_reduce"]
    if taps == 3:   # K5's da: the persistent ping-pong kernel
        names[1] = "bwd_da_pingpong"
    if taps == 3 or t % 8:
        names.insert(1, "bwd_transpose")
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("act,m", [(True, 256), (False, 768)])
@pytest.mark.parametrize("t", [283, 288])
def test_gn_conv_backward_cuda(cuda, monkeypatch, act, m, t, dtype, tol):
    """K4's gradients of x, the norm's scale and bias and the conv's weight
    and bias, through the backward kernel (one launch a call, the same
    bits in two calls), against the plain version's computed in fp32
    from the same inputs and upstream, at a ragged T (the upstream made
    time-major first) and at T % 8 == 0 (read as it comes in bf16); the
    backward's CUDA kernels, each once."""
    _fp32_exact(monkeypatch, dtype)
    g = torch.Generator(device=cuda).manual_seed(m)
    b, c = 2, 256
    x = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    ga = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    be = 0.1 * torch.randn(c, generator=g, device=cuda)
    w = (0.05 * torch.randn(m, c, 1, generator=g, device=cuda)).to(dtype)
    bi = 0.05 * torch.randn(m, generator=g, device=cuda)
    ins = (x, ga, be, w, bi)

    def run(fn, ins):
        return _grads_of(lambda x, ga, be, w, bi: fn(
            x, {"scale": ga, "bias": be}, {"w": w, "b": bi}, 32, act),
            ins, up_dtype=dtype)
    before = k4.KERNEL_BWD.launches
    out_k, g_k = run(k4.gn_conv1x1, ins)
    assert k4.KERNEL_BWD.launches == before + 1
    _, again = run(k4.gn_conv1x1, ins)
    assert all(torch.equal(a, r) for a, r in zip(g_k, again))
    out_p, g_p = run(k4.gn_conv1x1_plain, [_f32(v) for v in ins])
    _rel_close(out_k, out_p, tol)
    for a, p in zip(g_k, g_p):
        _rel_close(a, p, tol)
    _, st = k4._launch(x, ga, be, w, bi, 32, act, 1e-5, with_stats=True)
    up = torch.randn(b, m, t, generator=g, device=cuda).to(dtype)
    wb = w.reshape(m, c).t().contiguous()[None]
    names = _cuda_kernel_names(lambda: k4._launch_bwd(
        k4.KERNEL_BWD, x, ga, be, bi, wb, up, st, 32, act, 1e-5))
    assert [_kernel_base(n) for n in names] == _resblock_bwd_names(
        dtype, 1, t), names


@pytest.mark.cuda
@pytest.mark.parametrize("taps,t", [(1, 283), (3, 283), (3, 2240)])
def test_resblock_backward_fp32_repeats_its_bits_cuda(cuda, monkeypatch,
                                                     taps, t):
    """K4's (taps 1) and K5's (taps 3) fp32 backward at a ragged T (g's
    rows off 16 bytes: its split copy padded to whole rows) and at the
    training step's T: ten calls give the first call's bits (dW's slices
    summed in order, no atomics), and each gradient is within 1e-4 of the
    fp32 plain backward's (row by row)."""
    _fp32_exact(monkeypatch, torch.float32)
    g = torch.Generator(device=cuda).manual_seed(taps * 1000 + t)
    b, c = 2, 256
    x = torch.randn(b, c, t, generator=g, device=cuda)
    ga = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    be = 0.1 * torch.randn(c, generator=g, device=cuda)
    bi = 0.05 * torch.randn(c, generator=g, device=cuda)
    w = 0.03 * torch.randn(c, c, taps, generator=g, device=cuda)
    up = torch.randn(b, c, t, generator=g, device=cuda)
    if taps == 1:
        _, st = k4._launch(x, ga, be, w, bi, 32, True, 1e-5, with_stats=True)
        wb, emb = w.reshape(c, c).t().contiguous()[None], None
        want = k4.gn_conv1x1_bwd_plain(x, ga, be, w, bi, up, 32, True,
                                       stats=(st[:b * 32], st[b * 32:]))
        names = ("x", "gamma", "beta", "w", "b")
    else:
        emb = 0.3 * torch.randn(b, 2 * c, generator=g, device=cuda)
        _, st = k5._launch(x, x, emb, ga, be, k5.taps(w), bi, 32, 1e-5,
                           with_stats=True)
        wb = w.flip(2).permute(2, 1, 0).contiguous()
        dh, demb, dga, dbe, dw, db = k4.ts_res_block_out_bwd_plain(
            x, emb, ga, be, w, bi, up, 32, stats=(st[:b * 32], st[b * 32:]))
        want = (dh, dga, dbe, dw, db, demb)
        names = ("h", "gamma", "beta", "w", "b", "emb")
    kernel = k5.KERNEL_BWD if taps == 3 else k4.KERNEL_BWD

    def call():
        return k4._launch_bwd(kernel, x, ga, be, bi, wb, up, st, 32, True,
                              1e-5, emb=emb)[:len(names)]
    first = call()
    for _ in range(10):
        assert all(torch.equal(a, r) for a, r in zip(first, call()))
    for nm, a, p in zip(names, first, want):
        _rel_close(a.reshape(p.shape), p, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,t", [(4, 1024, 2240), (16, 1024, 283)])
def test_ts_res_block_backward_bf16_repeats_its_bits_cuda(cuda, b, c, t):
    """K5's bf16 backward as autograd calls it (the forward's tap-major
    weight, da on the persistent ``bwd_da_pingpong``) at the training T
    and at a ragged T (g's rows off 16 bytes, the last 128-step tile
    partial), where the 128 x 128 da tiles outnumber the blocks and both
    warpgroups take several: five more calls give the first call's bits
    (every sum in a fixed order, no atomics), each gradient is within the
    bf16 row bound of the plain backward's (fp32 inside), and the call is
    its six CUDA kernels in order."""
    g = torch.Generator(device=cuda).manual_seed(t)
    h, x, up = (torch.randn(b, c, t, generator=g, device=cuda)
                .to(torch.bfloat16) for _ in range(3))
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=cuda)
           ).to(torch.bfloat16)
    ga = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    be = 0.1 * torch.randn(c, generator=g, device=cuda)
    bi = 0.05 * torch.randn(c, generator=g, device=cuda)
    w = (0.03 * torch.randn(c, c, 3, generator=g, device=cuda)
         ).to(torch.bfloat16)
    wt = k5.taps(w)
    _, st = k5._launch(h, x, emb, ga, be, wt, bi, 32, 1e-5, with_stats=True)

    def call():
        return k4._launch_bwd(k5.KERNEL_BWD, h, ga, be, bi, wt, up, st, 32,
                              True, 1e-5, emb=emb)
    first = call()
    for _ in range(5):
        assert all(torch.equal(a, r) for a, r in zip(first, call()))
    dh, demb, dga, dbe, dw, db = k4.ts_res_block_out_bwd_plain(
        h.float(), emb.float(), ga, be, w.float(), bi, up.float(), 32,
        stats=(st[:b * 32], st[b * 32:]))
    for a, p in zip(first, (dh, dga, dbe, dw, db, demb)):
        _rel_close(a.reshape(p.shape), p.to(a.dtype), 2e-2)
    names = _cuda_kernel_names(call)
    assert [_kernel_base(n) for n in names] == [
        "bwd_apply_norm", "bwd_transpose", "bwd_da_pingpong", "bwd_norm",
        "bwd_dw_wgmma", "bwd_reduce"], names


@pytest.mark.cuda
def test_resblock_backward_refuses_cuda(cuda):
    """A backward the kernel does not take (an upstream of M rows, M % 8
    != 0: read in 16-byte pieces) raises, and the count does not move;
    nothing falls back to the plain recompute."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(2, 64, 130, generator=g, device=cuda,
                    dtype=torch.bfloat16).requires_grad_()
    norm = {"scale": torch.ones(64, device=cuda),
            "bias": torch.zeros(64, device=cuda)}
    conv = {"w": 0.1 * torch.randn(12, 64, 1, generator=g, device=cuda,
                                   dtype=torch.bfloat16),
            "b": torch.zeros(12, device=cuda)}
    out = k4.gn_conv1x1(x, norm, conv, 16, False)
    before = k4.KERNEL_BWD.launches
    with pytest.raises(ValueError, match="M % 8"):
        out.backward(torch.ones_like(out))
    assert k4.KERNEL_BWD.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_ts_res_block_backward_reaches_the_live_weight_cuda(
        cuda, monkeypatch, dtype, tol):
    """K5 with its tap-major weight made from the live weight inside the
    graph (as the diffusion train step prepares it): every gradient,
    the weight's included and nonzero, through the backward kernel (one
    launch a call, the same bits in two calls), against the plain
    version's computed in fp32 from the same inputs and upstream; the
    backward's CUDA kernels, each once (the upstream made time-major
    first); and two SGD updates of the weight on the card equal the plain
    path's."""
    _fp32_exact(monkeypatch, dtype)
    g = torch.Generator(device=cuda).manual_seed(5)
    b, c, t = 2, 256, 130
    h = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    x = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    emb = (0.3 * torch.randn(b, 2 * c, generator=g, device=cuda)).to(dtype)
    ga = 1 + 0.1 * torch.randn(c, generator=g, device=cuda)
    be = 0.1 * torch.randn(c, generator=g, device=cuda)
    w0 = (0.03 * torch.randn(c, c, 3, generator=g, device=cuda)).to(dtype)
    bi = 0.05 * torch.randn(c, generator=g, device=cuda)

    def kernel(h, x, emb, ga, be, w, bi):
        return k5.ts_res_block_out(h, x, emb, {"scale": ga, "bias": be},
                                   k5.prepare_conv({"w": w, "b": bi}), 32)

    def plain(h, x, emb, ga, be, w, bi):
        return k5.ts_res_block_out_plain(h, x, emb, {"scale": ga,
                                                     "bias": be},
                                         {"w": w, "b": bi}, 32)
    ins = (h, x, emb, ga, be, w0, bi)
    before = k5.KERNEL_BWD.launches
    out_k, g_k = _grads_of(kernel, ins, up_dtype=dtype)
    assert k5.KERNEL_BWD.launches == before + 1
    _, again = _grads_of(kernel, ins, up_dtype=dtype)
    assert all(torch.equal(a, r) for a, r in zip(g_k, again))
    out_p, g_p = _grads_of(plain, [_f32(v) for v in ins], up_dtype=dtype)
    _rel_close(out_k, out_p, tol)
    for a, p in zip(g_k, g_p):
        _rel_close(a, p, tol)
    assert g_k[5].float().abs().max() > 0
    with torch.no_grad():
        _, st = k5._launch(h, x, emb, ga, be, k5.taps(w0), bi, 32, 1e-5,
                           with_stats=True)
    up = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    bf16 = dtype == torch.bfloat16
    wb = k5.taps(w0) if bf16 else w0.flip(2).permute(2, 1, 0).contiguous()
    names = _cuda_kernel_names(lambda: k4._launch_bwd(
        k5.KERNEL_BWD, h, ga, be, bi, wb, up, st, 32, True, 1e-5, emb=emb))
    assert [_kernel_base(n) for n in names] == _resblock_bwd_names(
        dtype, 3, t), names
    wk, wp = w0.clone(), w0.clone()
    for _ in range(2):
        for fn, w in ((kernel, wk), (plain, wp)):
            _, gr = _grads_of(fn, (h, x, emb, ga, be, w, bi))
            w.sub_(1e-3 * gr[5].to(w.dtype))
    _rel_close(wk, wp, tol)
    assert not torch.equal(wk, w0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("b,c,t", [(8, 768, 128), (8, 24, 8192),
                                   (2, 5, 1001)])
def test_snake_backward_cuda(cuda, monkeypatch, b, c, t, dtype, tol):
    """K7's autograd path (kernel forward, plain recompute backward)
    against the plain version's autograd at the vocoder step's first and
    last stages (B=8, 8192 samples) and a ragged T: the output and the
    gradients of x, alpha and inv_beta, one kernel launch a call."""
    _fp32_exact(monkeypatch, dtype)
    g = torch.Generator(device=cuda).manual_seed(c)
    x = torch.randn(b, c, t, generator=g, device=cuda).to(dtype)
    alpha = torch.exp(0.3 * torch.randn(c, generator=g, device=cuda))
    inv_beta = 1 / (torch.exp(0.3 * torch.randn(c, generator=g,
                                                device=cuda)) + 1e-9)
    before = k7.KERNEL.launches
    out_k, g_k = _grads_of(k7.snake_resample2, (x, alpha, inv_beta))
    assert k7.KERNEL.launches == before + 1
    out_p, g_p = _grads_of(k7.snake_resample2_plain, (x, alpha, inv_beta))
    _rel_close(out_k, out_p, tol)
    for a, p in zip(g_k, g_p):
        _rel_close(a, p, tol)
        assert a.float().abs().max() > 0


@pytest.mark.cuda
def test_vocoder_step_launches_k7_twice_a_forward_cuda(cuda):
    """A tiny vocoder GAN step in bf16 on the card: K7 for every Snake of
    the detached fake and of the generator's loss (218 launches), finite
    metrics, the generator and the discriminator both updated."""
    import numpy as np
    from tortoise_tts_tpu_torch.config import Hyperparameters
    from tortoise_tts_tpu_torch.engine import optim, train_step as ts
    from tortoise_tts_tpu_torch.engine.state import TrainState, tree_leaves
    from tortoise_tts_tpu_torch.models import _bigvgan_random, bigvgan
    from tortoise_tts_tpu_torch.models import bigvgan_disc as bvd
    from tortoise_tts_tpu_torch.models.common import tree_cast
    vcfg = bigvgan.BigVGANConfig(upsample_initial_channel=64)
    dcfg = bvd.DiscriminatorConfig(periods=(2, 3),
                                   resolutions=((512, 128, 512),))
    gen = tree_cast(_bigvgan_random(torch.Generator(device=cuda)
                                    .manual_seed(0), vcfg), torch.bfloat16)
    disc = bvd.init(torch.Generator(device=cuda).manual_seed(1), dcfg)
    hp = Hyperparameters(optimizer="AdamW", learning_rate=1e-4,
                         warmup_steps=0, gradient_accumulation_steps=1)
    tx, tx_d = optim.make_optimizer(hp), optim.make_optimizer(hp)
    state = TrainState({"generator": gen, "discriminator": disc},
                       {"g": tx.init(gen), "d": tx_d.init(disc)})
    before = [p.clone() for p in tree_leaves(state.params)]
    wav = np.random.RandomState(0).randn(2, 4096).astype(np.float32) * 0.3
    launches = k7.KERNEL.launches
    state, m = ts.make_vocoder_train_step(vcfg, tx, tx_d, dcfg)(
        state, ts.to_device({"wav": wav}, cuda))
    assert k7.KERNEL.launches - launches == 2 * 109
    assert all(torch.isfinite(v) for v in m.values())
    moved = [not torch.equal(a, b)
             for a, b in zip(before, tree_leaves(state.params))]
    n_gen = len(tree_leaves(gen))
    assert any(moved[:n_gen]) and any(moved[n_gen:])


@pytest.mark.cuda
@pytest.mark.parametrize("eta,schedule", [(0.8, "linear"), (0.5, "cosine"),
                                          (0.0, "cosine")])
@pytest.mark.parametrize("b", [1, 8])
def test_captured_ddim_eta_and_cosine_equal_eager_cuda(cuda, b, eta,
                                                       schedule):
    """DDIM at eta > 0 (per-row noise registered with the graph) and on the
    cosine schedule: the captured loop equals the eager step bit for bit,
    with the same launches."""
    from tortoise_tts_tpu_torch import kernels
    from tortoise_tts_tpu_torch.models import diffusion, gaussian
    cfg, params, rel = _tiny_denoiser(cuda, "auto")
    sched = gaussian.get_schedule(steps=6, schedule=schedule)
    g = torch.Generator(device=cuda).manual_seed(3)
    code = torch.randn(2 * b, 128, 256, generator=g, device=cuda).to(
        torch.bfloat16)
    noise = torch.randn(b, 100, 256, generator=g, device=cuda)

    def model_fn(x, ts, _):
        return diffusion.forward(params, x.to(torch.bfloat16), ts, code, cfg,
                                 rel)

    def gens():
        return [torch.Generator(device=cuda).manual_seed(70 + r)
                for r in range(b)]

    kernels.reset_launches()
    x = noise.clone()
    t = torch.tensor([sched.num_timesteps - 1], device=cuda)
    step = gaussian.sampler_step_fn(model_fn, x, t,
                                    gaussian.step_tables(sched, cuda, eta),
                                    gens(), sched, "ddim", eta)
    for _ in range(sched.num_timesteps):
        step()
    eager_counts = kernels.launch_counts()
    kernels.reset_launches()
    got = gaussian.sample_loop(model_fn, noise, gens(), sched, "ddim", eta)
    torch.cuda.synchronize()
    assert torch.equal(got, x)
    assert kernels.launch_counts() == eager_counts


@pytest.mark.cuda
def test_classifier_heads_launch_k4_cuda(cuda):
    """The classifier at the published widths in bf16 on the card: each of
    its 4 attention blocks' heads is one K4 launch, the logits finite."""
    from tortoise_tts_tpu_torch.models import load_model
    m = load_model("classifier", "bfloat16", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    audio = (0.3 * torch.randn(2, 1, 222720, generator=g, device=cuda)) \
        .to(torch.bfloat16)
    before = k4.KERNEL.launches
    with torch.inference_mode():
        logits = m.module.forward(m.params, audio, m.config)
    torch.cuda.synchronize()
    assert k4.KERNEL.launches == before + 4
    assert logits.shape == (2, 2) and torch.isfinite(logits.float()).all()
