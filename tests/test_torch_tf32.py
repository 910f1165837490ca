"""fp32 means fp32 in the port: every convolution of the port goes through
``models.common.conv``, which runs an fp32 CUDA input, forward and
backward, with cuDNN's TF32 off and cuDNN still enabled, and changes no
flag that outlives the call.  bf16 inputs and CPU tensors call the
convolution as they are.

There is no card here, so a CUDA input is a CPU tensor whose ``is_cuda``
says True, and a stand-in for the ``torch.nn.functional`` convolution
records cuDNN's flags when it is called (and, through a recording
autograd node, when its backward runs), then computes on the CPU.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tortoise_tts_tpu_torch.models import bigvgan_disc, common
from tortoise_tts_tpu_torch.ops import stft

FLAGS = ("allow_tf32", "enabled", "benchmark", "deterministic")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def _flags():
    return {n: getattr(torch.backends.cudnn, n) for n in FLAGS}


class _RecordBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, seen):
        ctx.seen = seen
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.seen.append(("backward", _flags()))
        return g, None


@pytest.fixture
def seen(monkeypatch):
    """torch's default cuDNN flags (TF32 on: other test modules turn it
    off when imported), and F.conv1d, F.conv_transpose1d and F.conv2d
    replaced with stand-ins that record the flags of each call and of its
    backward."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "enabled", True)
    calls = []
    for name in ("conv1d", "conv_transpose1d", "conv2d"):
        real = getattr(F, name)

        def stand_in(*a, real=real, **kw):
            calls.append(("forward", _flags()))
            return _RecordBackward.apply(real(*a, **kw), calls)
        monkeypatch.setattr(F, name, stand_in)
    return calls


def _inputs(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 8, 40, generator=g).to(dtype)
    p = {"w": torch.randn(12, 8, 3, generator=g) * 0.1,
         "b": torch.randn(12, generator=g) * 0.1}
    pt = {"w": torch.randn(8, 6, 4, generator=g) * 0.1,
          "b": torch.randn(6, generator=g) * 0.1}
    v = torch.randn(5, 1, 3, 1, generator=g) * 0.1
    p2 = {"v": v, "g": v.pow(2).sum(dim=(1, 2, 3)).sqrt(),
          "b": torch.randn(5, generator=g) * 0.1}
    filt = np.hanning(12).astype(np.float32)
    return x, {
        "conv1d": lambda x: common.conv1d(p, x, padding=1),
        "conv_transpose1d": lambda x: common.conv_transpose1d(pt, x, 2),
        "depthwise_lowpass": lambda x: common.depthwise_lowpass(
            x, filt, 2, 5, 6),
        "depthwise_upsample": lambda x: common.depthwise_upsample(
            x, filt, 2, 5, 15, 15),
        "wn_conv2d": lambda x: bigvgan_disc._wn_conv2d(
            p2, x.reshape(2, 1, 80, 4), stride=(3, 1), padding=(2, 0)),
        "resample": lambda x: stft.resample(x[:, 0], 24000, 22050),
    }


CONVS = ("conv1d", "conv_transpose1d", "depthwise_lowpass",
         "depthwise_upsample", "wn_conv2d", "resample")


@pytest.mark.parametrize("name", CONVS)
def test_fp32_cuda_convs_run_with_tf32_off(seen, name):
    """An fp32 input on the card: TF32 off and cuDNN enabled inside the
    call, every flag as it was after it, and the same values as the
    convolution itself."""
    x, fns = _inputs(torch.float32)
    before = _flags()
    assert before["allow_tf32"] and before["enabled"]
    got = fns[name](x.as_subclass(_OnCard))
    assert seen and all(f["allow_tf32"] is False and f["enabled"]
                        for _, f in seen), seen
    assert _flags() == before
    torch.testing.assert_close(got.as_subclass(torch.Tensor), fns[name](x),
                               atol=0, rtol=0)


@pytest.mark.parametrize("name", ("conv1d", "wn_conv2d", "depthwise_lowpass"))
def test_fp32_cuda_conv_backward_runs_with_tf32_off(seen, name):
    """Where a gradient flows, the backward runs under the same flags,
    and the gradients are the convolution's own."""
    x, fns = _inputs(torch.float32)
    xc = x.as_subclass(_OnCard).requires_grad_()
    before = _flags()
    fns[name](xc).square().sum().backward()
    kinds = [k for k, _ in seen]
    assert "forward" in kinds and "backward" in kinds, kinds
    assert all(f["allow_tf32"] is False and f["enabled"] for _, f in seen)
    assert _flags() == before
    xr = x.clone().requires_grad_()
    fns[name](xr).square().sum().backward()
    torch.testing.assert_close(xc.grad.as_subclass(torch.Tensor), xr.grad,
                               atol=1e-6, rtol=1e-6)


def test_the_callers_other_cudnn_flags_stand(seen, monkeypatch):
    """benchmark and deterministic as the caller set them hold inside the
    call and after it (flags' own defaults would reset them and turn
    cuDNN off)."""
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    x, fns = _inputs(torch.float32)
    before = _flags()
    fns["conv1d"](x.as_subclass(_OnCard))
    (_, f), = seen
    assert f == {**before, "allow_tf32": False}
    assert _flags() == before


@pytest.mark.parametrize("dtype,on_card", [(torch.bfloat16, True),
                                           (torch.float32, False)])
def test_bf16_and_cpu_convs_are_called_as_they_are(seen, dtype, on_card):
    """TF32 does not apply to bf16, and a CPU tensor runs no cuDNN: both
    see the flags unchanged.  (``resample`` computes in fp32 whatever it
    is given, so it is left out of the bf16 case.)"""
    x, fns = _inputs(dtype)
    if on_card:
        x = x.as_subclass(_OnCard)
    before = _flags()
    for name in CONVS:
        if dtype == torch.float32 or name != "resample":
            fns[name](x)
    assert seen and all(f == before for _, f in seen), seen
