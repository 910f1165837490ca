"""Functional NN primitives over plain parameter dicts.

Port of ``tortoise_tts_tpu/models/common.py``.  Every model in the port
is a set of functions over a nested dict of tensors that mirrors the
JAX package's parameter pytree leaf for leaf, so ``bridge.py`` carries
weights across without a key map.  Layouts stay the JAX package's:

- linear ``w`` is ``(in, out)`` (application ``x @ w + b``);
- conv1d ``w`` is ``(out, in, k)``; conv-transpose ``w`` is ``(in, out, k)``;
- norms use ``scale`` / ``bias``.

Every convolution of the port goes through ``conv``: an fp32 input on
CUDA runs, forward and backward, with cuDNN's TF32 off (fp32 means fp32
in the port: torch's default, ``torch.backends.cudnn.allow_tf32 = True``,
keeps about three decimal digits), cuDNN's other settings as the caller
left them, and no flag changed after the call.  Matmuls need nothing:
``torch.backends.cuda.matmul.allow_tf32`` defaults to False.
"""

from __future__ import annotations

import functools
import inspect
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# init helpers: draws come from an explicit torch.Generator on the device
# the tensors are made on

def _uniform(g: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=g, device=g.device) * 2 - 1) * bound


def normal(g: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=g, device=g.device) * std


def linear_init(g: torch.Generator, d_in: int, d_out: int,
                bias: bool = True) -> Params:
    """Torch nn.Linear default init (kaiming-uniform); w is (in, out)."""
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": _uniform(g, (d_in, d_out), bound)}
    if bias:
        p["b"] = _uniform(g, (d_out,), bound)
    return p


def embedding_init(g: torch.Generator, n: int, dim: int,
                   std: float = 0.02) -> Params:
    return {"w": normal(g, (n, dim), std)}


def conv1d_init(g: torch.Generator, c_in: int, c_out: int, k: int,
                bias: bool = True) -> Params:
    bound = 1.0 / math.sqrt(c_in * k)
    p = {"w": _uniform(g, (c_out, c_in, k), bound)}
    if bias:
        p["b"] = _uniform(g, (c_out,), bound)
    return p


def norm_init(dim: int, device=None) -> Params:
    """LayerNorm / GroupNorm parameters: scale 1, bias 0."""
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def group_norm_init(dim: int, device=None) -> Params:
    """GroupNorm parameters (the JAX package's ``group_norm_init``)."""
    return norm_init(dim, device)


def tree_map(fn, tree):
    """Apply fn to every tensor leaf of nested dicts / lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_cast(params: Params, dtype: torch.dtype) -> Params:
    """Cast every floating leaf to dtype."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    w = p["w"].to(x.dtype)
    if "b" in p:
        return torch.addmm(p["b"].to(x.dtype), x.reshape(-1, x.shape[-1]),
                           w).reshape(x.shape[:-1] + (w.shape[1],))
    return x @ w


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    # out-of-range ids clamp (the JAX package pins the TPU's clamping
    # semantics so an over-long decode budget degrades instead of NaNing)
    w = p["w"]
    return w[ids.clamp(0, w.shape[0] - 1)]


@functools.lru_cache(maxsize=None)
def _flag_names() -> tuple:
    return tuple(inspect.signature(torch.backends.cudnn.flags).parameters)


def _fp32_flags():
    """``torch.backends.cudnn.flags`` with TF32 off and every other setting
    as it stands: enabled, benchmark, deterministic (and benchmark_limit
    where this torch has it) passed as they are, any other flag None,
    which ``set_flags`` leaves unchanged.  (flags' own defaults would turn
    cuDNN off.)"""
    c = torch.backends.cudnn
    kw = {n: None for n in _flag_names()}
    kw.update(enabled=c.enabled, benchmark=c.benchmark,
              deterministic=c.deterministic, allow_tf32=False)
    if "benchmark_limit" in kw and c.is_available():
        kw["benchmark_limit"] = c.benchmark_limit
    return c.flags(**kw)


def _fp32_backward(node) -> None:
    """Runs a convolution's autograd node under ``_fp32_flags`` as well: a
    hook before the node enters them, a hook after it restores the
    flags."""
    held = []

    def enter(grad_outputs):
        held.append(_fp32_flags())
        held[-1].__enter__()

    def leave(grad_inputs, grad_outputs):
        held.pop().__exit__(None, None, None)
    node.register_prehook(enter)
    node.register_hook(leave)


def conv(fn: Callable, x: torch.Tensor, w: torch.Tensor,
         b: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
    """fn(x, w, b, **kw) for a ``torch.nn.functional`` convolution; an
    fp32 CUDA input runs, forward and backward, with cuDNN's TF32 off
    (``_fp32_flags``).  Any other input calls fn as it is."""
    if x.dtype != torch.float32 or not x.is_cuda:
        return fn(x, w, b, **kw)
    with _fp32_flags():
        out = fn(x, w, b, **kw)
    if out.grad_fn is not None:
        _fp32_backward(out.grad_fn)
    return out


def conv1d(p: Params, x: torch.Tensor, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """x: (B, C, T) -> (B, C_out, T_out)."""
    b = p["b"].to(x.dtype) if "b" in p else None
    return conv(F.conv1d, x, p["w"].to(x.dtype), b, stride=stride,
                padding=padding, dilation=dilation, groups=groups)


def conv_transpose1d(p: Params, x: torch.Tensor, stride: int,
                     padding: int = 0, output_padding: int = 0
                     ) -> torch.Tensor:
    """Torch ConvTranspose1d; weight (in, out, k)."""
    b = p["b"].to(x.dtype) if "b" in p else None
    return conv(F.conv_transpose1d, x, p["w"].to(x.dtype), b, stride=stride,
                padding=padding, output_padding=output_padding)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 LayerNorm over the last axis, cast back to x's dtype."""
    y = F.layer_norm(x.float(), x.shape[-1:], p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """xtransformers RMSNorm: x / max(||x|| d^-1/2, eps) * scale, fp32
    compute, cast back."""
    x32 = x.float()
    norm = torch.linalg.vector_norm(x32, dim=-1, keepdim=True) \
        * (x.shape[-1] ** -0.5)
    return (x32 / norm.clamp(min=eps) * p["scale"].float()).to(x.dtype)


def group_norm(p: Params, x: torch.Tensor, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm32 over (B, C, *spatial): fp32 compute, cast back."""
    y = F.group_norm(x.float(), groups, p["scale"].float(),
                     p["bias"].float(), eps)
    return y.to(x.dtype)


def norm_groups(channels: int) -> int:
    """Group-count heuristic (reference arch_utils.py:29-44)."""
    groups = 32
    if channels <= 16:
        groups = 8
    elif channels <= 64:
        groups = 16
    while channels % groups != 0:
        groups = int(groups / 2)
    if groups <= 2:
        raise ValueError(f"no group count for {channels} channels")
    return groups


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2 'gelu_new' (tanh approximation)."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return F.leaky_relu(x, slope)


def interpolate_linear(x: torch.Tensor, size: int,
                       scale: Optional[float] = None) -> torch.Tensor:
    """torch F.interpolate(mode='linear', align_corners=False) along the
    last axis of (B, C, T).  ``scale`` is source samples per output
    sample when the reference passed a scale_factor."""
    t = x.shape[-1]
    if scale is None:
        scale = t / size
    coords = (torch.arange(size, device=x.device, dtype=torch.float32)
              + 0.5) * scale - 0.5
    lo = torch.floor(coords)
    frac = torch.where(coords < 0, 0.0, coords - lo).to(x.dtype)
    lo_i = lo.long().clamp(0, t - 1)
    hi_i = (lo_i + 1).clamp(0, t - 1)
    return x[..., lo_i] * (1 - frac) + x[..., hi_i] * frac


def interpolate_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """torch F.interpolate(mode='nearest') along the last axis of (B, C,
    T), with the source index computed in fp32 as the JAX package does."""
    t = x.shape[-1]
    ratio = torch.tensor(t / size, dtype=torch.float32)
    idx = (torch.arange(size, dtype=torch.float32) * ratio).to(torch.long)
    return x[..., idx.clamp(0, t - 1).to(x.device)]


def sinusoidal_timestep_embedding(t: torch.Tensor, dim: int,
                                  max_period: int = 10000) -> torch.Tensor:
    """Timestep embedding [cos | sin] (reference diffusion.py:1277-1295);
    t: (N,) -> (N, dim) fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def _depthwise_weight(filt, x: torch.Tensor) -> torch.Tensor:
    """One FIR shared by every channel as a (C, 1, K) grouped-conv
    weight."""
    f = torch.as_tensor(filt, device=x.device).to(x.dtype)
    return f.view(1, 1, -1).expand(x.shape[1], 1, -1).contiguous()


def depthwise_lowpass(x: torch.Tensor, filt, stride: int, pad_left: int,
                      pad_right: int) -> torch.Tensor:
    """Per-channel FIR with edge padding (BigVGAN LowPassFilter1d).
    x: (B, C, T); filt: (K,) shared across channels."""
    x = F.pad(x, (pad_left, pad_right), mode="replicate")
    return conv(F.conv1d, x, _depthwise_weight(filt, x), stride=stride,
                groups=x.shape[1])


def depthwise_upsample(x: torch.Tensor, filt, ratio: int, pad: int,
                       pad_left: int, pad_right: int) -> torch.Tensor:
    """BigVGAN UpSample1d: edge-pad, zero-stuffed transposed conv with a
    FIR shared across channels, times ``ratio``, trimmed."""
    x = F.pad(x, (pad, pad), mode="replicate")
    y = ratio * conv(F.conv_transpose1d, x, _depthwise_weight(filt, x),
                     stride=ratio, groups=x.shape[1])
    return y[..., pad_left:y.shape[-1] - pad_right]
