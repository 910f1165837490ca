"""UnifiedVoice, the autoregressive GPT-2 TTS model (port of
``tortoise_tts_tpu/models/unified_voice.py``).

Sequence layout, as in the JAX package:
    [cond (1)] [start_text, text.., stop_text (+pad)] [start_mel, mel..]
with per-modality learned position embeddings and no trunk positions.

What runs where:
- the causal trunk attention of the prefill, of the latent pass and of
  the training forward (``forward``) goes through K1
  (``kernels/flash_attention``), whose backward recomputes its plain
  version; with ``remat`` each trunk layer is recomputed in the backward
  (``torch.utils.checkpoint``), so a training step launches K1 twice a
  layer;
- each decode step's four linears go through K2 (``kernels/qgemv``, int8
  weights) or, with ``quant_mode="w8a8"``, K8 (``kernels/qgemv_w8a8``,
  int8 weights and per-row int8 activations), the LayerNorms fused into
  either, when the caller passes the int8 decode weights; its attention
  goes through K3 (``kernels/flash_decode``), or
  through K3's shared-prefix form in the candidate fan-out
  (``inference_speech_shared``: each group's prefill K/V held once, beside
  the rows' decode regions);
- beam search (``inference_speech_beam``) runs the same decode step over
  B x W beams, with the cache's decode region gathered by beam each step.

``decode_start`` runs the prefill and returns a ``DecodeState`` whose
cache and buffers every decode step updates in place (one KV cache, (L,
B, H, S, Dh), no padding).  A step (``decode_step_fn``) reads no host
value: the step counter lives on the device (``DecodeState.step_dev``, a
0-d int32 tensor, from which K3's slot is made) and indexes the cache
write, the position embedding, the token and latent buffers and the
length penalty.
On CUDA tensors ``decode_chunk`` captures the step once per state as a
CUDA graph (``utils/graphs.StepGraph``) and replays it per token, as the
JAX package runs its decode as one ``lax.while_loop``; on CPU tensors it
runs the same step eagerly.  ``DecodeState.step`` mirrors the counter on
the host for the loop's limit and the callers.  Whether every row has
stopped is read once per ``SYNC_EVERY`` steps and at chunk boundaries; a
row that stopped emits stop tokens, so the few extra steps change no
token, length or latent a caller reads.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_decode import flash_decode, flash_decode_shared
from ..kernels.qgemv import qgemv
from ..kernels.qgemv_w8a8 import qgemv_w8a8
from ..ops.sampling import (SamplingConfig, apply_length_penalty,
                            apply_repetition_penalty, apply_temperature,
                            apply_top_k, apply_top_p, apply_typical, gumbel,
                            mirostat_step, row_uniforms, sample_token)
from ..utils.graphs import StepGraph
from .arch import conditioning_encoder, conditioning_encoder_init
from .common import (embedding, embedding_init, gelu_new, layer_norm,
                     linear, linear_init, normal, norm_init)

Params = Dict[str, Any]

SYNC_EVERY = 8      # decode steps between reads of "every row stopped"


@dataclass(frozen=True)
class UnifiedVoiceConfig:
    """Reference defaults (unified_voice.py:335-354)."""
    layers: int = 30
    model_dim: int = 1024
    heads: int = 16
    max_text_tokens: int = 402
    max_prompt_tokens: int = 2
    max_mel_tokens: int = 604
    max_conditioning_inputs: int = 2
    mel_length_compression: int = 1024
    number_text_tokens: int = 255
    start_text_token: int = 255
    stop_text_token: int = 0
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    types: int = 1
    # True reproduces the reference's HF-generate mel-position offset
    # (the first sampled token gets mel position 2), see the JAX config
    hf_decode_positions: bool = True

    @property
    def max_mel_seq_len(self) -> int:
        return self.max_mel_tokens + 2 + self.max_conditioning_inputs

    @property
    def max_text_seq_len(self) -> int:
        return self.max_text_tokens + 2

    @property
    def text_vocab(self) -> int:
        return self.number_text_tokens * self.types + 1


def init(g: torch.Generator, cfg: UnifiedVoiceConfig = UnifiedVoiceConfig()
         ) -> Params:
    """Random parameters with the JAX package's structure and init
    scales, made on the generator's device."""
    d, L, dev = cfg.model_dim, cfg.layers, g.device
    proj_std = 0.02 / (2 * L) ** 0.5

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    def ones(*shape):
        return torch.ones(shape, device=dev)

    gpt = {
        "ln_1": {"scale": ones(L, d), "bias": zeros(L, d)},
        "attn_qkv": {"w": normal(g, (L, d, 3 * d), 0.02), "b": zeros(L, 3 * d)},
        "attn_proj": {"w": normal(g, (L, d, d), proj_std), "b": zeros(L, d)},
        "ln_2": {"scale": ones(L, d), "bias": zeros(L, d)},
        "mlp_fc": {"w": normal(g, (L, d, 4 * d), 0.02), "b": zeros(L, 4 * d)},
        "mlp_proj": {"w": normal(g, (L, 4 * d, d), proj_std),
                     "b": zeros(L, d)},
        "ln_f": norm_init(d, dev),
    }
    return {
        "conditioning_encoder": conditioning_encoder_init(g, 80, d,
                                                          attn_blocks=6),
        "text_embedding": embedding_init(g, cfg.text_vocab, d),
        "mel_embedding": embedding_init(g, cfg.number_mel_codes, d),
        "text_pos_embedding": embedding_init(g, cfg.max_text_seq_len, d),
        "mel_pos_embedding": embedding_init(g, cfg.max_mel_seq_len, d),
        "gpt": gpt,
        "final_norm": norm_init(d, dev),
        "text_head": linear_init(g, d, cfg.text_vocab),
        "mel_head": linear_init(g, d, cfg.number_mel_codes),
    }


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, H, S, Dh)
    v: torch.Tensor


def _layer(gpt: Params, li: int) -> Params:
    """Layer li of the stacked trunk parameters (views)."""
    return {name: {k: t[li] for k, t in p.items()}
            for name, p in gpt.items() if name != "ln_f"}


def _gpt_layer(lp: Params, x: torch.Tensor, heads: int,
               key_mask: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pre-LN GPT-2 block over a whole sequence, causal attention
    through K1.  x: (B, T, D); key_mask: (B, T) bool or None.  Returns
    the block's output and its K, V as (B, H, T, Dh) views."""
    b, t, d = x.shape
    hd = d // heads
    qkv = linear(lp["attn_qkv"], layer_norm(lp["ln_1"], x))
    q, k, v = (z.view(b, t, heads, hd).transpose(1, 2)
               for z in qkv.split(d, dim=-1))
    a = flash_attention(q, k, v, key_mask=key_mask, causal=True)
    x = x + linear(lp["attn_proj"], a.transpose(1, 2).reshape(b, t, d))
    h = layer_norm(lp["ln_2"], x)
    x = x + linear(lp["mlp_proj"], gelu_new(linear(lp["mlp_fc"], h)))
    return x, k, v


def _unbound_layers(gpt: Params) -> List[Params]:
    """Every layer's parameters as views made by one ``unbind`` a stacked
    tensor: the backward then stacks the layers' gradients once, where a
    view per layer (``_layer``) would add a stacked-size gradient per
    layer."""
    n_layers = gpt["attn_qkv"]["w"].shape[0]
    parts = {name: {k: t.unbind(0) for k, t in p.items()}
             for name, p in gpt.items() if name != "ln_f"}
    return [{name: {k: ts[li] for k, ts in p.items()}
             for name, p in parts.items()} for li in range(n_layers)]


def gpt_forward(gpt: Params, emb: torch.Tensor, heads: int,
                key_mask: Optional[torch.Tensor] = None,
                remat: bool = False) -> torch.Tensor:
    """Full-sequence causal forward.  emb: (B, T, D) -> the ln_f'd hidden
    states (B, T, D); key_mask: (B, T) bool, True = valid key.  ``remat``:
    each layer keeps only its input for the backward and runs again there
    (the JAX package's ``jax.checkpoint`` of the scan body)."""
    def body(lp, x):
        return _gpt_layer(lp, x, heads, key_mask)[0]

    x = emb
    for lp in _unbound_layers(gpt):
        x = (checkpoint(body, lp, x, use_reentrant=False) if remat
             else body(lp, x))
    return layer_norm(gpt["ln_f"], x)


def _gpt_prefill(gpt: Params, emb: torch.Tensor, heads: int,
                 key_mask: torch.Tensor, cache_len: int
                 ) -> Tuple[torch.Tensor, KVCache]:
    """Causal forward over the prefix.  emb: (B, T, D); key_mask: (B, T)
    bool.  Returns the ln_f'd hidden states (B, T, D) and a cache of
    cache_len slots whose first T hold the prefix's K/V."""
    b, t, d = emb.shape
    n_layers = gpt["attn_qkv"]["w"].shape[0]
    shape = (n_layers, b, heads, cache_len, d // heads)
    kc = torch.zeros(shape, dtype=emb.dtype, device=emb.device)
    vc = torch.zeros(shape, dtype=emb.dtype, device=emb.device)
    x = emb
    for li in range(n_layers):
        x, k, v = _gpt_layer(_layer(gpt, li), x, heads, key_mask)
        kc[li, :, :, :t] = k
        vc[li, :, :, :t] = v
    return layer_norm(gpt["ln_f"], x), KVCache(kc, vc)


_Q_NAMES = ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj")
QUANT_MODES = ("int8", "w8a8")


def quantize_decode_weights(params: Params) -> Params:
    """Int8 copies of the four trunk linears for the decode
    (per-output-channel symmetric scales), as the JAX package makes them:
    {name: {'wq': (L, in, out) int8, 's': (L, out) fp32, 'b': fp32}}.
    Both decode modes, "int8" and "w8a8", take the same weights."""
    gpt = params["gpt"]
    out = {}
    for name in _Q_NAMES:
        w = gpt[name]["w"].float()
        s = w.abs().amax(dim=-2, keepdim=True) / 127.0 + 1e-12
        q = {"wq": torch.round(w / s).to(torch.int8),
             "s": s.squeeze(-2).contiguous()}
        del w
        if "b" in gpt[name]:
            q["b"] = gpt[name]["b"].float().contiguous()
        out[name] = q
    return out


def decode_layers(gpt: Params, qgpt: Optional[Params] = None) -> List:
    """Per-layer views of the decode weights, made once per chunk so the
    per-token loop indexes Python lists instead of tensors.  With
    ``qgpt`` (int8 decode weights) each linear is (wq, s, b) for K2 and
    the LayerNorms are fp32, fused into K2; without, the layer's plain
    parameters."""
    n_layers = gpt["attn_qkv"]["w"].shape[0]
    if qgpt is None:
        return [_layer(gpt, li) for li in range(n_layers)]
    ln32 = {n: {k: t.float().contiguous() for k, t in gpt[n].items()}
            for n in ("ln_1", "ln_2")}
    out = []
    for li in range(n_layers):
        lp = {n: (ln32[n]["scale"][li], ln32[n]["bias"][li])
              for n in ("ln_1", "ln_2")}
        for name in _Q_NAMES:
            qp = qgpt[name]
            lp[name] = (qp["wq"][li], qp["s"][li],
                        qp["b"][li] if "b" in qp else None)
        out.append(lp)
    return out


def _gpt_decode_step(layers: List, ln_f: Params, x: torch.Tensor,
                     heads: int, cache: KVCache, pos: torch.Tensor,
                     key_mask: torch.Tensor, quant_mode: Optional[str],
                     prefix: Optional[KVCache] = None) -> torch.Tensor:
    """One token through the trunk.  x: (B, D); ``layers`` from
    ``decode_layers``; ``pos``: the slot, a 0-d int32 tensor on x's
    device.  Writes slot ``pos`` of every layer's cache in place and
    attends to the slots <= pos that key_mask allows.  With
    ``prefix`` (the shared-prefix decode) ``cache`` is the rows' decode
    region, ``pos`` a region slot and ``key_mask`` the (G, Sp) mask of the
    groups' prefix.  ``quant_mode``: None for the plain weights, or the
    int8 decode weights' mode, "int8" (K2) or "w8a8" (K8), with the
    LayerNorms fused.  Returns the ln_f'd hidden state (B, D)."""
    b, d = x.shape
    hd = d // heads
    gemv = {"int8": qgemv, "w8a8": qgemv_w8a8}.get(quant_mode)
    slot = pos.long().view(1)

    def lin(lp, name, h, ln=None):
        if gemv is not None:
            wq, s, bias = lp[name]
            return gemv(h, wq, s, bias, ln=lp[ln] if ln else None)
        if ln is not None:
            h = layer_norm(lp[ln], h)
        return linear(lp[name], h)

    for li, lp in enumerate(layers):
        qkv = lin(lp, "attn_qkv", x, ln="ln_1")
        q, k, v = (z.view(b, heads, hd) for z in qkv.split(d, dim=-1))
        cache.k[li].index_copy_(2, slot, k[:, :, None])
        cache.v[li].index_copy_(2, slot, v[:, :, None])
        if prefix is None:
            a = flash_decode(q, cache.k[li], cache.v[li], pos, key_mask)
        else:
            a = flash_decode_shared(q, prefix.k[li], prefix.v[li], key_mask,
                                    cache.k[li], cache.v[li], pos)
        x = x + lin(lp, "attn_proj", a.reshape(b, d))
        h = gelu_new(lin(lp, "mlp_fc", x, ln="ln_2"))
        x = x + lin(lp, "mlp_proj", h)
    return layer_norm(ln_f, x)


def get_conditioning(params: Params, cond_mels: torch.Tensor,
                     cfg: UnifiedVoiceConfig = UnifiedVoiceConfig()
                     ) -> torch.Tensor:
    """cond_mels: (B, N, 80, T) or (B, 80, T) -> (B, D), the mean over
    the N clips."""
    if cond_mels.dim() == 3:
        cond_mels = cond_mels[:, None]
    b, n = cond_mels.shape[:2]
    flat = cond_mels.reshape((b * n,) + tuple(cond_mels.shape[2:]))
    lat = conditioning_encoder(params["conditioning_encoder"], flat,
                               cfg.heads)
    return lat.reshape(b, n, -1).mean(dim=1)


def _build_text_segment(params: Params, text: torch.Tensor,
                        text_lengths: torch.Tensor, cfg: UnifiedVoiceConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[start, text.., stop, pad..] embeddings (B, Tt+2, D) and their
    validity mask (B, Tt+2)."""
    b, tt = text.shape
    seg_len = tt + 2
    pos = torch.arange(seg_len, device=text.device)[None]
    shifted = F.pad(text, (1, 1), value=cfg.stop_text_token)
    ids = torch.where(pos == 0, cfg.start_text_token, shifted)
    ids = torch.where(pos > text_lengths[:, None], cfg.stop_text_token, ids)
    mask = pos <= text_lengths[:, None] + 1
    emb = embedding(params["text_embedding"], ids)
    emb = emb + embedding(params["text_pos_embedding"], pos[0])[None]
    return emb, mask


def forward(params: Params, cond_latent: torch.Tensor, text: torch.Tensor,
            text_lengths: torch.Tensor, mel_codes: torch.Tensor,
            wav_lengths: torch.Tensor,
            cfg: UnifiedVoiceConfig = UnifiedVoiceConfig(),
            return_latent: bool = True, remat: bool = False):
    """Teacher-forced forward (reference unified_voice.py:544-612).
    cond_latent: (B, D); text: (B, Tt), text_lengths: (B,); mel_codes:
    (B, Tm); wav_lengths: (B,) in samples.  The whole sequence is attended
    without a key mask, as the JAX package does.

    ``return_latent`` (the default, the latent pass): the hidden states
    above each mel input, (B, Tm, D).  Otherwise the training losses
    (loss_text, loss_mel, mel_logits): the mean cross entropies of the
    text and mel heads against [text, stop, stop] and [codes, stop, stop],
    and the (B, Tm + 2, number_mel_codes) mel logits.  ``remat``: the
    trunk's layers are recomputed in the backward."""
    tt = text.shape[1]
    tm = mel_codes.shape[1]
    text_emb, _ = _build_text_segment(params, text, text_lengths, cfg)
    # set_mel_padding (unified_voice.py:494-506)
    mel_lengths = wav_lengths // cfg.mel_length_compression
    pos_m = torch.arange(tm, device=mel_codes.device)[None]
    codes = torch.where(pos_m >= mel_lengths[:, None] + 1,
                        cfg.stop_mel_token, mel_codes)
    mel_in = F.pad(codes, (1, 0), value=cfg.start_mel_token)
    mel_in = F.pad(mel_in, (0, 1), value=cfg.stop_mel_token)
    mel_emb = (embedding(params["mel_embedding"], mel_in)
               + embedding(params["mel_pos_embedding"],
                           torch.arange(tm + 2, device=mel_in.device))[None])
    emb = torch.cat([cond_latent[:, None].to(text_emb.dtype), text_emb,
                     mel_emb.to(text_emb.dtype)], dim=1)
    hidden = gpt_forward(params["gpt"], emb, cfg.heads, remat=remat)
    # the first position is tied to the conditioning input
    if return_latent:
        enc = layer_norm(params["final_norm"], hidden[:, -(tm + 2):])
        return enc[:, :tm]
    enc = layer_norm(params["final_norm"], hidden[:, 1:])
    # aligned targets: positions >= len are stop, as the reference's
    # stop(0)-padded text is
    pos_t = torch.arange(tt + 2, device=text.device)[None]
    text_targets = torch.where(pos_t >= text_lengths[:, None],
                               cfg.stop_text_token, F.pad(text, (0, 2)))
    mel_targets = F.pad(codes, (0, 2), value=cfg.stop_mel_token)
    text_logits = linear(params["text_head"], enc[:, :tt + 2])
    mel_logits = linear(params["mel_head"], enc[:, -(tm + 2):])
    return (_ce(text_logits, text_targets), _ce(mel_logits, mel_targets),
            mel_logits)


def _ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy, log-softmax in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


class DecodeResult(NamedTuple):
    codes: torch.Tensor     # (B, max_len) int64, stop-padded
    lengths: torch.Tensor   # (B,) codes before the stop
    latents: torch.Tensor   # (B, max_len, D) with collect_latents


@dataclass
class DecodeState:
    """Resumable decode state; ``decode_chunk`` advances it in place.
    ``step`` is the host's mirror of ``step_dev``, the device's step
    counter; ``graph`` is the captured decode step on CUDA (kept for the
    state's later chunks while ``graph_key`` matches the call)."""
    step: int
    step_dev: torch.Tensor   # () int32, the step on the device
    cache: KVCache
    lat: torch.Tensor        # (B, D) latent that gives this step's logits
    tokens: torch.Tensor     # (B, max_len)
    counts: torch.Tensor     # (B, V) tokens seen, for the repetition penalty
    latents: torch.Tensor    # (B, max_len, D)
    finished: torch.Tensor   # (B,) bool
    lengths: torch.Tensor    # (B,)
    generators: Optional[List[torch.Generator]]  # one per row
    key_mask: torch.Tensor   # (B, cache_len) bool; (G, Sp) shared prefix
    mu: torch.Tensor         # (B,) mirostat running max-surprise
    graph: Optional[StepGraph] = None
    graph_key: Optional[tuple] = None


def decode_start(params: Params, cond_latent: torch.Tensor,
                 text: torch.Tensor, text_lengths: torch.Tensor,
                 generators: Optional[List[torch.Generator]] = None,
                 cfg: UnifiedVoiceConfig = UnifiedVoiceConfig(),
                 max_length: int = 500, shared_rows: int = 0):
    """Prefill [cond, text segment, start_mel] and return the state.
    ``generators``: one torch.Generator per decode row on the model's
    device (sampled decoding draws from them; greedy needs none).

    ``shared_rows`` > 0 (candidate fan-out): the B input rows are G
    prefill groups, each fanning out ``shared_rows`` = C decode rows,
    group-major (row g*C + c).  Returns ``(state, prefix)``: ``state``
    holds only the G*C rows' decode regions, and ``prefix`` the groups'
    prefill K/V (L, G, H, Sp, Dh), held once per group and passed to
    ``decode_chunk(prefix=...)``."""
    b, tt = text.shape
    d = cfg.model_dim
    dev = text.device
    prefix_len = 1 + tt + 2
    cache_len = prefix_len + 1 + max_length
    dtype = params["mel_embedding"]["w"].dtype
    rows = b * shared_rows if shared_rows else b
    if generators is not None and len(generators) != rows:
        # the JAX package takes explicit per-row keys here unchecked
        raise ValueError(f"{len(generators)} generators for {rows} decode "
                         f"rows ({b} prefill rows x {shared_rows or 1}): "
                         "pass one per decode row, group-major")

    text_emb, text_mask = _build_text_segment(params, text, text_lengths, cfg)
    start_emb = (params["mel_embedding"]["w"][cfg.start_mel_token]
                 + params["mel_pos_embedding"]["w"][0]).to(text_emb.dtype)
    prefill = torch.cat([cond_latent[:, None].to(text_emb.dtype), text_emb,
                         start_emb.expand(b, 1, d)], dim=1)
    ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
    prefill_mask = torch.cat([ones, text_mask, ones], dim=1)
    if shared_rows:
        sp = prefill.shape[1]
        hidden, prefix = _gpt_prefill(params["gpt"], prefill, cfg.heads,
                                      prefill_mask, sp)
        rshape = (cfg.layers, rows, cfg.heads, max_length, d // cfg.heads)
        cache = KVCache(torch.zeros(rshape, dtype=prefix.k.dtype, device=dev),
                        torch.zeros(rshape, dtype=prefix.v.dtype, device=dev))
        key_mask = prefill_mask
    else:
        hidden, cache = _gpt_prefill(params["gpt"], prefill, cfg.heads,
                                     prefill_mask, cache_len)
        key_mask = torch.cat(
            [prefill_mask, torch.ones((b, cache_len - prefill.shape[1]),
                                      dtype=torch.bool, device=dev)], dim=1)
    lat = layer_norm(params["final_norm"], hidden[:, -1])
    if shared_rows:
        lat = lat.repeat_interleave(shared_rows, dim=0)
    counts = torch.zeros((rows, cfg.number_mel_codes), dtype=torch.int32,
                         device=dev)
    # start_mel counts as seen for the repetition penalty
    counts[:, cfg.start_mel_token] += 1
    state = DecodeState(
        0, torch.zeros((), dtype=torch.int32, device=dev), cache, lat,
        torch.full((rows, max_length), cfg.stop_mel_token, dtype=torch.long,
                   device=dev),
        counts, torch.zeros((rows, max_length, d), dtype=dtype, device=dev),
        torch.zeros(rows, dtype=torch.bool, device=dev),
        torch.full((rows,), max_length, dtype=torch.long, device=dev),
        generators, key_mask,
        torch.zeros(rows, dtype=torch.float32, device=dev))
    return (state, prefix) if shared_rows else state


def decode_step_fn(params: Params, state: DecodeState,
                   cfg: UnifiedVoiceConfig = UnifiedVoiceConfig(),
                   sampling: SamplingConfig = SamplingConfig(),
                   collect_latents: bool = False,
                   qgpt: Optional[Params] = None,
                   quant_mode: str = "int8",
                   prefix: Optional[KVCache] = None) -> Callable[[], None]:
    """One decode step over ``state``'s buffers, as a function of no
    arguments (the body of the JAX package's ``decode_chunk`` loop): the
    next token of every row from ``state.lat``, written with its length,
    count and latent at the device step, then that token through the
    trunk into the cache and ``state.lat``, and the device step advanced.
    It reads no host value and writes every result in place, so it can be
    captured and replayed (``decode_chunk``); the host's ``state.step``
    is the caller's to advance.  Arguments as ``decode_chunk``'s."""
    if quant_mode not in QUANT_MODES:
        raise ValueError(f"quant_mode must be int8|w8a8, got {quant_mode!r}")
    draw = not sampling.greedy or sampling.mirostat_tau > 0
    if draw and state.generators is None:
        raise ValueError("sampled decoding needs one generator per row")
    b, max_len = state.tokens.shape
    cache_len = state.cache.k.shape[3]
    # the write slot: past the prefill, or in the region of a shared prefix
    first_slot = 0 if prefix is not None else cache_len - max_len
    gpt = params["gpt"]
    dtype = params["mel_embedding"]["w"].dtype
    stop = cfg.stop_mel_token
    pos_off = 2 if cfg.hf_decode_positions else 1
    pos_w = params["mel_pos_embedding"]["w"]
    layers = decode_layers(gpt, qgpt)
    mode = quant_mode if qgpt is not None else None
    # the buffers alone: a captured step keeps them, and no graph
    st = dataclasses.replace(state, graph=None, graph_key=None)

    def step() -> None:
        t = st.step_dev
        idx = t.long().view(1)
        logits = linear(params["mel_head"], st.lat).float()
        if sampling.length_penalty_factor != 0.0:
            logits[:, stop] = apply_length_penalty(
                logits[:, stop], t, sampling.length_penalty_factor)
        u = (row_uniforms(st.generators, logits.shape[-1], logits.device)
             if draw else None)
        if sampling.mirostat_tau > 0:
            x = apply_repetition_penalty(logits, st.counts,
                                         sampling.repetition_penalty)
            mu0 = torch.where(t == 0, 2.0 * sampling.mirostat_tau, st.mu)
            tok, mu = mirostat_step(x, mu0, u, sampling.mirostat_tau,
                                    sampling.mirostat_eta)
            st.mu.copy_(mu)
        else:
            tok = sample_token(logits, sampling, st.counts, u)
        tok = torch.where(st.finished, stop, tok)
        now_stop = (tok == stop) & ~st.finished
        st.lengths.copy_(torch.where(now_stop, idx, st.lengths))
        st.finished.logical_or_(tok == stop)
        st.tokens.index_copy_(1, idx, tok[:, None])
        rows = torch.arange(b, device=tok.device)
        st.counts[rows, tok] += 1
        if collect_latents:
            st.latents.index_copy_(1, idx,
                                   st.lat[:, None].to(st.latents.dtype))
        row = (idx + pos_off).clamp(max=pos_w.shape[0] - 1)
        emb = (embedding(params["mel_embedding"], tok)
               + pos_w.index_select(0, row))
        h = _gpt_decode_step(layers, gpt["ln_f"], emb.to(dtype), cfg.heads,
                             st.cache, t + first_slot, st.key_mask, mode,
                             prefix)
        st.lat.copy_(layer_norm(params["final_norm"], h))
        st.step_dev.add_(1)
    return step


def advance(state: DecodeState, limit: int, step: Callable[[], None]
            ) -> DecodeState:
    """Run ``step`` (one decode step of ``state``) until the host step
    reaches ``limit`` or, read every ``SYNC_EVERY`` steps, every row has
    stopped; nothing when every row has stopped already."""
    if state.step < limit and bool(state.finished.all()):
        return state
    while state.step < limit:
        step()
        state.step += 1
        if state.step % SYNC_EVERY == 0 and bool(state.finished.all()):
            break
    return state


def decode_chunk(params: Params, state: DecodeState,
                 cfg: UnifiedVoiceConfig = UnifiedVoiceConfig(),
                 sampling: SamplingConfig = SamplingConfig(),
                 chunk: Optional[int] = None,
                 collect_latents: bool = False,
                 qgpt: Optional[Params] = None,
                 quant_mode: str = "int8",
                 prefix: Optional[KVCache] = None) -> DecodeState:
    """Advance the decode by up to ``chunk`` tokens (None: to the end),
    stopping early once every row has emitted the stop token.  ``qgpt``:
    int8 decode weights from ``quantize_decode_weights``, multiplied in
    ``quant_mode``: "int8" (weight-only, K2) or "w8a8" (per-row int8
    activations too, K8); ``prefix``: the shared prefill K/V from
    ``decode_start(shared_rows=...)``.

    CPU tensors run ``decode_step_fn``'s step eagerly.  CUDA tensors run
    it as a CUDA graph, captured at the first step run with these
    arguments (that step runs eagerly, as the capture's warm-up) and
    replayed per token; the graph stays with the state, so a later chunk
    with the same arguments replays it, and other sampling,
    ``collect_latents``, quantization, config, weights or prefix capture
    anew."""
    max_len = state.tokens.shape[1]
    limit = max_len if chunk is None else min(state.step + chunk, max_len)
    dev = state.tokens.device
    key = (cfg, sampling, collect_latents,
           quant_mode if qgpt is not None else None,
           id(params), id(qgpt), id(prefix))
    if dev.type == "cuda" and state.graph_key == key:
        return advance(state, limit, state.graph.replay)
    step = decode_step_fn(params, state, cfg, sampling, collect_latents,
                          qgpt, quant_mode, prefix)
    if dev.type != "cuda":
        return advance(state, limit, step)
    draw = not sampling.greedy or sampling.mirostat_tau > 0

    def run() -> None:
        if state.graph_key == key:
            state.graph.replay()
            return
        state.graph = None      # the old graph's pool goes first
        state.graph = StepGraph(step, dev, state.generators if draw else ())
        state.graph_key = key
    return advance(state, limit, run)


def inference_speech(params: Params, cond_latent: torch.Tensor,
                     text: torch.Tensor, text_lengths: torch.Tensor,
                     generators: Optional[List[torch.Generator]] = None,
                     cfg: UnifiedVoiceConfig = UnifiedVoiceConfig(),
                     sampling: SamplingConfig = SamplingConfig(),
                     max_length: int = 500,
                     collect_latents: bool = False,
                     qgpt: Optional[Params] = None,
                     quant_mode: str = "int8") -> DecodeResult:
    """Prefill plus the whole decode: mel codes, lengths and (with
    collect_latents) the latent that predicted each code."""
    state = decode_start(params, cond_latent, text, text_lengths, generators,
                         cfg, max_length)
    state = decode_chunk(params, state, cfg, sampling, chunk=None,
                         collect_latents=collect_latents, qgpt=qgpt,
                         quant_mode=quant_mode)
    return DecodeResult(state.tokens, state.lengths, state.latents)


def inference_speech_shared(params: Params, cond_latent: torch.Tensor,
                            text: torch.Tensor, text_lengths: torch.Tensor,
                            generators: Optional[List[torch.Generator]],
                            rows: int,
                            cfg: UnifiedVoiceConfig = UnifiedVoiceConfig(),
                            sampling: SamplingConfig = SamplingConfig(),
                            max_length: int = 500,
                            collect_latents: bool = False,
                            qgpt: Optional[Params] = None,
                            quant_mode: str = "int8") -> DecodeResult:
    """Candidate fan-out decode with a shared prefix: G input rows (one per
    text), each decoded as ``rows`` candidates (group-major, row g*rows +
    c) from one prefill whose K/V are held once per group.  Draw for draw
    the fan-out decode of the repeated rows with the same generators."""
    state, prefix = decode_start(params, cond_latent, text, text_lengths,
                                 generators, cfg, max_length,
                                 shared_rows=rows)
    state = decode_chunk(params, state, cfg, sampling, chunk=None,
                         collect_latents=collect_latents, qgpt=qgpt,
                         quant_mode=quant_mode, prefix=prefix)
    return DecodeResult(state.tokens, state.lengths, state.latents)


# ---------------------------------------------------------------------------
# beam search (the JAX package's inference_speech_beam)
# ---------------------------------------------------------------------------


@dataclass
class BeamState:
    """A beam decode's buffers, every one updated in place by the step:
    B rows of W beams, the beams in the batch dimension of the trunk's
    cache (row-major, row b's beams at b*W .. b*W + W - 1).  ``scratch``
    holds the gathered decode region of the cache, one of K and V at a
    time; ``gumbel`` is an injected (max_len, B, W*V) noise table
    (tests), else the sampled beam draws from ``generator``."""
    step: int
    step_dev: torch.Tensor   # () int32
    cache: KVCache           # (L, B*W, H, S, Dh)
    scratch: torch.Tensor    # (L, B*W, H, max_len, Dh)
    lat: torch.Tensor        # (B*W, D)
    tokens: torch.Tensor     # (B, W, max_len)
    scores: torch.Tensor     # (B, W) summed log-probs
    finished: torch.Tensor   # (B, W) bool
    lengths: torch.Tensor    # (B, W)
    counts: torch.Tensor     # (B, W, V) tokens seen, per beam
    key_mask: torch.Tensor   # (B*W, S)
    generator: Optional[torch.Generator]
    gumbel: Optional[torch.Tensor]


def beam_start(params: Params, cond_latent: torch.Tensor, text: torch.Tensor,
               text_lengths: torch.Tensor, num_beams: int,
               cfg: UnifiedVoiceConfig = UnifiedVoiceConfig(),
               max_length: int = 500,
               generator: Optional[torch.Generator] = None,
               gumbel: Optional[torch.Tensor] = None) -> BeamState:
    """The prefill of every row repeated ``num_beams`` times, and the beam
    state: beam 0 of each row at score 0, the others at -1e9, so the first
    step expands beam 0 alone."""
    b, w = text.shape[0], num_beams

    def rep(x):
        return x.repeat_interleave(w, dim=0)
    st = decode_start(params, rep(cond_latent), rep(text), rep(text_lengths),
                      None, cfg, max_length)
    dev = text.device
    k = st.cache.k
    scratch = torch.empty(k.shape[:3] + (max_length, k.shape[4]),
                          dtype=k.dtype, device=dev)
    scores = torch.full((b, w), -1e9, device=dev)
    scores[:, 0] = 0.0
    return BeamState(
        0, st.step_dev, st.cache, scratch, st.lat,
        st.tokens.view(b, w, max_length), scores,
        torch.zeros((b, w), dtype=torch.bool, device=dev),
        st.lengths.view(b, w), st.counts.view(b, w, -1), st.key_mask,
        generator, gumbel)


def gather_beams(state: BeamState, sel: torch.Tensor) -> None:
    """Reorder the cache's decode region by beam, in place: trunk row i
    takes row ``sel[i]``'s K and V (the prefix, the same in a row's beams,
    stays).  One gather into the scratch and one copy back for each of K
    and V, on 16-byte elements: ``index_select`` moves one element a
    thread, so the cache viewed as complex128 moves 8 bf16 values at a
    time (PERF.md, section 6)."""
    first = state.cache.k.shape[3] - state.tokens.shape[2]
    scratch = state.scratch.view(torch.complex128)
    for z in state.cache:
        region = z[:, :, :, first:].view(torch.complex128)
        torch.index_select(region, 1, sel, out=scratch)
        region.copy_(scratch)


def beam_step_fn(params: Params, state: BeamState,
                 cfg: UnifiedVoiceConfig = UnifiedVoiceConfig(),
                 sampling: SamplingConfig = SamplingConfig(),
                 do_sample: bool = False, qgpt: Optional[Params] = None,
                 quant_mode: str = "int8") -> Callable[[], None]:
    """One beam step as a function of no arguments (the body of the JAX
    package's beam ``lax.while_loop``), reading no host value:

    1. the stop logit's length penalty on the raw logits, then
       ``log_softmax``, then the repetition penalty (per-beam counts) and
       the typical warper on the log-probs (HF's beam order);
    2. a finished beam may only continue with the stop token, at 0 added
       score;
    3. greedy: the top W of the (B, W*V) totals.  Sampled (HF
       ``beam_sample``): temperature, top-k and top-p warp the totals, a
       Gumbel top-2W draws candidates, the W stop continuations join them,
       and the W best by warped score go on;
    4. the decode region of the cache, the tokens, counts, ``finished`` and
       lengths are gathered by beam, and the new tokens go through the
       trunk (K2 or K8 with ``qgpt``, then K3) into the cache and ``lat``.

    Once every beam has stopped the step changes no score, token, length
    or beam order (the JAX loop has ended there), so the steps run before
    the host reads "all stopped" change nothing."""
    if quant_mode not in QUANT_MODES:
        raise ValueError(f"quant_mode must be int8|w8a8, got {quant_mode!r}")
    if do_sample and state.generator is None and state.gumbel is None:
        raise ValueError("the sampled beam needs a generator")
    b, w, max_len = state.tokens.shape
    v = state.counts.shape[-1]
    dev = state.tokens.device
    stop = cfg.stop_mel_token
    cache_len = state.cache.k.shape[3]
    first_slot = cache_len - max_len
    gpt = params["gpt"]
    dtype = params["mel_embedding"]["w"].dtype
    pos_off = 2 if cfg.hf_decode_positions else 1
    pos_w = params["mel_pos_embedding"]["w"]
    layers = decode_layers(gpt, qgpt)
    mode = quant_mode if qgpt is not None else None
    st = state
    stop_only = torch.full((v,), float("-inf"), device=dev)
    stop_only[stop] = 0.0
    stop_cand = (torch.arange(w, device=dev) * v + stop)[None].expand(b, w)
    beams = torch.arange(w, device=dev)[None].expand(b, w)
    row0 = (torch.arange(b, device=dev) * w)[:, None]
    rows = torch.arange(b, device=dev)[:, None].expand(b, w)

    def step() -> None:
        t = st.step_dev
        idx = t.long().view(1)
        x = linear(params["mel_head"], st.lat).float()
        if sampling.length_penalty_factor != 0.0:
            x[:, stop] = apply_length_penalty(x[:, stop], t,
                                              sampling.length_penalty_factor)
        logp = torch.log_softmax(x, dim=-1)
        logp = apply_repetition_penalty(logp, st.counts.view(b * w, v),
                                        sampling.repetition_penalty)
        logp = apply_typical(logp, sampling.typical_mass).view(b, w, v)
        logp = torch.where(st.finished[..., None], stop_only, logp)
        total = st.scores[..., None] + logp
        if do_sample:
            warped = apply_temperature(total.view(b * w, v),
                                       sampling.temperature)
            warped = apply_top_p(apply_top_k(warped, sampling.top_k),
                                 sampling.top_p)
            flat = warped.view(b, w * v)
            if st.gumbel is not None:
                noise = st.gumbel.index_select(0, idx)[0]
            else:
                noise = gumbel(torch.rand((b, w * v), generator=st.generator,
                                          device=dev))
            cand = torch.topk(torch.where(torch.isfinite(flat), flat + noise,
                                          float("-inf")), 2 * w).indices
            cand = torch.cat([cand, stop_cand], dim=1)
            top_scores, order = torch.topk(torch.gather(flat, 1, cand), w)
            top_idx = torch.gather(cand, 1, order)
        else:
            top_scores, top_idx = torch.topk(total.view(b, w * v), w)
        go = ~st.finished.all()
        beam = torch.where(go, top_idx // v, beams)
        tok = torch.where(go, top_idx % v, stop)
        top_scores = torch.where(go, top_scores, st.scores)
        gather_beams(st, (row0 + beam).view(-1))
        st.tokens.copy_(torch.gather(
            st.tokens, 1, beam[..., None].expand(b, w, max_len)))
        st.tokens.index_copy_(2, idx, tok[..., None])
        st.counts.copy_(torch.gather(st.counts, 1,
                                     beam[..., None].expand(b, w, v)))
        st.counts[rows, beams, tok] += 1
        finished = torch.gather(st.finished, 1, beam)
        lengths = torch.gather(st.lengths, 1, beam)
        st.lengths.copy_(torch.where((tok == stop) & ~finished, idx, lengths))
        st.finished.copy_(finished | (tok == stop))
        st.scores.copy_(top_scores)
        row = (idx + pos_off).clamp(max=pos_w.shape[0] - 1)
        emb = (embedding(params["mel_embedding"], tok.view(-1))
               + pos_w.index_select(0, row))
        h = _gpt_decode_step(layers, gpt["ln_f"], emb.to(dtype), cfg.heads,
                             st.cache, t + first_slot, st.key_mask, mode)
        st.lat.copy_(layer_norm(params["final_norm"], h))
        st.step_dev.add_(1)
    return step


def beam_result(state: BeamState, length_penalty: float) -> DecodeResult:
    """Each row's best beam by score / max(length, 1)**length_penalty.
    The latents come back as zeros, as the JAX package returns them: a
    route's latent pass recomputes them."""
    b, _, max_len = state.tokens.shape
    norm = state.scores / torch.pow(state.lengths.clamp(min=1).float(),
                                    length_penalty)
    best = norm.argmax(dim=1)
    rows = torch.arange(b, device=best.device)
    return DecodeResult(
        state.tokens[rows, best], state.lengths[rows, best],
        torch.zeros((b, max_len, state.lat.shape[-1]),
                    dtype=state.lat.dtype, device=best.device))


def inference_speech_beam(params: Params, cond_latent: torch.Tensor,
                          text: torch.Tensor, text_lengths: torch.Tensor,
                          cfg: UnifiedVoiceConfig = UnifiedVoiceConfig(),
                          num_beams: int = 4, max_length: int = 500,
                          sampling: SamplingConfig = SamplingConfig(),
                          generator: Optional[torch.Generator] = None,
                          do_sample: bool = False,
                          qgpt: Optional[Params] = None,
                          quant_mode: str = "int8",
                          gumbel: Optional[torch.Tensor] = None
                          ) -> DecodeResult:
    """Beam search over B rows of ``num_beams`` beams with the HF
    processor stack (``beam_step_fn``), then each row's best beam by
    ``sampling.length_penalty``.  ``do_sample``: HF ``beam_sample``,
    drawing from ``generator`` (one for the whole batch, as the JAX
    package keys the whole frontier with one key) or from the injected
    ``gumbel`` table.  CPU tensors run the step eagerly; CUDA tensors
    capture it once a call (the first step runs eagerly, as the capture's
    warm-up) and replay it a token.  "Every beam stopped" is read every
    ``SYNC_EVERY`` steps."""
    state = beam_start(params, cond_latent, text, text_lengths, num_beams,
                       cfg, max_length, generator, gumbel)
    step = beam_step_fn(params, state, cfg, sampling, do_sample, qgpt,
                        quant_mode)
    dev = text.device
    if dev.type != "cuda":
        advance(state, max_length, step)
    else:
        graph: List[StepGraph] = []
        draws = ([generator] if do_sample and gumbel is None else [])

        def run() -> None:
            if graph:
                graph[0].replay()
            else:
                graph.append(StepGraph(step, dev, draws))
        advance(state, max_length, run)
    return beam_result(state, sampling.length_penalty)
