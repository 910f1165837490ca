"""UnifiedVoice, the autoregressive GPT-2 TTS model (port of
``tortoise_tts_tpu/models/unified_voice.py``, inference slice).

Sequence layout, as in the JAX package:
    [cond (1)] [start_text, text.., stop_text (+pad)] [start_mel, mel..]
with per-modality learned position embeddings and no trunk positions.

What runs where:
- the causal trunk attention of the prefill and of the latent pass
  (``forward``) goes through K1 (``kernels/flash_attention``);
- each decode step's four linears go through K2 (``kernels/qgemv``, int8
  weights) or, with ``quant_mode="w8a8"``, K8 (``kernels/qgemv_w8a8``,
  int8 weights and per-row int8 activations), the LayerNorms fused into
  either, when the caller passes the int8 decode weights; its attention
  goes through K3 (``kernels/flash_decode``), or
  through K3's shared-prefix form in the candidate fan-out
  (``inference_speech_shared``: each group's prefill K/V held once, beside
  the rows' decode regions).

The decode is eager: ``decode_start`` runs the prefill and returns a
``DecodeState`` whose cache and buffers ``decode_chunk`` updates in place
(one KV cache, (L, B, H, S, Dh), no padding).  The step counter is a
host int, so positions never need a device read; whether every row has
stopped is read once per ``SYNC_EVERY`` steps and at chunk boundaries.
A row that stopped emits stop tokens, so the few extra steps change no
token, length or latent a caller reads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_decode import flash_decode, flash_decode_shared
from ..kernels.qgemv import qgemv
from ..kernels.qgemv_w8a8 import qgemv_w8a8
from ..ops.sampling import (SamplingConfig, apply_length_penalty,
                            apply_repetition_penalty, mirostat_step,
                            row_uniforms, sample_token)
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


def gpt_forward(gpt: Params, emb: torch.Tensor, heads: int,
                key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence causal forward.  emb: (B, T, D) -> the ln_f'd hidden
    states (B, T, D); key_mask: (B, T) bool, True = valid key."""
    x = emb
    for li in range(gpt["attn_qkv"]["w"].shape[0]):
        x = _gpt_layer(_layer(gpt, li), x, heads, key_mask)[0]
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
                     heads: int, cache: KVCache, pos: int,
                     key_mask: torch.Tensor, quant_mode: Optional[str],
                     prefix: Optional[KVCache] = None) -> torch.Tensor:
    """One token through the trunk.  x: (B, D); ``layers`` from
    ``decode_layers``.  Writes slot ``pos`` of every layer's cache in
    place and attends to the slots <= pos that key_mask allows.  With
    ``prefix`` (the shared-prefix decode) ``cache`` is the rows' decode
    region, ``pos`` a region slot and ``key_mask`` the (G, Sp) mask of the
    groups' prefix.  ``quant_mode``: None for the plain weights, or the
    int8 decode weights' mode, "int8" (K2) or "w8a8" (K8), with the
    LayerNorms fused.  Returns the ln_f'd hidden state (B, D)."""
    b, d = x.shape
    hd = d // heads
    gemv = {"int8": qgemv, "w8a8": qgemv_w8a8}.get(quant_mode)

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
        cache.k[li, :, :, pos] = k
        cache.v[li, :, :, pos] = v
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
            return_latent: bool = True) -> torch.Tensor:
    """Teacher-forced forward (reference unified_voice.py:544-612) for the
    latent pass: the hidden states above each mel input, (B, Tm, D).
    cond_latent: (B, D); text: (B, Tt), text_lengths: (B,); mel_codes:
    (B, Tm); wav_lengths: (B,) in samples.  The whole sequence is
    attended without a key mask, as the JAX package does."""
    if not return_latent:
        raise NotImplementedError(
            "the training losses of UnifiedVoice.forward are not ported "
            "yet (ROADMAP.md); pass return_latent=True")
    b = text.shape[0]
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
    hidden = gpt_forward(params["gpt"], emb, cfg.heads)
    # the first position is tied to the conditioning input
    enc = layer_norm(params["final_norm"], hidden[:, -(tm + 2):])
    return enc[:, :tm]


class DecodeResult(NamedTuple):
    codes: torch.Tensor     # (B, max_len) int64, stop-padded
    lengths: torch.Tensor   # (B,) codes before the stop
    latents: torch.Tensor   # (B, max_len, D) with collect_latents


@dataclass
class DecodeState:
    """Resumable decode state; ``decode_chunk`` advances it in place."""
    step: int
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
        0, cache, lat,
        torch.full((rows, max_length), cfg.stop_mel_token, dtype=torch.long,
                   device=dev),
        counts, torch.zeros((rows, max_length, d), dtype=dtype, device=dev),
        torch.zeros(rows, dtype=torch.bool, device=dev),
        torch.full((rows,), max_length, dtype=torch.long, device=dev),
        generators, key_mask,
        torch.zeros(rows, dtype=torch.float32, device=dev))
    return (state, prefix) if shared_rows else state


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
    ``decode_start(shared_rows=...)``."""
    if quant_mode not in QUANT_MODES:
        raise ValueError(f"quant_mode must be int8|w8a8, got {quant_mode!r}")
    b, max_len = state.tokens.shape
    cache_len = state.cache.k.shape[3]
    # the write slot: past the prefill, or in the region of a shared prefix
    first_slot = 0 if prefix is not None else cache_len - max_len
    limit = max_len if chunk is None else min(state.step + chunk, max_len)
    gpt = params["gpt"]
    dtype = params["mel_embedding"]["w"].dtype
    stop = cfg.stop_mel_token
    pos_off = 2 if cfg.hf_decode_positions else 1
    pos_w = params["mel_pos_embedding"]["w"]
    rows = torch.arange(b, device=state.tokens.device)
    layers = decode_layers(gpt, qgpt)
    draw = not sampling.greedy or sampling.mirostat_tau > 0
    if draw and state.generators is None:
        raise ValueError("sampled decoding needs one generator per row")

    if state.step < limit and bool(state.finished.all()):
        return state
    while state.step < limit:
        step = state.step
        logits = linear(params["mel_head"], state.lat).float()
        if sampling.length_penalty_factor != 0.0:
            logits[:, stop] = apply_length_penalty(
                logits[:, stop], step, sampling.length_penalty_factor)
        u = (row_uniforms(state.generators, logits.shape[-1], logits.device)
             if draw else None)
        if sampling.mirostat_tau > 0:
            x = apply_repetition_penalty(logits, state.counts,
                                         sampling.repetition_penalty)
            mu0 = (torch.full_like(state.mu, 2.0 * sampling.mirostat_tau)
                   if step == 0 else state.mu)
            tok, state.mu = mirostat_step(x, mu0, u, sampling.mirostat_tau,
                                          sampling.mirostat_eta)
        else:
            tok = sample_token(logits, sampling, state.counts, u)
        tok = torch.where(state.finished, stop, tok)
        now_stop = (tok == stop) & ~state.finished
        state.lengths = torch.where(now_stop, step, state.lengths)
        state.finished = state.finished | (tok == stop)
        state.tokens[:, step] = tok
        state.counts[rows, tok] += 1
        if collect_latents:
            state.latents[:, step] = state.lat.to(state.latents.dtype)

        emb = (embedding(params["mel_embedding"], tok)
               + pos_w[min(step + pos_off, pos_w.shape[0] - 1)])
        h = _gpt_decode_step(layers, gpt["ln_f"], emb.to(dtype), cfg.heads,
                             state.cache, first_slot + step,
                             state.key_mask,
                             quant_mode if qgpt is not None else None, prefix)
        state.lat = layer_norm(params["final_norm"], h)
        state.step = step + 1
        if state.step % SYNC_EVERY == 0 and bool(state.finished.all()):
            break
    return state


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
