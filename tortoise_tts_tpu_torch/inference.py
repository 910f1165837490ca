"""TTS inference API (port of ``tortoise_tts_tpu/inference.py``: the
default BigVGAN route, candidates with the CLVP rerank, voiceless
generation, batch serving and the HiFiGAN streaming route).

Per line of text, ``TTS.inference`` (``vocoder_type="bigvgan"``, the
default): tokenize -> bucket -> UnifiedVoice prefill and sampled decode
(``candidates`` > 1: a shared-prefix decode of that many rows) ->
stop-token cleanup and calm trim (and, for candidates, the CLVP rerank,
on the device) -> latent pass -> DDIM (or P) sampling of the denoiser
with cond-free guidance -> denormalize -> BigVGAN -> 16-bit PCM, trimmed
to the calm-trim length.  ``TTS.batch_inference`` runs the same stages
over many texts at once, with per-row seeds and voices and the diffusion
bucketed by row length.  With ``vocoder_type="hifigan"``, and in
``TTS.stream``: decode in chunks collecting latents -> HiFiGAN over a
trailing 60-latent window per chunk, crossfaded at the seams.  Without
references the conditioning latents come from the random latent
converters.  ``Inference.denoise_attention`` picks the kernels of the
denoiser's biased attention on every diffusion route, the cached
unconditional integrator included (``models/diffusion.py``).  UnivNet,
beam search, DPM++ and the serving mesh are not ported yet (ROADMAP.md).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
Sampled decoding draws from one ``torch.Generator`` per row, and the
diffusion noise from one more per row, all seeded from the row's seed
through the JAX package's SeedSequence chain (``_stage_keys``,
``_row_keys``), so one seed gives one wav per route and a batch row
replays as the single call with its seed.  The JAX package draws from
threefry keys, so the two agree in distribution only (greedy decoding
agrees token for token, and the tests inject the JAX package's diffusion
noise through ``_diffusion_noise``).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import Config
from .emb import mel as emb_mel
from .models import (bigvgan, clvp, diffusion, gaussian, hifigan, load_model,
                     resolve_device, rlg)
from .models.unified_voice import (QUANT_MODES, decode_chunk, decode_start,
                                   forward as uv_forward, inference_speech,
                                   inference_speech_shared,
                                   quantize_decode_weights)
from .ops.sampling import SamplingConfig
from .ops.stft import denormalize_tacotron_mel
from .tokenizer import VoiceBpeTokenizer
from .utils.io import write_wav

SAMPLE_RATE = 24_000
CALM_TOKEN = 83               # inference.py:231
TAIL_TOKENS = (45, 45, 248)   # inference.py:363-366
# decode budgets at or under this size the diffusion by the budget
# itself; larger ones read the decoded lengths once
STATIC_BUDGET_MAX = 256
# rows per diffusion dispatch of batch_inference (cond-free: B=16)
BATCH_CAP_ROWS = 8


def _sampling_from_knobs(ar_temp=0.8, top_k=0, top_p=1.0,
                         typical_sampling=False, typical_mass=0.9,
                         repetition_penalty=1.0, length_penalty_factor=0.0,
                         greedy=False, mirostat_tau=0.0, mirostat_eta=0.1,
                         min_temperature=0.0) -> SamplingConfig:
    """One SamplingConfig builder for inference() and stream()."""
    return SamplingConfig(
        temperature=ar_temp, top_k=top_k, top_p=top_p,
        typical_mass=typical_mass if typical_sampling else 0.0,
        repetition_penalty=repetition_penalty,
        length_penalty_factor=length_penalty_factor, greedy=greedy,
        mirostat_tau=mirostat_tau, mirostat_eta=mirostat_eta,
        min_temperature=min_temperature)


def _host_keys(seed: int, n: int) -> List[np.ndarray]:
    """n raw (2,) uint32 keys from numpy's SeedSequence (the JAX
    package's host key derivation)."""
    ss = np.random.SeedSequence(int(seed))
    return [np.asarray(s.generate_state(2), np.uint32) for s in ss.spawn(n)]


def _key_int(key) -> int:
    k = np.asarray(key)
    return (int(k[0]) << 32) | int(k[1])


def _generator(key, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(_key_int(key))


def _row_keys(key, n: int) -> List[np.ndarray]:
    """n per-row keys from one stage key.  SeedSequence children are
    prefix-stable (child i is the same for any n > i), so candidate c of
    a single call and of a batch row with the same seed draw alike."""
    return _host_keys(_key_int(key), n)


def _stage_keys(row_seed: int) -> List[np.ndarray]:
    """The (k_ar, k_diff, k_voc) keys of a single-line call with
    ``seed=row_seed``: ``inference`` and ``batch_inference``'s per-row
    seeds derive them alike, so a batch row replays as that call."""
    (sub,) = _host_keys(row_seed * 1000003, 1)
    return _host_keys(_key_int(sub), 3)


def _row_generators(line_key, n: int, device) -> List[torch.Generator]:
    """Per-row decode generators for one line, from its key: the AR stage
    key, then one child per row (the JAX package's k_ar / _row_keys)."""
    k_ar = _host_keys(_key_int(line_key), 3)[0]
    return [_generator(k, device) for k in _row_keys(k_ar, n)]


def _device_cleanup(codes: torch.Tensor, lengths: torch.Tensor, cfg):
    """Stop-token cleanup and the calm-trim point, vectorized on the
    codes' device (reference inference.py:353-389; the JAX package's
    ``_device_cleanup``).  Returns (codes with stops -> calm, the last 3
    kept codes -> the fixed tail and everything past lv -> stop; the trim
    point t_lat (B,); lv, a 0-d tensor)."""
    b, n = codes.shape
    idx = torch.arange(n, device=codes.device)[None]
    lv = torch.clamp(lengths.max() + 1, max=n)
    in_range = idx < lv
    stop_mask = (codes == cfg.stop_mel_token) & in_range
    has_stop = stop_mask.any(dim=1, keepdim=True)
    fs = torch.where(stop_mask, idx, n).min(dim=1, keepdim=True).values
    cleaned = torch.where(has_stop & (idx >= fs), CALM_TOKEN, codes)
    off = idx - (lv - 3)                        # 0, 1, 2 at the tail
    tails = torch.tensor(TAIL_TOKENS, dtype=codes.dtype,
                         device=codes.device)[off.clamp(0, 2)]
    cleaned = torch.where(has_stop & (off >= 0) & in_range, tails, cleaned)
    cleaned = torch.where(in_range, cleaned, cfg.stop_mel_token)
    # first index where more than 8 consecutive calm tokens begin, else lv
    is_calm = (cleaned == CALM_TOKEN) & in_range
    run = idx - torch.cummax(torch.where(is_calm, -1, idx), dim=1).values
    t_lat = torch.where((run > 8) & in_range, idx, lv).min(dim=1).values
    return cleaned, t_lat, lv


def _cleanup_latents(params, cond, text, text_lengths, codes, lengths, cfg):
    """Cleanup, calm trim and the latent pass, with no host read: returns
    (latents (B, N, D), t_lat (B,))."""
    cleaned, t_lat, lv = _device_cleanup(codes, lengths, cfg)
    wav_lengths = (torch.ones_like(text_lengths) * lv
                   * cfg.mel_length_compression)
    return uv_forward(params, cond, text, text_lengths, cleaned,
                      wav_lengths, cfg), t_lat


def _rerank_latents(params, clvp_params, cond, text, text_lengths, codes,
                    lengths, cfg, clvp_cfg, ncand: Optional[int] = None,
                    n_real: Optional[int] = None):
    """The candidates' cleanup, their CLVP scores on the calm-padded codes,
    the best row of each group of ``ncand`` (row-major; None: one group)
    and the latent pass on the winners only, with no host read (the JAX
    package's ``_jit_rerank_latents``).  Rows at or past ``n_real`` are
    padding and never win.  Returns (latents (G, N, D), t_lat (G,), best
    (G,) row indices)."""
    r = codes.shape[0]
    c = r if ncand is None else ncand
    cleaned, t_lat, lv = _device_cleanup(codes, lengths, cfg)
    idx = torch.arange(cleaned.shape[1], device=codes.device)[None]
    # CLVP's speech vocabulary has 8192 codes: the stop-padding past lv
    # is scored as the calm tokens the reference's cleanup emits there
    scores = clvp.forward(clvp_params, text,
                          torch.where(idx < lv, cleaned, CALM_TOKEN),
                          clvp_cfg)
    rows = torch.arange(r, device=codes.device)
    if n_real is not None and n_real < r:
        scores = torch.where(rows < n_real, scores, float("-inf"))
    best = scores.reshape(-1, c).argmax(dim=1) + rows[::c]
    wav_lengths = torch.ones_like(best) * lv * cfg.mel_length_compression
    latents = uv_forward(params, cond[best], text[best], text_lengths[best],
                         cleaned[best], wav_lengths, cfg)
    return latents, t_lat[best], best


def _diffusion_noise(key, shape, device) -> torch.Tensor:
    """The sampler's starting noise x_T, standard normal, from ``key``."""
    return torch.randn(shape, generator=_generator(key, device),
                       device=device)


def _rel_biases(dparams, T: int, dcfg, dtype, attention: str):
    """The denoiser's rel-pos biases, built for ``attention``
    (``Inference.denoise_attention``): transposed for "kq"."""
    return diffusion.precompute_rel_biases(
        dparams, T, dcfg, dtype, transposed=attention == "kq",
        flash_bias=attention == "flash_bias")


def _uncond_integrate(dparams, dcfg, steps: int, T: int,
                      attention: str = "auto") -> torch.Tensor:
    """Per-step integrator outputs of the unconditional guidance branch,
    (S, 1, C, T): a function of the weights, T and the schedule's
    timesteps only, so ``TTS`` caches it and each step runs the integrator
    for the conditional row alone.  ``attention``: the denoiser's
    attention mode, as in ``_diffusion``."""
    sched = gaussian.get_schedule(steps=steps)
    pdt = dparams["inp_block"]["w"].dtype
    dev = dparams["inp_block"]["w"].device
    rel = _rel_biases(dparams, T, dcfg, pdt, attention)
    uncond = diffusion.unconditioned_embedding(dparams, 1, T).to(pdt)
    temb = diffusion.embed_time(
        dparams, torch.as_tensor(sched.timestep_map, device=dev), dcfg, pdt)
    return torch.stack([
        diffusion.integrate_conditioning(dparams, uncond, temb[i:i + 1],
                                         dcfg, rel)
        for i in range(temb.shape[0])])


def _diffusion(dparams, latents, diff_cond, keys, dcfg, steps: int,
               sampler: str, seq_len: int, cond_free: bool,
               diffusion_temp: float, n_lat: int, t_lat,
               pad_seq_len: Optional[int], uncond_h,
               attention: str = "auto") -> torch.Tensor:
    """Latents -> denormalized mel (B, 100, T) (the JAX package's
    ``_jit_diffusion``).  ``latents`` is the latent pass's whole buffer:
    each row takes its first ``t_lat`` latents, edge-padded to ``n_lat``.
    ``diff_cond``: one diffusion latent per row, or one for all.  ``keys``:
    one (2,) key per row; row r's noise and sampler draws come from
    ``keys[r]`` alone.  The code embedding is made at ``seq_len`` and
    edge-padded to ``pad_seq_len``; with ``cond_free``, ``uncond_h`` is
    the cached unconditional integrator (``_uncond_integrate``).
    ``attention``: ``Inference.denoise_attention``, the kernel choice of
    the biased attention blocks (``models/diffusion.py``)."""
    sched = gaussian.get_schedule(steps=steps, cond_free=cond_free)
    b, dev = latents.shape[0], latents.device
    idx = torch.minimum(torch.arange(n_lat, device=dev)[None],
                        t_lat.reshape(-1, 1) - 1).expand(b, n_lat)
    latents = torch.gather(
        latents, 1, idx[..., None].expand(b, n_lat, latents.shape[-1]))
    diff_cond = diff_cond.float().reshape(-1, diff_cond.shape[-1]) \
        .expand(b, -1)
    T = seq_len if pad_seq_len is None else max(pad_seq_len, seq_len)
    pre = diffusion.timestep_independent(dparams, latents.float(), diff_cond,
                                         seq_len, dcfg)
    if T > seq_len:
        pre = F.pad(pre, (0, T - seq_len), mode="replicate")
    # the denoiser runs at the weights' type (bf16 in production), the
    # sampler math in fp32
    pdt = dparams["inp_block"]["w"].dtype
    code_emb = pre.to(pdt)
    rel = _rel_biases(dparams, T, dcfg, pdt, attention)
    if cond_free:
        uh = uncond_h.to(pdt)

        def model_fn(x, ts, t_idx):
            # t_idx: the sampler's respaced step, a (1,) device tensor
            te = diffusion.embed_time(dparams, ts, dcfg, pdt)
            h_c = diffusion.integrate_conditioning(dparams, code_emb, te[:b],
                                                   dcfg, rel)
            h = torch.cat([h_c, uh.index_select(0, t_idx)[0].expand_as(h_c)])
            return diffusion.forward_trunk(dparams, x.to(pdt), te, h, dcfg,
                                           rel)
    else:
        def model_fn(x, ts, t_idx):
            return diffusion.forward(dparams, x.to(pdt), ts, code_emb, dcfg,
                                     rel)

    noise, gens = [], []
    for key in keys:
        k_noise, k_samp = _host_keys(_key_int(key), 2)
        noise.append(_diffusion_noise(k_noise, (1, dcfg.in_channels, T), dev))
        gens.append(_generator(k_samp, dev))
    mel = gaussian.sample_loop(model_fn, torch.cat(noise) * diffusion_temp,
                               gens, sched, sampler=sampler)
    return denormalize_tacotron_mel(mel)


def _mel_frames(n_lat: int, mel_pad_multiple: int) -> int:
    """The denoiser's T for ``n_lat`` latents: the 22.05k -> 24k mel
    length, padded to ``mel_pad_multiple``."""
    t = n_lat * 4 * 24000 // 22050
    if mel_pad_multiple > 1:
        t += (-t) % mel_pad_multiple
    return t


def _row_buckets(t_lat: np.ndarray, mult: int, mel_pad_multiple: int
                 ) -> List[Tuple[int, np.ndarray]]:
    """The diffusion dispatches of a batch, (n_lat, rows) with at most
    ``BATCH_CAP_ROWS`` rows each, from the rows' trim points (the JAX package's
    ``batch_inference`` ladder): rungs at ``mult``·2^k below the longest
    row, plus up to three refined rungs, one padded-T tile apart, just
    under it (rows concentrate near the decode budget); a bucket of one or
    two rows moves up a rung while each of its rows' T grows by at most
    25% over its own rung."""
    budget = max(int(t_lat.max()), 1)
    rungs, n = {budget}, mult
    while n < budget:
        rungs.add(n)
        n *= 2
    if mel_pad_multiple > 1:
        for k in range(1, 4):
            t_r = _mel_frames(budget, mel_pad_multiple) - k * mel_pad_multiple
            if t_r <= 0:
                break
            cand = min(int(t_r * 22050 // 96000) + 2, budget)
            while cand > 0 and _mel_frames(cand, mel_pad_multiple) > t_r:
                cand -= 1
            if cand >= mult:
                rungs.add(cand)
    srungs = sorted(rungs)
    n_lats = np.asarray([next(r for r in srungs
                              if r >= min(max(int(t), 1), budget))
                         for t in t_lat])
    orig = np.asarray([_mel_frames(int(n), mel_pad_multiple) for n in n_lats])
    occupied = sorted(set(n_lats.tolist()))
    for here_n, nxt in zip(occupied[:-1], occupied[1:]):
        here = n_lats == here_n
        if (0 < int(here.sum()) < 3
                and _mel_frames(nxt, mel_pad_multiple)
                <= 1.25 * orig[here].min()):
            n_lats[here] = nxt
    chunks = []
    for n_lat in sorted(set(n_lats.tolist())):
        rows = np.nonzero(n_lats == n_lat)[0]
        chunks += [(n_lat, rows[i:i + BATCH_CAP_ROWS])
                   for i in range(0, len(rows), BATCH_CAP_ROWS)]
    return chunks


def _refuse_unported(vocoder_type: str, diffusion_sampler: str,
                     beam_width: int) -> None:
    """Raise for the options the port does not run yet."""
    if vocoder_type not in ("bigvgan", "hifigan"):
        raise NotImplementedError(
            f"vocoder_type={vocoder_type!r} (UnivNet) is not ported "
            "yet (ROADMAP.md); use 'bigvgan' or 'hifigan'")
    if diffusion_sampler == "dpm++":
        raise NotImplementedError(
            "diffusion_sampler='dpm++' is not ported yet (ROADMAP.md)")
    if beam_width > 1:
        raise NotImplementedError(
            "beam_width > 1 (beam search) is not ported yet (ROADMAP.md)")


def _vocode(params, mel: torch.Tensor, cfg) -> torch.Tensor:
    """BigVGAN at the weights' type, then 16-bit PCM on the device, as the
    JAX package delivers it: clip(w * 32767) -> int16."""
    pdt = params["conv_pre"]["w"].dtype
    wav = bigvgan.inference(params, mel.to(pdt), cfg).float()
    return torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)


class TTS:
    """User-facing inference API."""

    def __init__(self, config: Optional[Config | str | Path] = None,
                 device=None, amp=None, dtype: Optional[str] = None,
                 attention=None):
        """``amp`` and ``attention`` are accepted and ignored, as the JAX
        package and the reference accept them (the precision follows
        ``dtype``; the denoiser's attention, ``denoise_attention``)."""
        del amp, attention
        if isinstance(config, (str, Path)):
            config = Config.load(config)
        self.cfg = config or Config()
        self.device = resolve_device(device, "TTS")
        self.dtype = dtype or self.cfg.inference.weight_dtype
        self.tokenizer = VoiceBpeTokenizer()
        self.cache_voice = True
        self._models = {}
        self._voice_cache = {}
        self._uncond_cache = {}
        self._qgpt = None
        self._dparams = (None, None)

    def _model(self, name: str):
        if name not in self._models:
            self._models[name] = load_model(name, self.dtype,
                                            device=self.device)
        return self._models[name]

    def _ar_qgpt(self):
        """Cached int8 decode weights when decode_quant is 'int8' (weight
        only, K2) or 'w8a8' (per-row int8 activations too, K8): one copy
        for both, so switching ``cfg`` between them re-quantizes
        nothing."""
        if self.cfg.inference.decode_quant not in QUANT_MODES:
            return None
        if self._qgpt is None:
            self._qgpt = quantize_decode_weights(
                self._model("autoregressive").params)
        return self._qgpt

    def _denoiser_params(self):
        """The denoiser's params with K5's weights tap-major
        (``diffusion.prepare``), made once per loaded model, as
        ``_ar_qgpt`` keeps the decode's int8 weights."""
        params = self._model("diffusion").params
        if self._dparams[0] is not params:
            self._dparams = (params, diffusion.prepare(params))
        return self._dparams[1]

    @property
    def _quant_mode(self) -> str:
        mode = self.cfg.inference.decode_quant
        return mode if mode in QUANT_MODES else "int8"

    def encode_text(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer.encode(text), dtype=np.int64)

    def encode_audio(self, paths: str | Sequence[str | Path],
                     seed: Optional[int] = None):
        """Encode reference clips (';'-separated or a list) into the AR and
        diffusion conditioning latents; cached per clip list (and per seed
        with ``cache_voice=False``), at most 16 entries."""
        if isinstance(paths, str):
            paths = [Path(p) for p in paths.split(";")]
        key = tuple(str(p) for p in paths)
        if not self.cache_voice:
            key = (key, seed)
        if key in self._voice_cache:
            return self._voice_cache[key]
        enc = emb_mel.encode_from_files(
            paths, dtype=self.dtype, rng=np.random.RandomState(seed),
            device=self.device, ar=self._model("autoregressive"),
            diffusion=self._model("diffusion"))
        if len(self._voice_cache) < 16:
            self._voice_cache[key] = enc
        return enc

    def _bucket_text(self, tokens: np.ndarray) -> np.ndarray:
        buckets = self.cfg.inference.text_buckets
        n = tokens.shape[-1]
        for b in buckets:
            if n <= b:
                return np.pad(tokens, (0, b - n))
        return tokens[:buckets[-1]]

    def _latents(self, references, seed, conditioning_latents=None):
        """(AR latent, diffusion latent) on the device: the explicit
        latents, the references' encoding, or without references one draw
        of the random latent converters from ``seed`` (noise from
        generators seeded by the JAX package's ``_host_keys(seed ^
        0x5F3C, 2)``)."""
        if conditioning_latents is not None:
            return tuple(torch.as_tensor(np.asarray(c), device=self.device)
                         for c in conditioning_latents)
        if references is None:
            keys = _host_keys(seed ^ 0x5F3C, 2)
            return tuple(
                rlg.sample(m.params, _generator(k, self.device), 1, m.config)
                for m, k in zip((self._model("rlg_auto"),
                                 self._model("rlg_diffuser")), keys))
        return self.encode_audio(references, seed=seed)["latent"]

    def _encode_voice_rows(self, references, voices, n: int,
                           row_seeds: Sequence[int]):
        """Conditioning latents of a batch: (AR (n, Da), diffusion (n, Dd),
        or (1, Dd) for one shared voice), fp32.  ``references`` is one
        voice for every row, encoded with row 0's seed; ``voices`` one
        entry per row (None: voiceless); with neither, each row draws its
        own voiceless latents from its own seed, so every row replays as
        the single call with its seed."""
        if voices is None:
            if references is not None:
                a, d = self._latents(references, row_seeds[0])
                return (a.float().reshape(1, -1).expand(n, -1),
                        d.float().reshape(1, -1))
            voices = [None] * n
        elif references is not None:
            raise ValueError("pass either references (one voice) or voices "
                             "(one entry per row), not both")
        if len(voices) != n:
            raise ValueError(f"voices has {len(voices)} entries for {n} "
                             "texts")
        rows = [self._latents(v, s) for v, s in zip(voices, row_seeds)]
        return tuple(torch.cat([r[i].float().reshape(1, -1) for r in rows])
                     for i in (0, 1))

    def _diffusion_geometry(self, n_lat_base: int,
                            diffusion_pad_multiple: int,
                            mel_pad_multiple: int, steps: int,
                            cond_free: bool):
        """Pad the latent count to its bucket, derive the 22.05k -> 24k
        mel length and its padded length, and fetch the cached
        unconditional integrator for that shape."""
        n_lat = n_lat_base
        if diffusion_pad_multiple > 1:
            n_lat += (-n_lat) % diffusion_pad_multiple
        seq_len = n_lat * 4 * 24000 // 22050
        pad_seq_len = None
        if mel_pad_multiple > 1:
            pad_seq_len = seq_len + ((-seq_len) % mel_pad_multiple)
        uh = (self._uncond_integrated(steps, pad_seq_len or seq_len)
              if cond_free else None)
        return n_lat, seq_len, pad_seq_len, uh

    @staticmethod
    def _decode_budget_latents(max_ar_steps: int, res_lengths) -> int:
        """Small decode budgets size the diffusion by the budget itself
        (no read of the decoded lengths); larger ones read them once so a
        short utterance does not pay for a budget-sized diffusion."""
        if max_ar_steps <= STATIC_BUDGET_MAX:
            return max_ar_steps
        return min(int(res_lengths.max()) + 1, max_ar_steps)

    @torch.inference_mode()
    def _uncond_integrated(self, steps: int, T: int):
        """The cached unconditional integrator for (steps, T) and the
        attention mode, at most four entries (about 90 MB each at the
        shipped widths in bf16)."""
        attention = self.cfg.inference.denoise_attention
        key = (steps, T, attention)
        if key not in self._uncond_cache:
            if len(self._uncond_cache) >= 4:
                self._uncond_cache.pop(next(iter(self._uncond_cache)))
            d = self._model("diffusion")
            self._uncond_cache[key] = _uncond_integrate(
                self._denoiser_params(), d.config, steps, T, attention)
        return self._uncond_cache[key]

    def inference(self, text: str,
                  references: Optional[str | Sequence[str | Path]] = None,
                  max_ar_steps: int = 500, max_diffusion_steps: int = 80,
                  ar_temp: float = 0.8, diffusion_temp: float = 1.0,
                  top_p: float = 1.0, top_k: int = 0,
                  repetition_penalty: float = 1.0,
                  length_penalty_factor: float = 0.0,
                  typical_sampling: bool = False, typical_mass: float = 0.9,
                  diffusion_sampler: str = "ddim", cond_free: bool = True,
                  vocoder_type: str = "bigvgan", candidates: int = 1,
                  seed: Optional[int] = None,
                  out_path: Optional[str | Path] = None,
                  diffusion_pad_multiple: int = 0, mel_pad_multiple: int = 0,
                  mirostat_tau: float = 0.0, mirostat_eta: float = 0.1,
                  min_temperature: float = 0.0, greedy: bool = False,
                  conditioning_latents: Optional[Tuple] = None,
                  beam_width: int = 1) -> Tuple[np.ndarray, int]:
        """Text -> (wav float32 (T,), 24000).  The default route decodes,
        runs the diffusion and BigVGAN; ``vocoder_type="hifigan"`` runs
        the windowed HiFiGAN route of ``stream``.  ``candidates`` > 1
        decodes that many candidates from one shared prefill and keeps the
        CLVP's best (the BigVGAN route; the HiFiGAN route decodes one, as
        in the JAX package).  ``references`` None: voiceless, the
        conditioning latents drawn from the random latent converters.
        ``conditioning_latents``: an explicit (ar_latent, diff_latent)
        pair in place of ``references``."""
        _refuse_unported(vocoder_type, diffusion_sampler, beam_width)
        seed = int(time.time()) if seed is None else seed
        ar_latent, diff_latent = self._latents(references, seed,
                                               conditioning_latents)
        sampling = _sampling_from_knobs(
            ar_temp=ar_temp, top_k=top_k, top_p=top_p,
            typical_sampling=typical_sampling, typical_mass=typical_mass,
            repetition_penalty=repetition_penalty,
            length_penalty_factor=length_penalty_factor, greedy=greedy,
            mirostat_tau=mirostat_tau, mirostat_eta=mirostat_eta,
            min_temperature=min_temperature)
        wavs = []
        for i, line in enumerate(text.split("\n")):
            if not line.strip():
                continue
            (sub,) = _host_keys(seed * 1000003 + i, 1)
            if vocoder_type == "hifigan":
                wavs.append(np.concatenate(list(self._stream_line_windowed(
                    line, ar_latent, sampling, max_ar_steps, sub)), axis=-1))
            else:
                wavs.append(self._infer_line(
                    line, ar_latent, diff_latent, sampling, max_ar_steps,
                    max_diffusion_steps, diffusion_temp, diffusion_sampler,
                    cond_free, sub, diffusion_pad_multiple,
                    mel_pad_multiple, candidates))
        wav = np.concatenate(wavs, axis=-1)
        if out_path is not None:
            write_wav(out_path, wav, SAMPLE_RATE)
        return wav, SAMPLE_RATE

    @torch.inference_mode()
    def batch_inference(self, texts: Sequence[str],
                        references: Optional[str | Sequence] = None,
                        voices: Optional[Sequence] = None,
                        max_ar_steps: int = 500,
                        max_diffusion_steps: int = 80, ar_temp: float = 0.8,
                        diffusion_temp: float = 1.0, top_p: float = 1.0,
                        top_k: int = 0, repetition_penalty: float = 1.0,
                        length_penalty_factor: float = 0.0,
                        beam_width: int = 1, typical_sampling: bool = False,
                        typical_mass: float = 0.9,
                        mirostat_tau: float = 0.0, mirostat_eta: float = 0.1,
                        min_temperature: float = 0.0, greedy: bool = False,
                        candidates: int = 1,
                        diffusion_sampler: str = "ddim",
                        cond_free: bool = True,
                        vocoder_type: str = "bigvgan",
                        seed: Optional[int] = None,
                        seeds: Optional[Sequence[int]] = None,
                        diffusion_pad_multiple: int = 32,
                        mel_pad_multiple: int = 0, mesh=None,
                        row_buckets: bool = True, fetch: str = "sync"):
        """Many single-line texts at once -> (list of float32 wavs, 24000),
        each stage running over the whole batch.

        Row r draws everything (decode tokens, candidates, diffusion noise)
        from its own seed, ``seeds[r]`` (default ``seed + r``), so it
        replays as ``inference(texts[r], seed=seeds[r])`` with the same
        voice and knobs (exactly when its diffusion runs at the same T:
        always with ``row_buckets=False``).  ``references`` is one voice
        for every row; ``voices`` one per row (None entries voiceless);
        neither: every row voiceless from its own seed.  ``candidates`` > 1
        decodes that many candidates per row from the row's shared prefill
        and keeps the CLVP's best.

        ``row_buckets``: read the rows' trim points once and run the
        diffusion and the vocoder per length bucket (``_row_buckets``), at
        most 8 rows per dispatch, the rows padded to a power of two;
        otherwise one dispatch sized by the decode budget.  ``fetch=
        "async"`` returns ``(finalize, 24000)``, where ``finalize()``
        copies the wavs to the host.  The serving mesh and beam search are
        not ported yet (ROADMAP.md)."""
        if mesh is not None:
            raise NotImplementedError(
                "batch_inference(mesh=...): the serving mesh is not ported "
                "yet (ROADMAP.md)")
        if vocoder_type != "bigvgan":
            raise NotImplementedError(
                f"batch_inference(vocoder_type={vocoder_type!r}) is not "
                "ported yet (ROADMAP.md); use 'bigvgan'")
        _refuse_unported(vocoder_type, diffusion_sampler, beam_width)
        if fetch not in ("sync", "async"):
            raise ValueError(f"fetch must be sync|async, got {fetch!r}")
        b = len(texts)
        if any("\n" in t.strip() for t in texts):
            # inference() keys each line separately: a row must be one
            # line for the per-row replay to hold
            raise ValueError("batch_inference rows are single utterances; "
                             "split multi-line texts into rows")
        if seeds is not None and len(seeds) != b:
            raise ValueError(f"seeds has {len(seeds)} entries for {b} texts")
        seed = int(time.time()) if seed is None else seed
        row_seeds = ([int(s) for s in seeds] if seeds is not None
                     else [seed + r for r in range(b)])
        ar = self._model("autoregressive")
        dmodel = self._model("diffusion")
        voc = self._model("bigvgan")
        dev = self.device
        lat, diff_cond = self._encode_voice_rows(references, voices, b,
                                                 row_seeds)
        c = max(1, candidates)
        toks = [self.encode_text(t) for t in texts]
        bucket = self._bucket_text(max(toks, key=len)).shape[-1]
        tokens = torch.as_tensor(np.stack(
            [np.pad(t[:bucket], (0, bucket - len(t[:bucket]))) for t in toks]),
            device=dev)
        lengths = torch.tensor([min(len(t), bucket) for t in toks],
                               device=dev)
        sampling = _sampling_from_knobs(
            ar_temp=ar_temp, top_k=top_k, top_p=top_p,
            typical_sampling=typical_sampling, typical_mass=typical_mass,
            repetition_penalty=repetition_penalty,
            length_penalty_factor=length_penalty_factor, greedy=greedy,
            mirostat_tau=mirostat_tau, mirostat_eta=mirostat_eta,
            min_temperature=min_temperature)
        # row r's (k_ar, k_diff, k_voc) are the single call's for its seed;
        # candidate c of row r draws from child c of its k_ar
        trips = [_stage_keys(s) for s in row_seeds]
        gens = [_generator(k, dev) for t in trips for k in _row_keys(t[0], c)]
        diff_keys = [t[1] for t in trips]

        if c > 1:
            res = inference_speech_shared(
                ar.params, lat, tokens, lengths, gens, c, ar.config,
                sampling, max_ar_steps, qgpt=self._ar_qgpt(),
                quant_mode=self._quant_mode)
            cm = self._model("clvp")
            fan = lambda x: x.repeat_interleave(c, dim=0)  # noqa: E731
            latents, t_lat, _ = _rerank_latents(
                ar.params, cm.params, fan(lat), fan(tokens), fan(lengths),
                res.codes, res.lengths, ar.config, cm.config, ncand=c)
        else:
            res = inference_speech(ar.params, lat, tokens, lengths, gens,
                                   ar.config, sampling, max_ar_steps,
                                   qgpt=self._ar_qgpt(),
                                   quant_mode=self._quant_mode)
            latents, t_lat = _cleanup_latents(
                ar.params, lat, tokens, lengths, res.codes, res.lengths,
                ar.config)

        def run(rows, n_lat, seq_len, pad_seq_len, uh):
            idx = torch.as_tensor(rows, device=dev)
            dc = diff_cond if diff_cond.shape[0] == 1 else diff_cond[idx]
            mel = _diffusion(self._denoiser_params(), latents[idx], dc,
                             [diff_keys[r] for r in rows], dmodel.config,
                             max_diffusion_steps, diffusion_sampler, seq_len,
                             cond_free, diffusion_temp, n_lat, t_lat[idx],
                             pad_seq_len, uh,
                             attention=self.cfg.inference.denoise_attention)
            return _vocode(voc.params, mel, voc.config)

        if row_buckets:
            t_np = t_lat.cpu().numpy()        # the one read mid-pipeline
            pending = []
            for n_lat, rows in _row_buckets(t_np, max(diffusion_pad_multiple,
                                                      1), mel_pad_multiple):
                k = len(rows)
                rows_p = np.concatenate(
                    [rows, np.repeat(rows[:1], (1 << (k - 1).bit_length())
                                     - k)])
                # n_lat is already a rung: no further rounding
                geo = self._diffusion_geometry(n_lat, 0, mel_pad_multiple,
                                               max_diffusion_steps, cond_free)
                pending.append((rows, run(rows_p, *geo)))
        else:
            geo = self._diffusion_geometry(
                self._decode_budget_latents(max_ar_steps, res.lengths),
                diffusion_pad_multiple, mel_pad_multiple,
                max_diffusion_steps, cond_free)
            t_np = None
            pending = [(np.arange(b), run(np.arange(b), *geo))]

        def finalize() -> List[np.ndarray]:
            tl = t_lat.cpu().numpy() if t_np is None else t_np
            out = [None] * b
            for rows, pcm in pending:
                pcm = pcm[:len(rows), 0].cpu().numpy()
                for j, r in enumerate(rows):
                    n = int(tl[r]) * 4 * 24000 // 22050 * 256
                    out[r] = pcm[j, :n].astype(np.float32) / 32767.0
            return out

        if fetch == "async":
            return finalize, SAMPLE_RATE
        return finalize(), SAMPLE_RATE

    def _decode_codes(self, line: str, ar_latent, sampling: SamplingConfig,
                      max_ar_steps: int, line_key, candidates: int = 1):
        """Prefill and the whole sampled decode of one line, as
        ``candidates`` rows from one shared prefill when there are several
        (row c draws from the line's c-th row generator): (DecodeResult,
        bucketed tokens (R, Tt), text lengths (R,)), R = candidates."""
        ar = self._model("autoregressive")
        dev = self.device
        toks = self.encode_text(line)
        tokens = torch.as_tensor(self._bucket_text(toks)[None], device=dev)
        lengths = torch.tensor([min(len(toks), tokens.shape[1])], device=dev)
        lat = ar_latent.to(dev).reshape(1, -1)
        gens = _row_generators(line_key, candidates, dev)
        if candidates > 1:
            res = inference_speech_shared(
                ar.params, lat, tokens, lengths, gens, candidates, ar.config,
                sampling, max_ar_steps, qgpt=self._ar_qgpt(),
                quant_mode=self._quant_mode)
            return (res, tokens.expand(candidates, -1),
                    lengths.expand(candidates))
        res = inference_speech(ar.params, lat, tokens, lengths, gens,
                               ar.config, sampling, max_ar_steps,
                               qgpt=self._ar_qgpt(),
                               quant_mode=self._quant_mode)
        return res, tokens, lengths

    @torch.inference_mode()
    def _infer_line(self, line, ar_latent, diff_latent, sampling,
                    max_ar_steps, max_diffusion_steps, diffusion_temp,
                    diffusion_sampler, cond_free, key,
                    diffusion_pad_multiple, mel_pad_multiple,
                    candidates: int = 1) -> np.ndarray:
        """The BigVGAN route for one line.  The device is read twice: the
        trim point and the wav at the end (and the decoded lengths when
        the budget is over ``STATIC_BUDGET_MAX``)."""
        ar = self._model("autoregressive")
        dmodel = self._model("diffusion")
        # the (k_ar, k_diff, k_voc) keys of the JAX package's _stage_keys
        k_diff = _host_keys(_key_int(key), 3)[1]
        res, tokens, text_lengths = self._decode_codes(
            line, ar_latent, sampling, max_ar_steps, key, candidates)
        lat = ar_latent.to(self.device).reshape(1, -1)
        if candidates > 1:
            cm = self._model("clvp")
            latents, t_lat, _ = _rerank_latents(
                ar.params, cm.params, lat.expand(candidates, -1), tokens,
                text_lengths, res.codes, res.lengths, ar.config, cm.config)
        else:
            latents, t_lat = _cleanup_latents(
                ar.params, lat, tokens, text_lengths, res.codes, res.lengths,
                ar.config)
        # a static decode budget already fixes the shape, so the latent
        # count is not rounded up when the mel length is padded anyway
        dpm = (0 if (max_ar_steps <= STATIC_BUDGET_MAX
                     and mel_pad_multiple > 1) else diffusion_pad_multiple)
        n_lat, seq_len, pad_seq_len, uh = self._diffusion_geometry(
            self._decode_budget_latents(max_ar_steps, res.lengths), dpm,
            mel_pad_multiple, max_diffusion_steps, cond_free)
        mel = _diffusion(self._denoiser_params(), latents, diff_latent,
                         [k_diff], dmodel.config, max_diffusion_steps,
                         diffusion_sampler, seq_len, cond_free,
                         diffusion_temp, n_lat, t_lat, pad_seq_len, uh,
                         attention=self.cfg.inference.denoise_attention)
        voc = self._model("bigvgan")
        pcm = _vocode(voc.params, mel, voc.config)
        exact_seq_len = int(t_lat[0]) * 4 * 24000 // 22050
        pcm = pcm[0, 0, :exact_seq_len * 256].cpu().numpy()
        return pcm.astype(np.float32) / 32767.0

    @staticmethod
    def _latents_to_samples(n: int) -> int:
        """HiFiGAN sample count for n latents (n -> int(4n) ->
        int(*24000/22050) -> *256)."""
        t1 = int(n * 1024 / 256)
        t2 = int(t1 * 24000 / 22050)
        return t2 * 256

    def stream(self, text: str,
               references: Optional[str | Sequence[str | Path]] = None,
               max_ar_steps: int = 500, ar_temp: float = 0.8,
               top_p: float = 1.0, top_k: int = 0,
               repetition_penalty: float = 1.0,
               length_penalty_factor: float = 0.0,
               typical_sampling: bool = False, typical_mass: float = 0.9,
               mirostat_tau: float = 0.0, mirostat_eta: float = 0.1,
               min_temperature: float = 0.0, greedy: bool = False,
               seed: Optional[int] = None, mode: str = "windowed",
               stream_chunk_size: int = 40,
               first_buffer: int = 60) -> Iterator[np.ndarray]:
        """Yield 24 kHz float32 chunks as the decode advances: each chunk
        vocodes a fixed ``first_buffer``-latent window ending at the
        decode position."""
        if mode != "windowed":
            raise NotImplementedError(
                f"stream mode {mode!r}: only 'windowed' is ported")
        seed = int(time.time()) if seed is None else seed
        ar_latent = self._latents(references, seed)[0]
        sampling = _sampling_from_knobs(
            ar_temp=ar_temp, top_k=top_k, top_p=top_p,
            typical_sampling=typical_sampling, typical_mass=typical_mass,
            repetition_penalty=repetition_penalty,
            length_penalty_factor=length_penalty_factor, greedy=greedy,
            mirostat_tau=mirostat_tau, mirostat_eta=mirostat_eta,
            min_temperature=min_temperature)
        for i, line in enumerate(text.split("\n")):
            if not line.strip():
                continue
            (sub,) = _host_keys(seed * 1000003 + i, 1)
            yield from self._stream_line_windowed(
                line, ar_latent, sampling, max_ar_steps, sub,
                stream_chunk_size=stream_chunk_size, window=first_buffer)

    @torch.inference_mode()
    def _stream_line_windowed(self, line, ar_latent, sampling, max_ar_steps,
                              key, stream_chunk_size: int = 40,
                              window: int = 60, overlap_wav_len: int = 1024
                              ) -> Iterator[np.ndarray]:
        """Decode in chunks against one persistent KV cache; after each
        chunk vocode the trailing ``window`` latents (left context warms
        the vocoder) and emit the new samples with a linear crossfade at
        each seam."""
        ar = self._model("autoregressive")
        voc = self._model("hifigan")
        dev = self.device
        toks = self.encode_text(line)
        tokens = torch.as_tensor(self._bucket_text(toks)[None], device=dev)
        lengths = torch.tensor([min(len(toks), tokens.shape[1])], device=dev)
        lat = ar_latent.to(dev).reshape(1, -1)
        g = lat.float()
        state = decode_start(ar.params, lat, tokens, lengths,
                             _row_generators(key, 1, dev), ar.config,
                             max_ar_steps)
        emitted = 0          # latents already emitted as audio
        wav_overlap = None
        first = True
        while True:
            chunk = window if first else stream_chunk_size
            first = False
            state = decode_chunk(ar.params, state, ar.config, sampling,
                                 chunk=chunk, collect_latents=True,
                                 qgpt=self._ar_qgpt(),
                                 quant_mode=self._quant_mode)
            pos = state.step
            n = int(state.lengths[0])
            done = bool(state.finished.all()) or pos >= max_ar_steps
            upto = min(pos, n) if done else pos
            if upto <= emitted:
                if done:
                    break
                continue
            # fixed window ending at `upto`, left-padded by repeating the
            # first latent while the prefix is short
            start = max(0, upto - window)
            idx = torch.arange(upto - window, upto, device=dev).clamp(min=0)
            win_lat = state.latents[0, idx][None].float()
            wav_win = hifigan.inference(voc.params, win_lat, g, voc.config)
            wav_win = wav_win[0, 0].float().cpu().numpy()
            new_samples = (self._latents_to_samples(upto - start)
                           - self._latents_to_samples(emitted - start))
            take = min(new_samples + overlap_wav_len, wav_win.shape[-1])
            piece = np.array(wav_win[-take:])
            if wav_overlap is not None and piece.shape[0] > overlap_wav_len:
                ramp = np.linspace(0.0, 1.0, overlap_wav_len,
                                   dtype=np.float32)
                piece[:overlap_wav_len] = (wav_overlap * ramp[::-1]
                                           + piece[:overlap_wav_len] * ramp)
            wav_overlap = (piece[-overlap_wav_len:].copy()
                           if piece.shape[0] >= overlap_wav_len else None)
            yield piece[:-overlap_wav_len] if not done else piece
            emitted = upto
            if done:
                break
