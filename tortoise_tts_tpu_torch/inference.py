"""TTS inference API (port of ``tortoise_tts_tpu/inference.py``: the
default BigVGAN route and the HiFiGAN streaming route).

Per line of text, ``TTS.inference`` (``vocoder_type="bigvgan"``, the
default): tokenize -> bucket -> UnifiedVoice prefill and sampled decode
-> stop-token cleanup and calm trim -> latent pass -> DDIM (or P)
sampling of the denoiser with cond-free guidance -> denormalize ->
BigVGAN -> 16-bit PCM, trimmed to the calm-trim length.  With
``vocoder_type="hifigan"``, and in ``TTS.stream``: decode in chunks
collecting latents -> HiFiGAN over a trailing 60-latent window per
chunk, crossfaded at the seams.  UnivNet, candidates with the CLVP
rerank, beam search, DPM++ and voiceless generation are not ported yet
(ROADMAP.md).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
Sampled decoding draws from one ``torch.Generator`` per row, and the
diffusion noise from one more, all seeded from ``seed`` through the JAX
package's SeedSequence chain, so one seed gives one wav per route; the
JAX package draws from threefry keys, so the two agree in distribution
only (greedy decoding agrees token for token, and the tests inject the
JAX package's diffusion noise through ``_diffusion_noise``).
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
from .models import bigvgan, diffusion, gaussian, hifigan, load_model
from .models import resolve_device
from .models.unified_voice import (decode_chunk, decode_start,
                                   forward as uv_forward, inference_speech,
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


def _row_generators(line_key, n: int, device) -> List[torch.Generator]:
    """Per-row decode generators for one line, from its key: the AR stage
    key, then one child per row (the JAX package's k_ar / _row_keys)."""
    k_ar = _host_keys(_key_int(line_key), 3)[0]
    return [_generator(k, device) for k in _host_keys(_key_int(k_ar), n)]


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


def _diffusion_noise(key, shape, device) -> torch.Tensor:
    """The sampler's starting noise x_T, standard normal, from ``key``."""
    return torch.randn(shape, generator=_generator(key, device),
                       device=device)


def _uncond_integrate(dparams, dcfg, steps: int, T: int) -> torch.Tensor:
    """Per-step integrator outputs of the unconditional guidance branch,
    (S, 1, C, T): a function of the weights, T and the schedule's
    timesteps only, so ``TTS`` caches it and each step runs the integrator
    for the conditional row alone."""
    sched = gaussian.get_schedule(steps=steps)
    pdt = dparams["inp_block"]["w"].dtype
    dev = dparams["inp_block"]["w"].device
    rel = diffusion.precompute_rel_biases(dparams, T, dcfg, pdt)
    uncond = diffusion.unconditioned_embedding(dparams, 1, T).to(pdt)
    temb = diffusion.embed_time(
        dparams, torch.as_tensor(sched.timestep_map, device=dev), dcfg, pdt)
    return torch.stack([
        diffusion.integrate_conditioning(dparams, uncond, temb[i:i + 1],
                                         dcfg, rel)
        for i in range(temb.shape[0])])


def _diffusion(dparams, latents, diff_cond, key, dcfg, steps: int,
               sampler: str, seq_len: int, cond_free: bool,
               diffusion_temp: float, n_lat: int, t_lat,
               pad_seq_len: Optional[int], uncond_h) -> torch.Tensor:
    """Latents -> denormalized mel (B, 100, T) (the JAX package's
    ``_jit_diffusion``).  ``latents`` is the latent pass's whole buffer:
    each row takes its first ``t_lat`` latents, edge-padded to ``n_lat``.
    The code embedding is made at ``seq_len`` and edge-padded to
    ``pad_seq_len``; with ``cond_free``, ``uncond_h`` is the cached
    unconditional integrator (``_uncond_integrate``)."""
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
    rel = diffusion.precompute_rel_biases(dparams, T, dcfg, pdt)
    if cond_free:
        uh = uncond_h.to(pdt)

        def model_fn(x, ts, t_idx):
            te = diffusion.embed_time(dparams, ts, dcfg, pdt)
            h_c = diffusion.integrate_conditioning(dparams, code_emb, te[:b],
                                                   dcfg, rel)
            h = torch.cat([h_c, uh[t_idx].expand_as(h_c)])
            return diffusion.forward_trunk(dparams, x.to(pdt), te, h, dcfg,
                                           rel)
    else:
        def model_fn(x, ts, t_idx):
            return diffusion.forward(dparams, x.to(pdt), ts, code_emb, dcfg,
                                     rel)

    k_noise, k_samp = _host_keys(_key_int(key), 2)
    noise = _diffusion_noise(k_noise, (b, dcfg.in_channels, T), dev) \
        * diffusion_temp
    mel = gaussian.sample_loop(model_fn, noise, _generator(k_samp, dev),
                               sched, sampler=sampler)
    return denormalize_tacotron_mel(mel)


def _vocode(params, mel: torch.Tensor, cfg) -> torch.Tensor:
    """BigVGAN at the weights' type, then 16-bit PCM on the device, as the
    JAX package delivers it: clip(w * 32767) -> int16."""
    pdt = params["conv_pre"]["w"].dtype
    wav = bigvgan.inference(params, mel.to(pdt), cfg).float()
    return torch.clamp(wav * 32767.0, -32768.0, 32767.0).to(torch.int16)


class TTS:
    """User-facing inference API."""

    def __init__(self, config: Optional[Config | str | Path] = None,
                 device=None, dtype: Optional[str] = None):
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

    def _model(self, name: str):
        if name not in self._models:
            self._models[name] = load_model(name, self.dtype,
                                            device=self.device)
        return self._models[name]

    def _ar_qgpt(self):
        """Cached int8 decode weights when decode_quant='int8'."""
        if self.cfg.inference.decode_quant != "int8":
            return None
        if self._qgpt is None:
            self._qgpt = quantize_decode_weights(
                self._model("autoregressive").params)
        return self._qgpt

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
        """(AR latent, diffusion latent) on the device."""
        if conditioning_latents is not None:
            return tuple(torch.as_tensor(np.asarray(c), device=self.device)
                         for c in conditioning_latents)
        if references is None:
            raise NotImplementedError(
                "voiceless generation (random latent converters) is not "
                "ported yet: pass references (ROADMAP.md)")
        return self.encode_audio(references, seed=seed)["latent"]

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
        """The cached unconditional integrator for (steps, T), at most
        four shapes (about 90 MB each at the shipped widths in bf16)."""
        key = (steps, T)
        if key not in self._uncond_cache:
            if len(self._uncond_cache) >= 4:
                self._uncond_cache.pop(next(iter(self._uncond_cache)))
            d = self._model("diffusion")
            self._uncond_cache[key] = _uncond_integrate(
                d.params, d.config, steps, T)
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
                  conditioning_latents: Optional[Tuple] = None
                  ) -> Tuple[np.ndarray, int]:
        """Text -> (wav float32 (T,), 24000).  The default route decodes,
        runs the diffusion and BigVGAN; ``vocoder_type="hifigan"`` runs
        the windowed HiFiGAN route of ``stream``.
        ``conditioning_latents``: an explicit (ar_latent, diff_latent)
        pair in place of ``references``."""
        if vocoder_type not in ("bigvgan", "hifigan"):
            raise NotImplementedError(
                f"vocoder_type={vocoder_type!r} (UnivNet) is not ported "
                "yet (ROADMAP.md); use 'bigvgan' or 'hifigan'")
        if candidates > 1:
            raise NotImplementedError(
                "candidates > 1 (CLVP rerank) is not ported yet "
                "(ROADMAP.md, slice 3)")
        if diffusion_sampler == "dpm++":
            raise NotImplementedError(
                "diffusion_sampler='dpm++' is not ported yet (ROADMAP.md)")
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
                    mel_pad_multiple))
        wav = np.concatenate(wavs, axis=-1)
        if out_path is not None:
            write_wav(out_path, wav, SAMPLE_RATE)
        return wav, SAMPLE_RATE

    def _decode_codes(self, line: str, ar_latent, sampling: SamplingConfig,
                      max_ar_steps: int, line_key):
        """Prefill and the whole sampled decode of one line at B=1:
        (DecodeResult, bucketed tokens (1, Tt), text lengths (1,))."""
        ar = self._model("autoregressive")
        dev = self.device
        toks = self.encode_text(line)
        tokens = torch.as_tensor(self._bucket_text(toks)[None], device=dev)
        lengths = torch.tensor([min(len(toks), tokens.shape[1])], device=dev)
        res = inference_speech(
            ar.params, ar_latent.to(dev).reshape(1, -1), tokens, lengths,
            _row_generators(line_key, 1, dev), ar.config, sampling,
            max_ar_steps, qgpt=self._ar_qgpt())
        return res, tokens, lengths

    @torch.inference_mode()
    def _infer_line(self, line, ar_latent, diff_latent, sampling,
                    max_ar_steps, max_diffusion_steps, diffusion_temp,
                    diffusion_sampler, cond_free, key,
                    diffusion_pad_multiple, mel_pad_multiple) -> np.ndarray:
        """The BigVGAN route for one line.  The device is read twice: the
        trim point and the wav at the end (and the decoded lengths when
        the budget is over ``STATIC_BUDGET_MAX``)."""
        ar = self._model("autoregressive")
        dmodel = self._model("diffusion")
        # the (k_ar, k_diff, k_voc) keys of the JAX package's _stage_keys
        k_diff = _host_keys(_key_int(key), 3)[1]
        res, tokens, text_lengths = self._decode_codes(
            line, ar_latent, sampling, max_ar_steps, key)
        latents, t_lat = _cleanup_latents(
            ar.params, ar_latent.to(self.device).reshape(1, -1), tokens,
            text_lengths, res.codes, res.lengths, ar.config)
        # a static decode budget already fixes the shape, so the latent
        # count is not rounded up when the mel length is padded anyway
        dpm = (0 if (max_ar_steps <= STATIC_BUDGET_MAX
                     and mel_pad_multiple > 1) else diffusion_pad_multiple)
        n_lat, seq_len, pad_seq_len, uh = self._diffusion_geometry(
            self._decode_budget_latents(max_ar_steps, res.lengths), dpm,
            mel_pad_multiple, max_diffusion_steps, cond_free)
        mel = _diffusion(dmodel.params, latents, diff_latent, k_diff,
                         dmodel.config, max_diffusion_steps,
                         diffusion_sampler, seq_len, cond_free,
                         diffusion_temp, n_lat, t_lat, pad_seq_len, uh)
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
                                 qgpt=self._ar_qgpt())
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
