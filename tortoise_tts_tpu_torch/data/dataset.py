"""Dataset over .mel artifacts (port of ``tortoise_tts_tpu/data/dataset.py``,
a copy: the same paths, order and fixed-shape batches, bit for bit).

Reads the reference's artifact format (emb/process.py:43-74: np.save'd
dict with uint16 codes, float32 cond/latent tuples, uint8 text tokens,
metadata) from ``<data_dir>/<group>/<speaker>/<utt>.mel`` trees, with:

- per-speaker metadata JSONs + disk cache (data.py:347-412),
- speaker pruning by minimum utterances (data.py:487-489),
- host-sharded paths ``i % process_count`` (data.py:496-497 rank shard),
- duration-bucketed / random / ordered sampling with resumable state
  (data.py:499-661),
- **fixed-shape batches** for jit: text padded to ``text_bucket`` with
  stop(0), codes to ``mel_bucket`` (TPU design delta — the reference
  pads dynamically per batch, SURVEY §7 'fixed shapes under jit').

The native melbin loader (``use_melbin``) is not ported: it raises
(ROADMAP.md).  The HDF5 path needs ``h5py``, imported when used.
"""

from __future__ import annotations

import copy
import json
import logging
import pickle
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import Config
from .sampler import BatchedOrderedSampler, OrderedSampler, RandomSampler

_logger = logging.getLogger(__name__)


def load_artifact(path: str | Path) -> Dict[str, Any]:
    return np.load(path, allow_pickle=True)[()]


def _interleaved_reorder(items, key):
    """Round-robin across key groups (reference _interleaved_reorder,
    utils/utils.py — one item per speaker in turn)."""
    groups: Dict[Any, list] = {}
    for it in items:
        groups.setdefault(key(it), []).append(it)
    out = []
    i = 0
    while True:
        added = False
        for g in groups.values():
            if i < len(g):
                out.append(g[i])
                added = True
        if not added:
            return out
        i += 1


class Dataset:
    def __init__(self, cfg: Config, paths: Sequence[str | Path],
                 training: bool = True,
                 process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.dcfg = cfg.dataset
        self.training = training
        self.paths: List[Path] = []
        self.durations: List[float] = []
        self._h5 = None
        if self.dcfg.use_melbin:
            raise NotImplementedError(
                "dataset.use_melbin: the native melbin loader is not ported "
                "yet (ROADMAP.md); set use_melbin: false")
        if self.dcfg.use_hdf5:
            import h5py
            h5_path = cfg.rel_path / self.dcfg.hdf5_name
            self._h5 = h5py.File(h5_path, "r")

        all_paths = (self._gather_h5() if self._h5 is not None
                     else self._gather(paths))
        metadata = self._load_metadata(all_paths)

        # speaker pruning by minimum utterances (data.py:487-489)
        if training and self.dcfg.min_utterances > 1:
            per_speaker: Dict[str, int] = {}
            for p in all_paths:
                per_speaker[self._speaker_of(p)] = \
                    per_speaker.get(self._speaker_of(p), 0) + 1
            pruned = [s for s, n in per_speaker.items()
                      if n < self.dcfg.min_utterances]
            if pruned:
                _logger.info("pruning %d speakers with <%d utterances",
                             len(pruned), self.dcfg.min_utterances)
                all_paths = [p for p in all_paths
                             if self._speaker_of(p) not in set(pruned)]

        # host shard (data.py:496-497)
        if training and process_count > 1:
            all_paths = [p for i, p in enumerate(all_paths)
                         if i % process_count == process_index]

        # duration validation (data.py duration_range)
        lo, hi = self.dcfg.duration_range
        for p in all_paths:
            dur = metadata.get(str(p), {}).get("duration", 0.0)
            if self.dcfg.validate and training and not (lo <= dur <= hi):
                continue
            self.paths.append(p)
            self.durations.append(dur)

        order = self.dcfg.sample_order
        if training and order == "duration":
            # duration buckets, sorted within, interleaved by speaker
            # across the bucket (data.py:499-530)
            buckets: Dict[int, list] = {}
            for p, d in zip(self.paths, self.durations):
                buckets.setdefault(int(round(d)), []).append((p, d))
            pairs = []
            for b in sorted(buckets):
                items = sorted(buckets[b], key=lambda x: x[1])
                pairs.extend(_interleaved_reorder(
                    items, lambda x: self._speaker_of(x[0])))
            self.paths = [p for p, _ in pairs]
            self.durations = [d for _, d in pairs]
        elif training and order == "interleaved":
            # plain speaker interleave (data.py:533-535)
            pairs = _interleaved_reorder(
                list(zip(self.paths, self.durations)),
                lambda x: self._speaker_of(x[0]))
            self.paths = [p for p, _ in pairs]
            self.durations = [d for _, d in pairs]

        # per-utterance similar lists for prompt sampling
        # (data.py:738-763 get_similar_utterance)
        self._similar = {str(p): metadata.get(str(p), {}).get("similar", [])
                         for p in self.paths}
        self._by_key = {self._utt_key(p): i
                        for i, p in enumerate(self.paths)}
        self._rng = np.random.RandomState(0)

        self.sampler = self._make_sampler()

    def _speaker_of(self, p) -> str:
        return str(Path(str(p)).parent)

    def _utt_key(self, p) -> str:
        q = Path(str(p))
        return f"{q.parent.name}/{q.stem}"

    def _gather(self, roots) -> List[Path]:
        out = []
        self._roots = [Path(r) for r in roots]
        for root in self._roots:
            if root.is_dir():
                out.extend(sorted(root.rglob("*.mel")))
            elif root.exists():
                out.append(root)
        return out

    def _metadata_json_for(self, p: Path) -> Optional[Path]:
        """Per-speaker metadata JSON written by --action=metadata
        (reference data.py:347-412 reads cfg.metadata_dir JSONs)."""
        for root in getattr(self, "_roots", []):
            try:
                rel = Path(str(p)).parent.relative_to(root)
            except ValueError:
                continue
            cand = self.cfg.metadata_dir / rel / "metadata.json"
            if cand.exists():
                return cand
        return None

    def _gather_h5(self) -> List[str]:
        keys: List[str] = []

        def visit(name, obj):
            if hasattr(obj, "keys") and "codes" in obj:
                keys.append(name)
        self._h5.visititems(visit)
        return sorted(keys)

    def _load(self, path) -> Dict[str, Any]:
        if self._h5 is not None:
            g = self._h5[str(path)]
            meta = json.loads(g.attrs.get("metadata", "{}"))
            out = {
                "codes": np.asarray(g["codes"]),
                "text": np.asarray(g["text"]) if "text" in g else
                np.zeros((0,), np.int32),
                "latent": (np.asarray(g["latent_ar"]),
                           np.asarray(g["latent_diff"])),
                "metadata": meta,
            }
            for mk in ("mel", "mel_diff"):
                if mk in g:
                    out[mk] = np.asarray(g[mk])
            return out
        return load_artifact(path)

    def _load_metadata(self, paths) -> Dict[str, dict]:
        """Durations per path, with a pickle disk cache
        (data.py:347-412)."""
        cache = self.cfg.cache_dir / ("metadata.train.pkl" if self.training
                                      else "metadata.val.pkl")
        if self.dcfg.cache and cache.exists():
            try:
                meta = pickle.loads(cache.read_bytes())
                if set(meta) >= {str(p) for p in paths}:
                    return meta
            except Exception:
                pass
        meta = {}
        json_cache: Dict[str, Optional[dict]] = {}
        for p in paths:
            # prefer the per-speaker metadata JSON (duration + similar
            # lists) over opening every artifact (data.py:347-412)
            mj = self._metadata_json_for(p) if self.dcfg.use_metadata \
                else None
            if mj is not None:
                key = str(mj)
                if key not in json_cache:
                    try:
                        json_cache[key] = json.loads(mj.read_text())
                    except Exception:
                        json_cache[key] = None
                entries = json_cache[key]
                stem = Path(str(p)).stem
                if entries and stem in entries:
                    e = entries[stem]
                    meta[str(p)] = {
                        "duration": float(e.get("duration", 0.0)),
                        "similar": e.get("similar", []),
                    }
                    continue
            try:
                art = self._load(p)
                md = art.get("metadata", {})
                dur = md.get("duration")
                if dur is None and "original_length" in md:
                    dur = md["original_length"] / md.get("sample_rate", 1)
                meta[str(p)] = {"duration": float(dur or 0.0),
                                "similar": md.get("similar", [])}
            except Exception as e:
                _logger.warning("bad artifact %s: %s", p, e)
                meta[str(p)] = {"duration": 0.0}
        if self.dcfg.cache:
            cache.parent.mkdir(parents=True, exist_ok=True)
            cache.write_bytes(pickle.dumps(meta))
        return meta

    def _make_sampler(self):
        if self.training and self.dcfg.sample_max_duration_batch > 0:
            return BatchedOrderedSampler(
                self.durations,
                max_duration=self.dcfg.sample_max_duration_batch,
                max_batch_size=self.cfg.hyperparameters.batch_size,
                shuffle=self.dcfg.sample_shuffle)
        if self.training and self.dcfg.sample_shuffle:
            return RandomSampler(len(self.paths))
        return OrderedSampler(len(self.paths))

    # ------------------------------------------------------------------
    def __len__(self):
        return len(self.paths)

    def get_similar_utterance(self, i: int) -> Optional[int]:
        """Index of a similar utterance of the same speaker, if the
        metadata has one (reference data.py:738-763)."""
        sims = self._similar.get(str(self.paths[i])) or []
        spk = Path(str(self.paths[i])).parent.name
        for stem in sims:
            j = self._by_key.get(f"{spk}/{stem}")
            if j is not None and j != i:
                return j
        return None

    def __getitem__(self, i: int) -> Dict[str, Any]:
        """One sample -> fixed-shape arrays (data.py:766-853)."""
        art = self._load(self.paths[i])
        codes = np.asarray(art["codes"]).reshape(-1).astype(np.int32)
        text = np.asarray(art["text"]).reshape(-1).astype(np.int32)
        lat_ar = np.asarray(art["latent"][0]).reshape(-1).astype(np.float32)
        lat_diff = np.asarray(art["latent"][1]).reshape(-1).astype(np.float32)
        wav_length = int(art["metadata"]["original_length"])

        # conditioning prompt from a *similar* utterance with probability
        # prompt_similar_p (reference data.py:738-763 + __getitem__ use)
        if (self.training and self.dcfg.prompt_similar_p > 0
                and self._rng.rand() < self.dcfg.prompt_similar_p):
            j = self.get_similar_utterance(i)
            if j is not None:
                sim = self._load(self.paths[j])
                lat_ar = np.asarray(
                    sim["latent"][0]).reshape(-1).astype(np.float32)
                lat_diff = np.asarray(
                    sim["latent"][1]).reshape(-1).astype(np.float32)

        tb, mb = self.dcfg.text_bucket, self.dcfg.mel_bucket
        text_len = min(len(text), tb)
        ncodes = min(len(codes), mb)
        out_text = np.zeros((tb,), np.int32)         # stop(0) padding
        out_text[:text_len] = text[:text_len]
        out_codes = np.zeros((mb,), np.int32)
        out_codes[:ncodes] = codes[:ncodes]
        wav_length = min(wav_length, ncodes * 1024)
        out = {
            "text": out_text,
            "text_lengths": np.int32(text_len),
            "codes": out_codes,
            "wav_lengths": np.int32(wav_length),
            "latents": lat_ar,
            "diffusion_latents": lat_diff,
        }
        if self.dcfg.load_mels and "mel" in art:
            mel = np.asarray(art["mel"], np.float32)
            mel = mel[0] if mel.ndim == 3 else mel
            mf = self.mel_frames
            n1 = min(mel.shape[-1], mf)
            m = np.zeros((mel.shape[0], mf), np.float32)
            m[:, :n1] = mel[:, :n1]
            out["mel"] = m
            out["mel_lengths"] = np.int32(n1)
        # guarded independently of "mel" — artifacts/H5 groups may carry
        # either target without the other
        if self.dcfg.load_mels and "mel_diff" in art:
            md = np.asarray(art["mel_diff"], np.float32)
            md = md[0] if md.ndim == 3 else md
            df = self.diff_frames
            n2 = min(md.shape[-1], df)
            d = np.zeros((md.shape[0], df), np.float32)
            d[:, :n2] = md[:, :n2]
            out["mel_diff"] = d
            out["mel_diff_lengths"] = np.int32(n2)
        return out

    @property
    def mel_frames(self) -> int:
        """Fixed 80-mel frame bucket (4 frames per DVAE code)."""
        return self.dcfg.mel_bucket * 4

    @property
    def diff_frames(self) -> int:
        """Fixed diffusion-mel frame bucket (22.05k->24k frame ratio,
        rounded up to 64)."""
        f = int(self.dcfg.mel_bucket * 4 * 24000 / 22050)
        return ((f + 63) // 64) * 64

    def collate(self, items: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    # ------------------------------------------------------------------
    def _index_batches(self, bs: int) -> Iterator[tuple]:
        """Infinite stream of (index list, the sampler's state once it is
        drawn) from the resumable sampler.

        The fill buffer carries ACROSS epochs: with bs > len(dataset)
        (or not dividing it) a per-epoch reset would discard the
        partial batch every epoch — for bs > n it yielded nothing and
        span forever.  A state is taken where the buffer is empty, so it
        resumes exactly after its batch."""
        buf = []
        while True:
            if isinstance(self.sampler, BatchedOrderedSampler):
                for b in self.sampler:
                    yield b, copy.deepcopy(self.sampler.get_state())
            else:
                for i in self.sampler:
                    buf.append(i)
                    if len(buf) == bs:
                        yield buf, copy.deepcopy(self.sampler.get_state())
                        buf = []

    def batches(self, batch_size: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite epoch iterator (trainer.py:104-120).

        Batch assembly is pipelined one batch ahead of the consumer in a
        worker thread, so the next batch overlaps the train step.  The
        state ``get_state`` saves is the sampler's as of the last batch
        yielded, not of the one assembled ahead: a run resumed from it
        trains on the batches the uninterrupted run trains on next (the
        JAX package saves the sampler's live state, one batch ahead)."""
        bs = batch_size or self.cfg.hyperparameters.batch_size

        def make(item):
            idx, state = item
            return self.collate([self[i] for i in idx]), state
        import concurrent.futures as _cf
        idx_it = self._index_batches(bs)
        with _cf.ThreadPoolExecutor(max_workers=1) as pool:
            pending = pool.submit(make, next(idx_it))
            while True:
                ready, self._yielded_state = pending.result()
                pending = pool.submit(make, next(idx_it))
                yield ready

    # ------------------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        sampler_state = getattr(self, "_yielded_state", None)
        return {"sampler": (sampler_state if sampler_state is not None
                            else self.sampler.get_state()),
                "n_paths": len(self.paths)}

    def set_state(self, state: Dict[str, Any]):
        if state.get("n_paths") != len(self.paths):
            _logger.warning("dataset changed since checkpoint; "
                            "sampler state not restored")
            return
        self.sampler.set_state(state["sampler"])

    def save_state(self, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(pickle.dumps(self.get_state()))

    def load_state(self, path: Path):
        if path.exists():
            self.set_state(pickle.loads(path.read_bytes()))


def create_train_val_dataloader(cfg: Config, process_index: int = 0,
                                process_count: int = 1):
    """data.py:944 equivalent -> (train Dataset, val Dataset)."""
    train = Dataset(cfg, cfg.dataset.training, training=True,
                    process_index=process_index, process_count=process_count)
    val = Dataset(cfg, cfg.dataset.validation or cfg.dataset.training,
                  training=False)
    _logger.info("dataset: %d train, %d val samples", len(train), len(val))
    return train, val
