"""Dataset maintenance CLI (port of ``tortoise_tts_tpu/data/__main__.py``;
reference data.py:1215-1350 __main__ actions).

    python -m tortoise_tts_tpu_torch.data --yaml cfg.yaml --action=metadata
    python -m tortoise_tts_tpu_torch.data --yaml cfg.yaml --action=similar
    python -m tortoise_tts_tpu_torch.data --yaml cfg.yaml --action=validate
    python -m tortoise_tts_tpu_torch.data --yaml cfg.yaml --action=sample
    python -m tortoise_tts_tpu_torch.data --yaml cfg.yaml --action=hdf5
    python -m tortoise_tts_tpu_torch.data --yaml cfg.yaml --action=melbin

Every action but ``sample`` is host work over the .mel artifacts and
writes what the JAX package writes.  ``sample`` decodes two artifacts'
DVAE codes to mels and those to audio by Griffin-Lim, on the CUDA device
unless ``--device`` says otherwise.  ``hdf5`` needs ``h5py``.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path
from typing import List

import numpy as np

from ..config import Config
from .dataset import Dataset, load_artifact

_logger = logging.getLogger(__name__)


def _roots(cfg: Config) -> List[Path]:
    """The configured training and validation directories that exist."""
    return [Path(r) for r in cfg.dataset.training + cfg.dataset.validation
            if Path(r).is_dir()]


def create_dataset_metadata(cfg: Config) -> int:
    """Per-speaker metadata JSONs with durations and similar lists
    (data.py:1014-1086; 'similar' copied from the artifact's metadata,
    data.py:976-978)."""
    n = 0
    for root in _roots(cfg):
        speakers = {}
        for mel in sorted(root.rglob("*.mel")):
            md = load_artifact(mel).get("metadata", {})
            dur = md.get("duration") or (
                md.get("original_length", 0) / md.get("sample_rate", 1))
            entry = {"duration": float(dur or 0.0),
                     "text": md.get("text", "")}
            if "similar" in md:
                entry["similar"] = md["similar"]
            speakers.setdefault(mel.parent, {})[mel.stem] = entry
        for spk, entries in speakers.items():
            out = cfg.metadata_dir / spk.relative_to(root)
            out.mkdir(parents=True, exist_ok=True)
            (out / "metadata.json").write_text(json.dumps(entries, indent=1))
            n += len(entries)
    _logger.info("wrote metadata for %d utterances", n)
    return n


def compute_similar_utterances(cfg: Config, top_k: int = 8) -> int:
    """The top-k similar utterances of each speaker's, by the cosine
    similarity of the artifacts' AR conditioning latents, written into
    the per-speaker metadata JSONs."""
    n = 0
    for root in _roots(cfg):
        speakers = {}
        for mel in sorted(root.rglob("*.mel")):
            speakers.setdefault(mel.parent, []).append(mel)
        for spk, mels in speakers.items():
            if len(mels) < 2:
                continue
            lat = np.stack([np.asarray(load_artifact(m)["latent"][0],
                                       np.float32).reshape(-1)
                            for m in mels])
            lat = lat / (np.linalg.norm(lat, axis=1, keepdims=True) + 1e-8)
            sim = lat @ lat.T
            np.fill_diagonal(sim, -np.inf)
            order = np.argsort(-sim, axis=1)[:, :top_k]
            meta_path = cfg.metadata_dir / spk.relative_to(root) \
                / "metadata.json"
            entries = (json.loads(meta_path.read_text())
                       if meta_path.exists() else {})
            for i, m in enumerate(mels):
                entries.setdefault(m.stem, {})["similar"] = [
                    mels[j].stem for j in order[i] if np.isfinite(sim[i, j])]
                n += 1
            meta_path.parent.mkdir(parents=True, exist_ok=True)
            meta_path.write_text(json.dumps(entries, indent=1))
    _logger.info("computed similar lists for %d utterances", n)
    return n


def create_hdf5(cfg: Config) -> int:
    """Pack the artifacts into one HDF5 file (data.py:1088-1213)."""
    import h5py
    out = cfg.rel_path / cfg.dataset.hdf5_name
    n = 0
    with h5py.File(out, "a") as f:
        for root in _roots(cfg):
            for mel in sorted(root.rglob("*.mel")):
                key = str(mel.relative_to(root).with_suffix(""))
                if key in f:
                    continue
                art = load_artifact(mel)
                g = f.create_group(key)
                g.create_dataset("codes", data=np.asarray(art["codes"]))
                if "text" in art:
                    g.create_dataset("text", data=np.asarray(art["text"]))
                g.create_dataset("latent_ar",
                                 data=np.asarray(art["latent"][0]))
                g.create_dataset("latent_diff",
                                 data=np.asarray(art["latent"][1]))
                for mk in ("mel", "mel_diff"):   # training-mel targets
                    if mk in art:
                        g.create_dataset(mk, data=np.asarray(art[mk]))
                g.attrs["metadata"] = json.dumps(art.get("metadata", {}),
                                                 default=str)
                n += 1
    _logger.info("packed %d artifacts into %s", n, out)
    return n


def validate_dataset(cfg: Config) -> int:
    """Count the artifacts with a token outside the tokenizer's vocabulary
    or all-zero codes (data.py:1270-1326)."""
    from ..tokenizer import default_tokenizer
    vocab_size = default_tokenizer().vocab_size
    bad = 0
    for root in _roots(cfg):
        for mel in sorted(root.rglob("*.mel")):
            art = load_artifact(mel)
            text = np.asarray(art.get("text", []))
            if text.size and int(text.max()) >= vocab_size:
                _logger.warning("%s has out-of-vocab tokens (max %d)",
                                mel, int(text.max()))
                bad += 1
            if np.count_nonzero(np.asarray(art["codes"])) == 0:
                _logger.warning("%s has zero'd codes", mel)
                bad += 1
    _logger.info("validation done, %d bad artifacts", bad)
    return bad


def sample_dataset(cfg: Config, out_dir: Path, device=None) -> List[Path]:
    """Decode two samples to 22.05 kHz wavs for listening (data.py:1241-
    1269): DVAE codes -> 80-bin mel (the mel_norms division undone) ->
    Griffin-Lim.  Returns the paths written."""
    import torch

    from ..models import load_mel_norms, load_model, resolve_device
    from ..ops.stft import griffin_lim_from_mel
    from ..utils.io import write_wav
    device = resolve_device(device, "sample_dataset")
    ds = Dataset(cfg, cfg.dataset.training, training=False)
    dvae = load_model("dvae", device=device)
    it = ds.batches(batch_size=1)
    out_dir.mkdir(parents=True, exist_ok=True)
    norms = load_mel_norms(device)
    paths = []
    for i in range(2):
        batch = next(it)
        n = max(4, int(batch["wav_lengths"][0]) // 1024)
        codes = torch.as_tensor(batch["codes"][:, :n], device=device)
        mel = dvae.module.decode(dvae.params, codes, dvae.config)
        if norms is not None:
            mel = mel * norms[None, :, None]
        wav = griffin_lim_from_mel(mel.float())
        paths.append(out_dir / f"sample{i}.wav")
        write_wav(paths[-1], wav[0], 22050)
    _logger.info("wrote samples to %s", out_dir)
    return paths


def pack_melbin(cfg: Config) -> int:
    """Every artifact into ``data.melbin`` beside the config (the native
    loader's pack)."""
    from .native_loader import pack_melbin as pack
    paths = [p for root in _roots(cfg) for p in sorted(root.rglob("*.mel"))]
    n = pack(paths, cfg.rel_path / "data.melbin")
    _logger.info("packed %d artifacts into data.melbin", n)
    return n


def main(argv=None):
    parser = argparse.ArgumentParser("tortoise_tts_tpu_torch.data")
    parser.add_argument("--yaml", type=Path, required=True)
    parser.add_argument("--action", type=str, default="metadata",
                        choices=["metadata", "similar", "hdf5", "validate",
                                 "sample", "melbin"])
    parser.add_argument("--out", type=Path, default=Path("data/samples"))
    parser.add_argument("--top-k", type=int, default=8)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device of 'sample' (default: the CUDA "
                        "device)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    cfg = Config.load(args.yaml)
    if args.action == "metadata":
        return create_dataset_metadata(cfg)
    if args.action == "similar":
        return compute_similar_utterances(cfg, top_k=args.top_k)
    if args.action == "hdf5":
        return create_hdf5(cfg)
    if args.action == "validate":
        return validate_dataset(cfg)
    if args.action == "sample":
        return sample_dataset(cfg, args.out, device=args.device)
    return pack_melbin(cfg)


if __name__ == "__main__":
    main()
