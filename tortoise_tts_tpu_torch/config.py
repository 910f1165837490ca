"""Configuration (port of ``tortoise_tts_tpu/config.py``): the
``inference`` group, the LoRA adapters, the training groups (``models``,
``hyperparameters``, ``evaluation``, ``trainer``, ``dataset``) and the
path conventions (``ckpt_dir``, ``log_dir``, ...).

Immutable dataclasses, built explicitly and passed down.  A YAML file
parses to the same values as in the JAX package.  YAML is read only by
``Config.load``, which imports ``yaml`` when called (``Config.from_dict``
needs no package); ``Config.from_cli`` reads ``--yaml``, ``--model`` and
``--lora``, with the ``TORTOISE_YAML``, ``TORTOISE_MODEL`` and
``TORTOISE_LORA`` environment variables as their defaults.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

_logger = logging.getLogger(__name__)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
DENOISE_ATTENTION = ("auto", "kq", "flash_bias")


@dataclass(frozen=True)
class Inference:
    weight_dtype: str = "bfloat16"
    # static text buckets: text is padded to the first bucket it fits
    text_buckets: Tuple[int, ...] = (64, 128, 256, 402)
    # AR-decode GEMV quantization: "int8" is weight-only int8 with
    # per-output-channel scales (kernels/qgemv.py); "w8a8" adds dynamic
    # per-row int8 activations and integer dots (kernels/qgemv_w8a8.py);
    # "none" decodes with the weights at weight_dtype
    decode_quant: str = "int8"
    # the denoiser's biased attention at T >= 256 (models/diffusion.py):
    # "auto" runs K6 from batch 8 up and plain matmuls below; "kq" builds
    # the biases transposed and runs K9a at any batch (the JAX package's
    # TTS_DENOISE_KQ=1); "flash_bias" runs K9b below batch 8 (its
    # TTS_FLASH_BIAS=1)
    denoise_attention: str = "auto"

    def __post_init__(self):
        if self.decode_quant not in ("none", "int8", "w8a8"):
            raise ValueError(
                "decode_quant must be none|int8|w8a8, got "
                f"{self.decode_quant!r}")
        if self.denoise_attention not in DENOISE_ATTENTION:
            raise ValueError(
                "denoise_attention must be auto|kq|flash_bias, got "
                f"{self.denoise_attention!r}")
        if self.weight_dtype not in DTYPES:
            raise ValueError(f"unknown weight_dtype {self.weight_dtype!r}")


@dataclass(frozen=True)
class LoRAConfig:
    """One LoRA adapter of the AR model's trunk (JAX ``config.py``)."""
    name: str = "lora"
    rank: int = 128
    alpha: int = 128
    training: bool = True
    include: Tuple[str, ...] = ("gpt",)
    # the adapter file; None: ``<ckpt_dir>/<full_name>/lora.<format>``
    path: Optional[str] = None

    @property
    def full_name(self) -> str:
        return f"{self.name}-r{self.rank}-a{self.alpha}"


def _build(cls, data: Optional[dict], path: str):
    """A dataclass from a dict, unknown keys warned about and dropped,
    lists read as tuples (and lists inside them too)."""
    known = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in (data or {}).items():
        if k not in known:
            _logger.warning("config: ignoring %s%s", path, k)
            continue
        if isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kw[k] = v
    return cls(**kw)


@dataclass(frozen=True)
class ModelConfig:
    """One named model of the pipeline; ``training`` makes it an engine."""
    name: str = "autoregressive"
    training: bool = False
    # explicit weights: the port's '/'-keyed export or a reference
    # torch-layout checkpoint
    path: Optional[str] = None
    # loaded frozen for the AR step's distillation term
    teacher: bool = False
    # per-model overrides of the Hyperparameters fields
    hyperparameters: Optional[dict] = None
    dtype: str = "bfloat16"

    @property
    def full_name(self) -> str:
        return self.name


@dataclass(frozen=True)
class Hyperparameters:
    batch_size: int = 16
    gradient_accumulation_steps: int = 4
    gradient_clipping: float = 1.0
    warmup_steps: int = 100
    optimizer: str = "AdamW"
    learning_rate: float = 1e-4
    scheduler: str = ""
    # the reference's deepspeed fields, accepted and ignored
    autotune: bool = False
    autotune_params: Optional[dict] = None
    torch_optimizer: bool = True
    torch_scheduler: bool = True
    teacher_alpha: float = 0.5
    teacher_temperature: float = 1.0
    teacher_loss_fn: str = "mse"


@dataclass(frozen=True)
class Evaluation:
    batch_size: int = 8
    frequency: int = 5000
    size: int = 8
    kwargs: Optional[dict] = None


@dataclass(frozen=True)
class Trainer:
    iterations: int = 1_000_000
    save_tag: str = "step"
    save_on_oom: bool = True
    save_on_quit: bool = True
    save_frequency: int = 250
    export_on_save: bool = True
    keep_last_checkpoints: int = 4
    gradient_checkpointing: bool = True
    strict_loading: bool = False
    resize_modules: bool = True
    weight_dtype: str = "bfloat16"
    amp: bool = False
    backend: str = "local"
    load_webui: bool = False
    deepspeed: Optional[dict] = None
    # the JAX package's mesh: one device only in the port (ROADMAP.md)
    mesh_axes: Tuple[str, ...] = ("data",)
    mesh_shape: Tuple[int, ...] = (-1,)
    wandb: bool = False
    # torch.autograd.set_detect_anomaly(True) for the run
    detect_grad_anomaly: bool = False
    # seeds the diffusion step's t and noise draws with the step counter
    seed: int = 0
    # metrics are read to the host once per log_frequency steps
    log_frequency: int = 10
    # periodic checkpoints written by a background thread from a copy
    async_checkpoint: bool = True
    # accepted for the JAX package's yaml; torch has no buffer donation
    donate_train_state: bool = True
    param_sharding: str = "replicated"

    def dtype(self) -> torch.dtype:
        return DTYPES[self.weight_dtype]


@dataclass(frozen=True)
class DatasetConfig:
    training: Tuple[str, ...] = ()
    validation: Tuple[str, ...] = ()
    noise: Tuple[str, ...] = ()
    speaker_name_getter: str = "lambda p: f'{p.parts[-3]}_{p.parts[-2]}'"
    speaker_group_getter: str = "lambda p: f'{p.parts[-3]}'"
    speaker_languages: Optional[dict] = None
    use_hdf5: bool = False
    hdf5_flag: str = "r"
    hdf5_name: str = "data.h5"
    use_metadata: bool = True
    validate: bool = True
    workers: int = 2
    cache: bool = True
    duration_range: Tuple[float, float] = (3.0, 5.0)
    min_utterances: int = 2
    prompt_max_samples: int = 1
    prompt_duration_range: Tuple[float, float] = (3.0, 6.0)
    prompt_similar_p: float = 1.0
    resps_max_samples: int = 1
    resps_append_p: float = 0.0
    sample_type: str = "path"
    sample_order: str = "duration"
    sample_max_duration_batch: float = 0
    sample_shuffle: bool = False
    retokenize_text: bool = False
    tasks_list: Tuple[str, ...] = ("tts",)
    # fixed text and mel-code lengths of a training batch
    text_bucket: int = 256
    mel_bucket: int = 512
    # the native packed-dataset loader (data/native_loader.py): reads
    # <data dir>/data.melbin where it exists
    use_melbin: bool = False
    # load the mel / mel_diff targets (artifacts written with store_mels)
    load_mels: bool = False


@dataclass(frozen=True)
class Config:
    yaml_path: Optional[str] = None
    # where training runs: None is the CUDA device ("tpu", the JAX
    # package's default, reads as None)
    device: Optional[str] = None
    mode: str = "training"
    audio_backend: str = "mel"
    sample_rate: int = 24_000
    vocoder: str = "bigvgan"
    models: Tuple[ModelConfig, ...] = (ModelConfig(),)
    loras: Tuple[LoRAConfig, ...] = ()
    hyperparameters: Hyperparameters = field(default_factory=Hyperparameters)
    evaluation: Evaluation = field(default_factory=Evaluation)
    trainer: Trainer = field(default_factory=Trainer)
    inference: Inference = field(default_factory=Inference)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimizations: Optional[dict] = None
    weights_format: str = "sft"
    # dataset wildcards that match nothing give () instead of raising
    silent_errors: bool = False

    @property
    def lora(self) -> Optional[LoRAConfig]:
        return self.loras[0] if self.loras else None

    @property
    def model(self) -> ModelConfig:
        return self.models[0]

    @property
    def rel_path(self) -> Path:
        return Path(self.yaml_path).parent if self.yaml_path else Path(".")

    @property
    def ckpt_dir(self) -> Path:
        return self.rel_path / "ckpt"

    @property
    def log_dir(self) -> Path:
        return self.rel_path / "logs"

    @property
    def data_dir(self) -> Path:
        return self.rel_path / "data"

    @property
    def metadata_dir(self) -> Path:
        return self.rel_path / "metadata"

    @property
    def cache_dir(self) -> Path:
        return self.rel_path / ".cache"

    @property
    def train_device(self) -> Optional[str]:
        """The device the config asks training to run on, or None."""
        return None if self.device in (None, "tpu") else self.device

    def _expand_path(self, path: str) -> Tuple[str, ...]:
        """A dataset path with a '*': its matches under the metadata dir
        (as stems), else under the data dir."""
        if "*" not in str(path):
            return (path,)
        rel = Path(path)
        for parent, keep_stem in ((self.metadata_dir / rel.parent, True),
                                  (self.data_dir / rel.parent, False)):
            if parent.exists():
                found = sorted(parent.glob(rel.name))
                if found:
                    return tuple(str(rel.parent / (c.stem if keep_stem
                                                   else c.name))
                                 for c in found)
        if self.silent_errors:
            return ()
        raise ValueError(f"cannot expand dataset path: {path}")

    def _expand_datasets(self) -> "Config":
        ds = self.dataset
        if not any("*" in str(p) for group in (ds.training, ds.validation,
                                               ds.noise) for p in group):
            return self

        def exp(group):
            return tuple(q for p in group for q in self._expand_path(p))
        return dataclasses.replace(
            self, dataset=dataclasses.replace(
                ds, training=exp(ds.training),
                validation=exp(ds.validation), noise=exp(ds.noise)))

    @staticmethod
    def from_dict(raw: dict, **overrides) -> "Config":
        """Every group the JAX package's ``Config.from_dict`` reads, to the
        same values; unknown keys are warned about and dropped."""
        kw: Dict[str, Any] = {}
        if "models" in raw:
            kw["models"] = tuple(_build(ModelConfig, m, "models.")
                                 for m in raw["models"])
        if "loras" in raw:
            kw["loras"] = tuple(_build(LoRAConfig, m, "loras.")
                                for m in raw["loras"] or ())
        for key, cls in (("hyperparameters", Hyperparameters),
                         ("evaluation", Evaluation), ("trainer", Trainer),
                         ("inference", Inference),
                         ("dataset", DatasetConfig)):
            if key in raw:
                kw[key] = _build(cls, raw[key], key + ".")
        for key in ("device", "mode", "audio_backend", "sample_rate",
                    "vocoder", "weights_format", "optimizations",
                    "silent_errors"):
            if key in raw:
                kw[key] = raw[key]
        kw.update(overrides)
        return Config(**kw)._expand_datasets()

    @staticmethod
    def load(path: str | Path, **overrides) -> "Config":
        """Read a YAML config (a .json one with the stdlib, where PyYAML
        may be missing), or the config a weights file (.sft) holds in its
        metadata."""
        path = Path(path)
        if path.suffix in (".sft", ".safetensors"):
            return Config.load_model(path, **overrides)
        if path.suffix == ".json":
            import json
            raw = json.loads(path.read_text()) or {}
            return Config.from_dict(raw, yaml_path=str(path), **overrides)
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return Config.from_dict(raw, yaml_path=str(path), **overrides)

    @staticmethod
    def load_model(path: str | Path, **overrides) -> "Config":
        """The config stored in a safetensors file's metadata (the JAX
        package's ``--model`` mode)."""
        from .utils.io import load_metadata
        raw = load_metadata(path).get("config") or {}
        return Config.from_dict(raw if isinstance(raw, dict) else {},
                                yaml_path=str(Path(path).parent
                                              / "config.yaml"), **overrides)

    @classmethod
    def from_cli(cls, args: Optional[List[str]] = None) -> "Config":
        """``--yaml`` / ``--model`` / ``--lora`` (also ``yaml=...``), each
        defaulting to its ``TORTOISE_*`` environment variable."""
        import argparse
        import os
        import sys
        argv = list(sys.argv[1:] if args is None else args)
        argv = [f"--{a}" if a.startswith("yaml=") else a for a in argv]
        p = argparse.ArgumentParser(allow_abbrev=False, add_help=False)
        for flag, env in (("--yaml", "TORTOISE_YAML"),
                          ("--model", "TORTOISE_MODEL"),
                          ("--lora", "TORTOISE_LORA")):
            p.add_argument(flag, type=Path, default=os.environ.get(env))
        ns, _ = p.parse_known_args(argv)
        overrides: Dict[str, Any] = {}
        if ns.lora:
            overrides["loras"] = (LoRAConfig(path=str(ns.lora),
                                             training=False),)
        if ns.model:
            return cls.load_model(ns.model, **overrides)
        if ns.yaml:
            return cls.load(ns.yaml, **overrides)
        return cls(**overrides)
