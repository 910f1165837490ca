"""Inference configuration (the slice of ``tortoise_tts_tpu/config.py``
the port runs: the ``inference`` group, the LoRA adapters and the
checkpoint paths).

Immutable dataclasses, built explicitly and passed down.  YAML is read
only by ``Config.load``, which imports ``yaml`` when called;
``Config.from_cli`` reads ``--yaml``, ``--model`` and ``--lora``, with
the ``TORTOISE_YAML``, ``TORTOISE_MODEL`` and ``TORTOISE_LORA``
environment variables as their defaults.
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
    lists read as tuples."""
    known = {f.name for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in (data or {}).items():
        if k not in known:
            _logger.warning("config: ignoring %s%s", path, k)
            continue
        kw[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


@dataclass(frozen=True)
class Config:
    yaml_path: Optional[str] = None
    inference: Inference = field(default_factory=Inference)
    loras: Tuple[LoRAConfig, ...] = ()
    weights_format: str = "sft"

    @property
    def lora(self) -> Optional[LoRAConfig]:
        return self.loras[0] if self.loras else None

    @property
    def rel_path(self) -> Path:
        return Path(self.yaml_path).parent if self.yaml_path else Path(".")

    @property
    def ckpt_dir(self) -> Path:
        return self.rel_path / "ckpt"

    @staticmethod
    def from_dict(raw: dict, **overrides) -> "Config":
        """The ``inference`` and ``loras`` groups and ``weights_format``;
        the other groups (training, datasets) belong to the JAX package
        and are ignored."""
        kw: Dict[str, Any] = {}
        if "inference" in raw:
            kw["inference"] = _build(Inference, raw["inference"],
                                     "inference.")
        if "loras" in raw:
            kw["loras"] = tuple(_build(LoRAConfig, m, "loras.")
                                for m in raw["loras"] or ())
        if "weights_format" in raw:
            kw["weights_format"] = raw["weights_format"]
        kw.update(overrides)
        return Config(**kw)

    @staticmethod
    def load(path: str | Path, **overrides) -> "Config":
        """Read a YAML config, or the config a weights file (.sft) holds in
        its metadata."""
        path = Path(path)
        if path.suffix in (".sft", ".safetensors"):
            return Config.load_model(path, **overrides)
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
