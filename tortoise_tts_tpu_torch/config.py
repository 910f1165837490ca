"""Inference configuration (the slice of ``tortoise_tts_tpu/config.py``
the port runs).

Immutable dataclasses, built explicitly and passed down.  YAML is read
only by ``Config.load``, which imports ``yaml`` when called.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple

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
class Config:
    yaml_path: Optional[str] = None
    inference: Inference = field(default_factory=Inference)

    @staticmethod
    def load(path: str | Path) -> "Config":
        """Read the ``inference`` group of a YAML config; other groups
        (training, datasets) belong to the JAX package and are ignored."""
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        inf = raw.get("inference") or {}
        known = {f.name for f in dataclasses.fields(Inference)}
        for k in inf:
            if k not in known:
                _logger.warning("config: ignoring inference.%s", k)
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in inf.items() if k in known}
        return Config(yaml_path=str(path), inference=Inference(**kw))
