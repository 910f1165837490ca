"""Export trainer checkpoints to deployable weights (port of
``tortoise_tts_tpu/export.py``; reference export.py).

    python -m tortoise_tts_tpu_torch.export --yaml config.yaml [--lora]

The latest checkpoint of the module (or of the config's LoRA adapter)
under ``<yaml dir>/ckpt/<name>/`` becomes ``fp32.sft`` beside it: every
floating leaf in float32, the rest as stored, with the name and the
step in the metadata.  Host work only: no device is touched.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

_logger = logging.getLogger(__name__)


def export(cfg, module_name: str = "autoregressive", lora: bool = False,
           out: Path | None = None) -> Path:
    """Write the fp32 export of ``cfg``'s latest checkpoint; returns its
    path.  Raises SystemExit where the config has no LoRA for ``lora`` or
    where there is no checkpoint."""
    from .engine import state as st
    from .utils.io import load_state_dict, save_state_dict
    if lora and cfg.lora is None:
        # exporting the base model where LoRA weights were asked for
        # would ship the wrong artifact
        raise SystemExit("--lora requested but the config defines no "
                         "loras entry")
    name = cfg.lora.full_name if lora else module_name
    ckpt = st.latest_checkpoint(cfg.ckpt_dir, name)
    if ckpt is None:
        raise SystemExit(f"no checkpoint for {name} under {cfg.ckpt_dir}")
    flat = load_state_dict(ckpt / "module.sft")
    out = out or (cfg.ckpt_dir / name / "fp32.sft")
    save_state_dict({k: v.float() if v.is_floating_point() else v
                     for k, v in flat.items()}, out,
                    metadata={"config": {"name": name}, "step": ckpt.name})
    _logger.info("exported %s -> %s", ckpt, out)
    return out


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser("tortoise_tts_tpu_torch.export")
    parser.add_argument("--yaml", type=Path, required=True)
    parser.add_argument("--module-name", type=str, default="autoregressive")
    parser.add_argument("--lora", action="store_true",
                        help="export standalone LoRA weights")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from .config import Config
    return export(Config.load(args.yaml), args.module_name, args.lora,
                  args.out)


if __name__ == "__main__":
    main()
