"""``python -m tortoise_tts_tpu_torch``: the JAX package's arguments, a
wav written on the CPU with tiny models (``--device cpu``), the W8A8
decode through ``--decode-quant``, beam search, UnivNet and DPM++, and the
CUDA device by default."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tortoise_tts_tpu_torch
from tests.torch_tiny import tiny_models
from tortoise_tts_tpu_torch import inference as tinf
from tortoise_tts_tpu_torch.__main__ import main
from tortoise_tts_tpu_torch.models import unified_voice as uv
from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer
from tortoise_tts_tpu_torch.utils.io import read_wav, write_wav

REPO = Path(tortoise_tts_tpu_torch.__file__).parent.parent


@pytest.fixture
def cli(tmp_path, monkeypatch):
    """Tiny models in place of the registry's, the W8A8 and int8 GEMVs
    counted where the decode imports them, and a reference wav."""
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER",
                       str(write_char_tokenizer(tmp_path / "tok.json")))
    tiny = tiny_models()
    monkeypatch.setattr(tinf, "load_model",
                        lambda name, dtype, device=None: tiny[name])
    calls = {}
    for name in ("qgemv_w8a8", "qgemv"):
        fn = getattr(uv, name)
        calls[name] = 0

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(uv, name, counted)
    ref = tmp_path / "ref.wav"
    t = np.arange(22050) / 22050.0
    write_wav(ref, (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32),
              22050)
    return tmp_path, str(ref), calls


ARGS = ["--device", "cpu", "--dtype", "float32", "--max-ar-steps", "16",
        "--max-diffusion-steps", "2", "--seed", "3"]


@pytest.mark.parametrize("extra,gemv", [
    (["--decode-quant", "w8a8"], "qgemv_w8a8"),
    (["--decode-quant", "w8a8", "--vocoder", "hifigan"], "qgemv_w8a8"),
    (["--candidates", "2", "--top-p", "0.9"], "qgemv")])
def test_cli_writes_a_wav(cli, capsys, extra, gemv):
    tmp, ref, calls = cli
    out = tmp / "out.wav"
    main(["hello there", ref, "--out-path", str(out), *ARGS, *extra])
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.size > 1000
    assert np.isfinite(wav).all() and float(np.abs(wav).mean()) > 1e-4
    assert f"wrote {out}" in capsys.readouterr().out
    other = "qgemv" if gemv == "qgemv_w8a8" else "qgemv_w8a8"
    assert calls[gemv] > 0 and calls[other] == 0


@pytest.mark.parametrize("extra", [["--beam-width", "2"],
                                   ["--vocoder", "vocoder"],
                                   ["--diffusion-sampler", "dpm++"]])
def test_cli_refuses_unported_options(cli, capsys, extra):
    """The options the port refused before it ran them (beam search with
    its length penalty, UnivNet, DPM++) now write a wav."""
    tmp, ref, _ = cli
    out = tmp / "o.wav"
    main(["hello", ref, "--out-path", str(out), *ARGS, *extra,
          "--length-penalty", "2.0"])
    wav, sr = read_wav(out)
    assert sr == 24000 and wav.size > 1000 and np.isfinite(wav).all()
    assert f"wrote {out}" in capsys.readouterr().out


def test_cli_defaults_to_cuda(cli, monkeypatch):
    tmp, ref, _ = cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["hello", ref, "--out-path", str(tmp / "o.wav")])
    with pytest.raises(SystemExit):
        main(["hello", "--decode-quant", "fp8"])


def test_cli_module_runs():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-m", "tortoise_tts_tpu_torch",
                          "--help"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("references", "--decode-quant", "--vocoder", "--device",
                 "--out-path"):
        assert flag in out.stdout
