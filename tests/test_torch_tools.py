"""The port's tools against the JAX package's, on the CPU: ``export``
(the same fp32.sft from one checkpoint directory), ``plot``
(``parse_logs``, a drawn figure), ``utils/profiling`` (the timer, the
FLOPs estimate, a ``torch.profiler`` Chrome trace), ``emb/transcribe``
(one voices tree through a stub ASR pipeline in both packages: the same
whisper.json files) and the stdlib web UI over real HTTP with tiny
models (the form, a generate round trip, the stream, an error shown in
the page).  Everything compared is exact but the wavs, which are checked
for being whole, finite and not silent.
"""

import json
import re
import sys
import threading
import types
import urllib.parse
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tortoise_tts_tpu import export as jexport
from tortoise_tts_tpu import plot as jplot
from tortoise_tts_tpu import webui as jwebui
from tortoise_tts_tpu.emb import transcribe as jtr
from tortoise_tts_tpu.utils import profiling as jprof
from tortoise_tts_tpu_torch import export, plot, webui
from tortoise_tts_tpu_torch.config import Config, Inference
from tortoise_tts_tpu_torch.emb import transcribe as ttr
from tortoise_tts_tpu_torch.utils import profiling
from tortoise_tts_tpu_torch.utils.io import (load_metadata, load_state_dict,
                                             read_wav, save_state_dict,
                                             write_wav)

from tests.torch_tiny import tiny_models


def _checkpoint(root: Path, name: str, step: int, seed: int = 0):
    """A trainer checkpoint ``<root>/ckpt/<name>/<step>/module.sft`` of
    float16, float32 and integer leaves, and its ``latest`` tag."""
    rng = np.random.RandomState(seed)
    flat = {"gpt/ln_f/scale": rng.randn(8).astype(np.float16),
            "gpt/attn_qkv/w": rng.randn(4, 12).astype(np.float32),
            "mel_head/w": rng.randn(4, 6).astype(np.float16),
            "codebook/cluster_size": rng.randint(0, 9, (5,)).astype(np.int64)}
    d = root / "ckpt" / name / str(step)
    save_state_dict(flat, d / "module.sft", metadata={"step": step})
    (root / "ckpt" / name / "latest").write_text(str(step))
    return flat


@pytest.mark.parametrize("lora", [False, True])
def test_export_matches_jax(tmp_path, lora):
    """The latest checkpoint (of the module, or of the config's LoRA
    adapter) becomes fp32.sft: every floating leaf in float32, integers
    kept, the same metadata, in both packages."""
    cfg = {"loras": [{"name": "voice", "rank": 4}]} if lora else {}
    (tmp_path / "cfg.yaml").write_text(json.dumps(cfg))
    name = Config.load(tmp_path / "cfg.yaml").lora.full_name if lora \
        else "autoregressive"
    _checkpoint(tmp_path, name, 3)
    flat = _checkpoint(tmp_path, name, 7, seed=1)
    argv = ["--yaml", str(tmp_path / "cfg.yaml")] + (["--lora"] if lora
                                                     else [])
    jexport.main(argv + ["--out", str(tmp_path / "jax.sft")])
    out = export.main(argv)
    assert out == tmp_path / "ckpt" / name / "fp32.sft"
    got, want = load_state_dict(out), load_state_dict(tmp_path / "jax.sft")
    assert sorted(got) == sorted(want) == sorted(flat)
    for k, v in got.items():
        assert v.dtype == want[k].dtype and torch.equal(v, want[k]), k
        src = torch.from_numpy(flat[k])
        assert v.dtype == (torch.float32 if src.is_floating_point()
                           else src.dtype)
        assert torch.equal(v, src.to(v.dtype)), k
    assert load_metadata(out) == load_metadata(tmp_path / "jax.sft") == {
        "config": {"name": name}, "step": 7}


def test_export_refuses_what_it_cannot_export(tmp_path):
    (tmp_path / "cfg.yaml").write_text("{}")
    cfg = Config.load(tmp_path / "cfg.yaml")
    with pytest.raises(SystemExit, match="no loras entry"):
        export.export(cfg, lora=True)
    with pytest.raises(SystemExit, match="no checkpoint"):
        export.export(cfg)


def test_export_takes_bf16_checkpoints(tmp_path):
    """The port's trainer writes bf16 weights; their fp32 export holds the
    same values (the JAX package's numpy reader has no bf16)."""
    w = torch.randn(3, 5).to(torch.bfloat16)
    save_state_dict({"w": w, "n": torch.arange(4)},
                    tmp_path / "ckpt" / "autoregressive" / "2" /
                    "module.sft")
    (tmp_path / "ckpt" / "autoregressive" / "latest").write_text("2")
    (tmp_path / "cfg.yaml").write_text("{}")
    got = load_state_dict(export.export(Config.load(tmp_path / "cfg.yaml")))
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], w.float())
    assert torch.equal(got["n"], torch.arange(4))


LOG = """INFO:trainer:{"it": 1, "loss": 2.5, "loss.mel": 1.0}
not a metric line
{"it": 2, "loss": 2.0}
DEBUG:x:{"it": 3, "loss": 1.5, "lr": 1e-4}
{"it": 4, "loss": broken}
"""


def test_plot_matches_jax(tmp_path):
    (tmp_path / "a.txt").write_text(LOG)
    (tmp_path / "b.txt").write_text('{"it": 5, "loss": 1.0}\n')
    paths = [tmp_path / "a.txt", tmp_path / "b.txt"]
    rows = plot.parse_logs(paths)
    assert rows == jplot.parse_logs(paths)
    assert [r["it"] for r in rows] == [1, 2, 3, 5]
    pytest.importorskip("matplotlib")
    out = plot.plot(paths, ys=("loss", "loss.mel"),
                    out=str(tmp_path / "m.png"))
    assert Path(out).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_profiling_matches_jax_and_traces(tmp_path):
    assert profiling.estimate_flops_per_token(30, 1024) == \
        jprof.estimate_flops_per_token(30, 1024)
    seen = []
    with pytest.raises(ValueError):
        with profiling.timer("block", callback=seen.append):
            raise ValueError("timed blocks that raise are timed")
    assert len(seen) == 1 and seen[0] >= 0
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profiling.trace(tmp_path / "trace") as prof:
        (a @ b).sum()
    assert prof is not None
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    logger = profiling.WandbLogger(enabled=False)
    logger.log({"loss": 1.0}, step=1)
    logger.finish()


WORDS = [{"text": " Hello", "timestamp": (0.0, 0.4)},
         {"text": " there.", "timestamp": (0.4, 0.9)},
         {"text": " After", "timestamp": (2.0, 2.3)},
         {"text": " a", "timestamp": (2.3, 2.4)},
         {"text": " gap", "timestamp": (2.4, None)}]


class _StubPipe:
    """A fixed ASR result whatever the audio (its length is checked)."""

    def __init__(self, word_timestamps):
        self.word_timestamps = word_timestamps

    def __call__(self, inputs):
        assert inputs["array"].ndim == 1 and inputs["sampling_rate"] > 0
        chunks = WORDS if self.word_timestamps else [
            {"text": " Hello there.", "timestamp": (0.0, 0.9)},
            {"text": " After a gap", "timestamp": (2.0, None)}]
        return {"text": " Hello there. After a gap", "chunks": chunks}


@pytest.mark.parametrize("word_timestamps", [True, False])
def test_transcribe_batch_matches_jax(tmp_path, monkeypatch,
                                      word_timestamps):
    """One voices tree (a top-level clip, two speakers, one clip already
    transcribed) through the same stub pipeline in both packages."""
    voices = tmp_path / "voices"
    t = np.arange(3 * 22050) / 22050
    wav = (0.3 * np.sin(2 * np.pi * 200 * t)).astype(np.float32)
    write_wav(voices / "top.wav", wav, 22050)
    for spk in ("a", "b"):
        for c in range(2):
            write_wav(voices / "g" / spk / f"c{c}.wav", wav, 22050)
    for side in ("jax", "port"):
        d = tmp_path / side / "g" / "b"
        d.mkdir(parents=True)
        (d / "whisper.json").write_text(json.dumps({"c0.wav": {"text": "x"}}))
    built = []

    def stub(model_name, wt=True, device=None):
        built.append((model_name, wt, device))
        return _StubPipe(wt)
    monkeypatch.setattr(jtr, "get_pipeline", stub)
    monkeypatch.setattr(ttr, "get_pipeline", stub)
    n_j = jtr.transcribe_batch(voices, tmp_path / "jax",
                               word_timestamps=word_timestamps)
    n_t = ttr.transcribe_batch(voices, tmp_path / "port",
                               word_timestamps=word_timestamps,
                               device="cpu")
    assert n_j == n_t == 4
    assert built[-1] == ("openai/whisper-base", word_timestamps, "cpu")
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("whisper.json"))
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("whisper.json"))
    assert len(files) == 3
    for rel in files:
        got = json.loads((tmp_path / "port" / rel).read_text())
        assert got == json.loads((tmp_path / "jax" / rel).read_text())
    seg = json.loads((tmp_path / "port" / "whisper.json").read_text())
    segs = seg["top.wav"]["segments"]
    assert segs[-1]["end"] == 3.0
    if word_timestamps:
        assert [s["text"] for s in segs] == ["Hello there.", "After a gap"]


def test_transcribe_pipeline_on_the_device(monkeypatch):
    """The pipeline is built once per (model, mode, device), on the CUDA
    device unless told otherwise."""
    calls = []
    fake = types.ModuleType("transformers")
    fake.pipeline = lambda *a, **kw: calls.append((a, kw)) or object()
    monkeypatch.setitem(sys.modules, "transformers", fake)
    monkeypatch.setattr(ttr, "_PIPELINES", {})
    p = ttr.get_pipeline("local/whisper", device="cpu")
    assert ttr.get_pipeline("local/whisper", device="cpu") is p
    assert len(calls) == 1 and calls[0][1]["device"] == torch.device("cpu")
    assert calls[0][1]["return_timestamps"] == "word"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.get_pipeline("local/whisper")


@pytest.fixture()
def server(tmp_path, monkeypatch):
    from tortoise_tts_tpu_torch.inference import TTS
    from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER",
                       str(write_char_tokenizer(tmp_path / "tok.json")))
    tts = TTS(Config(inference=Inference(weight_dtype="float32",
                                         text_buckets=(32, 80))),
              device="cpu", dtype="float32")
    tts._models = tiny_models()
    srv = webui.make_server(tts, port=0, out_dir=tmp_path / "audio")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}", tmp_path / "audio"
    srv.shutdown()
    srv.server_close()


def _pcm(data: bytes) -> np.ndarray:
    return np.frombuffer(data[44:44 + (len(data) - 44) // 2 * 2], "<i2")


def test_webui_form_renders(server):
    url, _ = server
    html = urllib.request.urlopen(url + "/", timeout=30).read().decode()
    assert "tortoise-tts-tpu" in html
    assert 'name="text"' in html and 'name="max_ar_steps"' in html
    assert webui._FORM == jwebui._FORM
    assert webui.HARVARD_SENTENCES == jwebui.HARVARD_SENTENCES
    with pytest.raises(urllib.error.HTTPError, match="404"):
        urllib.request.urlopen(url + "/audio/missing.wav", timeout=30)


def _generate(url, **over):
    data = {"text": "hello from the web ui", "references": "",
            "max_ar_steps": "12", "max_diffusion_steps": "2", "seed": "0",
            "cond_free": "false", **over}
    return urllib.request.urlopen(
        url + "/generate", data=urllib.parse.urlencode(data).encode(),
        timeout=600).read().decode()


def test_webui_generate_roundtrip(server):
    url, out_dir = server
    html = _generate(url)
    assert "error:" not in html and "<audio" in html, html[-500:]
    m = re.search(r'src="(/audio/[0-9a-f]+\.wav)"', html)
    assert m
    wav = urllib.request.urlopen(url + m.group(1), timeout=30).read()
    assert wav[:4] == b"RIFF" and len(wav) > 2000
    assert wav == (out_dir / Path(m.group(1)).name).read_bytes()
    got, sr = read_wav(out_dir / Path(m.group(1)).name)
    assert sr == 24000 and np.isfinite(got).all() and np.abs(got).max() > 0


def test_webui_shows_a_generation_error(server):
    url, _ = server
    html = _generate(url, diffusion_sampler="nonsense")
    assert "<pre>error:" in html and "<audio" not in html


def test_webui_stream_yields_wav(server):
    """/stream: a chunked 16-bit WAV of unknown length, then PCM chunks."""
    url, _ = server
    with urllib.request.urlopen(url + "/stream?text=hi", timeout=600) as r:
        assert r.headers["Transfer-Encoding"] == "chunked"
        data = r.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    assert data[:44] == webui.wav_stream_header()
    pcm = _pcm(data)
    assert pcm.size > 500 and np.abs(pcm).max() > 0
