"""Dataset preparation in the port against the JAX package, on the CPU in
fp32 with the same tiny models on both sides (the JAX package's inits,
carried over by the bridge): ``emb/mel.encode``'s DVAE codes and training
mels, ``emb/process`` over a voices tree, the ``data`` CLI's actions
(metadata, similar, validate, hdf5, sample, melbin) and Griffin-Lim.

The JAX package encodes the DVAE's mel edge-padded to a multiple of 256
frames unless ``TTS_MEL_EXACT=1``; the port encodes the exact shape, so
the tests set it.  Tolerances: the codes, the text tokens, the metadata,
the JSON files and the packs exactly; fp32 latents, conds and mels 1e-4
(absolute and relative: only the order of sums differs); the float16
mels of an artifact one float16 step (2^-6 below 16 in magnitude);
Griffin-Lim's fp32 wav 1e-4 from the same initial phase, and the 16-bit
wavs of ``sample`` two steps.
"""

import json
import math
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.data import __main__ as jdata
from tortoise_tts_tpu.data.dataset import load_artifact as jload
from tortoise_tts_tpu.emb import mel as jmel
from tortoise_tts_tpu.emb import process as jprocess
from tortoise_tts_tpu.config import Config as JConfig
from tortoise_tts_tpu.models import LoadedModel as JLoaded
from tortoise_tts_tpu.ops import stft as jstft
from tortoise_tts_tpu import tokenizer as jtok
from tortoise_tts_tpu_torch import bridge, tokenizer as ttok
from tortoise_tts_tpu_torch.config import Config
from tortoise_tts_tpu_torch.data import __main__ as tdata
from tortoise_tts_tpu_torch.data.dataset import load_artifact as tload
from tortoise_tts_tpu_torch.emb import mel as tmel
from tortoise_tts_tpu_torch.emb import process as tprocess
from tortoise_tts_tpu_torch.models import LoadedModel
from tortoise_tts_tpu_torch.ops import stft
from tortoise_tts_tpu_torch.utils.io import read_wav, write_wav

from tests.torch_train_util import CFGS, MODULES, jax_params, write_dataset

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=1e-4, rtol=1e-4)
F16_TOL = dict(atol=2.0 ** -6, rtol=2.0 ** -10)
NAMES = ("autoregressive", "diffusion", "dvae")


@pytest.fixture(scope="module")
def tiny():
    """{name: (JAX LoadedModel, port LoadedModel)} on the same weights."""
    out = {}
    for n in NAMES:
        p = jax_params(n)
        jm, tm = MODULES[n]
        jc, tc = CFGS[n]
        out[n] = (JLoaded(n, jm, jc, jax.tree_util.tree_map(jnp.asarray, p),
                          False),
                  LoadedModel(n, tm, tc, bridge.to_torch(p), False))
    return out


@pytest.fixture
def patched(tiny, tmp_path, monkeypatch):
    """Both packages' encoders load the tiny models, a char tokenizer is
    the default one, and the JAX package encodes at the exact shape."""
    monkeypatch.setenv("TTS_MEL_EXACT", "1")
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER", str(
        ttok.write_char_tokenizer(tmp_path / "tokenizer.json")))
    for mod in (jtok, ttok):
        mod.default_tokenizer.cache_clear()
    monkeypatch.setattr(jmel, "load_model",
                        lambda name, dtype="float32": tiny[name][0])
    monkeypatch.setattr(tmel, "load_model",
                        lambda name, dtype="float32", seed=0, device=None:
                        tiny[name][1])
    yield tiny
    for mod in (jtok, ttok):
        mod.default_tokenizer.cache_clear()


def _voice(seconds, f0, sr=22050, seed=0):
    """A gliding harmonic tone with a little noise (float32)."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    phase = 2 * np.pi * np.cumsum(f0 + 20 * np.sin(2 * np.pi * t)) / sr
    wav = sum(0.2 / k * np.sin(k * phase) for k in range(1, 5))
    return (wav * (0.6 + 0.4 * np.sin(6 * np.pi * t))
            + 0.01 * rng.randn(t.size)).astype(np.float32)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), err_msg=what, **tol)


def test_encode_codes_and_mels_match_jax(patched):
    """encode at 24 kHz (resampled to 22.05 kHz): the DVAE's codes equal,
    the conditioning mels, both latents and the two training mels close,
    the metadata equal; no CUDA device needed with device='cpu'."""
    wav = _voice(2.5, 150.0, sr=24000, seed=1)
    want = jmel.encode(wav, 24000, return_mels=True)
    got = tmel.encode(wav, 24000, return_mels=True, device="cpu")
    codes = got["codes"].numpy()
    assert codes.shape == np.asarray(want["codes"]).shape
    assert codes.shape[-1] == got["mel"].shape[-1] // 4
    np.testing.assert_array_equal(codes, np.asarray(want["codes"]))
    assert np.count_nonzero(codes) > 0
    for key in ("conds", "latent"):
        for i in range(2):
            _close(got[key][i].numpy(), want[key][i], TOL, f"{key}[{i}]")
    for key in ("mel", "mel_diff"):
        _close(got[key].numpy(), want[key], TOL, key)
    assert got["metadata"] == want["metadata"]
    # without return_mels no training mels; codes=False leaves the DVAE out
    lean = tmel.encode(wav, 24000, device="cpu", codes=False)
    assert "codes" not in lean and "mel" not in lean
    np.testing.assert_array_equal(lean["latent"][0].numpy(),
                                  got["latent"][0].numpy())


def _voices_tree(root: Path) -> Path:
    """2 speakers x 2 clips of 2-3 s with distinct f0: .txt transcripts,
    and one speaker's second clip sliced by a whisper.json."""
    voices = root / "voices"
    for s, spk in enumerate(("alice", "bob")):
        d = voices / "group" / spk
        d.mkdir(parents=True)
        for c in range(2):
            write_wav(d / f"clip{c}.wav",
                      _voice(2.0 + c, 120.0 + 60 * s + 15 * c, seed=s * 2 + c),
                      22050)
            (d / f"clip{c}.txt").write_text(f"speaker {spk} says {c}.\n")
    (voices / "group" / "bob" / "whisper.json").write_text(json.dumps({
        "clip1.wav": {"segments": [
            {"start": 0.1, "end": 1.0, "text": " first part."},
            {"start": 1.4, "end": 2.2, "text": " second part."}]}}))
    return voices


def test_process_matches_jax_and_loads_across(patched, tmp_path):
    """``emb.process`` over one voices tree in both packages (the port's
    through its CLI): the same artifacts, of numpy arrays only, that each
    package's loader reads from the other's."""
    voices = _voices_tree(tmp_path)
    n_j = jprocess.process(voices, tmp_path / "out_jax")
    n_t = tprocess.main(["--input-audio", str(voices), "--output-dataset",
                         str(tmp_path / "out_port"), "--device", "cpu"])
    assert n_j == n_t == 5
    files = sorted(p.relative_to(tmp_path / "out_jax")
                   for p in (tmp_path / "out_jax").rglob("*.mel"))
    assert files == sorted(p.relative_to(tmp_path / "out_port")
                           for p in (tmp_path / "out_port").rglob("*.mel"))
    for rel in files:
        want = jload(tmp_path / "out_jax" / rel)
        got = tload(tmp_path / "out_port" / rel)
        assert set(got) == set(want), rel
        assert got["codes"].dtype == np.uint16
        np.testing.assert_array_equal(got["codes"], want["codes"])
        np.testing.assert_array_equal(got["text"], want["text"])
        assert got["text"].dtype == np.uint8
        assert got["metadata"] == want["metadata"]
        for key in ("conds", "latent"):
            assert isinstance(got[key], tuple)
            for i in range(2):
                _close(got[key][i], want[key][i], TOL, f"{rel} {key}[{i}]")
        for key in ("mel", "mel_diff"):
            _close(got[key], want[key], F16_TOL, f"{rel} {key}")

        def leaves(x):
            if isinstance(x, dict):
                return [v for k in x for v in leaves(x[k])]
            if isinstance(x, (tuple, list)):
                return [v for e in x for v in leaves(e)]
            return [x]
        assert not any(torch.is_tensor(v) for v in leaves(got))
        # each package reads the other's artifact
        cross = jload(tmp_path / "out_port" / rel)
        np.testing.assert_array_equal(cross["codes"], got["codes"])
        assert tload(tmp_path / "out_jax" / rel)["metadata"] == \
            want["metadata"]
    # a second run keeps what is there
    assert tprocess.process(voices, tmp_path / "out_port", device="cpu") == 0


def _configs(tmp_path):
    """Two copies of a dataset of two speakers (fabricated artifacts), each
    with its config: (JAX config, port config)."""
    vocab = ttok.default_tokenizer().vocab_size
    out = []
    for side in ("jax", "port"):
        root = tmp_path / side
        data = write_dataset(root, n=4)
        spk2 = data / "group" / "speaker2"
        shutil.copytree(data / "group" / "speaker", spk2)
        for i, p in enumerate(sorted(data.rglob("*.mel"))):
            art = tload(p)
            art["text"] = (art["text"] % (vocab - 3) + 3).astype(np.uint8)
            if i == 5:
                art["codes"][:] = 0          # two bad artifacts for validate
            if i == 6:
                art["text"][0] = vocab       # out of the char vocabulary
            with open(p, "wb") as f:
                np.save(f, art)
        cfg = {"dataset": {"training": [str(data)], "validate": False,
                           "hdf5_name": "data.h5"}}
        (root / "cfg.yaml").write_text(json.dumps(cfg))
        out.append(root / "cfg.yaml")
    return JConfig.load(out[0]), Config.load(out[1])


def _files(root: Path, pattern: str):
    return {p.relative_to(root): p for p in sorted(root.rglob(pattern))}


def test_data_actions_match_jax(patched, tmp_path):
    """metadata, similar, validate, hdf5 and melbin write what the JAX
    package writes."""
    h5py = pytest.importorskip("h5py")
    jcfg, tcfg = _configs(tmp_path)
    assert jdata.create_dataset_metadata(jcfg) == \
        tdata.create_dataset_metadata(tcfg) == 8
    assert jdata.compute_similar_utterances(jcfg, top_k=2) == \
        tdata.compute_similar_utterances(tcfg, top_k=2) == 8
    jm, tm = _files(jcfg.metadata_dir, "*.json"), \
        _files(tcfg.metadata_dir, "*.json")
    assert set(jm) == set(tm) and len(tm) == 2
    for rel in jm:
        got = json.loads(tm[rel].read_text())
        assert got == json.loads(jm[rel].read_text())
        assert all(len(e["similar"]) == 2 for e in got.values())
    bad = jdata.validate_dataset(jcfg)
    assert bad == tdata.validate_dataset(tcfg) == 2
    assert jdata.create_hdf5(jcfg) == tdata.create_hdf5(tcfg) == 8
    with h5py.File(jcfg.rel_path / "data.h5") as fj, \
            h5py.File(tcfg.rel_path / "data.h5") as ft:
        keys = []
        fj.visit(keys.append)
        got = []
        ft.visit(got.append)
        assert keys == got and len(keys) > 8
        for k in keys:
            if isinstance(fj[k], h5py.Dataset):
                np.testing.assert_array_equal(ft[k][()], fj[k][()])
                assert ft[k].dtype == fj[k].dtype
            else:
                assert dict(ft[k].attrs) == dict(fj[k].attrs)
    jdata.main(["--yaml", str(jcfg.rel_path / "cfg.yaml"), "--action",
                "melbin"])
    assert tdata.main(["--yaml", str(tcfg.rel_path / "cfg.yaml"),
                       "--action", "melbin"]) == 8
    assert (tcfg.rel_path / "data.melbin").read_bytes() == \
        (jcfg.rel_path / "data.melbin").read_bytes()


def _jax_phase(shape):
    """The JAX package's initial Griffin-Lim phase (PRNGKey(0))."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(0), shape, minval=-np.pi, maxval=np.pi)))


@pytest.mark.parametrize("iters", [0, 4])
def test_griffin_lim_matches_jax_with_injected_phase(iters):
    mel = np.log(np.random.RandomState(2).rand(2, 80, 24) * 2 + 1e-3) \
        .astype(np.float32)
    want = np.asarray(jstft.griffin_lim_from_mel(jnp.asarray(mel),
                                                 iters=iters))
    got = stft.griffin_lim_from_mel(torch.from_numpy(mel), iters=iters,
                                    phase=_jax_phase((2, 513, 24)))
    assert got.shape == want.shape == (2, 23 * 256)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the port's own draw: uniform in [-pi, pi) from a generator seeded 0
    a = stft.griffin_lim_from_mel(torch.from_numpy(mel), iters=1)
    phase = (torch.rand((2, 513, 24), generator=torch.Generator()
                        .manual_seed(0)) * 2 - 1) * np.pi
    b = stft.griffin_lim_from_mel(torch.from_numpy(mel), iters=1,
                                  phase=phase)
    assert torch.equal(a, b) and torch.isfinite(a).all()


def test_sample_matches_jax(patched, tmp_path, monkeypatch):
    """``sample``: two artifacts' codes through the DVAE's decoder and
    Griffin-Lim (the JAX package's initial phase handed to the port), the
    two 22.05 kHz wavs within two 16-bit steps."""
    import tortoise_tts_tpu.models as jmodels
    import tortoise_tts_tpu_torch.models as tmodels
    from tortoise_tts_tpu_torch.ops import stft as tstft
    jcfg, tcfg = _configs(tmp_path)
    monkeypatch.setattr(jmodels, "load_model",
                        lambda name, dtype="float32": patched[name][0])
    monkeypatch.setattr(tmodels, "load_model",
                        lambda name, dtype="float32", seed=0, device=None:
                        patched[name][1])
    gl = tstft.griffin_lim_from_mel
    monkeypatch.setattr(tstft, "griffin_lim_from_mel", lambda mel, **kw: gl(
        mel, phase=_jax_phase((mel.shape[0], 513, mel.shape[-1])), **kw))
    jdata.sample_dataset(jcfg, tmp_path / "jax_samples")
    paths = tdata.main(["--yaml", str(tcfg.rel_path / "cfg.yaml"),
                        "--action", "sample", "--out",
                        str(tmp_path / "port_samples"), "--device", "cpu"])
    assert [p.name for p in paths] == ["sample0.wav", "sample1.wav"]
    for p in paths:
        got, sr = read_wav(p)
        want, jsr = read_wav(tmp_path / "jax_samples" / p.name)
        assert sr == jsr == 22050 and got.shape == want.shape
        assert got.size > 0 and np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=2 / 32768)


def test_prep_entry_points_need_cuda_or_explicit_cpu(patched, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    voices = _voices_tree(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprocess.main(["--input-audio", str(voices), "--output-dataset",
                       str(tmp_path / "out")])
    _, tcfg = _configs(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.sample_dataset(tcfg, tmp_path / "samples")
    assert math.isfinite(tdata.validate_dataset(tcfg))
