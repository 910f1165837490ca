"""The port's native melbin loader against the JAX package's, on the CPU:
the pack byte for byte (payload alignments of 0 to 3 bytes), the native
batches against the JAX ``MelBinDataset``'s and against the port's own
Python path, bit for bit, through the Dataset with ``use_melbin`` (a pack
made by either package); the library built from ``native/melbin.cpp``
into the port's ``_build/``; and the refusals (no sidecar, a failed
build).  The JAX reader is pointed at the port's library, so nothing is
built into ``native/``."""

import json

import numpy as np
import pytest

from tortoise_tts_tpu.config import Config as JConfig
from tortoise_tts_tpu.data import dataset as jdataset
from tortoise_tts_tpu.data import native_loader as jnl
from tortoise_tts_tpu_torch.config import Config
from tortoise_tts_tpu_torch.data import Dataset
from tortoise_tts_tpu_torch.data import native_loader as nl

from tests.torch_train_util import write_artifact

KEYS = ("text", "text_lengths", "codes", "wav_lengths", "latents",
        "diffusion_latents")


@pytest.fixture()
def data(tmp_path, monkeypatch):
    """Seven artifacts of two speakers; text lengths 9-15 and 17-23 codes,
    so the codes + text payload needs every pad of 0-3 bytes."""
    monkeypatch.setattr(jnl, "SO_PATH", nl.build())
    monkeypatch.setattr(jnl, "_lib", None)
    root = tmp_path / "data"
    paths = []
    for i in range(7):
        p = root / f"spk{i % 2}" / f"utt{i:02d}.mel"
        write_artifact(p, n_codes=17 + i, n_text=9 + i, seed=i, dim=48,
                       mels=False)
        paths.append(p)
    return tmp_path, root, sorted(paths)


def _cfg(cls, root, data, melbin: bool):
    raw = {"dataset": {"training": [str(data)], "validate": False,
                       "use_melbin": melbin, "text_bucket": 16,
                       "mel_bucket": 20, "sample_shuffle": False,
                       "cache": False},
           "hyperparameters": {"batch_size": 3}}
    return cls.from_dict(raw, yaml_path=str(root / "cfg.yaml"))


def test_pack_is_byte_equal_to_jax(data):
    root, _, paths = data
    n = nl.pack_melbin(paths, root / "port.melbin")
    assert n == jnl.pack_melbin(paths, root / "jax.melbin") == 7
    assert (root / "port.melbin").read_bytes() == \
        (root / "jax.melbin").read_bytes()
    assert json.loads((root / "port.melbin.paths.json").read_text()) == \
        json.loads((root / "jax.melbin.paths.json").read_text())
    # the library comes from the repo's source, under the port's _build
    assert nl.lib_path().exists()
    assert nl.lib_path().parent.parent == nl.BUILD_ROOT


def test_native_batches_equal_jax_reader(data):
    root, _, paths = data
    nl.pack_melbin(paths, root / "data.melbin")
    got = nl.MelBinDataset(root / "data.melbin")
    want = jnl.MelBinDataset(root / "data.melbin")
    assert len(got) == len(want) == 7
    np.testing.assert_array_equal(got.durations(), want.durations())
    assert (got.lat_dim, got.dlat_dim) == (48, 96)
    for rows in ([0, 1, 2], [6, 3, 3, 5], [4]):
        a = got.batch(rows, 16, 20)
        b = want.batch(rows, 16, 20)
        assert set(a) == set(b) == set(KEYS)
        for k in KEYS:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="mb_batch"):
        got.batch([7], 16, 20)
    got.close()


@pytest.mark.parametrize("packer", ["port", "jax"])
def test_use_melbin_batches_equal_python_path(data, packer):
    """The Dataset with ``use_melbin`` (a pack from either package) yields
    the Python path's batches bit for bit, in the sampler's order (the
    samples reordered by speaker against the pack's order), and the JAX
    Dataset over the same pack yields the same."""
    root, droot, paths = data
    (nl if packer == "port" else jnl).pack_melbin(paths,
                                                  root / "data.melbin")
    native = Dataset(_cfg(Config, root, droot, True), [droot])
    plain = Dataset(_cfg(Config, root, droot, False), [droot])
    jax_native = jdataset.Dataset(_cfg(JConfig, root, droot, True), [droot])
    assert native._melbin is not None and plain._melbin is None
    assert jax_native._melbin is not None
    assert not np.array_equal(native._melbin_rows, np.arange(7))
    it_n, it_p, it_j = (d.batches() for d in (native, plain, jax_native))
    for _ in range(3):
        a, b, c = next(it_n), next(it_p), next(it_j)
        for k in KEYS:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)
    assert native.get_state() == plain.get_state()


def test_use_melbin_without_a_pack_runs_the_python_path(data):
    root, droot, _ = data
    d = Dataset(_cfg(Config, root, droot, True), [droot])
    assert d._melbin is None
    assert next(d.batches())["codes"].shape == (3, 20)


def test_an_unusable_pack_raises(data, monkeypatch, tmp_path):
    """No sidecar, a path the pack lacks, and a library that does not
    build each raise (the JAX package logs and falls back)."""
    root, droot, paths = data
    nl.pack_melbin(paths[:-1], root / "data.melbin")
    with pytest.raises(KeyError, match="lacks 1"):
        Dataset(_cfg(Config, root, droot, True), [droot])
    (root / "data.melbin.paths.json").unlink()
    with pytest.raises(FileNotFoundError, match="sidecar"):
        Dataset(_cfg(Config, root, droot, True), [droot])
    nl.pack_melbin(paths, root / "data.melbin")
    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(nl, "BUILD_ROOT", tmp_path / "fresh_build")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        Dataset(_cfg(Config, root, droot, True), [droot])
