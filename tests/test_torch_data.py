"""The port's training data and config against the JAX package's: the
same YAML parses to the same values, the Dataset yields bit-equal batches
(duration order, shuffled, duration-budgeted, host-sharded, mel targets,
epochs spanning, the HDF5 path) and the samplers' states cross between
the two packages; the melbin loader is refused."""

import dataclasses
import pickle

import numpy as np
import pytest

from tortoise_tts_tpu.config import Config as JConfig
from tortoise_tts_tpu.data import Dataset as JDataset
from tortoise_tts_tpu.data import sampler as jsampler
from tortoise_tts_tpu_torch.config import Config
from tortoise_tts_tpu_torch.data import Dataset, create_train_val_dataloader
from tortoise_tts_tpu_torch.data import sampler

from tests.torch_train_util import write_artifact

README_YAML = """
models:
- name: autoregressive
  training: true
- name: diffusion
  training: true
  hyperparameters:
    learning_rate: 5.0e-5
loras:
- name: voice
  rank: 16
  alpha: 32
hyperparameters:
  batch_size: 16
  gradient_accumulation_steps: 4
  learning_rate: 1.0e-4
  optimizer: AdamW
  scheduler: cosine
  warmup_steps: 100
evaluation:
  frequency: 1000
  kwargs: {max_steps: 64}
trainer:
  iterations: 10000
  save_frequency: 500
  keep_last_checkpoints: 2
  gradient_checkpointing: true
  mesh_shape: [1, 1]
  seed: 3
dataset:
  training: [data/train]
  validation: [data/val]
  duration_range: [1.0, 12.0]
  load_mels: true
  text_bucket: 128
  mel_bucket: 256
"""


def test_yaml_parses_to_the_same_values(tmp_path):
    (tmp_path / "cfg.yaml").write_text(README_YAML)
    j = JConfig.load(tmp_path / "cfg.yaml")
    t = Config.load(tmp_path / "cfg.yaml")
    for group in ("hyperparameters", "evaluation", "trainer", "dataset"):
        assert dataclasses.asdict(getattr(t, group)) == \
            dataclasses.asdict(getattr(j, group)), group
    assert [dataclasses.asdict(m) for m in t.models] == \
        [dataclasses.asdict(m) for m in j.models]
    assert t.lora.full_name == j.lora.full_name == "voice-r16-a32"
    for path in ("ckpt_dir", "log_dir", "data_dir", "metadata_dir",
                 "cache_dir"):
        assert getattr(t, path) == getattr(j, path), path
    # the defaults of every group agree too
    d_t, d_j = Config(), JConfig()
    for group in ("hyperparameters", "evaluation", "trainer", "dataset"):
        assert dataclasses.asdict(getattr(d_t, group)) == \
            dataclasses.asdict(getattr(d_j, group)), group
    assert t.train_device is None


@pytest.fixture()
def data_root(tmp_path):
    # two speakers, durations 0.9-1.8 s, one speaker below min_utterances
    for spk, n in (("alice", 6), ("bob", 5), ("carol", 1)):
        for i in range(n):
            write_artifact(tmp_path / "data" / "g" / spk / f"u{i:02d}.mel",
                           n_codes=20 + 3 * i + len(spk), seed=7 * i + n)
    return tmp_path


def _pair(root, **ds):
    raw = {"hyperparameters": {"batch_size": 3},
           "dataset": {"training": [str(root / "data")], "validate": False,
                       "text_bucket": 40, "mel_bucket": 48,
                       "load_mels": True, **ds}}
    j = JConfig.from_dict(raw, yaml_path=str(root / "cfg.yaml"))
    t = Config.from_dict(raw, yaml_path=str(root / "cfg.yaml"))
    return j, t


def _batches(ds, n, bs=None):
    it = ds.batches(batch_size=bs)
    return [next(it) for _ in range(n)]


def _same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("ds", [
    {},                                            # duration order
    {"sample_order": "interleaved"},
    {"sample_shuffle": True},
    {"sample_max_duration_batch": 3.0},
    {"min_utterances": 1, "prompt_similar_p": 0.0},
])
def test_batches_are_bit_equal(data_root, ds):
    """Eight batches, across more than one epoch, with the mel and
    mel_diff targets."""
    j, t = _pair(data_root, **ds)
    jd = JDataset(j, j.dataset.training, training=True)
    td = Dataset(t, t.dataset.training, training=True)
    assert [str(p) for p in td.paths] == [str(p) for p in jd.paths]
    assert td.durations == jd.durations
    for a, b in zip(_batches(td, 8), _batches(jd, 8)):
        _same(a, b)


def test_host_sharding_and_validation_split(data_root):
    j, t = _pair(data_root)
    for idx in (0, 1):
        jd = JDataset(j, j.dataset.training, process_index=idx,
                      process_count=2)
        td = Dataset(t, t.dataset.training, process_index=idx,
                     process_count=2)
        assert [str(p) for p in td.paths] == [str(p) for p in jd.paths]
    train, val = create_train_val_dataloader(t)
    assert not val.training and len(val) == 12 and len(train) == 11
    _same(next(val.batches(batch_size=1)),
          next(JDataset(j, j.dataset.training, training=False)
               .batches(batch_size=1)))


def test_sampler_state_crosses_between_packages(data_root):
    """A sampler state saved by either package resumes the other's order."""
    for mk_j, mk_t in (
            (lambda: jsampler.RandomSampler(9, seed=4),
             lambda: sampler.RandomSampler(9, seed=4)),
            (lambda: jsampler.OrderedSampler(9),
             lambda: sampler.OrderedSampler(9)),
            (lambda: jsampler.BatchedOrderedSampler(
                [0.5 * i for i in range(9)], max_duration=3.0, shuffle=True),
             lambda: sampler.BatchedOrderedSampler(
                [0.5 * i for i in range(9)], max_duration=3.0,
                shuffle=True))):
        js, ts = mk_j(), mk_t()
        ji, ti = iter(js), iter(ts)
        assert [next(ji) for _ in range(4)] == [next(ti) for _ in range(4)]
        t2, j2 = mk_t(), mk_j()
        t2.set_state(pickle.loads(pickle.dumps(js.get_state())))
        j2.set_state(pickle.loads(pickle.dumps(ts.get_state())))
        assert list(iter(t2)) == list(ji)
        assert list(iter(j2)) == list(ti)
    # the dataset's state file written by one package loads in the other
    j, t = _pair(data_root, sample_shuffle=True)
    jd = JDataset(j, j.dataset.training)
    td = Dataset(t, t.dataset.training)
    _batches(jd, 3)
    jd.save_state(data_root / "sampler.0.state")
    td.load_state(data_root / "sampler.0.state")
    jd2 = JDataset(j, j.dataset.training)
    jd2.load_state(data_root / "sampler.0.state")
    for a, b in zip(_batches(td, 3), _batches(jd2, 3)):
        _same(a, b)


def test_hdf5_path_is_bit_equal(data_root):
    from tortoise_tts_tpu.data.__main__ import create_hdf5
    j, t = _pair(data_root, min_utterances=1)
    assert create_hdf5(j) == 12
    j = dataclasses.replace(j, dataset=dataclasses.replace(j.dataset,
                                                          use_hdf5=True))
    t = dataclasses.replace(t, dataset=dataclasses.replace(t.dataset,
                                                          use_hdf5=True))
    jd = JDataset(j, j.dataset.training)
    td = Dataset(t, t.dataset.training)
    assert len(td) == len(jd) == 12
    for a, b in zip(_batches(td, 5), _batches(jd, 5)):
        _same(a, b)


def test_melbin_loader_is_refused(data_root, monkeypatch):
    """``use_melbin`` (refused before slice 14; the test keeps its name):
    without a pack both packages run the Python path; with one (packed by
    the port) both batch natively, the same batches, bit for bit
    (tests/test_torch_melbin.py holds the pack and the reader)."""
    from tortoise_tts_tpu.data import native_loader as jnl
    from tortoise_tts_tpu_torch.data import native_loader as nl
    monkeypatch.setattr(jnl, "SO_PATH", nl.build())
    monkeypatch.setattr(jnl, "_lib", None)
    j, t = _pair(data_root, use_melbin=True)
    for packed in (False, True):
        if packed:
            nl.pack_melbin(sorted((data_root / "data").rglob("*.mel")),
                           data_root / "data.melbin")
        jd, td = (JDataset(j, j.dataset.training),
                  Dataset(t, t.dataset.training))
        assert (td._melbin is not None) == packed
        assert (jd._melbin is not None) == packed
        for a, b in zip(_batches(td, 3), _batches(jd, 3)):
            _same(a, b)
            assert ("mel" in a) != packed
