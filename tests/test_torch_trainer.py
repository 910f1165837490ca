"""``python -m tortoise_tts_tpu_torch.train`` end to end on tiny models on
the CPU: the README's AR + diffusion yaml and the AR-only yaml train,
checkpoint and resume to the parameters of an uninterrupted run; the
REPL's deferred events and ``lr``; the OOM skip and the reload after an
OOM inside the update; the trainer fault the port repairs; checkpoints
crossing between the two packages; ``run_eval`` writing wavs; the
routes of slice 14 (CLVP, BigVGAN, Prodigy) through the trainer's
engines; and the training mesh raising."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.engine import state as jst
from tortoise_tts_tpu_torch import train as train_mod
from tortoise_tts_tpu_torch import models as tmodels
from tortoise_tts_tpu_torch.config import Config
from tortoise_tts_tpu_torch.data import Dataset
from tortoise_tts_tpu_torch.engine import state as st
from tortoise_tts_tpu_torch.engine import train_step as ts
from tortoise_tts_tpu_torch.engine.factory import load_engines
from tortoise_tts_tpu_torch.engine.optim import get_lr_scale
from tortoise_tts_tpu_torch.utils import trainer as tr

from tests.torch_train_util import (CFGS, ar_batch, dvae_torch_layout,
                                    jax_params, port_params, tiny_load_model,
                                    write_dataset)
from tests.torch_train_util import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

README = """
models:
- name: autoregressive
  training: true
- name: diffusion
  training: true
hyperparameters:
  batch_size: 2
  gradient_accumulation_steps: 2
  learning_rate: 1.0e-3
  warmup_steps: 1
  optimizer: AdamW
trainer:
  save_frequency: 2
  iterations: 4
  log_frequency: 1
  weight_dtype: float32
  gradient_checkpointing: true
evaluation:
  frequency: 0
dataset:
  training: [{data}]
  validate: false
  text_bucket: 40
  mel_bucket: 48
  load_mels: true
"""
AR_ONLY = README.replace("- name: diffusion\n  training: true\n", "")


@pytest.fixture()
def env(tmp_path, monkeypatch):
    data = write_dataset(tmp_path)
    params = {n: jax_params(n) for n in ("autoregressive", "diffusion",
                                         "dvae")}
    monkeypatch.setattr(tmodels, "load_model", tiny_load_model(params))
    import tortoise_tts_tpu_torch.engine.factory as fac
    monkeypatch.setattr(fac, "load_model", tiny_load_model(params))
    monkeypatch.setattr(tr, "_non_blocking_input", lambda: "")
    return tmp_path, data, params


def _yaml(root, text, data, name="cfg.yaml"):
    d = root / name.replace(".yaml", "")
    d.mkdir(exist_ok=True)
    (d / "cfg.yaml").write_text(text.format(data=data))
    return d / "cfg.yaml"


def _flat(engines):
    return {f"{n}/{k}": v.clone() for n in engines.names()
            for k, v in st.flatten_tree(engines[n].params).items()}


@pytest.fixture()
def deterministic():
    """Bit-equal runs: the CPU's accumulating index_put (the rel-pos
    tables' gradient) sums in a thread-dependent order otherwise."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("yaml", [README, AR_ONLY], ids=["readme", "ar"])
def test_train_main_resumes_to_the_uninterrupted_params(env, yaml,
                                                        deterministic):
    """The sampler's state and every engine's checkpoint at step 1 (an
    update a step), then a new run to step 2: bit-equal to 2 steps in one
    run."""
    root, data, _ = env
    yaml = (yaml.replace("gradient_accumulation_steps: 2",
                         "gradient_accumulation_steps: 1")
            .replace("save_frequency: 2", "save_frequency: 1")
            .replace("iterations: 4", "iterations: 2"))
    full = _yaml(root, yaml, data, "full.yaml")
    whole = train_mod.main(["--yaml", str(full)], device="cpu")
    assert whole.global_step == 2
    split = _yaml(root, yaml, data, "split.yaml")
    first = train_mod.main(["--yaml", str(split), "--iterations", "1"],
                           device="cpu")
    assert first.global_step == 1
    assert (split.parent / "ckpt" / "sampler.0.state").exists()
    resumed = train_mod.main(["--yaml", str(split)], device="cpu")
    assert resumed.global_step == 2
    a, b = _flat(whole), _flat(resumed)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    names = {"autoregressive", "diffusion"} if "diffusion" in yaml \
        else {"autoregressive"}
    assert set(whole.names()) == names
    for n in names:
        ck = split.parent / "ckpt" / n
        assert (ck / "latest").read_text() == "2"
        assert (ck / "fp32.sft").exists()
        assert int(resumed[n].opt_state["inner"]["count"]) == 2
    log = sorted((full.parent / "logs").rglob("log.txt"))[0].read_text()
    lines = [l for l in log.splitlines() if l]
    assert len(lines) == 2 and "autoregressive.loss.mel" in lines[0]


def test_repl_deferred_events_lr_and_quit(env, monkeypatch):
    root, data, _ = env
    cfg = Config.load(_yaml(root, README, data))
    engines = load_engines(cfg, device="cpu")
    ds = Dataset(cfg, cfg.dataset.training)
    commands = iter(["", "lr 2e-4", "save@3", "event show", "", "quit"])
    monkeypatch.setattr(tr, "_non_blocking_input",
                        lambda: next(commands, ""))
    saved = []
    engines = tr.train_engines(cfg, ds, engines,
                               save_fn=lambda es, step: saved.append(step),
                               max_iterations=10)
    for name in engines.names():
        assert abs(get_lr_scale(engines[name].opt_state) - 0.2) < 1e-6
    # the periodic saves at 2 and 4, save@3 at step 3, quit's at step 5
    assert saved == [2, 3, 4, 5] and engines.global_step == 5


def test_oom_skips_the_batch_and_an_update_oom_reloads(env, monkeypatch):
    root, data, _ = env
    cfg = Config.load(_yaml(root, AR_ONLY, data))
    engines = load_engines(cfg, device="cpu")
    ds = Dataset(cfg, cfg.dataset.training)
    it = ds.batches()
    engines.step(next(it))
    engines.save_checkpoint(cfg.ckpt_dir, mode="sync")
    saved = _flat(engines)
    engines.step(next(it))
    before = _flat(engines)
    e = engines._engines["autoregressive"]
    real_step = e["step"]

    def oom_forward(state, batch):
        raise torch.cuda.OutOfMemoryError("simulated, forward")

    e["step"] = oom_forward
    m = engines.step(next(it))
    assert m == {"autoregressive.skipped": 1.0}
    assert engines.global_step == 2
    after = _flat(engines)
    assert all(torch.equal(before[k], after[k]) for k in before)

    def oom_update(state, batch):
        for t in st.tree_leaves(state.params):
            t.add_(1.0)                          # half written
        state.intact = False
        raise torch.cuda.OutOfMemoryError("simulated, update")

    e["step"] = oom_update
    m = engines.step(next(it))
    assert m == {"autoregressive.skipped": 1.0}
    assert engines.global_step == 1             # rewound to the checkpoint
    now = _flat(engines)
    assert all(torch.equal(saved[k], now[k]) for k in saved)
    e["step"] = real_step
    m = engines.step(next(it))
    assert np.isfinite(m["autoregressive.loss"]) and engines.global_step == 2


def test_update_oom_marks_the_state():
    """An OOM raised inside the optimizer's update leaves the state not
    intact (its tensors may be half written)."""
    class Boom:
        def init(self, params):
            return {}

        def step(self, *args, **kwargs):
            raise torch.cuda.OutOfMemoryError("simulated")

    step = ts.make_ar_train_step(CFGS["autoregressive"][1], Boom())
    state = st.init_state(port_params(jax_params("autoregressive")), Boom())
    with pytest.raises(torch.cuda.OutOfMemoryError):
        step(state, ts.to_device(ar_batch(), "cpu"))
    assert not state.intact and state.step == 0


def test_interrupted_save_error_is_not_masked(env, monkeypatch):
    """The repaired fault: a save that fails inside the KeyboardInterrupt
    handler propagates, and the background writer's later error is only
    logged.  A clean run still raises the writer's error."""
    root, data, _ = env
    cfg = Config.load(_yaml(root, AR_ONLY, data))
    engines = load_engines(cfg, device="cpu")
    ds = Dataset(cfg, cfg.dataset.training)

    def interrupt(batch, fetch_metrics=True):
        raise KeyboardInterrupt

    def bad_save(es, step):
        raise RuntimeError("save failed")

    def writer_error():
        raise RuntimeError("writer failed")

    monkeypatch.setattr(engines, "step", interrupt)
    monkeypatch.setattr(engines, "finish_saves", writer_error)
    with pytest.raises(RuntimeError, match="save failed"):
        tr.train_engines(cfg, ds, engines, save_fn=bad_save)
    # a clean interrupt (the save works) stays fail-loud on the writer
    with pytest.raises(RuntimeError, match="writer failed"):
        tr.train_engines(cfg, ds, engines, save_fn=lambda es, s: None)


def test_checkpoints_cross_between_packages(env):
    """A JAX package checkpoint loads into the port's engine (params and
    counters), and the port's loads into the JAX package's state."""
    root, data, params = env
    cfg = Config.load(_yaml(root, AR_ONLY, data))
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x) + 0.5,
                                params["autoregressive"])
    import optax
    jstate = jst.TrainState(jp, optax.sgd(1e-3).init(jp),
                            jnp.asarray(7, jnp.int32),
                            jnp.asarray(14, jnp.int32),
                            jnp.asarray(99, jnp.int32))
    jst.save_checkpoint(cfg.ckpt_dir, "autoregressive", jstate, 7)
    engines = load_engines(cfg, device="cpu")
    s = engines["autoregressive"]
    assert (s.step, s.samples_processed, s.tokens_processed) == (7, 14, 99)
    assert engines.global_step == 7
    want = {k: np.asarray(v) for k, v in jst.flatten_tree(jp).items()}
    got = st.flatten_tree(s.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # and back: the port's checkpoint into the JAX package
    with torch.no_grad():
        for t in st.tree_leaves(s.params):
            t.mul_(2.0)
    s.step = 9
    st.save_checkpoint(root / "port_ckpt", "autoregressive", s, 9)
    back = jst.load_checkpoint(root / "port_ckpt", "autoregressive", jstate)
    assert int(back.step) == 9 and int(back.tokens_processed) == 99
    for k, v in jst.flatten_tree(back.params).items():
        np.testing.assert_array_equal(np.asarray(v), 2 * want[k], err_msg=k)


def test_model_path_export_loads(env):
    """models[].path with the port's '/'-keyed export restores exactly the
    exported tensors."""
    root, data, params = env
    src = port_params(params["autoregressive"])
    marked = {k: v + 1.0 for k, v in st.flatten_tree(src).items()}
    st.export_weights(marked, root / "ar.sft")
    text = AR_ONLY.replace("- name: autoregressive\n  training: true",
                           "- name: autoregressive\n  training: true\n"
                           f"  path: {root / 'ar.sft'}")
    engines = load_engines(Config.load(_yaml(root, text, data)),
                           device="cpu")
    got = st.flatten_tree(engines["autoregressive"].params)
    for k in marked:
        assert torch.equal(got[k], marked[k]), k


def test_lora_engine_trains_the_adapter_only(env):
    root, data, params = env
    text = AR_ONLY + "loras:\n- name: voice\n  rank: 4\n  alpha: 8\n"
    cfg = Config.load(_yaml(root, text, data))
    engines = load_engines(cfg, device="cpu")
    assert engines.names() == ["voice-r4-a8"]
    before = st.flatten_tree(engines["voice-r4-a8"].params)
    before = {k: v.clone() for k, v in before.items()}
    it = Dataset(cfg, cfg.dataset.training).batches()
    for _ in range(4):
        m = engines.step(next(it))
    assert np.isfinite(m["voice-r4-a8.loss"])
    after = st.flatten_tree(engines["voice-r4-a8"].params)
    assert set(after) == {f"gpt/{n}/{ab}" for n in
                          ("attn_qkv", "attn_proj", "mlp_fc", "mlp_proj")
                          for ab in "ab"}
    assert any(not torch.equal(before[k], after[k]) for k in after)


def test_run_eval_writes_wavs(env, monkeypatch, tmp_path):
    """run_eval on the subtrain and val splits: a wav each and a finite
    mel distance, the AR engine's params decoding."""
    import tortoise_tts_tpu_torch.inference as inf
    from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer
    from tests.torch_tiny import tiny_models
    root, data, params = env
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER", str(
        write_char_tokenizer(tmp_path / "tok" / "tokenizer.json")))
    tiny = tiny_models()
    base = tiny_load_model(params)

    def load(name, dtype="float32", seed=0, device=None):
        if name in params:
            return base(name, dtype, seed, device)
        return tiny[name]
    monkeypatch.setattr(inf, "load_model", load)
    text = AR_ONLY + ("inference:\n  weight_dtype: float32\n"
                      "  text_buckets: [40]\n")
    cfg = Config.load(_yaml(root, text, data))
    cfg = dataclasses.replace(cfg, evaluation=dataclasses.replace(
        cfg.evaluation, kwargs={"max_steps": 8}))
    engines = load_engines(cfg, device="cpu")
    sub = Dataset(cfg, cfg.dataset.training, training=False)
    metrics = {}
    for prefix in ("subtrain", "val"):
        metrics.update(train_mod.run_eval(
            cfg, engines["autoregressive"], sub, tmp_path / "logs",
            max_samples=1, prefix=prefix, device="cpu"))
    assert set(metrics) == {"subtrain.mel_distance", "val.mel_distance"}
    assert all(np.isfinite(v) for v in metrics.values())
    hyps = sorted((tmp_path / "logs" / "0").glob("*_hyp.wav"))
    assert [p.name for p in hyps] == ["subtrain_0_hyp.wav", "val_0_hyp.wav"]

    # a failed generation (a kernel's or the device's error) propagates
    # instead of leaving a metric over fewer samples
    def fail(*args, **kwargs):
        raise RuntimeError("simulated kernel failure")
    monkeypatch.setattr(inf.TTS, "inference", fail)
    with pytest.raises(RuntimeError, match="simulated kernel failure"):
        train_mod.run_eval(cfg, engines["autoregressive"], sub,
                           tmp_path / "logs", max_samples=1, device="cpu")


@pytest.mark.parametrize("edit,match", [
    ({"models": [{"name": "clvp", "training": True}]}, "clvp"),
    ({"models": [{"name": "bigvgan", "training": True}]}, "bigvgan"),
    ({"trainer": {"mesh_shape": [4, 1]}}, "mesh_shape"),
    ({"hyperparameters": {"optimizer": "Prodigy"}}, "Prodigy"),
])
def test_training_routes_not_ported_say_so(env, monkeypatch, edit, match):
    """A mesh of more than one device still raises.  The routes the port
    refused before slice 14 (the test keeps its name) build through
    ``load_engines`` and step on the Dataset's batches: the CLVP engine
    and a Prodigy AR engine move their parameters; the BigVGAN engine's
    feeder refuses a batch without wavs and steps on one with them."""
    from tortoise_tts_tpu_torch.engine import factory as fac
    from tortoise_tts_tpu_torch.models import (DTYPES, LoadedModel,
                                               _bigvgan_random)
    from tortoise_tts_tpu_torch.models import bigvgan as tbv
    from tortoise_tts_tpu_torch.models import bigvgan_disc as bvd
    from tortoise_tts_tpu_torch.models.common import tree_cast
    root, data, params = env
    raw = {"models": [{"name": "autoregressive", "training": True}],
           "dataset": {"training": [str(data)], "validate": False,
                       "text_bucket": 40, "mel_bucket": 48},
           "hyperparameters": {"batch_size": 2, "warmup_steps": 0,
                               "learning_rate": 1e-3,
                               "gradient_accumulation_steps": 1},
           "trainer": {"weight_dtype": "float32"}}
    for k, v in edit.items():
        raw[k] = {**raw[k], **v} if isinstance(v, dict) else v
    cfg = Config.from_dict(raw, yaml_path=str(root / "cfg.yaml"))
    if match == "mesh_shape":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            load_engines(cfg, device="cpu")
        return
    base = tiny_load_model({**params, "clvp": jax_params("clvp")})
    vcfg = tbv.BigVGANConfig(upsample_initial_channel=64)

    def load(name, dtype="float32", seed=0, device=None):
        if name != "bigvgan":
            return base(name, dtype, seed, device)
        g = _bigvgan_random(torch.Generator().manual_seed(0), vcfg)
        return LoadedModel(name, tbv, vcfg, tree_cast(g, DTYPES[dtype]),
                           False)
    monkeypatch.setattr(tmodels, "load_model", load)
    monkeypatch.setattr(fac, "load_model", load)
    small = bvd.DiscriminatorConfig(periods=(2,),
                                    resolutions=((512, 128, 512),))
    monkeypatch.setattr(bvd, "DiscriminatorConfig", lambda: small)
    engines = load_engines(cfg, device="cpu")
    name = "autoregressive" if match == "Prodigy" else match
    assert engines.names() == [name]
    before = [t.clone() for t in st.tree_leaves(engines[name].params)]
    batch = next(Dataset(cfg, cfg.dataset.training).batches())
    if name == "bigvgan":
        with pytest.raises(KeyError, match="wav"):
            engines.step(batch)
        rng = np.random.RandomState(0)
        batch = {"wav": (0.3 * rng.randn(1, 2048)).astype(np.float32)}
    m = engines.step(batch)
    assert np.isfinite(m[f"{name}.loss"])
    after = st.tree_leaves(engines[name].params)
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


def test_model_path_reference_torch_layout_loads(env, tmp_path):
    """models[].path with a reference torch-layout checkpoint (the DVAE's
    dvae.pth keys) converts through models/convert.py."""
    root, data, params = env
    sd = dvae_torch_layout(params["dvae"])
    torch.save({k: v * 2 for k, v in sd.items()}, tmp_path / "dvae.pth")
    text = AR_ONLY.replace(
        "- name: autoregressive\n  training: true",
        f"- name: dvae\n  training: true\n  path: {tmp_path / 'dvae.pth'}")
    engines = load_engines(Config.load(_yaml(root, text, data)),
                           device="cpu")
    got = engines["dvae"].params
    assert torch.equal(got["enc_out"]["w"],
                       2 * torch.as_tensor(params["dvae"]["enc_out"]["w"]))
    assert torch.equal(got["codebook"]["embed"],
                       2 * torch.as_tensor(params["dvae"]["codebook"]
                                           ["embed"]))


def test_training_needs_cuda_or_an_explicit_cpu(env, monkeypatch):
    """No fallback: without a card, training raises unless the caller or
    the config asks for the CPU; detect_grad_anomaly turns on autograd's
    anomaly mode for the run."""
    root, data, _ = env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.load(_yaml(root, AR_ONLY, data))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_engines(cfg)
    assert load_engines(dataclasses.replace(cfg, device="cpu")).names() \
        == ["autoregressive"]
    text = AR_ONLY.replace("  iterations: 4", "  iterations: 1\n"
                           "  detect_grad_anomaly: true")
    try:
        engines = train_mod.main(["--yaml", str(_yaml(root, text, data,
                                                      "anomaly.yaml"))],
                                 device="cpu")
        assert engines.global_step == 1 and torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_single_state_train_loop(env):
    """utils/trainer.train: the single-state loop with its save cadence
    and the final save."""
    root, data, params = env
    cfg = Config.load(_yaml(root, AR_ONLY, data))
    cfg = dataclasses.replace(cfg, hyperparameters=dataclasses.replace(
        cfg.hyperparameters, gradient_accumulation_steps=1))
    from tortoise_tts_tpu_torch.engine.optim import make_optimizer
    tx = make_optimizer(cfg.hyperparameters)
    step = ts.make_ar_train_step(CFGS["autoregressive"][1], tx)
    state = st.init_state(port_params(params["autoregressive"]), tx)
    saved = []
    ds = Dataset(cfg, cfg.dataset.training)
    state = tr.train(cfg, _DeviceBatches(ds), step, state,
                     save_fn=lambda s, n: saved.append(n),
                     max_iterations=3)
    assert state.step == 3 and saved == [2, 3]


class _DeviceBatches:
    """The Dataset's batches as the AR step's tensors."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def batches(self):
        for b in self.ds.batches():
            yield ts.to_device({k: b[k] for k in ("latents", "text",
                                                  "text_lengths", "codes",
                                                  "wav_lengths")}, "cpu")


def test_resize_like_cuts_or_pads_the_leading_dimension():
    """resize_modules: a vocabulary-size change of a loaded leaf is cut or
    zero-padded to the model's; any other mismatch raises."""
    from tortoise_tts_tpu_torch.engine.factory import _resize_like
    template = {"emb": torch.zeros(5, 3), "w": [torch.zeros(2, 2)]}
    got = _resize_like({"emb": torch.ones(4, 3, dtype=torch.float64),
                        "w": [torch.ones(2, 2)]}, template)
    assert got["emb"].dtype == torch.float32
    assert torch.equal(got["emb"][:4], torch.ones(4, 3))
    assert torch.equal(got["emb"][4], torch.zeros(3))
    assert torch.equal(_resize_like({"emb": torch.ones(7, 3),
                                     "w": [torch.ones(2, 2)]},
                                    template)["emb"], torch.ones(5, 3))
    for bad, kw in (({"emb": torch.ones(5, 4), "w": [torch.ones(2, 2)]}, {}),
                    ({"emb": torch.ones(4, 3), "w": [torch.ones(2, 2)]},
                     {"resize": False})):
        with pytest.raises(ValueError):
            _resize_like(bad, template, **kw)
