"""LoRA (``models/lora.py``, ``TTS(lora=...)``, ``enable_lora``) and the
configuration's LoRA group and environment modes (``Config.from_cli``),
against the JAX package on the CPU.

Tolerances: the merged weights 1e-6 (one fp32 einsum each side); the
HiFiGAN route's wav 1e-4, as its test without an adapter; configs, names
and masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pair import make_pair
from tortoise_tts_tpu import inference as jinf
from tortoise_tts_tpu.config import (Config as JConfig,
                                     Inference as JInference,
                                     LoRAConfig as JLoRAConfig)
from tortoise_tts_tpu.engine.state import unflatten_like as junflatten
from tortoise_tts_tpu.inference import TTS as JTTS
from tortoise_tts_tpu.models import lora as jlora
from tortoise_tts_tpu.utils.io import save_state_dict
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch import inference as tinf
from tortoise_tts_tpu_torch.config import Config, Inference, LoRAConfig
from tortoise_tts_tpu_torch.inference import TTS
from tortoise_tts_tpu_torch.models import lora as tlora
from tortoise_tts_tpu_torch.utils.state import unflatten_like

RANK = 4


def _adapter(ar_params, rank, seed=0):
    """A random adapter, both factors non-zero, as flat numpy arrays
    named as the JAX package's checkpoints name them."""
    rng = np.random.RandomState(seed)
    flat = {}
    for name in tlora.GPT_TARGETS:
        n_layers, d_in, d_out = ar_params["gpt"][name]["w"].shape
        flat[f"gpt/{name}/a"] = (0.1 * rng.randn(n_layers, d_in, rank)) \
            .astype(np.float32)
        flat[f"gpt/{name}/b"] = (0.1 * rng.randn(n_layers, rank, d_out)) \
            .astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("lora")
    jtts, ttts, ref, params = make_pair(tmp, mp)
    # the fixed voice as explicit latents: the TTS made in _fresh encode
    # nothing
    latents = jtts.encode_audio(ref)["latent"]
    path = tmp / "adapter.sft"
    save_state_dict(_adapter(params["autoregressive"], RANK), path)
    yield jtts, ttts, latents, params, path
    mp.undo()


def test_init_lora_matches_jax(pair):
    _, _, _, params, _ = pair
    tp = params["autoregressive"]
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tp))
    got = tlora.init_lora(torch.Generator().manual_seed(0), tp, rank=RANK)
    want = jlora.init_lora(jax.random.PRNGKey(0), jp, rank=RANK)
    assert set(got["gpt"]) == set(want["gpt"]) == set(tlora.GPT_TARGETS)
    for name, ab in got["gpt"].items():
        for k in ("a", "b"):
            w = want["gpt"][name][k]
            assert tuple(ab[k].shape) == w.shape
            assert ab[k].dtype == torch.float32 and w.dtype == jnp.float32
        bound = 1.0 / np.sqrt(ab["a"].shape[1])
        assert float(ab["a"].abs().max()) <= bound
        assert not ab["b"].any()
        assert not np.asarray(want["gpt"][name]["b"]).any()


def test_merge_lora_matches_jax(pair):
    _, _, _, params, _ = pair
    tp = params["autoregressive"]
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tp))
    flat = _adapter(tp, RANK, seed=1)
    tl = {"gpt": {n: {k: torch.from_numpy(flat[f"gpt/{n}/{k}"])
                      for k in "ab"} for n in tlora.GPT_TARGETS}}
    jl = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tl))
    got = tlora.merge_lora(tp, tl, alpha=8, rank=RANK)
    want = jlora.merge_lora(jp, jl, alpha=8, rank=RANK)
    for name in tlora.GPT_TARGETS:
        np.testing.assert_allclose(got["gpt"][name]["w"].numpy(),
                                   np.asarray(want["gpt"][name]["w"]),
                                   atol=1e-6, rtol=1e-6)
        assert got["gpt"][name]["w"] is not tp["gpt"][name]["w"]
    # the input trees stay as they were; untouched leaves are shared
    assert got["gpt"]["ln_1"] is tp["gpt"]["ln_1"]
    assert tlora.apply_lora(tp, None) is tp


def test_unflatten_like_matches_jax(pair):
    _, _, _, params, _ = pair
    tree = tlora.init_lora(torch.Generator().manual_seed(0),
                           params["autoregressive"], rank=RANK)
    flat = _adapter(params["autoregressive"], RANK, seed=2)
    del flat["gpt/mlp_fc/b"]
    got = unflatten_like(tree, flat, strict=False)
    jtree = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tree))
    want = junflatten(jtree, flat, strict=False)
    for name in tlora.GPT_TARGETS:
        for k in "ab":
            np.testing.assert_array_equal(got["gpt"][name][k].numpy(),
                                          np.asarray(want["gpt"][name][k]))
    assert torch.equal(got["gpt"]["mlp_fc"]["b"], tree["gpt"]["mlp_fc"]["b"])
    with pytest.raises(KeyError, match="gpt/mlp_fc/b"):
        unflatten_like(tree, flat)
    flat["gpt/mlp_fc/b"] = np.zeros((1, 1), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        unflatten_like(tree, flat)


def _fresh(pair, monkeypatch, **port_kw):
    """A JAX and a port TTS whose AR models still load (through the
    patched loaders) and so take the adapter."""
    jtts, ttts, latents, params, path = pair
    jbase = jtts._models["autoregressive"]
    tbase = ttts._models["autoregressive"]
    monkeypatch.setattr(jinf, "load_model",
                        lambda name, dtype="float32": jbase)
    monkeypatch.setattr(tinf, "load_model",
                        lambda name, dtype, device=None: tbase)
    inf = dict(weight_dtype="float32", text_buckets=(32, 64))
    j = JTTS(config=JConfig(inference=JInference(**inf), loras=(
        JLoRAConfig(path=str(path), training=False, rank=RANK, alpha=8),)),
        dtype="float32")
    j._models = {k: v for k, v in jtts._models.items()
                 if k != "autoregressive"}
    t = TTS(Config(inference=Inference(**inf)), device="cpu",
            dtype="float32", **port_kw)
    t._models = {k: v for k, v in ttts._models.items()
                 if k != "autoregressive"}
    return j, t, tbase, latents


def test_tts_lora_matches_jax(pair, monkeypatch):
    """``TTS(lora=LoRAConfig(path=...))`` merges the adapter written to
    disk as the JAX TTS merges its ``Config.loras``; the HiFiGAN route on
    the merged weights, greedy, against the JAX TTS's."""
    _, _, _, _, path = pair
    j, t, tbase, latents = _fresh(pair, monkeypatch, lora=LoRAConfig(
        path=str(path), training=False, rank=RANK, alpha=8))
    assert t.cfg.lora.path == str(path)
    got = t._model("autoregressive")
    want = j._model("autoregressive")
    assert got.from_checkpoint and want.from_checkpoint
    for name in tlora.GPT_TARGETS:
        w = got.params["gpt"][name]["w"]
        assert not torch.equal(w, tbase.params["gpt"][name]["w"])
        np.testing.assert_allclose(w.numpy(),
                                   np.asarray(want.params["gpt"][name]["w"]),
                                   atol=1e-6, rtol=1e-6)
    kw = dict(max_ar_steps=40, vocoder_type="hifigan", greedy=True, seed=1,
              conditioning_latents=latents)
    jwav, _ = j.inference("hello world, a test.", **kw)
    twav, _ = t.inference("hello world, a test.", **kw)
    assert twav.shape == jwav.shape and np.isfinite(twav).all()
    np.testing.assert_allclose(twav, jwav, atol=1e-4)


def test_enable_and_disable_lora(pair, monkeypatch):
    """Toggling swaps the AR weights and drops the int8 decode weights made
    from the old ones; the greedy decode follows the weights.  A missing
    explicit adapter file raises."""
    _, _, _, _, path = pair
    _, t, tbase, _ = _fresh(pair, monkeypatch, lora=LoRAConfig(
        path=str(path), rank=RANK, alpha=8))

    def codes():
        res, _, _ = t._decode_codes(
            "hi there", torch.zeros(1, 64),
            tinf.SamplingConfig(greedy=True), 24, tinf._host_keys(0, 1)[0])
        return res.codes
    merged = t._model("autoregressive")
    q_merged = t._ar_qgpt()
    with_lora = codes()
    t.disable_lora()
    assert t._model("autoregressive") is tbase and t._qgpt is None
    assert t._ar_qgpt() is not q_merged
    base = codes()
    t.enable_lora()
    assert t._qgpt is None
    again = t._model("autoregressive")
    assert again is not merged and again.from_checkpoint
    for name in tlora.GPT_TARGETS:
        assert torch.equal(again.params["gpt"][name]["w"],
                           merged.params["gpt"][name]["w"])
    assert torch.equal(codes(), with_lora)
    assert not torch.equal(base, with_lora)
    missing = TTS(Config(), lora=str(path) + ".absent", device="cpu")
    missing._ar_plain = tbase
    with pytest.raises(FileNotFoundError, match="absent"):
        missing._model("autoregressive")


def test_config_from_cli_and_environment(tmp_path, monkeypatch):
    """``--yaml`` / ``--model`` / ``--lora`` and their ``TORTOISE_*``
    defaults, read alike by both packages; ``TTS()`` takes them from the
    environment."""
    yml = tmp_path / "c.yaml"
    yml.write_text("inference:\n  decode_quant: w8a8\n  text_buckets: "
                   "[16, 32]\nloras:\n  - name: spk\n    rank: 8\n"
                   "    alpha: 4\ntrainer:\n  seed: 3\n")
    sft = tmp_path / "m.sft"
    save_state_dict({"x": np.zeros(1, np.float32)}, sft, metadata={
        "config": {"inference": {"decode_quant": "none"}}})
    lora = tmp_path / "lora.sft"

    def same(args):
        got, want = Config.from_cli(args), JConfig.from_cli(args)
        assert got.inference.decode_quant == want.inference.decode_quant
        assert got.inference.text_buckets == want.inference.text_buckets
        assert len(got.loras) == len(want.loras)
        for a, b in zip(got.loras, want.loras):
            assert (a.name, a.rank, a.alpha, a.path, a.full_name) == \
                (b.name, b.rank, b.alpha, b.path, b.full_name)
        assert got.ckpt_dir == want.ckpt_dir
        return got

    for var in ("TORTOISE_YAML", "TORTOISE_MODEL", "TORTOISE_LORA"):
        monkeypatch.delenv(var, raising=False)
    assert same([]).lora is None
    assert same(["--yaml", str(yml)]).lora.full_name == "spk-r8-a4"
    assert same([f"yaml={yml}"]).inference.decode_quant == "w8a8"
    assert same(["--model", str(sft)]).inference.decode_quant == "none"
    monkeypatch.setenv("TORTOISE_YAML", str(yml))
    monkeypatch.setenv("TORTOISE_LORA", str(lora))
    cfg = same([])
    assert cfg.lora.path == str(lora) and not cfg.lora.training
    assert cfg.inference.text_buckets == (16, 32)
    monkeypatch.setenv("TORTOISE_MODEL", str(sft))
    assert same([]).inference.decode_quant == "none"
    tts = TTS(device="cpu")
    assert tts.cfg.inference.decode_quant == "none"
    assert tts.cfg.lora.path == str(lora)
