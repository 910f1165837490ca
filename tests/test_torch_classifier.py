"""The audio classifier and its building blocks (``models/arch.py``'s
Upsample, Downsample, ResBlock and AudioMiniEncoder, ``models/
classifier.py``, ``convert_classifier``, the registry and the bridge)
against the JAX package on the CPU, fp32, the same weights on both
sides (the JAX package's inits carried over by the bridge, the
zero-initialised out convs and attention projections made random so
every block reaches the output).  The JAX attention block takes its
plain [GroupNorm + qkv conv] head on the CPU, as the JAX tests run it;
the port's takes K4's plain version.

Tolerance: 1e-4 (absolute and relative) on fp32 forwards, where only the
order of sums differs; the converters and the bridge are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models import arch as jarch
from tortoise_tts_tpu.models import classifier as jclf
from tortoise_tts_tpu.models import convert as jconvert
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.models import arch, classifier, convert

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(atol=1e-4, rtol=1e-4)
TINY = dict(classes=3, spec_dim=1, embedding_dim=32, base_channels=8,
            depth=2, resnet_blocks=2, attn_blocks=2, num_attn_heads=2,
            downsample_factor=4, kernel_size=5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_zeros(tree, rng, scale=0.05):
    """Every all-zero floating leaf (the zero_module'd out convs and
    attention projections) made random, in place."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                _randomize_zeros(v, rng, scale)
            elif np.asarray(v).dtype.kind == "f" and not np.any(v):
                tree[k] = (rng.randn(*np.shape(v)) * scale).astype(np.float32)
    elif isinstance(tree, list):
        for v in tree:
            _randomize_zeros(v, rng, scale)
    return tree


def _params(cfg_kw, seed):
    jcfg = jclf.ClassifierConfig(**cfg_kw)
    p = _randomize_zeros(_np(jclf.init(jax.random.PRNGKey(seed), jcfg)),
                         np.random.RandomState(seed))
    return jcfg, classifier.ClassifierConfig(**cfg_kw), p


def _audio(b, t, seed):
    return (np.random.RandomState(seed).randn(b, 1, t) * 0.3) \
        .astype(np.float32)


@pytest.mark.parametrize("use_conv", [False, True])
def test_upsample_and_downsample_match_jax(use_conv):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 37).astype(np.float32)
    pu = _np(jarch.upsample_init(jax.random.PRNGKey(1), 8, use_conv, 12))
    pd = _np(jarch.downsample_init(jax.random.PRNGKey(2), 8, use_conv, 12))
    got = arch.upsample(bridge.to_torch(pu), torch.from_numpy(x))
    want = jarch.upsample(pu, jnp.asarray(x))
    assert got.shape == want.shape == ((2, 12, 148) if use_conv
                                       else (2, 8, 148))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = arch.downsample(bridge.to_torch(pd), torch.from_numpy(x),
                          use_conv=use_conv)
    want = jarch.downsample(pd, jnp.asarray(x), use_conv=use_conv)
    assert got.shape == want.shape == ((2, 12, 10) if use_conv
                                       else (2, 8, 9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("out_ch,use_conv,k", [(16, False, 3), (32, True, 5),
                                              (32, False, 5)])
def test_res_block_matches_jax(out_ch, use_conv, k):
    """The ResBlock, with a skip conv where the width changes (1x1, or of
    the block's kernel with ``use_conv``)."""
    p = _randomize_zeros(_np(jarch.res_block_init(
        jax.random.PRNGKey(3), 16, out_ch, use_conv, k)),
        np.random.RandomState(3))
    assert ("skip" in p) == (out_ch != 16)
    x = np.random.RandomState(4).randn(2, 16, 45).astype(np.float32)
    got = arch.res_block(bridge.to_torch(p), torch.from_numpy(x), k)
    want = jarch.res_block(p, jnp.asarray(x), k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_audio_mini_encoder_matches_jax():
    """Two stride-4 stages of two res blocks, two attention blocks of two
    heads over the 512 frames left of 8192 samples."""
    _, _, p = _params(TINY, 5)
    x = _audio(2, 8192, 6)
    got = arch.audio_mini_encoder(bridge.to_torch(p["enc"]),
                                  torch.from_numpy(x), 2, 5, 4)
    want = jarch.audio_mini_encoder(p["enc"], jnp.asarray(x), 2, 5, 4)
    assert got.shape == want.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("widths,t", [("tiny", 8192), ("published", 4096)])
def test_classifier_matches_jax(widths, t):
    """Logits of the classifier: tiny, and at the published widths (base
    32, depth 5, C = 1024 before the 512-wide attention blocks) over
    4096 samples (4 frames at the attention)."""
    kw = TINY if widths == "tiny" else {}
    jcfg, cfg, p = _params(kw, 7)
    x = _audio(2, t, 8)
    tp = bridge.classifier_from_jax(p)
    got = classifier.forward(tp, torch.from_numpy(x), cfg)
    want = jclf.forward(p, jnp.asarray(x), jcfg)
    assert got.shape == want.shape == (2, cfg.classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _torch_layout(p):
    """The reference classifier.pth state dict of a params tree."""
    sd = {}

    def t(a):
        return torch.from_numpy(np.array(a))

    def conv(prefix, c):
        sd[prefix + ".weight"] = t(c["w"])
        if "b" in c:
            sd[prefix + ".bias"] = t(c["b"])

    def norm(prefix, n):
        sd[prefix + ".weight"], sd[prefix + ".bias"] = t(n["scale"]), \
            t(n["bias"])

    enc = p["enc"]
    conv("enc.init.0", enc["init"])
    for i, blk in enumerate(enc["res"]):
        if "down" in blk:
            conv(f"enc.res.{i}.op", blk["down"]["op"])
            continue
        r = blk["res"]
        norm(f"enc.res.{i}.in_layers.0", r["in_norm"])
        conv(f"enc.res.{i}.in_layers.2", r["in_conv"])
        norm(f"enc.res.{i}.out_layers.0", r["out_norm"])
        conv(f"enc.res.{i}.out_layers.3", r["out_conv"])
    norm("enc.final.0", enc["final_norm"])
    conv("enc.final.2", enc["final_conv"])
    for i, a in enumerate(enc["attn"]):
        norm(f"enc.attn.{i}.norm", a["norm"])
        conv(f"enc.attn.{i}.qkv", a["qkv"])
        conv(f"enc.attn.{i}.proj_out", a["proj_out"])
    sd["head.weight"] = t(np.asarray(p["head"]["w"]).T)
    sd["head.bias"] = t(p["head"]["b"])
    return sd


def _assert_trees_equal(a, b, path="root"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def test_convert_classifier_matches_jax():
    """A fabricated classifier.pth at the published depth (15 enc.res
    entries, the (32, 1, 3) raw-audio init conv) converts to the same
    tree in both packages, which is the tree it was made from."""
    g = torch.Generator().manual_seed(9)
    p = bridge.to_numpy(classifier.init(g))
    sd = _torch_layout(p)
    assert sd["enc.init.0.weight"].shape == (32, 1, 3)
    assert sum(k.endswith(".op.weight") for k in sd) == 5
    got = convert.convert_classifier(sd)
    _assert_trees_equal(got, jconvert.convert_classifier(sd))
    _assert_trees_equal(got, p)
    tp = bridge.classifier_from_jax(got)
    assert tp["enc"]["final_conv"]["w"].shape == (512, 1024, 1)
    assert tp["head"]["w"].shape == (512, 2)


def test_registry_and_tts_return_the_classifier(tmp_path, monkeypatch):
    """``load_model("classifier")`` builds the published architecture
    (from a seed, or from a classifier.pth in the model directory, through
    ``convert_classifier``) and ``TTS._model("classifier")`` returns it."""
    from tortoise_tts_tpu_torch.inference import TTS
    from tortoise_tts_tpu_torch.models import load_model
    from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer
    monkeypatch.setenv("TORTOISE_TPU_MODELS", str(tmp_path))
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER",
                       str(write_char_tokenizer(tmp_path / "tok.json")))
    m = load_model("classifier", device="cpu")
    assert m.name == "classifier" and m.module is classifier
    assert m.config == classifier.ClassifierConfig() and not \
        m.from_checkpoint
    jshapes = jax.tree_util.tree_map(
        lambda a: a.shape, jclf.init(jax.random.PRNGKey(0)))
    tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                     bridge.to_numpy(m.params))
    assert jshapes == tshapes
    logits = m.module.forward(m.params, torch.zeros(1, 1, 2048), m.config)
    assert logits.shape == (1, 2) and torch.isfinite(logits).all()
    sd = _torch_layout(bridge.to_numpy(m.params))
    sd["head.bias"] = torch.tensor([0.25, -0.5])
    torch.save(sd, tmp_path / "classifier.pth")
    ck = load_model("classifier", device="cpu")
    assert ck.from_checkpoint
    assert torch.equal(ck.params["head"]["b"], sd["head.bias"])
    assert torch.equal(ck.params["enc"]["res"][14]["down"]["op"]["w"],
                       m.params["enc"]["res"][14]["down"]["op"]["w"])
    tts = TTS(device="cpu", dtype="float32")
    got = tts._model("classifier")
    assert got.module is classifier and got.from_checkpoint


def test_bridge_rejects_foreign_classifier_trees():
    p = bridge.to_numpy(classifier.init(torch.Generator().manual_seed(0),
                                        classifier.ClassifierConfig(
                                            **TINY)))
    with pytest.raises(KeyError, match="classifier params"):
        bridge.classifier_from_jax({"enc": p["enc"]})
    bad = {**p, "enc": {**p["enc"], "res": p["enc"]["res"] + [{"x": 1}]}}
    with pytest.raises(KeyError, match="res entry"):
        bridge.classifier_from_jax(bad)
