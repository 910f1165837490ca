"""Reference checkpoints into the port: ``models/convert.py`` against the
JAX package's converters, and ``load_model`` reading ``.pth`` and
``.safetensors`` files from ``$TORTOISE_TPU_MODELS``.

Each model's parameters (the JAX package's ``init`` at a tiny config; the
port's own init for BigVGAN, whose JAX init takes half a minute on the
CPU, and whose structure the bridge tests pin to the JAX package's) go
into a reference-layout state dict by a test-local inverse of the
converters' rules: a linear transposed to (out, in), HF Conv1D weights
and convolutions as they are, norms as weight/bias, embeddings as weight,
and for the vocoders weight-norm pairs with g = ||v||.  The port's
converter must give the JAX converter's tree leaf for leaf
(``np.array_equal``) and the parameters back: exactly, or within fp32
rounding where the weight norm is folded.
"""

import json

import jax
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models import _hifigan_random as jax_hifigan_random
from tortoise_tts_tpu.models import clvp as jclvp
from tortoise_tts_tpu.models import convert as jconvert
from tortoise_tts_tpu.models import diffusion as jdiff
from tortoise_tts_tpu.models import hifigan as jhg
from tortoise_tts_tpu.models import rlg as jrlg
from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu_torch import bridge, models
from tortoise_tts_tpu_torch.models import (_bigvgan_random, bigvgan,
                                           convert)
from tortoise_tts_tpu_torch.utils import io

KEY = jax.random.PRNGKey(0)
UV = dict(layers=2, model_dim=64, heads=4, max_text_tokens=20,
          max_mel_tokens=30)
DIFF = dict(model_channels=32, num_layers=2, in_latent_channels=64,
            num_heads=2)
CL = dict(dim_text=32, dim_speech=32, dim_latent=32, text_enc_depth=2,
          speech_enc_depth=2, text_heads=2, speech_heads=2, dim_head=16,
          rotary_dim=16)
HG = dict(in_channels=64, upsample_initial_channel=32, cond_channels=64)
BV = dict(upsample_initial_channel=64)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the inverse of convert.py's rules ---------------------------------------


def _lin(sd, prefix, p, transpose=True):
    sd[prefix + ".weight"] = p["w"].T if transpose else p["w"]
    if "b" in p:
        sd[prefix + ".bias"] = p["b"]


def _conv(sd, prefix, p):
    _lin(sd, prefix, p, transpose=False)


def _norm(sd, prefix, p):
    sd[prefix + ".weight"] = p["scale"]
    if "bias" in p:
        sd[prefix + ".bias"] = p["bias"]


def _attn(sd, prefix, p):
    _norm(sd, prefix + ".norm", p["norm"])
    _conv(sd, prefix + ".qkv", p["qkv"])
    _conv(sd, prefix + ".proj_out", p["proj_out"])
    if "rel_pos" in p:
        sd[prefix + ".relative_pos_embeddings.relative_attention_bias"
           ".weight"] = p["rel_pos"]["w"]


def _ts_res(sd, prefix, p):
    _norm(sd, prefix + ".in_layers.0", p["in_norm"])
    _conv(sd, prefix + ".in_layers.2", p["in_conv"])
    _lin(sd, prefix + ".emb_layers.1", p["emb"])
    _norm(sd, prefix + ".out_layers.0", p["out_norm"])
    _conv(sd, prefix + ".out_layers.3", p["out_conv"])


def _weight_norm(sd):
    """Every convolution weight as a torch weight_norm(dim=0) pair."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 3:
            base = k[:-len(".weight")]
            out[base + ".weight_g"] = np.sqrt(
                (v.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True)
            ).astype(np.float32)
            out[base + ".weight_v"] = v
        else:
            out[k] = v
    return out


def uv_sd(p):
    sd = {}
    for i in range(len(p["gpt"]["ln_1"]["scale"])):
        h = f"gpt.h.{i}"
        layer = {n: {k: t[i] for k, t in p["gpt"][n].items()}
                 for n in p["gpt"] if n != "ln_f"}
        _norm(sd, h + ".ln_1", layer["ln_1"])
        _norm(sd, h + ".ln_2", layer["ln_2"])
        for name, ref in (("attn_qkv", "attn.c_attn"),
                          ("attn_proj", "attn.c_proj"),
                          ("mlp_fc", "mlp.c_fc"), ("mlp_proj", "mlp.c_proj")):
            _conv(sd, f"{h}.{ref}", layer[name])      # HF Conv1D: (in, out)
    _norm(sd, "gpt.ln_f", p["gpt"]["ln_f"])
    ce = p["conditioning_encoder"]
    _conv(sd, "conditioning_encoder.init", ce["init"])
    for i, a in enumerate(ce["attn"]):
        _attn(sd, f"conditioning_encoder.attn.{i}", a)
    for name, ref in (("text_embedding", "text_embedding"),
                      ("mel_embedding", "mel_embedding"),
                      ("text_pos_embedding", "text_pos_embedding.emb"),
                      ("mel_pos_embedding", "mel_pos_embedding.emb")):
        sd[ref + ".weight"] = p[name]["w"]
    _norm(sd, "final_norm", p["final_norm"])
    _lin(sd, "text_head", p["text_head"])
    _lin(sd, "mel_head", p["mel_head"])
    return sd


def diffusion_sd(p):
    sd = {}
    _conv(sd, "inp_block", p["inp_block"])
    _lin(sd, "time_embed.0", p["time_embed_0"])
    _lin(sd, "time_embed.2", p["time_embed_2"])
    sd["code_embedding.weight"] = p["code_embedding"]["w"]
    for i, a in enumerate(p["code_converter"]):
        _attn(sd, f"code_converter.{i}", a)
    _norm(sd, "code_norm", p["code_norm"])
    _conv(sd, "latent_conditioner.0", p["latent_conditioner_conv"])
    for i, a in enumerate(p["latent_conditioner_attn"]):
        _attn(sd, f"latent_conditioner.{i + 1}", a)
    _conv(sd, "contextual_embedder.0", p["contextual_embedder_conv0"])
    _conv(sd, "contextual_embedder.1", p["contextual_embedder_conv1"])
    for i, a in enumerate(p["contextual_embedder_attn"]):
        _attn(sd, f"contextual_embedder.{i + 2}", a)
    sd["unconditioned_embedding"] = p["unconditioned_embedding"]
    for i, lyr in enumerate(p["conditioning_timestep_integrator"]):
        _ts_res(sd, f"conditioning_timestep_integrator.{i}.resblk",
                lyr["resblk"])
        _attn(sd, f"conditioning_timestep_integrator.{i}.attn", lyr["attn"])
    _conv(sd, "integrating_conv", p["integrating_conv"])
    _conv(sd, "mel_head", p["mel_head"])
    n = len(p["layers"])
    for i, lyr in enumerate(p["layers"]):
        _ts_res(sd, f"layers.{i}.resblk", lyr["resblk"])
        _attn(sd, f"layers.{i}.attn", lyr["attn"])
    for i, blk in enumerate(p["final_res"]):
        _ts_res(sd, f"layers.{n + i}", blk)
    _norm(sd, "out.0", p["out_norm"])
    _conv(sd, "out.2", p["out_conv"])
    return sd


def clvp_sd(p):
    sd = {"text_emb.weight": p["text_emb"]["w"],
          "speech_emb.weight": p["speech_emb"]["w"],
          "temperature": p["temperature"]}
    _lin(sd, "to_text_latent", p["to_text_latent"])
    _lin(sd, "to_speech_latent", p["to_speech_latent"])
    for tower in ("text_transformer", "speech_transformer"):
        t = f"{tower}.transformer"
        for i, lyr in enumerate(p[tower]["layers"]):
            la = f"{t}.attn_layers.layers.{2 * i}"
            lf = f"{t}.attn_layers.layers.{2 * i + 1}"
            sd[la + ".0.0.g"] = lyr["attn_norm"]["scale"]
            sd[lf + ".0.0.g"] = lyr["ff_norm"]["scale"]
            for n in ("to_q", "to_k", "to_v", "to_out"):
                _lin(sd, f"{la}.1.wrap.{n}", lyr[n])
            _lin(sd, lf + ".1.wrap.net.0.proj", lyr["ff_proj"])
            _lin(sd, lf + ".1.wrap.net.3", lyr["ff_out"])
        _norm(sd, t + ".norm", p[tower]["final_norm"])
    return sd


def rlg_sd(p):
    sd = {}
    for i, lyr in enumerate(p["equal_linears"]):
        sd[f"layers.{i}.weight"], sd[f"layers.{i}.bias"] = lyr["w"], lyr["b"]
    _lin(sd, "layers.5", p["final"])
    return sd


def hifigan_sd(p):
    sd = {}
    for name in ("conv_pre", "conv_post", "cond_layer"):
        _conv(sd, name, p[name])
    for i, u in enumerate(p["ups"]):
        _conv(sd, f"ups.{i}", u)
    for i, rb in enumerate(p["resblocks"]):
        for conv in ("convs1", "convs2"):
            for j, c in enumerate(rb[conv]):
                _conv(sd, f"resblocks.{i}.{conv}.{j}", c)
    return _weight_norm(sd)


def bigvgan_sd(p):
    sd = {}

    def snake(prefix, s):
        sd[prefix + ".act.alpha"], sd[prefix + ".act.beta"] = \
            s["alpha"], s["beta"]
    _conv(sd, "conv_pre", p["conv_pre"])
    _conv(sd, "conv_post", p["conv_post"])
    for i, u in enumerate(p["ups"]):
        _conv(sd, f"ups.{i}.0", u)
    snake("activation_post", p["activation_post"])
    for i, rb in enumerate(p["resblocks"]):
        for conv in ("convs1", "convs2"):
            for j, c in enumerate(rb[conv]):
                _conv(sd, f"resblocks.{i}.{conv}.{j}", c)
        for j, s in enumerate(rb["activations"]):
            snake(f"resblocks.{i}.activations.{j}", s)
    return _weight_norm(sd)


def _bigvgan_params():
    return bridge.to_numpy(_bigvgan_random(
        torch.Generator().manual_seed(0), bigvgan.BigVGANConfig(**BV)))


CASES = {
    "autoregressive": (lambda: _np(juv.init(KEY, juv.UnifiedVoiceConfig(**UV))),
                       uv_sd, lambda sd, m: m.convert_unified_voice(
                           sd, UV["layers"]), True),
    "diffusion": (lambda: _np(jdiff.init(KEY, jdiff.DiffusionConfig(**DIFF))),
                  diffusion_sd, lambda sd, m: m.convert_diffusion(
                      sd, DIFF["num_layers"]), True),
    "clvp": (lambda: _np(jclvp.init(KEY, jclvp.CLVPConfig(**CL))), clvp_sd,
             lambda sd, m: m.convert_clvp(sd, CL["text_enc_depth"]), True),
    "rlg": (lambda: _np(jrlg.init(KEY, 48)), rlg_sd,
            lambda sd, m: m.convert_rlg(sd), True),
    "hifigan": (lambda: _np(jax_hifigan_random(KEY, jhg.HifiganConfig(**HG))),
                hifigan_sd, lambda sd, m: m.convert_hifigan(sd), False),
    "bigvgan": (_bigvgan_params, bigvgan_sd,
                lambda sd, m: m.convert_bigvgan(sd), False),
}


def _leaves_equal(a, b, exact=True):
    sa = jax.tree_util.tree_structure(a)
    assert sa == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        if exact:
            assert np.array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(CASES))
def test_converters_match_jax_and_roundtrip(name):
    make, to_sd, conv, exact = CASES[name]
    params = make()
    sd = to_sd(params)
    got = conv(sd, convert)
    _leaves_equal(got, conv(sd, jconvert))           # leaf for leaf
    _leaves_equal(got, params, exact=exact)          # back to init
    # torch tensors in (what torch.load gives), bf16 included
    tsd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    _leaves_equal(conv(tsd, convert), got)
    some = next(k for k, v in tsd.items() if v.dtype == torch.float32)
    tsd[some] = tsd[some].to(torch.bfloat16)
    assert conv(tsd, convert) is not None


def _save_pth(path, sd, key=None):
    tsd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    torch.save({key: tsd} if key else tsd, path)


def _save_safetensors(path, sd):
    from safetensors.torch import save_file
    save_file({k: torch.from_numpy(np.array(v, order="C"))
               for k, v in sd.items()},
              str(path))


@pytest.fixture
def model_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TORTOISE_TPU_MODELS", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("fmt", ["pth", "safetensors"])
def test_load_model_reads_checkpoints(model_dir, fmt):
    """rlg_auto at its shipped width (1024) from a .pth and from a
    .safetensors file; the safetensors read agrees with the safetensors
    package tensor for tensor."""
    params = _np(jrlg.init(KEY, 1024))
    sd = rlg_sd(params)
    path = model_dir / f"rlg_auto.{fmt}"
    if fmt == "pth":
        _save_pth(path, sd)
    else:
        _save_safetensors(path, sd)
        from safetensors.torch import load_file
        want = load_file(str(path))
        got = io.load_state_dict(path)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k])
    m = models.load_model("rlg_auto", device="cpu")
    assert m.from_checkpoint and m.config == 1024
    _leaves_equal(bridge.to_numpy(m.params), params)
    m16 = models.load_model("rlg_auto", dtype="bfloat16", device="cpu")
    assert m16.params["final"]["w"].dtype == torch.bfloat16


def test_load_model_bigvgan_generator_and_json(model_dir):
    """BigVGAN's weights under 'generator', its config from the .json
    beside them (here a narrow one)."""
    params = _bigvgan_params()
    _save_pth(model_dir / "bigvgan_24khz_100band.pth", bigvgan_sd(params),
              key="generator")
    cfg = bigvgan.BigVGANConfig(**BV)
    (model_dir / "bigvgan_24khz_100band.json").write_text(json.dumps({
        "num_mels": cfg.num_mels, "upsample_rates": cfg.upsample_rates,
        "upsample_kernel_sizes": cfg.upsample_kernel_sizes,
        "upsample_initial_channel": 64, "resblock": "1",
        "resblock_kernel_sizes": cfg.resblock_kernel_sizes,
        "resblock_dilation_sizes": cfg.resblock_dilation_sizes,
        "activation": "snakebeta", "snake_logscale": True,
        "hop_size": 256}))
    m = models.load_model("bigvgan", device="cpu")
    assert m.from_checkpoint and m.config == cfg
    _leaves_equal(bridge.to_numpy(m.params), params, exact=False)


@pytest.mark.parametrize("what", ["garbage_pth", "truncated_safetensors",
                                  "missing_key"])
def test_unreadable_checkpoint_raises(model_dir, what):
    """Where the JAX package logs a warning and serves random weights, the
    port raises and names the file."""
    sd = rlg_sd(_np(jrlg.init(KEY, 1024)))
    if what == "garbage_pth":
        (model_dir / "rlg_auto.pth").write_bytes(b"not a checkpoint" * 64)
        match = "cannot read"
    elif what == "truncated_safetensors":
        path = model_dir / "rlg_auto.safetensors"
        _save_safetensors(path, sd)
        path.write_bytes(path.read_bytes()[:1000])
        match = "cannot read"
    else:
        del sd["layers.5.weight"]
        _save_pth(model_dir / "rlg_auto.pth", sd)
        match = "does not convert"
    with pytest.raises(RuntimeError, match=match) as e:
        models.load_model("rlg_auto", device="cpu")
    assert "rlg_auto." in str(e.value)
