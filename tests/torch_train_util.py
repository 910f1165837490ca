"""Shared pieces of the training parity tests: tiny configs of the three
trainable models in both packages, the same weights on both sides (made
by the JAX package's inits, carried over by the bridge) and fabricated
reference-format .mel artifacts."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models import diffusion as jdiff
from tortoise_tts_tpu.models import dvae as jdvae
from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.models import diffusion as tdiff
from tortoise_tts_tpu_torch.models import dvae as tdvae
from tortoise_tts_tpu_torch.models import unified_voice as tuv

UV = dict(layers=2, model_dim=64, heads=4, max_text_tokens=40,
          max_mel_tokens=48)
DIFF = dict(model_channels=64, num_layers=2, in_latent_channels=64,
            num_heads=4)
DVAE = dict(codebook_dim=32, hidden_dim=32)
CFGS = {"autoregressive": (juv.UnifiedVoiceConfig(**UV),
                           tuv.UnifiedVoiceConfig(**UV)),
        "diffusion": (jdiff.DiffusionConfig(**DIFF),
                      tdiff.DiffusionConfig(**DIFF)),
        "dvae": (jdvae.DVAEConfig(**DVAE), tdvae.DVAEConfig(**DVAE))}
MODULES = {"autoregressive": (juv, tuv), "diffusion": (jdiff, tdiff),
           "dvae": (jdvae, tdvae)}
SEEDS = {"autoregressive": 11, "diffusion": 12, "dvae": 13}
# fp32 parity of a loss and of every gradient leaf
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def one_thread():
    """One intra-op thread for the test: the tiny models' ops gain nothing
    from more, and the suite's parallel workers would oversubscribe the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_params(name: str, seed: int = None):
    """The JAX package's random params of the tiny model, as numpy."""
    jmod = MODULES[name][0]
    key = jax.random.PRNGKey(SEEDS[name] if seed is None else seed)
    p = np_tree(jmod.init(key, CFGS[name][0]))
    if name == "diffusion":
        # proj_out is zero-initialised: make the attention reach the output
        rng = np.random.RandomState(5)
        for blk in (p["latent_conditioner_attn"]
                    + [l["attn"] for l in p["layers"]]
                    + [l["attn"] for l in
                       p["conditioning_timestep_integrator"]]):
            blk["proj_out"]["w"] = (rng.randn(*blk["proj_out"]["w"].shape)
                                    * 0.05).astype(np.float32)
    return p


def port_params(tree, device="cpu", dtype=torch.float32):
    return bridge.to_torch(tree, device, dtype)


def write_artifact(path: Path, n_codes: int = 30, n_text: int = 12,
                   seed: int = 0, dim: int = 64, mels: bool = True):
    """A reference-format .mel artifact (emb/process.py:43-74)."""
    rng = np.random.RandomState(seed)
    art = {
        "codes": rng.randint(0, 8192, (n_codes,)).astype(np.uint16),
        "conds": (rng.randn(1, 1, 80, 100).astype(np.float32),
                  rng.randn(1, 1, 100, 100).astype(np.float32)),
        "latent": (rng.randn(1, dim).astype(np.float32),
                   rng.randn(1, 2 * dim).astype(np.float32)),
        "text": rng.randint(3, 255, (n_text,)).astype(np.uint8),
        "metadata": {"original_length": n_codes * 1024,
                     "sample_rate": 22050,
                     "duration": n_codes * 1024 / 22050, "text": "hello"},
    }
    if mels:
        art["mel"] = (rng.randn(80, n_codes * 4) * 0.1).astype(np.float16)
        art["mel_diff"] = np.clip(rng.randn(100, n_codes * 4) * 0.3, -1,
                                  1).astype(np.float16)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        np.save(f, art)


def write_dataset(root: Path, n: int = 6, **kw) -> Path:
    d = root / "data" / "group" / "speaker"
    for i in range(n):
        write_artifact(d / f"utt{i:03d}.mel", n_codes=20 + i, seed=i, **kw)
    return root / "data"


def ar_batch(b: int = 2, tt: int = 40, tm: int = 48, seed: int = 0):
    """An AR batch of the Dataset's layout (numpy)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(5, tt, (b,)).astype(np.int32)
    text = np.zeros((b, tt), np.int32)
    for i, n in enumerate(lens):
        text[i, :n] = rng.randint(3, 255, (n,))
    n_codes = rng.randint(8, tm, (b,))
    codes = rng.randint(0, 8192, (b, tm)).astype(np.int32)
    return {"latents": rng.randn(b, UV["model_dim"]).astype(np.float32),
            "text": text, "text_lengths": lens, "codes": codes,
            "wav_lengths": (n_codes * 1024).astype(np.int32)}


def tiny_load_model(params_by_name):
    """A ``load_model`` stand-in for the port: the named tiny model, its
    params from ``params_by_name`` (numpy, copied per call)."""
    from tortoise_tts_tpu_torch.models import DTYPES, LoadedModel

    def load(name, dtype="float32", seed=0, device=None):
        return LoadedModel(name, MODULES[name][1], CFGS[name][1],
                           port_params(params_by_name[name],
                                       device or "cpu", DTYPES[dtype]),
                           False)
    return load


def dvae_torch_layout(p):
    """The reference dvae.py state dict of a params tree."""
    sd = {}

    def conv(prefix, c):
        sd[prefix + ".weight"] = torch.from_numpy(np.array(c["w"]))
        sd[prefix + ".bias"] = torch.from_numpy(np.array(c["b"]))

    def res(prefix, r):
        for i, k in ((0, "c1"), (2, "c2"), (4, "c3")):
            conv(f"{prefix}.net.{i}", r[k])
    n, r = len(p["enc_convs"]), len(p["enc_res"])
    for i, c in enumerate(p["enc_convs"]):
        conv(f"encoder.{i}.0", c)
    for i, b in enumerate(p["enc_res"]):
        res(f"encoder.{n + i}", b)
    conv(f"encoder.{n + r}", p["enc_out"])
    conv("decoder.0", p["dec_in"])
    for i, b in enumerate(p["dec_res"]):
        res(f"decoder.{1 + i}", b)
    for i, c in enumerate(p["dec_convs"]):
        conv(f"decoder.{1 + r + i}.0.conv", c)
    conv(f"decoder.{1 + r + n}", p["dec_out"])
    for k, v in p["codebook"].items():
        sd[f"codebook.{k}"] = torch.from_numpy(np.array(v))
    return sd
