"""The port's DVAE (``models/dvae.py``) against the JAX package's, fp32 on
the CPU within rtol 1e-4 / atol 1e-5: the encoder, the codes, the
decoder, the EMA quantiser and the training forward; its converter from
the reference torch layout, the bridge with the codebook buffers and the
registry's random init; and the diffusion training losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.models import convert as jconvert
from tortoise_tts_tpu.models import dvae as jdvae
from tortoise_tts_tpu.models import gaussian as jgauss
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch.models import convert, dvae, gaussian, load_model
from tortoise_tts_tpu_torch.models.lora import freeze_non_lora_mask

from tests.torch_train_util import (CFGS, dvae_torch_layout, jax_params,
                                    port_params)
from tests.torch_train_util import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    jp = jax_params("dvae")
    mel = (np.random.RandomState(3).randn(2, 80, 48) * 0.5
           ).astype(np.float32)
    return jp, port_params(jp), mel


def test_encoder_codes_and_decoder_match_jax(pair):
    jp, tp, mel = pair
    jcfg, tcfg = CFGS["dvae"]
    jj = jax.tree_util.tree_map(jnp.asarray, jp)
    np.testing.assert_allclose(
        dvae.encode_logits(tp, torch.from_numpy(mel), tcfg).numpy(),
        np.asarray(jdvae.encode_logits(jj, jnp.asarray(mel), jcfg)), **TOL)
    codes = dvae.get_codebook_indices(tp, torch.from_numpy(mel), tcfg)
    jcodes = np.asarray(jdvae.get_codebook_indices(jj, jnp.asarray(mel),
                                                   jcfg))
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    assert codes.shape == (2, 12)
    np.testing.assert_allclose(
        dvae.decode(tp, codes, tcfg).numpy(),
        np.asarray(jdvae.decode(jj, jnp.asarray(jcodes), jcfg)), **TOL)


@pytest.mark.parametrize("training", [False, True])
def test_forward_and_ema_state_match_jax(pair, training):
    jp, tp, mel = pair
    jcfg, tcfg = CFGS["dvae"]
    want = jdvae.forward(jax.tree_util.tree_map(jnp.asarray, jp),
                         jnp.asarray(mel), jcfg, training=training)
    got = dvae.forward(tp, torch.from_numpy(mel), tcfg, training=training)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[4], want[4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    moved = not torch.equal(got[4].cluster_size,
                            tp["codebook"]["cluster_size"])
    assert moved == training


def test_converter_and_bridge(pair):
    jp, _, _ = pair
    sd = dvae_torch_layout(jp)
    got = convert.convert_dvae(sd)
    want = jconvert.convert_dvae({k: v.numpy() for k, v in sd.items()})
    flat_g = jax.tree_util.tree_leaves(got)
    flat_w = jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for a, b in zip(flat_g, flat_w):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    t = bridge.dvae_from_jax(jp)
    assert set(t["codebook"]) == {"embed", "cluster_size", "embed_avg"}
    bad = dict(jp)
    bad["codebook"] = {"embed": jp["codebook"]["embed"]}
    with pytest.raises(KeyError):
        bridge.dvae_from_jax(bad)


def test_registry_dvae_has_the_jax_structure():
    m = load_model("dvae", device="cpu")
    j = jax.eval_shape(lambda k: jdvae.init(k, jdvae.DVAEConfig()),
                       jax.random.PRNGKey(0))
    shapes_t = [tuple(x.shape) for x in jax.tree_util.tree_leaves(m.params)]
    shapes_j = [tuple(x.shape) for x in jax.tree_util.tree_leaves(j)]
    assert shapes_t == shapes_j
    assert m.config == dvae.DVAEConfig() and not m.from_checkpoint


def test_diffusion_training_losses_match_jax():
    rng = np.random.RandomState(0)
    sched_j = jgauss.get_schedule(steps=4000, cond_free=False)
    sched_t = gaussian.get_schedule(steps=4000, cond_free=False)
    x0 = rng.randn(3, 4, 16).astype(np.float32)
    noise = rng.randn(3, 4, 16).astype(np.float32)
    out = rng.randn(3, 8, 16).astype(np.float32)
    t = np.asarray([0, 1234, 3999])
    xt_j = jgauss.q_sample(jnp.asarray(x0), jnp.asarray(t),
                           jnp.asarray(noise), sched_j)
    xt_t = gaussian.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                             torch.from_numpy(noise), sched_t)
    np.testing.assert_allclose(xt_t.numpy(), np.asarray(xt_j), **TOL)
    want = jgauss.training_losses(jnp.asarray(out), jnp.asarray(x0), xt_j,
                                  jnp.asarray(t), jnp.asarray(noise),
                                  sched_j)
    got = gaussian.training_losses(torch.from_numpy(out),
                                   torch.from_numpy(x0), xt_t,
                                   torch.from_numpy(t),
                                   torch.from_numpy(noise), sched_t)
    for k in ("mse", "vb", "loss"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_freeze_non_lora_mask():
    params = {"gpt": {"w": torch.zeros(2)}, "head": [torch.zeros(1)]}
    lora = {"gpt": {"attn_qkv": {"a": torch.zeros(1), "b": torch.zeros(1)}}}
    frozen, trainable = freeze_non_lora_mask(params, lora)
    assert frozen == {"gpt": {"w": False}, "head": [False]}
    assert trainable == {"gpt": {"attn_qkv": {"a": True, "b": True}}}
