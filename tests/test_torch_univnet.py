"""UnivNet, the "vocoder" route, against the JAX package on the CPU: the
converter leaf for leaf, the forward in fp32 with the noise injected, the
single and batch routes against the JAX package's TTS, and the static
cleanup and trim helpers on random codes.

Tolerances: the converter exact (both fold the weight norm in float64
numpy); the forward 1e-4 (fp32 convolutions and the LVC einsum sum in
other orders), and the routes' vocoder stage on the JAX package's own
mels and keys 1e-5; the routes' wavs 3e-3: UnivNet's fp32 output behind
the denoiser, whose fp32 order differences reach 0.22 in the batch's
denormalized mel at this tiny random denoiser (as on the BigVGAN batch
route, whose 16-bit output hides them) and which UnivNet's random weights
amplify to about 1e-3 in a few samples of the single route; the helpers
integer-exact.  TF32 is off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_pair import UN, inject_jax_noise, make_pair
from tortoise_tts_tpu import inference as jinf
from tortoise_tts_tpu.inference import TTS as JTTS
from tortoise_tts_tpu.models import convert as jconvert, univnet as jun
from tortoise_tts_tpu_torch import bridge
from tortoise_tts_tpu_torch import inference as tinf
from tortoise_tts_tpu_torch.inference import CALM_TOKEN, TTS
from tortoise_tts_tpu_torch.models import _univnet_random, load_model
from tortoise_tts_tpu_torch.models import convert as tconvert, univnet

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TEXTS = ["hello world, this is a test.", "a second row", "three"]
SEEDS = [21, 22, 23]
# the JAX package's UnivNet with the noise given (its eager run is slow)
jax_univnet = jax.jit(jun.inference, static_argnames=("cfg",))


def _reference_state_dict(rng, cfg):
    """A random state dict in the reference vocoder's layout, its convs
    under weight norm as the checkpoint ships them."""
    sd = {}

    def conv(name, cin, cout, k, transpose=False):
        shape = (cin, cout, k) if transpose else (cout, cin, k)
        sd[name + ".weight_v"] = rng.randn(*shape).astype(np.float32)
        sd[name + ".weight_g"] = rng.rand(shape[0], 1, 1).astype(np.float32)
        sd[name + ".bias"] = rng.randn(cout).astype(np.float32)

    cs, hid = cfg.channel_size, cfg.kpnet_hidden
    layers = len(cfg.dilations)
    conv("conv_pre", cfg.noise_dim, cs, 7)
    conv("conv_post.1", cs, 1, 7)
    for i, stride in enumerate(cfg.strides):
        kp = f"res_stack.{i}.kernel_predictor"
        conv(kp + ".input_conv.0", cfg.n_mel_channels, hid, 5)
        for j in range(3):
            conv(f"{kp}.residual_convs.{j}.1", hid, hid, 3)
            conv(f"{kp}.residual_convs.{j}.3", hid, hid, 3)
        conv(kp + ".kernel_conv", hid, cs * 2 * cs * 3 * layers, 3)
        conv(kp + ".bias_conv", hid, 2 * cs * layers, 3)
        conv(f"res_stack.{i}.convt_pre.1", cs, cs, 2 * stride,
             transpose=True)
        for j in range(layers):
            conv(f"res_stack.{i}.conv_blocks.{j}.1", cs, cs, 3)
    return sd


def test_convert_univnet_leaf_exact():
    cfg = univnet.UnivNetConfig(**UN)
    sd = _reference_state_dict(np.random.RandomState(0), cfg)
    got = tconvert.convert_univnet(sd)
    want = jconvert.convert_univnet(sd)
    got_l, got_t = jax.tree_util.tree_flatten(got)
    want_l, want_t = jax.tree_util.tree_flatten(want)
    assert got_t == want_t
    for a, b in zip(got_l, want_l):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    # the bridge takes the converted tree and checks its keys
    assert set(bridge.univnet_from_jax(got)) == {"conv_pre", "conv_post",
                                                  "res_stack"}


def test_load_model_vocoder(tmp_path, monkeypatch):
    """The registry's "vocoder": random UnivNet weights without a file; with
    ``vocoder.pth`` (the state dict under "model_g", as the reference
    ships it) the converted weights, leaf for leaf."""
    monkeypatch.setenv("TORTOISE_TPU_MODELS", str(tmp_path))
    cfg = univnet.UnivNetConfig()
    m = load_model("vocoder", device="cpu")
    assert not m.from_checkpoint and m.module is univnet and m.config == cfg
    sd = _reference_state_dict(np.random.RandomState(3), cfg)
    torch.save({"model_g": {k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "vocoder.pth")
    m = load_model("vocoder", device="cpu")
    assert m.from_checkpoint
    got, got_t = jax.tree_util.tree_flatten(bridge.to_numpy(m.params))
    want, want_t = jax.tree_util.tree_flatten(tconvert.convert_univnet(sd))
    assert got_t == want_t
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_univnet_forward_matches_jax():
    """``inference`` (10 silent frames, decode, trim, clip) with the same
    injected noise, two rows, and each row's wav from its own generator
    equal to the injected form of the same draws."""
    cfg = univnet.UnivNetConfig(**UN)
    tp = _univnet_random(torch.Generator().manual_seed(1), cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, bridge.to_numpy(tp))
    rng = np.random.RandomState(2)
    mel = rng.randn(2, 100, 12).astype(np.float32) * 2 - 4
    noise = rng.randn(2, 64, 22).astype(np.float32)
    want = jax_univnet(jp, jnp.asarray(mel), noise=jnp.asarray(noise),
                       cfg=jun.UnivNetConfig(**UN))
    got = univnet.inference(tp, torch.from_numpy(mel),
                            noise=torch.from_numpy(noise), cfg=cfg)
    assert got.shape == (2, 1, 12 * 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    gens = [torch.Generator().manual_seed(s) for s in (5, 6)]
    drawn = torch.stack([torch.randn(univnet.noise_shape(12, cfg),
                                     generator=torch.Generator()
                                     .manual_seed(s)) for s in (5, 6)])
    torch.testing.assert_close(
        univnet.inference(tp, torch.from_numpy(mel), generators=gens,
                          cfg=cfg),
        univnet.inference(tp, torch.from_numpy(mel), noise=drawn, cfg=cfg))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    jtts, ttts, ref, _ = make_pair(tmp_path_factory.mktemp("univnet"), mp)
    yield jtts, ttts, ref
    mp.undo()


def _jax_noise(keys, frames):
    """``_jit_univnet``'s noise: each row's normal(key, (64, T + 10)), or
    one key's normal for the whole batch."""
    shape = (64, frames + 10)
    keys = np.asarray(keys)
    if keys.ndim == 1:
        return jax.random.normal(jnp.asarray(keys), (1,) + shape)
    return jnp.stack([jax.random.normal(jnp.asarray(k), shape)
                      for k in keys])


def _record_jax_vocoder(monkeypatch):
    """The mels and keys the JAX package's routes hand UnivNet (a list the
    patched ``_jit_univnet`` fills)."""
    vocoded = []
    jit_univnet = jinf._jit_univnet

    def recorded(params, mel, keys, cfg):
        vocoded.append((np.asarray(mel), np.asarray(keys)))
        return jit_univnet(params, mel, keys, cfg)
    monkeypatch.setattr(jinf, "_jit_univnet", recorded)
    return vocoded


def _check_vocoder_stage(jtts, ttts, vocoded):
    """The port's vocoder stage on exactly what the JAX package vocoded."""
    voc_t, voc_j = ttts._model("vocoder"), jtts._model("vocoder")
    assert vocoded
    for mel, keys in list(vocoded):
        want = jax_univnet(voc_j.params, jnp.asarray(mel),
                           noise=_jax_noise(keys, mel.shape[2]),
                           cfg=voc_j.config)
        got = tinf._univnet(voc_t.params, torch.from_numpy(mel),
                            list(np.atleast_2d(keys)), voc_t.config)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("candidates", [1, 2])
def test_univnet_route_matches_jax(pair, monkeypatch, candidates):
    """``inference(vocoder_type="vocoder")``: greedy decode (candidates:
    two rows, the CLVP's pick of the cleaned codes), the host cleanup, the
    latent pass, the diffusion sized by the calm-trim point with the JAX
    package's noise, UnivNet with the JAX package's k_voc noise; and the
    port's vocoder stage on the mel and key the JAX package vocoded."""
    jtts, ttts, ref = pair
    drawn = inject_jax_noise(monkeypatch, [SEEDS[0]])
    vocoded = _record_jax_vocoder(monkeypatch)
    kw = dict(max_ar_steps=48, max_diffusion_steps=4, greedy=True,
              seed=SEEDS[0], vocoder_type="vocoder", candidates=candidates,
              diffusion_pad_multiple=8, mel_pad_multiple=64)
    jwav, _ = jtts.inference(TEXTS[0], ref, **kw)
    twav, sr = ttts.inference(TEXTS[0], ref, **kw)
    assert sr == 24000 and len(drawn["vocoder"]) == 1
    assert drawn["vocoder"][0][1] == drawn["diffusion"][0][2] + 10
    assert twav.shape == jwav.shape and twav.dtype == np.float32
    assert np.isfinite(twav).all() and np.count_nonzero(twav) > 1000
    np.testing.assert_allclose(twav, jwav, atol=3e-3, rtol=0)
    _check_vocoder_stage(jtts, ttts, vocoded)


@pytest.mark.parametrize("row_buckets", [True, False])
def test_univnet_batch_matches_jax(pair, monkeypatch, row_buckets):
    """``batch_inference(vocoder_type="vocoder")``: three rows, one voice,
    greedy, each row's UnivNet noise from its own k_voc; and the port's
    vocoder stage on the mels and keys the JAX package vocoded."""
    jtts, ttts, ref = pair
    drawn = inject_jax_noise(monkeypatch, SEEDS)
    vocoded = _record_jax_vocoder(monkeypatch)
    kw = dict(max_ar_steps=48, max_diffusion_steps=3, greedy=True,
              seeds=SEEDS, mel_pad_multiple=128, vocoder_type="vocoder",
              row_buckets=row_buckets)
    jw, _ = jtts.batch_inference(TEXTS, ref, **kw)
    tw, sr = ttts.batch_inference(TEXTS, ref, **kw)
    assert sr == 24000 and len(tw) == len(jw) == 3
    # bucketed: one dispatch of three rows, padded to four
    assert len(drawn["vocoder"]) == (4 if row_buckets else 3)
    for a, b in zip(tw, jw):
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.isfinite(a).all() and np.count_nonzero(a) > 1000
        np.testing.assert_allclose(a, b, atol=3e-3, rtol=0)
    _check_vocoder_stage(jtts, ttts, vocoded)


@pytest.mark.parametrize("seed", range(6))
def test_cleanup_and_trim_helpers_match_jax(seed):
    """``cleanup_codes``, ``calm_trim_point`` and ``trim_latents_at_calm``
    on random codes with stops, calm runs and rows without a stop."""
    rng = np.random.RandomState(seed)
    b, n = 5, 40
    codes = rng.choice([CALM_TOKEN, 8193, 45, 7, 1000, 3], size=(b, n),
                       p=[0.45, 0.05, 0.1, 0.1, 0.2, 0.1])
    codes[0] = 9                      # no stop
    codes[1, :2] = 8193               # a stop at once: a tail that fits
    lengths = np.asarray([int(np.argmax(r == 8193)) if (r == 8193).any()
                          else n for r in codes])
    got = TTS.cleanup_codes(codes, lengths)
    want = JTTS.cleanup_codes(codes, lengths)
    np.testing.assert_array_equal(got, want)
    lat = rng.randn(1, got.shape[1], 3)
    for row in got:
        for upto in (got.shape[1], 10):
            assert TTS.calm_trim_point(row, upto) == \
                JTTS.calm_trim_point(row, upto)
        np.testing.assert_array_equal(TTS.trim_latents_at_calm(row, lat),
                                      JTTS.trim_latents_at_calm(row, lat))
