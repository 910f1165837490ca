"""The PyTorch port's package boundary: no JAX inside it, CUDA by default,
CPU tensors through the kernels' plain versions, and the weight bridge
from the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import tortoise_tts_tpu_torch
from tortoise_tts_tpu.models import _hifigan_random as jax_hifigan_random
from tortoise_tts_tpu.models import unified_voice as juv
from tortoise_tts_tpu.models.hifigan import HifiganConfig as JHifiganConfig
from tortoise_tts_tpu_torch import bridge, kernels
from tortoise_tts_tpu_torch.models import _hifigan_random, unified_voice as uv
from tortoise_tts_tpu_torch.models.hifigan import HifiganConfig
from tortoise_tts_tpu_torch.tokenizer import write_char_tokenizer

PKG = Path(tortoise_tts_tpu_torch.__file__).parent
REPO = PKG.parent


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(np.shape(tree))


def test_import_leaves_jax_out():
    code = ("import sys, tortoise_tts_tpu_torch\n"
            "from tortoise_tts_tpu_torch import bridge, inference, kernels\n"
            "from tortoise_tts_tpu_torch.emb import mel\n"
            "from tortoise_tts_tpu_torch.models import (bigvgan, clvp, "
            "diffusion, gaussian, rlg)\n"
            "from tortoise_tts_tpu_torch.kernels import ("
            "flash_attention_bias, flash_attention_bias_cm, "
            "flash_attention_bias_kq, gn_conv, qgemv_w8a8, snake, "
            "ts_res_block)\n"
            "from tortoise_tts_tpu_torch.models import convert\n"
            "from tortoise_tts_tpu_torch import train\n"
            "from tortoise_tts_tpu_torch.engine import (engines, factory, "
            "optim, state, train_step)\n"
            "from tortoise_tts_tpu_torch.data import (dataset, "
            "native_loader, sampler)\n"
            "from tortoise_tts_tpu_torch.models import bigvgan_disc, dvae\n"
            "from tortoise_tts_tpu_torch.utils import trainer\n"
            "import tortoise_tts_tpu_torch.__main__\n"
            "from tortoise_tts_tpu_torch import export, plot, webui\n"
            "from tortoise_tts_tpu_torch.emb import process, transcribe\n"
            "from tortoise_tts_tpu_torch.models import classifier\n"
            "from tortoise_tts_tpu_torch.utils import profiling\n"
            "import tortoise_tts_tpu_torch.data.__main__\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.split('.')[0] == 'optax' "
            "or m == 'tortoise_tts_tpu' "
            "or m.startswith('tortoise_tts_tpu.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_jax_import_in_port_sources():
    """Neither the package nor ``chip_smoke.py``, which runs it on the
    card, imports JAX or the JAX package."""
    offenders = []
    for path in [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "optax", "tortoise_tts_tpu"):
                    offenders.append(f"{path.relative_to(REPO)}: {n}")
    assert not offenders


def test_tts_needs_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("TORTOISE_TPU_TOKENIZER",
                       str(write_char_tokenizer(tmp_path / "tok.json")))
    from tortoise_tts_tpu_torch.inference import TTS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTS()
    tts = TTS(device="cpu")
    assert tts.device.type == "cpu"
    assert tts.dtype == "bfloat16" and tts.cfg.inference.decode_quant == "int8"
    assert tts.encode_text("hi there").tolist()


def test_kernel_wrappers_on_cpu_run_plain_versions():
    from tortoise_tts_tpu_torch.kernels import flash_attention as k1
    from tortoise_tts_tpu_torch.kernels import flash_decode as k3
    from tortoise_tts_tpu_torch.kernels import qgemv as k2
    kernels.reset_launches()
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 10, 64, generator=g) for _ in range(3))
    mask = torch.ones(1, 10, dtype=torch.bool)
    assert torch.equal(k1.flash_attention(q, k, v, mask),
                       k1.flash_attention_plain(q, k, v, mask))
    x = torch.randn(1, 64, generator=g)
    wq = torch.randint(-127, 128, (64, 128), dtype=torch.int8, generator=g)
    s = torch.rand(128, generator=g)
    assert torch.equal(k2.qgemv(x, wq, s), k2.qgemv_plain(x, wq, s))
    ck, cv = k[:, :, :, :], v[:, :, :, :]
    assert torch.equal(k3.flash_decode(q[:, :, 3], ck, cv, 5, mask),
                       k3.flash_decode_plain(q[:, :, 3], ck, cv, 5, mask))
    from tortoise_tts_tpu_torch.kernels import gn_conv as k4
    from tortoise_tts_tpu_torch.kernels import snake as k7
    from tortoise_tts_tpu_torch.kernels import ts_res_block as k5
    x = torch.randn(2, 32, 9, generator=g)
    norm = {"scale": torch.rand(32, generator=g), "bias": torch.zeros(32)}
    conv1 = {"w": torch.randn(96, 32, 1, generator=g), "b": torch.zeros(96)}
    assert torch.equal(k4.gn_conv1x1(x, norm, conv1, 8, False),
                       k4.gn_conv1x1_plain(x, norm, conv1, 8, False))
    conv3 = {"w": torch.randn(32, 32, 3, generator=g), "b": torch.zeros(32)}
    emb = torch.randn(2, 64, generator=g)
    assert torch.equal(k5.ts_res_block_out(x, x, emb, norm, conv3, 8),
                       k5.ts_res_block_out_plain(x, x, emb, norm, conv3, 8))
    a = torch.rand(32, generator=g) + 0.5
    assert torch.equal(k7.snake_resample2(x, a, a),
                       k7.snake_resample2_plain(x, a, a))
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias as k6
    qkv, bias = torch.randn(2, 384, 9, generator=g), torch.randn(2, 9, 9)
    assert torch.equal(k6.flash_attention_bias(qkv, bias, 2),
                       k6.flash_attention_bias_plain(qkv, bias, 2))
    kp, kd = k[:1, :, :4], k[:, :, 4:]
    pm = mask[:, :4]
    assert torch.equal(
        k3.flash_decode_shared(q[:, :, 3], kp, kp, pm, kd, kd, 2),
        k3.flash_decode_shared_plain(q[:, :, 3], kp, kp, pm, kd, kd, 2))
    from tortoise_tts_tpu_torch.kernels import qgemv_w8a8 as k8
    x = torch.randn(3, 64, generator=g)
    assert torch.equal(k8.qgemv_w8a8(x, wq, s), k8.qgemv_w8a8_plain(x, wq, s))
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias_cm as k9b
    from tortoise_tts_tpu_torch.kernels import flash_attention_bias_kq as k9a
    assert torch.equal(k9a.flash_attention_bias_kq(qkv, bias, 2),
                       k9a.flash_attention_bias_kq_plain(qkv, bias, 2))
    assert torch.equal(k9b.flash_attention_bias_qkv(qkv, bias, 2),
                       k9b.flash_attention_bias_qkv_plain(qkv, bias, 2))
    q3 = qkv.view(2, 2, 3, 64, 9)
    assert torch.equal(
        k9b.flash_attention_bias_cm(q3[:, :, 0], q3[:, :, 1], q3[:, :, 2],
                                    bias),
        k9b.flash_attention_bias_cm_plain(q3[:, :, 0], q3[:, :, 1],
                                          q3[:, :, 2], bias))
    assert kernels.launch_counts() == {
        "flash_attention": 0, "qgemv": 0, "qgemv_w8a8": 0, "flash_decode": 0,
        "flash_decode_shared": 0, "gn_conv": 0, "ts_res_block": 0,
        "flash_attention_bias": 0, "snake": 0, "flash_attention_bias_kq": 0,
        "flash_attention_bias_cm": 0}


def test_kernel_wrappers_refuse_other_devices():
    from tortoise_tts_tpu_torch.kernels import qgemv as k2
    x = torch.zeros(1, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k2.qgemv(x, torch.zeros(64, 128, dtype=torch.int8, device="meta"),
                 torch.zeros(128, device="meta"))


def test_bridge_roundtrips_unified_voice():
    cfg = dict(layers=2, model_dim=128, heads=2, max_text_tokens=40,
               max_mel_tokens=32)
    jp = _np(juv.init(jax.random.PRNGKey(0), juv.UnifiedVoiceConfig(**cfg)))
    tp = bridge.unified_voice_from_jax(jp)
    back = bridge.to_numpy(tp)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jp)
    # the port's own init has the same structure leaf for leaf
    own = uv.init(torch.Generator().manual_seed(0),
                  uv.UnifiedVoiceConfig(**cfg))
    assert _shapes(own) == _shapes(jp)
    qj = _np(juv.quantize_decode_weights(
        jax.tree_util.tree_map(jax.numpy.asarray, jp)))
    qt = bridge.decode_weights_from_jax(qj)
    assert qt["mlp_fc"]["wq"].dtype == torch.int8
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           bridge.to_numpy(qt), qj)
    # the port quantizes the bridged weights to the same int8 leaves
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           bridge.to_numpy(uv.quantize_decode_weights(tp)),
                           qj)


def test_bridge_roundtrips_hifigan():
    kw = dict(in_channels=64, upsample_initial_channel=64, cond_channels=64)
    jp = _np(jax_hifigan_random(jax.random.PRNGKey(1), JHifiganConfig(**kw)))
    tp = bridge.hifigan_from_jax(jp, dtype=torch.float32)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(a, np.float32(b)),
        bridge.to_numpy(tp), jp)
    own = _hifigan_random(torch.Generator().manual_seed(0),
                          HifiganConfig(**kw))
    assert _shapes(own) == _shapes(jp)


def test_bridge_roundtrips_diffusion():
    from tortoise_tts_tpu.models import diffusion as jdiff
    from tortoise_tts_tpu_torch.models import diffusion as tdiff
    kw = dict(model_channels=64, num_layers=2, num_heads=4,
              in_latent_channels=64)
    jp = _np(jdiff.init(jax.random.PRNGKey(2), jdiff.DiffusionConfig(**kw)))
    tp = bridge.diffusion_from_jax(jp)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           bridge.to_numpy(tp), jp)
    own = tdiff.init(torch.Generator().manual_seed(0),
                     tdiff.DiffusionConfig(**kw))
    assert _shapes(own) == _shapes(jp)


def test_bridge_roundtrips_clvp_and_rlg():
    from tortoise_tts_tpu.models import clvp as jclvp, rlg as jrlg
    from tortoise_tts_tpu_torch.models import clvp as tclvp, rlg as trlg
    kw = dict(dim_text=32, dim_speech=32, dim_latent=32, text_enc_depth=2,
              speech_enc_depth=1, text_heads=2, speech_heads=2, dim_head=16,
              rotary_dim=16)
    jp = _np(jclvp.init(jax.random.PRNGKey(3), jclvp.CLVPConfig(**kw)))
    tp = bridge.clvp_from_jax(jp)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           bridge.to_numpy(tp), jp)
    own = tclvp.init(torch.Generator().manual_seed(0), tclvp.CLVPConfig(**kw))
    assert _shapes(own) == _shapes(jp)
    jr = _np(jrlg.init(jax.random.PRNGKey(4), 32))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           bridge.to_numpy(bridge.rlg_from_jax(jr)), jr)
    assert _shapes(trlg.init(torch.Generator().manual_seed(0), 32)) == \
        _shapes(jr)
    with pytest.raises(KeyError, match="CLVP"):
        bridge.clvp_from_jax({"text_emb": {}})


def test_registry_builds_the_slice3_models_from_a_seed():
    """clvp and both random latent converters come from the registry,
    random from a seed where no checkpoint is found
    (tests/test_torch_convert.py reads checkpoints)."""
    from tortoise_tts_tpu_torch.models import load_model
    m = load_model("rlg_diffuser", device="cpu")
    assert m.config == 2048 and not m.from_checkpoint
    assert m.params["final"]["w"].shape == (2048, 2048)
    assert load_model("rlg_auto", device="cpu").config == 1024


def test_bridge_rejects_foreign_trees():
    with pytest.raises(KeyError, match="UnifiedVoice"):
        bridge.unified_voice_from_jax({"gpt": {}})
    with pytest.raises(KeyError, match="DiffusionTTS"):
        bridge.diffusion_from_jax({"layers": []})
    with pytest.raises(KeyError, match="BigVGAN"):
        bridge.bigvgan_from_jax({"ups": []})
