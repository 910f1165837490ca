"""Checkpoint ingestion: reference PyTorch state dicts -> the port's
parameter trees (the port's own copy of ``tortoise_tts_tpu/models/
convert.py``: UnifiedVoice, DiffusionTTS, CLVP, BigVGAN, HiFiGAN,
UnivNet, the DVAE, the random latent converters and the classifier).

The reference ships jbetker's original tortoise-tts-v2 weights; this
module maps those state dicts (``utils/io.load_state_dict``) onto the
functional parameter layout the port shares with the JAX package, as
numpy arrays: ``models.load_model`` casts them onto the device.  The
classifier converts too.  Conventions
(models/common.py):

- torch nn.Linear.weight (out,in)   -> ours (in,out)  [transpose]
- HF  Conv1D.weight      (in,out)   -> ours (in,out)  [as-is]
- torch nn.Conv1d.weight (out,in,k) -> ours (out,in,k) [as-is]
- norm .weight/.bias                -> scale/bias
- nn.Embedding.weight               -> w
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

Array = np.ndarray
StateDict = Mapping[str, Any]


def _np(x) -> Array:
    if isinstance(x, np.ndarray):
        return x
    if not hasattr(x, "detach"):
        return np.asarray(x)
    x = x.detach().cpu()
    # numpy has no bfloat16: such a checkpoint converts through fp32
    return (x.float() if str(x.dtype) == "torch.bfloat16" else x).numpy()


def _lin(sd: StateDict, prefix: str, transpose: bool = True) -> Dict[str, Array]:
    w = _np(sd[prefix + ".weight"])
    p = {"w": w.T if transpose else w}
    if prefix + ".bias" in sd:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def _conv(sd: StateDict, prefix: str) -> Dict[str, Array]:
    p = {"w": _np(sd[prefix + ".weight"])}
    if prefix + ".bias" in sd and sd[prefix + ".bias"] is not None:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def _norm(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"scale": _np(sd[prefix + ".weight"]),
            "bias": _np(sd[prefix + ".bias"])}


def _emb(sd: StateDict, prefix: str) -> Dict[str, Array]:
    return {"w": _np(sd[prefix + ".weight"])}


def _attention_block(sd: StateDict, prefix: str) -> Dict[str, Any]:
    p = {
        "norm": _norm(sd, prefix + ".norm"),
        "qkv": _conv(sd, prefix + ".qkv"),
        "proj_out": _conv(sd, prefix + ".proj_out"),
    }
    rel = prefix + ".relative_pos_embeddings.relative_attention_bias.weight"
    if rel in sd:
        p["rel_pos"] = {"w": _np(sd[rel])}
    return p


def _res_block_arch(sd: StateDict, prefix: str) -> Dict[str, Any]:
    """arch_utils.ResBlock: in_layers.{0 norm,2 conv}, out_layers.{0,3}."""
    p = {"in_norm": _norm(sd, prefix + ".in_layers.0"),
         "in_conv": _conv(sd, prefix + ".in_layers.2"),
         "out_norm": _norm(sd, prefix + ".out_layers.0"),
         "out_conv": _conv(sd, prefix + ".out_layers.3")}
    if prefix + ".skip_connection.weight" in sd:
        p["skip"] = _conv(sd, prefix + ".skip_connection")
    return p


def convert_conditioning_encoder(sd: StateDict, prefix: str,
                                 attn_blocks: int = 6) -> Dict[str, Any]:
    dot = prefix + "." if prefix else ""
    return {
        "init": _conv(sd, dot + "init"),
        "attn": [_attention_block(sd, f"{dot}attn.{i}")
                 for i in range(attn_blocks)],
    }


def fold_weight_norm(sd: StateDict) -> Dict[str, Array]:
    """Fold torch weight_norm (weight_g/weight_v) into plain weights.

    torch weight_norm(dim=0): w = g * v / ||v|| with the norm over all dims
    except 0.  Vocoder checkpoints ship unfolded (hifigan.py, vocoder.py,
    bigvgan.py all wrap convs in weight_norm).
    """
    out: Dict[str, Array] = {}
    for k in sd:
        if k.endswith(".weight_g"):
            base = k[: -len(".weight_g")]
            g = _np(sd[k]).astype(np.float64)
            v = _np(sd[base + ".weight_v"]).astype(np.float64)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
            out[base + ".weight"] = (g * v / norm).astype(np.float32)
        elif k.endswith(".weight_v"):
            continue
        else:
            out[k] = _np(sd[k])
    return out


# ---------------------------------------------------------------------------
# Vocoders
# ---------------------------------------------------------------------------


def convert_hifigan(sd: StateDict, n_ups: int = 4,
                    n_resblocks_per_up: int = 3,
                    n_convs: int = 3) -> Dict[str, Any]:
    """reference hifigan.py:161-237 layout (weight-norm folded)."""
    sd = fold_weight_norm(sd)
    p: Dict[str, Any] = {
        "conv_pre": _conv(sd, "conv_pre"),
        "conv_post": _conv(sd, "conv_post"),
        "ups": [_conv(sd, f"ups.{i}") for i in range(n_ups)],
        "resblocks": [],
    }
    if "cond_layer.weight" in sd:
        p["cond_layer"] = _conv(sd, "cond_layer")
    for i in range(n_ups * n_resblocks_per_up):
        p["resblocks"].append({
            "convs1": [_conv(sd, f"resblocks.{i}.convs1.{j}")
                       for j in range(n_convs)],
            "convs2": [_conv(sd, f"resblocks.{i}.convs2.{j}")
                       for j in range(n_convs)],
        })
    return p


def convert_bigvgan(sd: StateDict, n_ups: int = 6, n_kernels: int = 3,
                    n_convs: int = 3, resblock: str = "1") -> Dict[str, Any]:
    """reference bigvgan.py:417-487 layout (weight-norm folded)."""
    sd = fold_weight_norm(sd)

    def snake(prefix: str) -> Dict[str, Array]:
        p = {"alpha": _np(sd[prefix + ".act.alpha"])}
        if prefix + ".act.beta" in sd:
            p["beta"] = _np(sd[prefix + ".act.beta"])
        return p

    p: Dict[str, Any] = {
        "conv_pre": _conv(sd, "conv_pre"),
        "conv_post": _conv(sd, "conv_post"),
        "ups": [_conv(sd, f"ups.{i}.0") for i in range(n_ups)],
        "activation_post": snake("activation_post"),
        "resblocks": [],
    }
    for i in range(n_ups * n_kernels):
        if resblock == "1":
            blk = {
                "convs1": [_conv(sd, f"resblocks.{i}.convs1.{j}")
                           for j in range(n_convs)],
                "convs2": [_conv(sd, f"resblocks.{i}.convs2.{j}")
                           for j in range(n_convs)],
                "activations": [snake(f"resblocks.{i}.activations.{j}")
                                for j in range(2 * n_convs)],
            }
        else:
            blk = {
                "convs": [_conv(sd, f"resblocks.{i}.convs.{j}")
                          for j in range(2)],
                "activations": [snake(f"resblocks.{i}.activations.{j}")
                                for j in range(2)],
            }
        p["resblocks"].append(blk)
    return p


def convert_univnet(sd: StateDict, n_blocks: int = 3,
                    n_dilations: int = 4) -> Dict[str, Any]:
    """UnivNet (reference vocoder.py:227-267 layout), weight norm
    folded."""
    sd = fold_weight_norm(sd)

    def kp(prefix: str) -> Dict[str, Any]:
        return {
            "input_conv": _conv(sd, prefix + ".input_conv.0"),
            "residual_convs": [
                {"c1": _conv(sd, f"{prefix}.residual_convs.{j}.1"),
                 "c2": _conv(sd, f"{prefix}.residual_convs.{j}.3")}
                for j in range(3)],
            "kernel_conv": _conv(sd, prefix + ".kernel_conv"),
            "bias_conv": _conv(sd, prefix + ".bias_conv"),
        }

    return {
        "conv_pre": _conv(sd, "conv_pre"),
        "conv_post": _conv(sd, "conv_post.1"),
        "res_stack": [{
            "kernel_predictor": kp(f"res_stack.{i}.kernel_predictor"),
            "convt_pre": _conv(sd, f"res_stack.{i}.convt_pre.1"),
            "conv_blocks": [_conv(sd, f"res_stack.{i}.conv_blocks.{j}.1")
                            for j in range(n_dilations)],
        } for i in range(n_blocks)],
    }


# ---------------------------------------------------------------------------
# DiffusionTTS — reference diffusion.py:1389-1465 state_dict layout
# ---------------------------------------------------------------------------


def _ts_res_block(sd: StateDict, prefix: str) -> Dict[str, Any]:
    """diffusion ResBlock (in_layers.{0,2}, emb_layers.1, out_layers.{0,3})."""
    return {
        "in_norm": _norm(sd, prefix + ".in_layers.0"),
        "in_conv": _conv(sd, prefix + ".in_layers.2"),
        "emb": _lin(sd, prefix + ".emb_layers.1"),
        "out_norm": _norm(sd, prefix + ".out_layers.0"),
        "out_conv": _conv(sd, prefix + ".out_layers.3"),
    }


def _diffusion_layer(sd: StateDict, prefix: str) -> Dict[str, Any]:
    return {
        "resblk": _ts_res_block(sd, prefix + ".resblk"),
        "attn": _attention_block(sd, prefix + ".attn"),
    }


def convert_diffusion(sd: StateDict, num_layers: int = 10) -> Dict[str, Any]:
    return {
        "inp_block": _conv(sd, "inp_block"),
        "time_embed_0": _lin(sd, "time_embed.0"),
        "time_embed_2": _lin(sd, "time_embed.2"),
        "code_embedding": _emb(sd, "code_embedding"),
        "code_converter": [_attention_block(sd, f"code_converter.{i}")
                           for i in range(3)],
        "code_norm": _norm(sd, "code_norm"),
        "latent_conditioner_conv": _conv(sd, "latent_conditioner.0"),
        "latent_conditioner_attn": [
            _attention_block(sd, f"latent_conditioner.{i}")
            for i in range(1, 5)],
        "contextual_embedder_conv0": _conv(sd, "contextual_embedder.0"),
        "contextual_embedder_conv1": _conv(sd, "contextual_embedder.1"),
        "contextual_embedder_attn": [
            _attention_block(sd, f"contextual_embedder.{i}")
            for i in range(2, 7)],
        "unconditioned_embedding": _np(sd["unconditioned_embedding"]),
        "conditioning_timestep_integrator": [
            _diffusion_layer(sd, f"conditioning_timestep_integrator.{i}")
            for i in range(3)],
        "integrating_conv": _conv(sd, "integrating_conv"),
        "mel_head": _conv(sd, "mel_head"),
        "layers": [_diffusion_layer(sd, f"layers.{i}")
                   for i in range(num_layers)],
        "final_res": [_ts_res_block(sd, f"layers.{num_layers + i}")
                      for i in range(3)],
        "out_norm": _norm(sd, "out.0"),
        "out_conv": _conv(sd, "out.2"),
    }


# ---------------------------------------------------------------------------
# CLVP — reference clvp.py + xtransformers checkpoint layout
# ---------------------------------------------------------------------------


def _clvp_tower(sd: StateDict, prefix: str, depth: int) -> Dict[str, Any]:
    """CheckpointedXTransformerEncoder layout: layers alternate attention
    (even idx) / feedforward (odd idx); blocks sit under `.1.wrap.`
    (arch_utils.py:414-437 CheckpointedLayer wrapping)."""
    t = prefix + ".transformer"
    layers = []
    for i in range(depth):
        a, f = 2 * i, 2 * i + 1
        la = f"{t}.attn_layers.layers.{a}"
        lf = f"{t}.attn_layers.layers.{f}"
        wrap_a = f"{la}.1.wrap" if f"{la}.1.wrap.to_q.weight" in sd else f"{la}.1"
        wrap_f = f"{lf}.1.wrap" if f"{lf}.1.wrap.net.0.proj.weight" in sd else f"{lf}.1"
        layers.append({
            "attn_norm": {"scale": _np(sd[f"{la}.0.0.g"])},
            "to_q": _lin(sd, wrap_a + ".to_q"),
            "to_k": _lin(sd, wrap_a + ".to_k"),
            "to_v": _lin(sd, wrap_a + ".to_v"),
            "to_out": _lin(sd, wrap_a + ".to_out"),
            "ff_norm": {"scale": _np(sd[f"{lf}.0.0.g"])},
            "ff_proj": _lin(sd, wrap_f + ".net.0.proj"),
            "ff_out": _lin(sd, wrap_f + ".net.3"),
        })
    return {"layers": layers, "final_norm": _norm(sd, t + ".norm")}


def convert_clvp(sd: StateDict, depth: int = 20) -> Dict[str, Any]:
    return {
        "text_emb": _emb(sd, "text_emb"),
        "speech_emb": _emb(sd, "speech_emb"),
        "to_text_latent": _lin(sd, "to_text_latent"),
        "to_speech_latent": _lin(sd, "to_speech_latent"),
        "text_transformer": _clvp_tower(sd, "text_transformer", depth),
        "speech_transformer": _clvp_tower(sd, "speech_transformer", depth),
        "temperature": _np(sd["temperature"]).reshape(()),
    }


# ---------------------------------------------------------------------------
# RandomLatentConverter
# ---------------------------------------------------------------------------


def convert_rlg(sd: StateDict) -> Dict[str, Any]:
    return {
        "equal_linears": [{"w": _np(sd[f"layers.{i}.weight"]),
                           "b": _np(sd[f"layers.{i}.bias"])}
                          for i in range(5)],
        "final": _lin(sd, "layers.5"),
    }


def convert_classifier(sd: StateDict, depth: int = 5, resnet_blocks: int = 2,
                       attn_blocks: int = 4) -> Dict[str, Any]:
    """Published classifier.pth: depth 5 (15 enc.res entries), the
    raw-audio init conv (32, 1, 3) (``classifier.ClassifierConfig``)."""
    res, idx = [], 0
    for _ in range(depth):
        for _ in range(resnet_blocks):
            res.append({"res": _res_block_arch(sd, f"enc.res.{idx}")})
            idx += 1
        res.append({"down": {"op": _conv(sd, f"enc.res.{idx}.op")}})
        idx += 1
    return {
        "enc": {
            "init": _conv(sd, "enc.init.0"),
            "res": res,
            "final_norm": _norm(sd, "enc.final.0"),
            "final_conv": _conv(sd, "enc.final.2"),
            "attn": [_attention_block(sd, f"enc.attn.{i}")
                     for i in range(attn_blocks)],
        },
        "head": _lin(sd, "head"),
    }


# ---------------------------------------------------------------------------
# DVAE — reference dvae.py state_dict layout
# ---------------------------------------------------------------------------


def _dvae_res(sd: StateDict, prefix: str) -> Dict[str, Any]:
    return {"c1": _conv(sd, prefix + ".net.0"),
            "c2": _conv(sd, prefix + ".net.2"),
            "c3": _conv(sd, prefix + ".net.4")}


def convert_dvae(sd: StateDict, num_layers: int = 2,
                 num_resnet_blocks: int = 3) -> Dict[str, Any]:
    n, r = num_layers, num_resnet_blocks
    return {
        "enc_convs": [_conv(sd, f"encoder.{i}.0") for i in range(n)],
        "enc_res": [_dvae_res(sd, f"encoder.{n + i}") for i in range(r)],
        "enc_out": _conv(sd, f"encoder.{n + r}"),
        "dec_in": _conv(sd, "decoder.0"),
        "dec_res": [_dvae_res(sd, f"decoder.{1 + i}") for i in range(r)],
        "dec_convs": [_conv(sd, f"decoder.{1 + r + i}.0.conv")
                      for i in range(n)],
        "dec_out": _conv(sd, f"decoder.{1 + r + n}"),
        "codebook": {"embed": _np(sd["codebook.embed"]),
                     "cluster_size": _np(sd["codebook.cluster_size"]),
                     "embed_avg": _np(sd["codebook.embed_avg"])},
    }


# ---------------------------------------------------------------------------
# UnifiedVoice — reference unified_voice.py state_dict layout
# ---------------------------------------------------------------------------


def convert_unified_voice(sd: StateDict, layers: int = 30) -> Dict[str, Any]:
    def stack_lin(fmt: str, transpose: bool) -> Dict[str, Array]:
        ws, bs = [], []
        for i in range(layers):
            w = _np(sd[fmt.format(i) + ".weight"])
            ws.append(w.T if transpose else w)
            bs.append(_np(sd[fmt.format(i) + ".bias"]))
        return {"w": np.stack(ws), "b": np.stack(bs)}

    def stack_norm(fmt: str) -> Dict[str, Array]:
        return {"scale": np.stack([_np(sd[fmt.format(i) + ".weight"])
                                   for i in range(layers)]),
                "bias": np.stack([_np(sd[fmt.format(i) + ".bias"])
                                  for i in range(layers)])}

    gpt = {
        "ln_1": stack_norm("gpt.h.{}.ln_1"),
        # HF Conv1D: stored (in, out) already
        "attn_qkv": stack_lin("gpt.h.{}.attn.c_attn", transpose=False),
        "attn_proj": stack_lin("gpt.h.{}.attn.c_proj", transpose=False),
        "ln_2": stack_norm("gpt.h.{}.ln_2"),
        "mlp_fc": stack_lin("gpt.h.{}.mlp.c_fc", transpose=False),
        "mlp_proj": stack_lin("gpt.h.{}.mlp.c_proj", transpose=False),
        "ln_f": _norm(sd, "gpt.ln_f"),
    }
    return {
        "conditioning_encoder": convert_conditioning_encoder(
            sd, "conditioning_encoder"),
        "text_embedding": _emb(sd, "text_embedding"),
        "mel_embedding": _emb(sd, "mel_embedding"),
        "text_pos_embedding": _emb(sd, "text_pos_embedding.emb"),
        "mel_pos_embedding": _emb(sd, "mel_pos_embedding.emb"),
        "gpt": gpt,
        "final_norm": _norm(sd, "final_norm"),
        "text_head": _lin(sd, "text_head"),
        "mel_head": _lin(sd, "mel_head"),
    }
