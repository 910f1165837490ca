"""Carry weights across from the JAX package.

A JAX parameter pytree, given as nested dicts and lists of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), becomes the port's
parameters leaf for leaf: the port keeps the JAX layouts (linear ``w``
is ``(in, out)``, conv ``w`` is ``(out, in, k)``), so no key map is
written.  The int8 decode weights ``{'wq', 's', 'b'}`` keep their types.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]

UNIFIED_VOICE_KEYS = {"conditioning_encoder", "text_embedding",
                      "mel_embedding", "text_pos_embedding",
                      "mel_pos_embedding", "gpt", "final_norm", "text_head",
                      "mel_head"}
GPT_KEYS = {"ln_1", "attn_qkv", "attn_proj", "ln_2", "mlp_fc", "mlp_proj",
            "ln_f"}
DECODE_KEYS = {"attn_qkv", "attn_proj", "mlp_fc", "mlp_proj"}
HIFIGAN_KEYS = {"conv_pre", "cond_layer", "ups", "resblocks", "conv_post"}
DIFFUSION_KEYS = {"inp_block", "time_embed_0", "time_embed_2",
                  "code_embedding", "code_converter", "code_norm",
                  "latent_conditioner_conv", "latent_conditioner_attn",
                  "contextual_embedder_conv0", "contextual_embedder_conv1",
                  "contextual_embedder_attn", "unconditioned_embedding",
                  "conditioning_timestep_integrator", "integrating_conv",
                  "mel_head", "layers", "final_res", "out_norm", "out_conv"}
BIGVGAN_KEYS = {"conv_pre", "ups", "resblocks", "activation_post",
                "conv_post"}
CLVP_KEYS = {"text_emb", "speech_emb", "to_text_latent", "to_speech_latent",
             "text_transformer", "speech_transformer", "temperature"}
CLVP_LAYER_KEYS = {"attn_norm", "to_q", "to_k", "to_v", "to_out", "ff_norm",
                   "ff_proj", "ff_out"}
RLG_KEYS = {"equal_linears", "final"}
UNIVNET_KEYS = {"conv_pre", "conv_post", "res_stack"}
UNIVNET_BLOCK_KEYS = {"kernel_predictor", "convt_pre", "conv_blocks"}
DVAE_KEYS = {"enc_convs", "enc_res", "enc_out", "dec_in", "dec_res",
             "dec_convs", "dec_out", "codebook"}
DVAE_CODEBOOK_KEYS = {"embed", "cluster_size", "embed_avg"}
CLASSIFIER_KEYS = {"enc", "head"}
MINI_ENCODER_KEYS = {"init", "res", "final_norm", "final_conv", "attn"}
ATTENTION_KEYS = {"norm", "qkv", "proj_out"}
DISC_KEYS = {"mpd", "mrd"}
WN_CONV_KEYS = {"v", "g", "b"}


def to_torch(tree, device=None, dtype: Optional[torch.dtype] = None):
    """Nested dicts / lists of arrays -> the same of tensors; floating
    leaves cast to ``dtype`` when given."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bf16, unknown to torch
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device) if device is not None else t


def to_numpy(tree):
    """The inverse: tensors -> numpy arrays (float32 for bf16)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _check_keys(tree, want, what: str):
    if not isinstance(tree, dict) or set(tree) != want:
        got = set(tree) if isinstance(tree, dict) else type(tree).__name__
        raise KeyError(f"{what}: expected keys {sorted(want)}, got {got}")


def unified_voice_from_jax(params, device=None,
                           dtype: Optional[torch.dtype] = None) -> Params:
    _check_keys(params, UNIFIED_VOICE_KEYS, "UnifiedVoice params")
    _check_keys(params["gpt"], GPT_KEYS, "UnifiedVoice params['gpt']")
    return to_torch(params, device, dtype)


def decode_weights_from_jax(qgpt, device=None) -> Params:
    """``quantize_decode_weights`` output: int8 ``wq``, fp32 ``s``/``b``."""
    _check_keys(qgpt, DECODE_KEYS, "int8 decode weights")
    for name, p in qgpt.items():
        if np.asarray(p["wq"]).dtype != np.int8:
            raise TypeError(f"{name}.wq must be int8")
    return to_torch(qgpt, device)


def hifigan_from_jax(params, device=None,
                     dtype: Optional[torch.dtype] = None) -> Params:
    _check_keys(params, HIFIGAN_KEYS, "HiFiGAN params")
    return to_torch(params, device, dtype)


def diffusion_from_jax(params, device=None,
                       dtype: Optional[torch.dtype] = None) -> Params:
    _check_keys(params, DIFFUSION_KEYS, "DiffusionTTS params")
    return to_torch(params, device, dtype)


def bigvgan_from_jax(params, device=None,
                     dtype: Optional[torch.dtype] = None) -> Params:
    _check_keys(params, BIGVGAN_KEYS, "BigVGAN params")
    return to_torch(params, device, dtype)


def clvp_from_jax(params, device=None,
                  dtype: Optional[torch.dtype] = None) -> Params:
    _check_keys(params, CLVP_KEYS, "CLVP params")
    for tower in ("text_transformer", "speech_transformer"):
        _check_keys(params[tower], {"layers", "final_norm"},
                    f"CLVP params['{tower}']")
        for lp in params[tower]["layers"]:
            _check_keys(lp, CLVP_LAYER_KEYS, f"CLVP {tower} layer")
    return to_torch(params, device, dtype)


def rlg_from_jax(params, device=None,
                 dtype: Optional[torch.dtype] = None) -> Params:
    _check_keys(params, RLG_KEYS, "RandomLatentConverter params")
    return to_torch(params, device, dtype)


def univnet_from_jax(params, device=None,
                     dtype: Optional[torch.dtype] = None) -> Params:
    _check_keys(params, UNIVNET_KEYS, "UnivNet params")
    for blk in params["res_stack"]:
        _check_keys(blk, UNIVNET_BLOCK_KEYS, "UnivNet res_stack block")
    return to_torch(params, device, dtype)


def dvae_from_jax(params, device=None,
                  dtype: Optional[torch.dtype] = None) -> Params:
    """The DVAE with its EMA codebook buffers (``embed``,
    ``cluster_size``, ``embed_avg``)."""
    _check_keys(params, DVAE_KEYS, "DVAE params")
    _check_keys(params["codebook"], DVAE_CODEBOOK_KEYS, "DVAE codebook")
    return to_torch(params, device, dtype)


def bigvgan_disc_from_jax(params, device=None,
                          dtype: Optional[torch.dtype] = None) -> Params:
    """The MultiPeriod + MultiResolution discriminators (lists of
    ``{"convs", "post"}``, weight-norm OIHW convs ``{"v", "g", "b"}``)."""
    _check_keys(params, DISC_KEYS, "BigVGAN discriminator params")
    for d in params["mpd"] + params["mrd"]:
        _check_keys(d, {"convs", "post"}, "BigVGAN discriminator")
        for c in d["convs"] + [d["post"]]:
            _check_keys(c, WN_CONV_KEYS, "weight-norm conv")
    return to_torch(params, device, dtype)


def classifier_from_jax(params, device=None,
                        dtype: Optional[torch.dtype] = None) -> Params:
    """The audio classifier: the AudioMiniEncoder (``enc``: its init conv,
    res blocks and downsamples, final norm and conv, attention blocks)
    and the linear ``head``."""
    _check_keys(params, CLASSIFIER_KEYS, "classifier params")
    enc = params["enc"]
    _check_keys(enc, MINI_ENCODER_KEYS, "classifier params['enc']")
    for blk in enc["res"]:
        if not isinstance(blk, dict) or len(blk) != 1 \
                or set(blk) not in ({"res"}, {"down"}):
            raise KeyError(f"classifier res entry: expected one of 'res', "
                           f"'down', got {blk!r:.80}")
    for a in enc["attn"]:
        _check_keys(a, ATTENTION_KEYS, "classifier attention block")
    return to_torch(params, device, dtype)
