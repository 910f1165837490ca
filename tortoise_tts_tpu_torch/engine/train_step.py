"""Train steps (port of ``tortoise_tts_tpu/engine/train_step.py``): the
AR step (LoRA, teacher distillation), the diffusion step and the DVAE
step.

Each ``make_*_train_step`` returns ``step(state, batch) -> (state,
metrics)``: the loss and every gradient from ``torch.autograd.grad``
over the trainable leaves, then the optimizer's update of the
parameters in place.  Metrics are 0-d tensors on the device under the
JAX package's names (``loss``, ``grad_norm``, ``loss.text``,
``loss.mel``, ``loss.kl``, ``loss.mse``, ``loss.vb``, ``loss.commit``);
``grad_norm`` is the global norm of the micro-step's raw gradients.

A ``torch.cuda.OutOfMemoryError`` in the forward or the backward leaves
the state as it was; one inside the update marks it not ``intact`` (the
tensors may be half written), and ``Engines.step`` reloads the last
checkpoint.

On the card the kernels carry the forward: K1 in the AR trunk (twice a
layer with ``remat``: the layer runs again in the backward), K4 and K5
in the denoiser's resblocks and attention heads.  Their backwards
recompute the plain versions.  K5 reads its weight tap-major: the
diffusion step prepares it from the live weight inside the loss, so the
kernel never sees a stale copy and the weight's gradient comes through.

Batch layout of the AR step (reference train_feeder, train.py:35-63):
latents (B, D) AR conditioning latents (or cond_mels), text (B, Tt)
stop-padded, text_lengths (B,), codes (B, Tm), wav_lengths (B,).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models import gaussian
from ..models import unified_voice as uv
from ..models.lora import apply_lora
from .optim import Optimizer, global_norm
from .state import TrainState, tree_leaves, tree_unflatten_like

Metrics = Dict[str, torch.Tensor]


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A host batch (numpy) as tensors on the device: integers as int64,
    floats as float32."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def _with_grad(tree):
    """The tree's leaves as new leaves that require grad (detached views
    of the same storage) and the tree over them."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    return leaves, tree_unflatten_like(tree, leaves)


def _grads(loss, leaves):
    """d loss / d leaf for every leaf, zeros where the loss does not use
    it (as ``jax.grad`` gives)."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _apply(state: TrainState, tx: Optimizer, grads) -> torch.Tensor:
    """The optimizer's update, in place; returns the gradients' global
    norm (the metric, and the clip's norm without accumulation).  An OOM
    inside the update leaves the state marked not intact."""
    norm = global_norm(grads)
    try:
        tx.step(state.params, grads, state.opt_state, norm=norm)
    except torch.cuda.OutOfMemoryError:
        state.intact = False
        raise
    return norm


def make_ar_train_step(cfg: uv.UnifiedVoiceConfig, tx: Optimizer,
                       remat: bool = True, lora_cfg=None, base_params=None,
                       teacher_params=None, teacher_alpha: float = 0.5,
                       teacher_temperature: float = 1.0):
    """UnifiedVoice step.  With ``lora_cfg`` the state's params are the
    adapter and ``base_params`` the frozen model; with ``teacher_params``
    a KL term against the frozen teacher's mel logits is blended in."""

    def loss_fn(params, batch):
        if lora_cfg is not None:
            params = apply_lora(base_params, params, lora_cfg.alpha,
                                lora_cfg.rank)
        cond = (uv.get_conditioning(params, batch["cond_mels"], cfg)
                if "cond_mels" in batch else batch["latents"])
        lt, lm, mel_logits = uv.forward(
            params, cond, batch["text"], batch["text_lengths"],
            batch["codes"], batch["wav_lengths"], cfg, return_latent=False,
            remat=remat)
        loss = lt + lm
        parts = {"loss.text": lt, "loss.mel": lm}
        if teacher_params is not None:
            with torch.no_grad():
                _, _, t_logits = uv.forward(
                    teacher_params, cond.detach(), batch["text"],
                    batch["text_lengths"], batch["codes"],
                    batch["wav_lengths"], cfg, return_latent=False)
            t = teacher_temperature
            p_t = torch.softmax(t_logits.float() / t, -1)
            logq = torch.log_softmax(mel_logits.float() / t, -1)
            kl = -(p_t * logq).sum(-1).mean() * (t * t)
            parts["loss.kl"] = kl
            loss = (1 - teacher_alpha) * loss + teacher_alpha * kl
        return loss, parts

    def step(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        leaves, params = _with_grad(state.params)
        loss, parts = loss_fn(params, batch)
        grads = _grads(loss, leaves)
        del params, leaves
        norm = _apply(state, tx, grads)
        state.step += 1
        state.samples_processed += batch["text"].shape[0]
        # a device tensor: no host read in the step
        state.tokens_processed = state.tokens_processed + (
            batch["text_lengths"].sum()
            + (batch["wav_lengths"] // cfg.mel_length_compression).sum())
        return state, {"loss": loss.detach(), "grad_norm": norm,
                       **{k: v.detach() for k, v in parts.items()}}

    return step


def diffusion_draws(seed: int, step: int, batch: int, shape, num_timesteps:
                    int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The diffusion step's t (B,) and noise, drawn on the device from a
    generator seeded by (trainer seed, step), so a resumed run draws what
    the uninterrupted run drew.  (The JAX package draws from
    fold_in(PRNGKey(seed), step): the streams differ, the contract is the
    same.)"""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, step])
                      .generate_state(1, np.uint64)[0]))
    t = torch.randint(0, num_timesteps, (batch,), generator=g,
                      device=device)
    noise = torch.randn(shape, generator=g, device=device)
    return t, noise


def make_diffusion_train_step(cfg, tx: Optimizer,
                              sched: gaussian.DiffusionSchedule,
                              seed: int = 0):
    """DiffusionTTS step (reference GaussianDiffusion.training_losses,
    diffusion.py:847-933).  Batch: mel (B, 100, T) normalised targets,
    latents (B, Tl, 1024), conditioning_latents (B, 2C).  t and the noise
    come from ``diffusion_draws(seed, state.step, ...)``.  x_t is cast to
    the weights' type for the denoiser (the JAX package lets fp32 targets
    promote its bf16 trunk to fp32); q_sample and the losses stay fp32."""
    from ..models import diffusion as dtts

    def loss_fn(params, batch, t, noise):
        x_start = batch["mel"]
        wdtype = params["inp_block"]["w"].dtype
        x_t = gaussian.q_sample(x_start, t, noise, sched)
        params = dtts.prepare(params)   # K5's tap-major weights, live
        code_emb = dtts.timestep_independent(
            params, batch["latents"].to(wdtype),
            batch["conditioning_latents"].to(wdtype), x_start.shape[-1],
            cfg)
        t_orig = torch.as_tensor(sched.timestep_map, device=t.device)[t]
        out = dtts.forward(params, x_t.to(wdtype), t_orig, code_emb, cfg)
        terms = gaussian.training_losses(out, x_start, x_t, t, noise, sched)
        return terms["loss"].mean(), {"loss.mse": terms["mse"].mean(),
                                      "loss.vb": terms["vb"].mean()}

    def step(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        x = batch["mel"]
        t, noise = diffusion_draws(seed, state.step, x.shape[0],
                                   tuple(x.shape), sched.num_timesteps,
                                   x.device)
        leaves, params = _with_grad(state.params)
        loss, parts = loss_fn(params, batch, t, noise.to(x.dtype))
        grads = _grads(loss, leaves)
        del params, leaves
        norm = _apply(state, tx, grads)
        state.step += 1
        state.samples_processed += x.shape[0]
        return state, {"loss": loss.detach(), "grad_norm": norm,
                       **{k: v.detach() for k, v in parts.items()}}

    return step


def make_dvae_train_step(cfg, tx: Optimizer):
    """DVAE step: reconstruction + commitment losses, the codebook's EMA
    update written over its buffers out of the gradient (dvae.py:281-302)."""
    from ..models import dvae as dvae_m

    def step(state: TrainState, batch) -> Tuple[TrainState, Metrics]:
        leaves, params = _with_grad(state.params)
        recon, commit, _, _, new_vq = dvae_m.forward(params, batch["mel"],
                                                     cfg, training=True)
        loss = recon.mean() + commit
        # the codebook buffers move by EMA only: their gradients are zero
        # (the loss reaches them through no differentiable path)
        grads = _grads(loss, leaves)
        del params, leaves
        _apply(state, tx, grads)
        with torch.no_grad():
            for k, v in zip(("embed", "cluster_size", "embed_avg"), new_vq):
                state.params["codebook"][k].copy_(v)
        state.step += 1
        state.samples_processed += batch["mel"].shape[0]
        return state, {"loss": loss.detach(), "loss.commit": commit.detach()}

    return step


def ar_latents(params, cfg: uv.UnifiedVoiceConfig, batch) -> torch.Tensor:
    """The AR hidden states the diffusion feeder conditions on: the latent
    pass of ``unified_voice.forward`` without gradient."""
    with torch.no_grad():
        return uv.forward(params, batch["latents"], batch["text"],
                          batch["text_lengths"], batch["codes"],
                          batch["wav_lengths"], cfg, return_latent=True)
