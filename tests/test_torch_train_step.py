"""The port's train steps against the JAX package's on the same params and
inputs, fp32 on the CPU: the AR step (with remat, LoRA and the teacher's
KL term), the diffusion step with the JAX package's t and noise injected,
and the DVAE step with its EMA codebook update.  Losses and every
gradient leaf within rtol 1e-4 / atol 1e-6 (``TOL``); the parameters
after 3 AdamW updates (warmup, MultiSteps k=2, clipping) within rtol
1e-4 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tortoise_tts_tpu.config import Hyperparameters as JHp
from tortoise_tts_tpu.engine import optim as joptim
from tortoise_tts_tpu.engine import state as jst
from tortoise_tts_tpu.engine import train_step as jts
from tortoise_tts_tpu.models import gaussian as jgauss
from tortoise_tts_tpu.models.lora import apply_lora as japply_lora
from tortoise_tts_tpu.models.lora import init_lora as jinit_lora
from tortoise_tts_tpu_torch.config import Hyperparameters, LoRAConfig
from tortoise_tts_tpu_torch.engine import optim, train_step as ts
from tortoise_tts_tpu_torch.engine.state import (flatten_tree, init_state,
                                                 tree_leaves)
from tortoise_tts_tpu_torch.models import gaussian

from tests.torch_train_util import (CFGS, MODULES, TOL, ar_batch, jax_params,
                                    np_tree, port_params)
from tests.torch_train_util import one_thread  # noqa: F401

pytestmark = [pytest.mark.filterwarnings("ignore::DeprecationWarning"),
              pytest.mark.usefixtures("one_thread")]


class Recorder:
    """An optimizer stand-in that keeps the step's gradients."""

    def init(self, params):
        return {}

    def step(self, params, grads, state, norm=None):
        self.grads = dict(zip(flatten_tree(params), grads))
        return True


def _jflat(tree):
    return {k: np.asarray(v) for k, v in jst.flatten_tree(tree).items()}


def _close_trees(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                   err_msg=k, **tol)


def _dev(batch):
    return ts.to_device(batch, "cpu")


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [False, True])
def test_ar_step_loss_and_grads_match_jax(remat):
    jcfg, tcfg = CFGS["autoregressive"]
    jp = jax_params("autoregressive")
    batch = ar_batch()

    def jloss(p):
        lt, lm, _ = MODULES["autoregressive"][0].forward(
            p, jnp.asarray(batch["latents"]), jnp.asarray(batch["text"]),
            jnp.asarray(batch["text_lengths"]), jnp.asarray(batch["codes"]),
            jnp.asarray(batch["wav_lengths"]), jcfg, remat=remat)
        return lt + lm, (lt, lm)

    (jl, (jlt, jlm)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    rec = Recorder()
    step = ts.make_ar_train_step(tcfg, rec, remat=remat)
    state, m = step(init_state(port_params(jp), rec), _dev(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jl), **TOL)
    np.testing.assert_allclose(float(m["loss.text"]), float(jlt), **TOL)
    np.testing.assert_allclose(float(m["loss.mel"]), float(jlm), **TOL)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(optax.global_norm(jg)), **TOL)
    _close_trees(rec.grads, _jflat(jg))
    assert state.step == 1 and state.samples_processed == 2


def test_ar_lora_teacher_step_matches_jax():
    """Adapter training with the frozen teacher's KL term: the adapter's
    gradients and the three loss parts."""
    jcfg, tcfg = CFGS["autoregressive"]
    base = jax_params("autoregressive")
    teacher = jax_params("autoregressive", seed=99)
    lora = np_tree(jinit_lora(jax.random.PRNGKey(3),
                              jax.tree_util.tree_map(jnp.asarray, base),
                              rank=4))
    rng = np.random.RandomState(4)
    for ab in lora["gpt"].values():     # b = 0 would hide a's gradient
        ab["b"] = (rng.randn(*ab["b"].shape) * 0.05).astype(np.float32)
    lcfg = LoRAConfig(rank=4, alpha=8)
    batch = ar_batch(seed=2)
    T, alpha = 2.0, 0.3

    def jloss(lp):
        p = japply_lora(jax.tree_util.tree_map(jnp.asarray, base), lp,
                        lcfg.alpha, lcfg.rank)
        jb = _jbatch(batch)
        juv = MODULES["autoregressive"][0]
        lt, lm, logits = juv.forward(p, jb["latents"], jb["text"],
                                     jb["text_lengths"], jb["codes"],
                                     jb["wav_lengths"], jcfg)
        _, _, tl = juv.forward(jax.tree_util.tree_map(jnp.asarray, teacher),
                               jb["latents"], jb["text"], jb["text_lengths"],
                               jb["codes"], jb["wav_lengths"], jcfg)
        p_t = jax.nn.softmax(tl / T, -1)
        kl = -jnp.mean(jnp.sum(p_t * jax.nn.log_softmax(logits / T, -1),
                               -1)) * T * T
        return (1 - alpha) * (lt + lm) + alpha * kl, kl

    (jl, jkl), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, lora))
    rec = Recorder()
    step = ts.make_ar_train_step(
        tcfg, rec, remat=True, lora_cfg=lcfg, base_params=port_params(base),
        teacher_params=port_params(teacher), teacher_alpha=alpha,
        teacher_temperature=T)
    _, m = step(init_state(port_params(lora), rec), _dev(batch))
    np.testing.assert_allclose(float(m["loss"]), float(jl), **TOL)
    np.testing.assert_allclose(float(m["loss.kl"]), float(jkl), **TOL)
    _close_trees(rec.grads, _jflat(jg))


def _diff_batch(seed=0, b=2, t=64):
    rng = np.random.RandomState(seed)
    return {"mel": np.clip(rng.randn(b, 100, t) * 0.3, -1, 1
                           ).astype(np.float32),
            "latents": rng.randn(b, 12, 64).astype(np.float32),
            "conditioning_latents": rng.randn(b, 128).astype(np.float32)}


def test_diffusion_step_loss_and_grads_match_jax(monkeypatch):
    """The JAX package's t and noise from its fold_in(seed, step) draw,
    injected into the port's step through ``diffusion_draws``."""
    jcfg, tcfg = CFGS["diffusion"]
    jp = jax_params("diffusion")
    batch = _diff_batch()
    sched = jgauss.get_schedule(steps=4000, cond_free=False)
    rng = jax.random.fold_in(jax.random.PRNGKey(7), 0)
    k_t, k_n = jax.random.split(rng)
    t = jax.random.randint(k_t, (2,), 0, sched.num_timesteps)
    noise = jax.random.normal(k_n, batch["mel"].shape, jnp.float32)
    jdiff = MODULES["diffusion"][0]

    def jloss(p):
        x0 = jnp.asarray(batch["mel"])
        x_t = jgauss.q_sample(x0, t, noise, sched)
        code = jdiff.timestep_independent(
            p, jnp.asarray(batch["latents"]),
            jnp.asarray(batch["conditioning_latents"]), x0.shape[-1], jcfg)
        out = jdiff.forward(p, x_t, jnp.asarray(sched.timestep_map)[t],
                            code, jcfg)
        terms = jgauss.training_losses(out, x0, x_t, t, noise, sched)
        return terms["loss"].mean(), (terms["mse"].mean(),
                                      terms["vb"].mean())

    (jl, (jmse, jvb)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    seen = []

    def draws(seed, step, b, shape, n, device):
        seen.append((seed, step, b, tuple(shape), n))
        return (torch.from_numpy(np.array(t)).long(),
                torch.from_numpy(np.array(noise)))

    monkeypatch.setattr(ts, "diffusion_draws", draws)
    rec = Recorder()
    step = ts.make_diffusion_train_step(
        tcfg, rec, gaussian.get_schedule(steps=4000, cond_free=False),
        seed=7)
    _, m = step(init_state(port_params(jp), rec), _dev(batch))
    assert seen == [(7, 0, 2, (2, 100, 64), 4000)]
    np.testing.assert_allclose(float(m["loss"]), float(jl), **TOL)
    np.testing.assert_allclose(float(m["loss.mse"]), float(jmse), **TOL)
    np.testing.assert_allclose(float(m["loss.vb"]), float(jvb), **TOL)
    _close_trees(rec.grads, _jflat(jg))


def test_diffusion_draws_replay_by_step():
    """A resumed run draws what the uninterrupted run drew: the draw is a
    function of (seed, step) only."""
    a = ts.diffusion_draws(3, 5, 2, (2, 4, 8), 4000, "cpu")
    b = ts.diffusion_draws(3, 5, 2, (2, 4, 8), 4000, "cpu")
    c = ts.diffusion_draws(3, 6, 2, (2, 4, 8), 4000, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
    assert int(a[0].min()) >= 0 and int(a[0].max()) < 4000


def test_dvae_step_loss_grads_and_codebook_match_jax():
    """Recon + commitment loss and gradients (the codebook's zero), then
    the EMA codebook the step writes over the buffers."""
    jcfg, tcfg = CFGS["dvae"]
    jp = jax_params("dvae")
    mel = (np.random.RandomState(1).randn(2, 80, 64) * 0.5
           ).astype(np.float32)
    jdvae = MODULES["dvae"][0]

    def jloss(p):
        recon, commit, _, _, vq = jdvae.forward(p, jnp.asarray(mel), jcfg,
                                                training=True)
        return recon.mean() + commit, (commit, vq)

    (jl, (jc, jvq)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp))
    jg["codebook"] = jax.tree_util.tree_map(jnp.zeros_like, jg["codebook"])
    rec = Recorder()
    step = ts.make_dvae_train_step(tcfg, rec)
    state, m = step(init_state(port_params(jp), rec),
                    _dev({"mel": mel}))
    np.testing.assert_allclose(float(m["loss"]), float(jl), **TOL)
    np.testing.assert_allclose(float(m["loss.commit"]), float(jc), **TOL)
    _close_trees(rec.grads, _jflat(jg))
    for k, v in zip(("embed", "cluster_size", "embed_avg"), jvq):
        np.testing.assert_allclose(state.params["codebook"][k].numpy(),
                                   np.asarray(v), err_msg=k, **TOL)


def _jtx(**hp):
    return joptim.make_optimizer(JHp(**hp))


def test_ar_step_params_after_three_adamw_updates_match_jax():
    """Six micro-steps, MultiSteps k=2: three AdamW updates with a 2-update
    warmup (lr 0 at the first) and clipping at 1.0."""
    hp = dict(optimizer="AdamW", learning_rate=1e-3, warmup_steps=2,
              gradient_accumulation_steps=2, gradient_clipping=1.0)
    jcfg, tcfg = CFGS["autoregressive"]
    jp = jax_params("autoregressive")
    jtx = _jtx(**hp)
    jstep = jts.make_ar_train_step(jcfg, jtx, remat=False, donate=False)
    jstate = jst.init_state(jax.tree_util.tree_map(jnp.asarray, jp), jtx)
    tx = optim.make_optimizer(Hyperparameters(**hp))
    step = ts.make_ar_train_step(tcfg, tx, remat=True)
    state = init_state(port_params(jp), tx)
    for i in range(6):
        batch = ar_batch(seed=10 + i % 3)
        jstate, jm = jstep(jstate, _jbatch(batch))
        state, m = step(state, _dev(batch))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **TOL)
    assert int(state.opt_state["gradient_step"]) == 3
    assert state.step == int(jstate.step) == 6
    assert int(state.tokens_processed) == int(jstate.tokens_processed)
    _close_trees(flatten_tree(state.params), _jflat(jstate.params))
    first = tree_leaves(state.params)[0]
    assert first.dtype == torch.float32


@pytest.mark.parametrize("n", [1, 2, 9, 130])
def test_rel_pos_bias_backward_sums_the_diagonals(n):
    """The denoiser's rel-pos bias: the gather forward, and a backward by
    diagonal sums equal to the gather's own backward (float64); its cached
    bucket tensors, first made under inference_mode, still serve a
    backward."""
    from tortoise_tts_tpu_torch.ops.attention import (rel_pos_bias_from_table,
                                                      t5_rel_pos_bucket)
    g = torch.Generator().manual_seed(n)
    w = torch.randn(32, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    with torch.inference_mode():    # a serving call may come first
        rel_pos_bias_from_table(w.detach(), n + 1000, n + 1000)
    with torch.inference_mode(False):
        rel_pos_bias_from_table(w, n + 1000, n + 1000).sum().backward()
    w.grad = None
    got = rel_pos_bias_from_table(w, n, n)
    bucket = torch.as_tensor(t5_rel_pos_bucket(n, n), dtype=torch.long)
    want = w[bucket].permute(2, 0, 1)
    assert torch.equal(got, want)
    up = torch.randn(got.shape, dtype=torch.float64, generator=g)
    a, = torch.autograd.grad(got, w, up)
    b, = torch.autograd.grad(want, w, up)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
