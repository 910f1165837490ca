"""Mirostat v1 (``ops/sampling.mirostat_step``) against the JAX package's
``mirostat_step`` on fixed logits: the dynamic-k mask and the ``mu``
update, and a draw with the JAX package's uniforms injected.

The JAX package draws through ``jax.random.categorical``: the argmax of
the logits plus Gumbel noise -log(-log u), u uniform in [tiny, 1) from
the row's key.  The draw test hands the port those uniforms.  Tolerances:
masks and tokens exact; ``mu`` 1e-5 (fp32 sums in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tortoise_tts_tpu.ops import sampling as jsampling
from tortoise_tts_tpu_torch.ops import sampling as tsampling

B, V = 3, 400


def _case(seed):
    """Zipf-like logits (Mirostat estimates the exponent from the top 100)
    with noise, and running surprises around and away from 2 tau."""
    rng = np.random.RandomState(seed)
    base = -1.1 * np.log(np.arange(1, V + 1))
    logits = np.stack([rng.permutation(base + 0.3 * rng.randn(V))
                       for _ in range(B)]).astype(np.float32)
    mu = np.asarray([6.0, 3.5, 9.0], np.float32)
    return logits, mu


@pytest.mark.parametrize("tau,eta", [(3.0, 0.2), (5.0, 0.1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_mirostat_mask_and_mu_match_jax(monkeypatch, seed, tau, eta):
    """The logits each draws from (the top-k mask with the dynamic k) and
    the new mu, the draw's Gumbel noise made the same on both sides."""
    logits, mu = _case(seed)
    noise = np.random.RandomState(seed + 10).gumbel(size=(B, V)) \
        .astype(np.float32)
    masks = {}

    def jax_draw(key, masked):
        masks["jax"] = np.asarray(masked)
        return jnp.argmax(masked + jnp.asarray(noise), axis=-1)

    def port_draw(masked, uniforms):
        masks["port"] = masked.numpy()
        return (masked + torch.from_numpy(noise)).argmax(-1)

    monkeypatch.setattr(jsampling, "categorical_rows", jax_draw)
    monkeypatch.setattr(tsampling, "categorical_rows", port_draw)
    jtok, jmu = jsampling.mirostat_step(jax.random.PRNGKey(0),
                                        jnp.asarray(logits),
                                        jnp.asarray(mu), tau, eta)
    ttok, tmu = tsampling.mirostat_step(torch.from_numpy(logits),
                                        torch.from_numpy(mu), None, tau, eta)
    kept = masks["port"] > tsampling.NEG_INF
    np.testing.assert_array_equal(kept, masks["jax"] > jsampling.NEG_INF)
    assert 1 <= kept.sum(-1).min() and kept.sum(-1).max() < V
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mirostat_draw_with_jax_uniforms(seed):
    """The JAX package's own draw from per-row keys, and the port's from
    those keys' uniforms."""
    logits, mu = _case(seed)
    keys = jax.random.split(jax.random.PRNGKey(100 + seed), B)
    jtok, jmu = jsampling.mirostat_step(keys, jnp.asarray(logits),
                                        jnp.asarray(mu))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    u = np.stack([np.asarray(jax.random.uniform(k, (V,), jnp.float32,
                                                minval=tiny, maxval=1.0))
                  for k in keys])
    ttok, tmu = tsampling.mirostat_step(torch.from_numpy(logits),
                                        torch.from_numpy(mu),
                                        torch.from_numpy(u))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=1e-5,
                               rtol=1e-5)
