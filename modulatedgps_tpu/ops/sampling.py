"""Reparameterized sampling: Gaussian and Gumbel-softmax (relaxed one-hot).

Replaces reference MixtureGPs/utils.py:8-36 (reparameterize) and the
tfp.distributions.RelaxedOneHotCategorical draw at
reference MixtureGPs/models.py:60.  All randomness is explicit
``jax.random`` keys (threefry) — deterministic, vmappable, shardable.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import default_jitter
from .linalg import add_jitter, cholesky

__all__ = ["reparameterize", "relaxed_one_hot", "gumbel_softmax_logits"]


def reparameterize(mean: jax.Array, var: jax.Array | None, z: jax.Array,
                   *, full_cov: bool = False, jitter: float | None = None) -> jax.Array:
    """mean + z * sqrt(var + jitter); z ~ N(0,1) gives a sample of N(mean, var).

    Diagonal case parity: reference MixtureGPs/utils.py:26-27.
    Full-cov case: mean [..., N, D], var [..., N, N, D]; applies a per-output
    Cholesky (the reference's full-cov branch is dead TF1 code,
    utils.py:28-36 — this one works).
    """
    if var is None:
        return mean
    jit = default_jitter(mean.dtype) if jitter is None else jitter
    if not full_cov:
        return mean + z * jnp.sqrt(var + jit)
    # var [..., N, N, D] -> [..., D, N, N]
    varT = jnp.moveaxis(var, -1, -3)
    chol = cholesky(add_jitter(varT, jit))
    zT = jnp.swapaxes(z, -1, -2)[..., None]           # [..., D, N, 1]
    f = jnp.swapaxes(mean, -1, -2) + jnp.matmul(chol, zT)[..., 0]
    return jnp.swapaxes(f, -1, -2)


def gumbel_softmax_logits(key: jax.Array, logits: jax.Array,
                          temperature: float) -> jax.Array:
    """(logits + G) / tau with G ~ Gumbel(0,1) — the pre-softmax logits of a
    RelaxedOneHotCategorical sample (tfp parity for
    reference MixtureGPs/models.py:60, temperature=1e-2)."""
    g = jax.random.gumbel(key, logits.shape, dtype=logits.dtype)
    return (logits + g) / jnp.asarray(temperature, logits.dtype)


def relaxed_one_hot(key: jax.Array, logits: jax.Array,
                    temperature: float = 1e-2) -> jax.Array:
    """Sample soft one-hot weights over the trailing axis.

    softmax is shift-invariant, so dividing by tau=1e-2 (x100 logits) stays
    finite in float32 — no fp64 island needed.
    """
    return jax.nn.softmax(gumbel_softmax_logits(key, logits, temperature), axis=-1)
