"""KL divergence between the variational posterior q(u) and the prior.

Parity with gpflow ``kullback_leiblers.gauss_kl`` as reached from
``prior_kl()`` at reference MixtureGPs/models.py:79.  The demos all use
whiten=True, where KL[q(u) || N(0, I)] has the cheap closed form below
(no solves); the unwhitened form (prior covariance K) is also provided.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .linalg import cholesky, solve_triangular

__all__ = ["gauss_kl"]


def _kl_white_tril_val(q_mu, Lq):
    M, K = q_mu.shape
    mahalanobis = jnp.sum(jnp.square(q_mu))
    idx = jnp.arange(M)
    d = Lq[..., idx, idx]                                 # [K, M]
    logdet_qcov = 2.0 * jnp.sum(jnp.log(jnp.abs(d)))
    trace = jnp.sum(jnp.square(Lq))
    return 0.5 * (mahalanobis - jnp.asarray(M * K, q_mu.dtype)
                  - logdet_qcov + trace)


@jax.custom_vjp
def _kl_white_tril(q_mu: jax.Array, Lq: jax.Array) -> jax.Array:
    """Whitened KL for a lower-triangular q_sqrt, with a hand-written
    backward.

    Autodiff of the closed form materializes the log-det gradient as a
    dense [K, M, M] scatter-add of 1/diag plus layout copies — at M=4096
    that is several full 537 MB passes per layer per step.  The analytic
    cotangent is one fused elementwise pass:

        d/d q_mu  = g * q_mu
        d/d Lq    = g * (Lq - diag_embed(1/diag(Lq)))   (upper stays 0)
    """
    return _kl_white_tril_val(q_mu, Lq)


def _kl_white_tril_fwd(q_mu, Lq):
    return _kl_white_tril_val(q_mu, Lq), (q_mu, Lq)


def _dense_kl_bwd(res, g):
    q_mu, Lq = res
    M = Lq.shape[-1]
    i = jnp.arange(M)
    eye = i[:, None] == i[None, :]
    safe = jnp.where(eye, Lq, jnp.ones_like(Lq))
    dLq = g * jnp.where(eye, Lq - 1.0 / safe, Lq)
    return g * q_mu, dLq


_kl_white_tril.defvjp(_kl_white_tril_fwd, _dense_kl_bwd)


def gauss_kl(q_mu: jax.Array, q_sqrt: jax.Array,
             Kmm: jax.Array | None = None, *,
             assume_tril: bool = False) -> jax.Array:
    """KL[q(u) || p(u)] summed over the K independent latent GPs.

    q_mu: [M, K]; q_sqrt: [K, M, M] lower-tri or [M, K] diagonal std-devs.
    Kmm=None means whitened prior N(0, I) (the demos' configuration,
    reference demos/demo_tf2.py:43 whiten=True).

    ``assume_tril=True`` promises a rank-3 q_sqrt is ALREADY lower
    triangular (e.g. it came through Parameter's "tril" transform) and
    skips the defensive jnp.tril — saving a full [K, M, M] read/write in
    the forward and its select in the backward.
    """
    M, K = q_mu.shape
    dtype = q_mu.dtype
    diag = q_sqrt.ndim == 2

    if Kmm is None:
        alpha = q_mu                                  # [M, K]
        mahalanobis = jnp.sum(jnp.square(alpha))
    else:
        Lp = cholesky(Kmm)                            # [M, M]
        alpha = solve_triangular(Lp, q_mu, lower=True)
        mahalanobis = jnp.sum(jnp.square(alpha))

    if diag:
        logdet_qcov = 2.0 * jnp.sum(jnp.log(q_sqrt))
        if Kmm is None:
            trace = jnp.sum(jnp.square(q_sqrt))
        else:
            Linv = solve_triangular(Lp, jnp.eye(M, dtype=dtype), lower=True)
            # tr(K^-1 S) with S diagonal = sum_i (K^-1)_ii * s_i
            Kinv_diag = jnp.sum(jnp.square(Linv), axis=0)
            trace = jnp.sum(Kinv_diag[:, None] * jnp.square(q_sqrt))
    else:
        Lq = q_sqrt if assume_tril else jnp.tril(q_sqrt)  # [K, M, M]
        if Kmm is None:
            # Hot path (whiten=True): closed form with an analytic VJP —
            # one fused elementwise backward pass instead of autodiff's
            # dense diag scatter-add + layout copies.
            return _kl_white_tril(q_mu, Lq)
        Lq_diag = jnp.diagonal(Lq, axis1=-2, axis2=-1)
        logdet_qcov = 2.0 * jnp.sum(jnp.log(jnp.abs(Lq_diag)))
        LpiLq = solve_triangular(Lp, Lq, lower=True)      # [K, M, M]
        trace = jnp.sum(jnp.square(LpiLq))

    constant = -jnp.asarray(M * K, dtype)
    twoKL = mahalanobis + constant - logdet_qcov + trace

    if Kmm is not None:
        log_det_p = 2.0 * jnp.sum(jnp.log(jnp.diagonal(Lp)))
        twoKL = twoKL + K * log_det_p

    return 0.5 * twoKL
