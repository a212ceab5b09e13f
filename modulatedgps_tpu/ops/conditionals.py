"""Sparse-GP conditional: the Cholesky→TRSM→matmul chain.

Rebuilds gpflow's ``base_conditional`` (the compute core reached from
reference MixtureGPs/models.py:141-143) as pure JAX.  Given the
inducing-point covariances this produces the marginal posterior
q(f(Xnew)) = N(fmean, fvar) of an SVGP with variational posterior
q(u) = N(q_mu, q_sqrt q_sqrt^T):

    Lm   = chol(Kmm)
    A    = Lm^-1 Kmn                       # whitened feature map
    fvar = Knn - A^T A (+ q_sqrt term)
    A    = Lm^-T A         (only when whiten=False)
    fmean = A^T q_mu

Shapes follow gpflow: Kmn [M, N], Kmm [M, M], Knn [N] (diag) or [N, N],
q_mu [M, K], q_sqrt [K, M, M] lower-triangular (or [M, K] diagonal).
Returns ([N, K], [N, K]) for full_cov=False or ([N, K], [K, N, N]) for
full_cov=True.

Everything here is batched matmul plus triangular solves; K latents are a
leading batch axis, never a Python loop.  Float32 inputs use float32
accumulation via preferred_element_type.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .linalg import cholesky, solve_lower, whiten_solve

__all__ = ["base_conditional", "sgp_conditional", "expand_independent_outputs"]


def expand_independent_outputs(fvar: jax.Array, full_cov: bool,
                               full_output_cov: bool) -> jax.Array:
    """gpflow expand_independent_outputs parity — the posterior post-processing
    step the reference reaches via _post_process_mean_and_cov (reference
    MixtureGPs/models.py:144).  The K latent GPs are independent, so the
    full-output covariance is (block-)diagonal over the output axis:

      full_cov, full_output_cov:       [K, N, N] -> [N, K, N, K]
      diag,     full_output_cov:       [N, K]    -> [N, K, K]
      otherwise: unchanged ([K, N, N] or [N, K]).
    """
    if not full_output_cov:
        return fvar
    if full_cov:
        # [K, N, N] -> [N, N, K] -> diag-embed -> [N, N, K, K] -> [N, K, N, K]
        d = jnp.moveaxis(fvar, 0, -1)
        K = d.shape[-1]
        full = d[..., :, None] * jnp.eye(K, dtype=fvar.dtype)
        return jnp.transpose(full, (0, 2, 1, 3))
    K = fvar.shape[-1]
    return fvar[..., :, None] * jnp.eye(K, dtype=fvar.dtype)  # [N, K, K]


def base_conditional(Kmn: jax.Array, Kmm: jax.Array, Knn: jax.Array,
                     q_mu: jax.Array, *, q_sqrt: jax.Array | None = None,
                     full_cov: bool = False, white: bool = True,
                     assume_tril: bool = False):
    """gpflow base_conditional parity (see module docstring).

    ``assume_tril=True`` promises a rank-3 q_sqrt is already lower
    triangular (e.g. via Parameter's "tril" transform), skipping the
    defensive jnp.tril — one fewer full [K, M, M] pass forward and one
    fewer select backward."""
    if white:
        # chol -> solve with one composite pullback in the fast-solves
        # form (linalg.whiten_solve).
        A = whiten_solve(Kmm, Kmn)
        return _conditional_tail(A, None, Knn, q_mu, q_sqrt=q_sqrt,
                                 full_cov=full_cov, white=True,
                                 assume_tril=assume_tril)
    Lm = cholesky(Kmm)
    return conditional_from_chol(Kmn, Lm, Knn, q_mu, q_sqrt=q_sqrt,
                                 full_cov=full_cov, white=white,
                                 assume_tril=assume_tril)


def conditional_from_chol(Kmn, Lm, Knn, q_mu, *, q_sqrt=None,
                          full_cov=False, white=True, assume_tril=False):
    """Same as base_conditional but with the Cholesky factor precomputed
    (lets callers amortize chol(Kmm) across prediction batches)."""
    A = solve_lower(Lm, Kmn)                           # [M, N]
    return _conditional_tail(A, Lm, Knn, q_mu, q_sqrt=q_sqrt,
                             full_cov=full_cov, white=white,
                             assume_tril=assume_tril)


def _conditional_tail(A, Lm, Knn, q_mu, *, q_sqrt, full_cov, white,
                      assume_tril):
    """Everything downstream of the whitened feature map A = Lm^-1 Kmn.

    Lm is only consulted when white=False (the de-whitening trans-solve);
    the fused-A path passes None."""
    dtype = A.dtype

    if full_cov:
        fvar = Knn - jnp.matmul(jnp.swapaxes(A, -1, -2), A,
                                preferred_element_type=dtype)  # [N, N]
    else:
        fvar = Knn - jnp.sum(jnp.square(A), axis=-2)   # [N]

    if not white:
        A = solve_lower(Lm, A, trans=True)             # Lm^-T A

    fmean = jnp.matmul(jnp.swapaxes(A, -1, -2), q_mu,
                       preferred_element_type=dtype)   # [N, K]

    K = q_mu.shape[-1]
    if q_sqrt is not None:
        if q_sqrt.ndim == 2:       # diagonal parameterization [M, K]
            B = q_sqrt.T[:, None, :] * jnp.swapaxes(A, -1, -2)[None]  # [K, N, M]
        elif q_sqrt.ndim == 3:     # lower-triangular [K, M, M]
            # Computed as B = A^T L (== (L^T A)^T) rather than L^T A: this
            # orientation contracts L on its STANDARD dot dims in the
            # forward AND in both backward dots (dL = A dB, dA^T = dB L^T),
            # so XLA keeps q_sqrt — and its Adam moments, which follow the
            # gradient's layout — in their natural row-major layout instead
            # of adding transposing relayout copies of the [K, M, M]
            # parameter, gradient and both moments to every train step.
            L = q_sqrt if assume_tril else jnp.tril(q_sqrt)
            B = jnp.matmul(jnp.swapaxes(A, -1, -2)[None], L,
                           preferred_element_type=dtype)         # [K, N, M]
        else:
            raise ValueError(f"q_sqrt must be rank 2 or 3, got {q_sqrt.ndim}")
        if full_cov:
            extra = jnp.matmul(B, jnp.swapaxes(B, -1, -2),
                               preferred_element_type=dtype)     # [K, N, N]
            fvar = fvar[None, :, :] + extra
        else:
            extra = jnp.sum(jnp.square(B), axis=-1)              # [K, N]
            fvar = fvar[None, :] + extra
    else:
        if full_cov:
            fvar = jnp.broadcast_to(fvar[None, :, :], (K,) + fvar.shape)
        else:
            fvar = jnp.broadcast_to(fvar[None, :], (K,) + fvar.shape)

    if not full_cov:
        fvar = jnp.swapaxes(fvar, -1, -2)              # [N, K]
    return fmean, fvar


def sgp_conditional(kernel, Z, Xnew, q_mu, q_sqrt, *, jitter: float,
                    full_cov: bool = False, white: bool = True):
    """Fused kernel-build + conditional for one SVGP layer.

    Matches the reference's modified posterior exactly: Kmn is built
    directly as kernel.K(Z, Xnew) (reference MixtureGPs/models.py:139) and
    Kmm = K(Z,Z) + jitter*I (models.py:135).
    """
    Kmm = kernel.K(Z) + jitter * jnp.eye(Z.shape[-2], dtype=Z.dtype)
    Kmn = kernel.K(Z, Xnew)
    Knn = kernel(Xnew, full_cov=full_cov)
    return base_conditional(Kmn, Kmm, Knn, q_mu, q_sqrt=q_sqrt,
                            full_cov=full_cov, white=white)
