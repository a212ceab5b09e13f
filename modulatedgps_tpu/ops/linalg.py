"""Dense linear-algebra primitives of the conditional chain.

The reference delegates these to TF's C++/CUDA kernels through gpflow
(tf.linalg.cholesky / tf.linalg.triangular_solve inside base_conditional,
reached from reference MixtureGPs/models.py:141).  Here the factorization
and the solves are XLA's own ops, which on a GPU call cuSOLVER and cuBLAS.
What this module adds is algebra, not kernels: the "fast solves" form of
the chain, whose pullbacks need no triangular solve.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "cholesky",
    "solve_triangular",
    "triangular_inverse",
    "solve_lower",
    "whiten_solve",
    "add_jitter",
    "chol_pullback",
    "set_fast_solves",
    "fast_solves",
    "INVERSE_PRECISION",
]

# Fast solves: L^-1 B with many right-hand sides is formed as (L^-1) @ B —
# one M x M triangular inverse, then a dense matmul — and the chain's
# pullbacks (whiten_solve, cholesky, triangular_inverse) close with dense
# matmuls instead of XLA's autodiff, whose backward solves [M, N]-panel and
# [M, M]-RHS triangular systems.  The inverse+matmul form trades a little
# backward stability for matmul throughput.
#
# By default the form is chosen per call from the factor's size and dtype
# (fast_solves): the fast form for float32 factors up to FAST_SOLVES_MAX_M,
# substitution otherwise.  On an H100 (train step at batch 8192, both
# forms within the float64 reference's tolerance, chip_smoke.py phases
# 5-6; PERF.md) the fast form was 1.29x faster at M=1024, 1.15x at M=2048
# and no faster at M=4096.  Float64 keeps substitution, the backward-stable
# oracle.
# None: chosen per call; True/False: forced (set_fast_solves).
_FAST_SOLVES: bool | None = None
FAST_SOLVES_MAX_M = 2048
# Precision of every product with an explicit triangular inverse (here and
# in models/posterior.py).  L^-1 has entries up to ~1/sqrt(jitter) that
# cancel in L^-1 Kmn, so one-pass reduced-precision inputs (bf16, TF32)
# lose the whitened features and the gradients through them.
INVERSE_PRECISION = jax.lax.Precision.HIGHEST


def set_fast_solves(enabled: bool | None) -> None:
    """Force the fast-solves form on (True) or off (False), or restore the
    choice by size and dtype (None).  Read at trace time: re-jit after
    changing it."""
    global _FAST_SOLVES
    _FAST_SOLVES = None if enabled is None else bool(enabled)


def fast_solves(m: int, dtype) -> bool:
    """Whether an [..., m, m] factor of ``dtype`` takes the fast form."""
    if _FAST_SOLVES is not None:
        return _FAST_SOLVES
    return jnp.dtype(dtype) == jnp.float32 and m <= FAST_SOLVES_MAX_M


def _fast(x: jax.Array) -> bool:
    return fast_solves(x.shape[-1], x.dtype)


def _solve_identity(L: jax.Array, lower: bool) -> jax.Array:
    eye = jnp.broadcast_to(jnp.eye(L.shape[-1], dtype=L.dtype), L.shape)
    return jax.lax.linalg.triangular_solve(L, eye, left_side=True, lower=lower)


def triangular_inverse(L: jax.Array, *, lower: bool = True) -> jax.Array:
    """Explicit inverse of a (batched) triangular matrix."""
    if lower and _fast(L):
        return _trinv(L)
    return _solve_identity(L, lower)


@jax.custom_vjp
def _trinv(L: jax.Array) -> jax.Array:
    """L^-1 for lower-triangular L, with a SOLVE-FREE pullback.

    The saved output IS the inverse, so the pullback of
    d(L^-1) = -L^-1 dL L^-1 closes with two dense matmuls:
        Lbar = -tril(X^T Xbar X^T),  X = L^-1
    where autodiff of the triangular solve would solve an M-RHS system.
    """
    return _solve_identity(L, True)


def _trinv_fwd(L):
    X = _trinv(L)
    return X, X


def _trinv_bwd(X, Xbar):
    hi = INVERSE_PRECISION
    XT = jnp.swapaxes(X, -1, -2)
    G = jnp.matmul(jnp.matmul(XT, Xbar, precision=hi,
                              preferred_element_type=X.dtype),
                   XT, precision=hi, preferred_element_type=X.dtype)
    return (-jnp.tril(G),)


_trinv.defvjp(_trinv_fwd, _trinv_bwd)


def chol_pullback(L: jax.Array, Linv: jax.Array,
                  Lbar: jax.Array) -> jax.Array:
    """Cholesky pullback (Murray 2016, eq. 8-9) given the factor's inverse:

        Kbar = sym(L^-T phi(L^T Lbar) L^-1),  phi = tril, halved diagonal

    Dense matmuls only, at INVERSE_PRECISION; batched over leading dims.
    """
    hi = INVERSE_PRECISION
    m = L.shape[-1]
    P = jnp.matmul(jnp.swapaxes(L, -1, -2), Lbar, precision=hi,
                   preferred_element_type=L.dtype)
    phi = jnp.tril(P) - 0.5 * P * jnp.eye(m, dtype=P.dtype)
    Kbar = jnp.matmul(jnp.matmul(jnp.swapaxes(Linv, -1, -2), phi,
                                 precision=hi,
                                 preferred_element_type=L.dtype),
                      Linv, precision=hi,
                      preferred_element_type=L.dtype)
    return 0.5 * (Kbar + jnp.swapaxes(Kbar, -1, -2))


def whiten_solve(Kmm: jax.Array, Kmn: jax.Array) -> jax.Array:
    """A = chol(Kmm)^-1 Kmn — the whitened feature map of the conditional
    (ops/conditionals.py, reached from reference MixtureGPs/models.py:141).

    In the fast form the chol -> inverse -> matmul chain gets ONE composite
    pullback.  Autodiff of the unfused chain would close the backward
    through d(L^-1): dLinv = Abar Kmn^T, the inverse's pullback turns that
    into two [M, M] matmuls, and the Cholesky pullback recomputes the
    inverse it already has.  The standard solve pullback needs none of it:

        Kmn_bar = L^-T Abar           = Linv^T Abar        (2 M^2 N)
        L_bar   = -L^-T Abar A^T      = -tril(Kmn_bar A^T) (2 M^2 N)

    then the Cholesky pullback (chol_pullback), reusing the forward's Linv.
    Otherwise this is plain cholesky + triangular solve, which is also the
    autodiff oracle the tests check the fast form against.
    """
    if _fast(Kmm) and Kmm.shape[:-2] == Kmn.shape[:-2]:
        return _whiten_solve_fused(Kmm, Kmn)
    return solve_lower(cholesky(Kmm), Kmn)


@jax.custom_vjp
def _whiten_solve_fused(Kmm, Kmn):
    A, _ = _whiten_solve_fused_fwd(Kmm, Kmn)
    return A


def _whiten_solve_fused_fwd(Kmm, Kmn):
    L = jnp.linalg.cholesky(Kmm)
    Linv = _solve_identity(L, True)
    A = jnp.matmul(Linv, Kmn, precision=INVERSE_PRECISION,
                   preferred_element_type=Kmn.dtype)
    return A, (L, Linv, A)


def _whiten_solve_fused_bwd(res, Abar):
    L, Linv, A = res
    Kmn_bar = jnp.matmul(jnp.swapaxes(Linv, -1, -2), Abar,
                         precision=INVERSE_PRECISION,
                         preferred_element_type=L.dtype)
    Lbar = -jnp.tril(jnp.matmul(Kmn_bar, jnp.swapaxes(A, -1, -2),
                                precision=INVERSE_PRECISION,
                                preferred_element_type=L.dtype))
    return chol_pullback(L, Linv, Lbar), Kmn_bar


_whiten_solve_fused.defvjp(_whiten_solve_fused_fwd, _whiten_solve_fused_bwd)


def solve_lower(L: jax.Array, B: jax.Array, *, trans: bool = False) -> jax.Array:
    """L^-1 B (or L^-T B): substitution, or inverse+matmul in the fast form
    (see fast_solves)."""
    if _fast(L):
        Linv = triangular_inverse(L)
        op = jnp.swapaxes(Linv, -1, -2) if trans else Linv
        return jnp.matmul(op, B, precision=INVERSE_PRECISION,
                          preferred_element_type=B.dtype)
    return solve_triangular(L, B, lower=True, trans=trans)


def add_jitter(K: jax.Array, jitter: float) -> jax.Array:
    m = K.shape[-1]
    return K + jitter * jnp.eye(m, dtype=K.dtype)


def cholesky(K: jax.Array) -> jax.Array:
    """Lower Cholesky factor of a (batched) SPD matrix."""
    if _fast(K):
        return _chol_fast_bwd(K)
    return jnp.linalg.cholesky(K)


@jax.custom_vjp
def _chol_fast_bwd(K: jax.Array) -> jax.Array:
    """XLA Cholesky forward with a substitution-free pullback.

    XLA's built-in Cholesky VJP closes with two [M, M]-RHS triangular
    solves.  chol_pullback needs only L^-1, from one triangular inverse;
    the rest is dense matmuls.
    """
    return jnp.linalg.cholesky(K)


def _chol_fast_bwd_fwd(K):
    L = _chol_fast_bwd(K)
    return L, L


def _chol_fast_bwd_bwd(L, Lbar):
    return (chol_pullback(L, _solve_identity(L, True), Lbar),)


_chol_fast_bwd.defvjp(_chol_fast_bwd_fwd, _chol_fast_bwd_bwd)


def solve_triangular(L: jax.Array, B: jax.Array, *, lower: bool = True,
                     trans: bool = False) -> jax.Array:
    """Solve op(L) X = B with op triangular; batched over leading dims.

    ``trans=True`` solves L^T X = B.  L may have fewer batch dims than B
    (it is broadcast), which is the common case here: one shared [M, M]
    Cholesky factor against per-latent right-hand sides.
    """
    batch = jnp.broadcast_shapes(L.shape[:-2], B.shape[:-2])
    Lb = jnp.broadcast_to(L, batch + L.shape[-2:])
    Bb = jnp.broadcast_to(B, batch + B.shape[-2:])
    return jax.lax.linalg.triangular_solve(
        Lb, Bb, left_side=True, lower=lower, transpose_a=trans)
