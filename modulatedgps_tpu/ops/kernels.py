"""Stationary covariance functions.

Rebuilds the gpflow kernel surface the reference uses (SquaredExponential at
demos/demo_tf2.py:37-38; Matern32/White only in the from_online sanity demo,
reference demos/from_online/demo_multiclass_lik.py:109) as JAX pytree modules.

Design notes:
 - Cross terms of the pairwise squared distance are computed as
   ``|x|^2 + |z|^2 - 2 x.z`` so the O(N*M*D) work is a single dot_general;
   XLA fuses the exp/scale epilogue into the surrounding elementwise loop.
 - All kernels broadcast over arbitrary leading batch dims: X [..., N, D].
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import default_float
from ..params import Module, Parameter, static_field

__all__ = [
    "Kernel",
    "SquaredExponential",
    "Matern12",
    "Matern32",
    "Matern52",
    "White",
    "Constant",
    "Sum",
    "Product",
    "square_distance",
]


def square_distance(X: jax.Array, X2: jax.Array | None) -> jax.Array:
    """Pairwise squared Euclidean distance, [..., N, D] x [..., M, D] -> [..., N, M].

    Uses the matmul form |x|^2 + |z|^2 - 2 x.z with a clamp at 0 (the
    expansion can go slightly negative in floating point).
    """
    if X2 is None:
        X2 = X
    Xs = jnp.sum(jnp.square(X), axis=-1)
    X2s = jnp.sum(jnp.square(X2), axis=-1)
    # HIGHEST: a reduced-precision pass (bf16 or TF32 inputs) loses up to
    # ~1e-2 absolute on the cross term, which the Cholesky downstream
    # cannot tolerate.
    cross = jnp.matmul(X, jnp.swapaxes(X2, -1, -2),
                       preferred_element_type=X.dtype,
                       precision=jax.lax.Precision.HIGHEST)
    d2 = Xs[..., :, None] + X2s[..., None, :] - 2.0 * cross
    return jnp.maximum(d2, 0.0)


class Kernel(Module):
    """Base: subclasses implement K(X, X2) and K_diag(X)."""

    def __call__(self, X, X2=None, full_cov: bool = True):
        # gpflow's kernel(X, full_cov=False) returns the diagonal
        # (reference MixtureGPs/models.py:133).
        if full_cov:
            return self.K(X, X2)
        if X2 is not None:
            raise ValueError("full_cov=False requires X2=None")
        return self.K_diag(X)

    def __add__(self, other):
        return Sum(kernels=(self, other))

    def __mul__(self, other):
        return Product(kernels=(self, other))


class _Stationary(Kernel):
    """Shared machinery: signal variance + (ARD) lengthscales."""

    variance: Parameter
    lengthscales: Parameter

    @classmethod
    def create(cls, variance=1.0, lengthscales=1.0, dtype=None, **extra):
        dtype = dtype or default_float()
        return cls(
            variance=Parameter(jnp.asarray(variance, dtype), transform="positive"),
            lengthscales=Parameter(jnp.asarray(lengthscales, dtype), transform="positive"),
            **extra,
        )

    def _scaled(self, X):
        return X / self.lengthscales.value

    def scaled_square_distance(self, X, X2=None):
        Xs = self._scaled(X)
        X2s = None if X2 is None else self._scaled(X2)
        return square_distance(Xs, X2s)

    def K_diag(self, X):
        shape = X.shape[:-1]
        return jnp.full(shape, 1.0, dtype=X.dtype) * self.variance.value


class SquaredExponential(_Stationary):
    """k(x,z) = variance * exp(-0.5 * |(x-z)/lengthscale|^2).

    Parity target: gpflow.kernels.SquaredExponential as constructed at
    reference demos/demo_tf2.py:37-38 (scalar variance & lengthscale; ARD
    supported by passing a vector of lengthscales).
    """

    def K(self, X, X2=None):
        d2 = self.scaled_square_distance(X, X2)
        return self.variance.value * jnp.exp(-0.5 * d2)


RBF = SquaredExponential


class Matern12(_Stationary):
    def K(self, X, X2=None):
        r = jnp.sqrt(self.scaled_square_distance(X, X2) + 1e-36)
        return self.variance.value * jnp.exp(-r)


class Matern32(_Stationary):
    """k(r) = variance * (1 + sqrt(3) r) exp(-sqrt(3) r); gpflow parity for
    reference demos/from_online/demo_multiclass_lik.py:109."""

    def K(self, X, X2=None):
        r = jnp.sqrt(self.scaled_square_distance(X, X2) + 1e-36)
        s3r = jnp.sqrt(jnp.asarray(3.0, X.dtype)) * r
        return self.variance.value * (1.0 + s3r) * jnp.exp(-s3r)


class Matern52(_Stationary):
    def K(self, X, X2=None):
        r2 = self.scaled_square_distance(X, X2)
        r = jnp.sqrt(r2 + 1e-36)
        s5r = jnp.sqrt(jnp.asarray(5.0, X.dtype)) * r
        return self.variance.value * (1.0 + s5r + 5.0 / 3.0 * r2) * jnp.exp(-s5r)


class White(Kernel):
    """Diagonal noise kernel (gpflow.kernels.White parity)."""

    variance: Parameter

    @classmethod
    def create(cls, variance=1.0, dtype=None):
        dtype = dtype or default_float()
        return cls(variance=Parameter(jnp.asarray(variance, dtype), transform="positive"))

    def K(self, X, X2=None):
        if X2 is None:
            n = X.shape[-2]
            eye = jnp.eye(n, dtype=X.dtype)
            return self.variance.value * jnp.broadcast_to(eye, X.shape[:-1] + (n,))
        n, m = X.shape[-2], X2.shape[-2]
        return jnp.zeros(jnp.broadcast_shapes(X.shape[:-2], X2.shape[:-2]) + (n, m),
                         dtype=X.dtype)

    def K_diag(self, X):
        return jnp.full(X.shape[:-1], 1.0, dtype=X.dtype) * self.variance.value


class Constant(Kernel):
    variance: Parameter

    @classmethod
    def create(cls, variance=1.0, dtype=None):
        dtype = dtype or default_float()
        return cls(variance=Parameter(jnp.asarray(variance, dtype), transform="positive"))

    def K(self, X, X2=None):
        if X2 is None:
            X2 = X
        shape = jnp.broadcast_shapes(X.shape[:-2], X2.shape[:-2]) + (X.shape[-2], X2.shape[-2])
        return jnp.full(shape, 1.0, dtype=X.dtype) * self.variance.value

    def K_diag(self, X):
        return jnp.full(X.shape[:-1], 1.0, dtype=X.dtype) * self.variance.value


class Sum(Kernel):
    kernels: tuple

    def K(self, X, X2=None):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = out + k.K(X, X2)
        return out

    def K_diag(self, X):
        out = self.kernels[0].K_diag(X)
        for k in self.kernels[1:]:
            out = out + k.K_diag(X)
        return out


class Product(Kernel):
    kernels: tuple

    def K(self, X, X2=None):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = out * k.K(X, X2)
        return out

    def K_diag(self, X):
        out = self.kernels[0].K_diag(X)
        for k in self.kernels[1:]:
            out = out * k.K_diag(X)
        return out
