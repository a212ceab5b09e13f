"""Variational GP with non-sparse posterior over the training inputs.

Rebuilds the surface of ``gpflow.models.VGP`` (whitened parameterization),
which the reference exercises only through its from_online sanity demo
(reference demos/from_online/demo_SVGP_bernoulli.py:36-48: VGP + Bernoulli
trained with the Scipy optimizer).  Unlike SVGP there are no inducing
points: q(v) = N(q_mu, q_sqrt q_sqrtT) lives at the N training inputs in
whitened space, f = L v with L = chol(K(X,X) + jitter I).

The training-point marginals need no solves at all — fmean = L q_mu and
fvar = rowsum((L q_sqrt)^2) are two batched matmuls, and
the single N x N Cholesky is shared between the ELBO and `predict_f`.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import default_float, default_jitter
from ..ops.conditionals import base_conditional
from ..ops.kl import gauss_kl
from ..ops.linalg import add_jitter, cholesky
from ..params import Module, Parameter, static_field
from ..ops.kernels import Kernel
from ..likelihoods.base import Likelihood

__all__ = ["VGP"]


class VGP(Module):
    kernel: Kernel
    likelihood: Likelihood
    X: Parameter           # training inputs [N, D] (data, never trainable)
    Y: Parameter           # training targets [N, P] (data, never trainable)
    q_mu: Parameter        # whitened variational means [N, K]
    q_sqrt: Parameter      # whitened variational sqrt-cov, tril [K, N, N]
    mean_function: object = None   # None = Zero (gpflow default)
    num_latent: int = static_field(default=1)

    @classmethod
    def create(cls, kernel: Kernel, likelihood: Likelihood, X, Y,
               num_latent_gps: int | None = None, mean_function=None,
               dtype=None) -> "VGP":
        """gpflow VGP.__init__ parity: q_mu = zeros(N, K), q_sqrt = K
        stacked identities (whitened)."""
        dtype = dtype or default_float()
        X = jnp.asarray(X, dtype)
        Y = jnp.asarray(Y, dtype)
        N = X.shape[0]
        K = num_latent_gps if num_latent_gps is not None else Y.shape[-1]
        q_mu = jnp.zeros((N, K), dtype)
        q_sqrt = jnp.broadcast_to(jnp.eye(N, dtype=dtype), (K, N, N)).copy()
        return cls(kernel=kernel, likelihood=likelihood,
                   X=Parameter(X, trainable=False),
                   Y=Parameter(Y, trainable=False),
                   q_mu=Parameter(q_mu),
                   q_sqrt=Parameter(q_sqrt, transform="tril"),
                   mean_function=mean_function,
                   num_latent=K)

    @property
    def num_data(self) -> int:
        return self.X.shape[0]

    def _chol_Kxx(self) -> jax.Array:
        X = self.X.value
        Kxx = add_jitter(self.kernel.K(X), default_jitter(X.dtype))
        return cholesky(Kxx)

    def q_moments(self):
        """Marginal q(f) at the training points: fmean = L q_mu,
        fvar_n = sum_m (L q_sqrt)_{nm}^2 — matmuls only, no solves."""
        L = self._chol_Kxx()                              # [N, N]
        fmean = L @ self.q_mu.value                       # [N, K]
        if self.mean_function is not None:
            fmean = fmean + self.mean_function(self.X.value)
        LS = L[None, :, :] @ self.q_sqrt.value            # [K, N, N]
        fvar = jnp.sum(jnp.square(LS), axis=-1).T         # [N, K]
        return fmean, fvar

    def prior_kl(self) -> jax.Array:
        """Whitened KL[q(v) || N(0, I)]."""
        return gauss_kl(self.q_mu.value, self.q_sqrt.value, None,
                        assume_tril=self.q_sqrt.transform == "tril")

    def elbo(self) -> jax.Array:
        fmean, fvar = self.q_moments()
        ve = self.likelihood.variational_expectations(fmean, fvar, self.Y.value)
        return jnp.sum(ve) - self.prior_kl()

    def training_loss(self, key=None, X=None, Y=None) -> jax.Array:
        """Negative ELBO.  key/X/Y accepted (and ignored) so the shared
        Adam loop's step contract works unchanged — VGP owns its data,
        matching gpflow's InternalDataTrainingLossMixin."""
        return -self.elbo()

    def predict_f(self, Xnew: jax.Array, *, full_cov: bool = False):
        X = self.X.value
        Kmm = add_jitter(self.kernel.K(X), default_jitter(X.dtype))
        Kmn = self.kernel.K(X, Xnew)
        Knn = self.kernel(Xnew, full_cov=full_cov)
        fmean, fvar = base_conditional(
            Kmn, Kmm, Knn, self.q_mu.value, q_sqrt=self.q_sqrt.value,
            full_cov=full_cov, white=True,
            assume_tril=self.q_sqrt.transform == "tril")
        if self.mean_function is not None:
            fmean = fmean + self.mean_function(Xnew)
        return fmean, fvar

    def predict_y(self, Xnew: jax.Array):
        fmean, fvar = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(fmean, fvar)

    def predict_log_density(self, Xnew: jax.Array, Ynew: jax.Array):
        fmean, fvar = self.predict_f(Xnew)
        return self.likelihood.predict_log_density(fmean, fvar, Ynew)
