"""Precomputed SVGP posterior — the serving path.

Parity surface: gpflow's ``SVGP.posterior(PrecomputeCacheType.TENSOR)`` as
subclassed by the reference (reference MixtureGPs/models.py:147-160).  All
X-independent linear algebra — the Cholesky factor's inverse and the
variational state folded through it — is cached once; each prediction
batch then costs one kernel build and matmuls, no Cholesky and no solves:

  a      = Linv Kzx                                   [M, N]
  fmean  = a^T m                                      [N, K]
  fvar_k = Kdiag - colsum(a^2) + rowsum((a^T R_k)^2)
  whitened:   m = q_mu,         R_k = S_k
  unwhitened: m = Linv q_mu,    R_k = Linv S_k

This is the training-path conditional (ops/conditionals.py) with its
factorization cached.  The variance is kept in this feature form, not
folded into one [K, M, M] matrix Linv^T (S S^T - I) Linv: that matrix has
entries ~1/jitter whose quadratic forms cancel down to O(1) variances, and
loses them at reduced matmul precision.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.conditionals import expand_independent_outputs
from ..ops.linalg import INVERSE_PRECISION, cholesky, triangular_inverse
from ..params import Module
from ..ops.kernels import Kernel

__all__ = ["PrecomputedPosterior", "precompute_posterior", "precompute_smgp"]


class PrecomputedPosterior(Module):
    kernel: Kernel
    Z: jax.Array           # [M, D]
    Linv: jax.Array        # [M, M]  inverse Cholesky factor of K_zz
    m: jax.Array           # [M, K]
    R: jax.Array           # [K, M, M]
    mean_function: object = None

    def predict_f(self, Xnew: jax.Array, *, full_cov: bool = False,
                  full_output_cov: bool = False):
        """Marginal posterior mean/var at Xnew [..., N, D] -> ([..., N, K] x2).

        ``full_output_cov`` expands the independent-latent variance to a
        diagonal [..., N, K, K] (reference MixtureGPs/models.py:144 post-
        processing); full_cov is not served from the cache — use the
        training-path SVGP.predict_f for full input covariances.
        """
        if full_cov:
            raise NotImplementedError(
                "PrecomputedPosterior serves marginal (diag) variances; "
                "use SVGP.predict_f(full_cov=True)")
        Kxz = self.kernel.K(Xnew, self.Z)                 # [..., N, M]
        Kdiag = self.kernel.K_diag(Xnew)                  # [..., N]
        # a^T = Kxz Linv^T: the one product with the explicit inverse.
        aT = jnp.matmul(Kxz, self.Linv.T, precision=INVERSE_PRECISION,
                        preferred_element_type=Kxz.dtype)  # [..., N, M]
        fmean = jnp.matmul(aT, self.m, preferred_element_type=aT.dtype)
        if self.mean_function is not None:
            fmean = fmean + self.mean_function(Xnew)
        B = jnp.einsum("...nm,kmp->...nkp", aT, self.R)   # [..., N, K, M]
        fvar = (Kdiag - jnp.sum(jnp.square(aT), axis=-1))[..., None] \
            + jnp.sum(jnp.square(B), axis=-1)             # [..., N, K]
        fvar = jnp.maximum(fvar, 1e-12)
        return fmean, expand_independent_outputs(fvar, False, full_output_cov)


def precompute_posterior(svgp) -> PrecomputedPosterior:
    """Fold an SVGP's variational state into a PrecomputedPosterior."""
    Linv = triangular_inverse(cholesky(svgp.kuu()))      # [M, M]
    q_mu = svgp.q_mu.value                                # [M, K]
    q_sqrt = svgp.q_sqrt.value
    if q_sqrt.ndim == 2:                                  # diag std-devs
        S = jax.vmap(jnp.diag, in_axes=1)(q_sqrt)         # [K, M, M]
    else:
        S = jnp.tril(q_sqrt)
    if svgp.whiten:
        m, R = q_mu, S
    else:
        # K^-1 k = Linv^T a, so the mean weights and the sqrt-covariance
        # pass through Linv once (never forming K_zz^-1 explicitly).
        m = jnp.matmul(Linv, q_mu, precision=INVERSE_PRECISION)
        R = jnp.matmul(Linv[None], S, precision=INVERSE_PRECISION)
    return PrecomputedPosterior(kernel=svgp.kernel, Z=svgp.Z.value,
                                Linv=Linv, m=m, R=R,
                                mean_function=svgp.mean_function)


def precompute_smgp(model):
    """Fold BOTH layers of an SMGP/SMGPModified into cached posteriors.

    The returned model serves the full prediction API (predict_assign,
    predict_y, predict_samples, predict_density, sample_W) with no Cholesky
    or solves per batch — SMGP's prediction methods only touch the layers
    through ``predict_f``, which PrecomputedPosterior provides.  Training
    methods (elbo / prior_kl) are invalid on the result; re-precompute after
    any parameter update.
    """
    return model.replace(pred_layer=precompute_posterior(model.pred_layer),
                         assign_layer=precompute_posterior(model.assign_layer))
