"""Mixture-of-SVGPs with GP-modulated data association (SMGP).

Rebuilds reference MixtureGPs/models.py:23-123 (SGP, SMGP, SMGPModified):
K experts share inputs; a *prediction* SVGP layer gives per-expert latents
f_k and an *assignment* SVGP layer gives logits α_k, sampled through a
temperature-1e-2 Gumbel-softmax to soft one-hot weights W.  The doubly
stochastic ELBO is

    E_n[ logsumexp_S( Σ_k VE_k(n) W_snk ) - log S ]
        - (KL_pred + KL_assign) / num_data

(reference models.py:63-79).

Restructured for the accelerator (same math, far fewer FLOPs): the reference tiles
X to [S, N, D] and recomputes the *identical* GP conditional S times
(models.py:35-36, 56, 64).  Since every sample row is the same X, the
conditional and the variational expectations are computed ONCE on [N, D];
only the S Gaussian + Gumbel draws are per-sample, vectorized as a leading
axis.  This cuts the hot path's kernel-build/Cholesky/TRSM work by S=25x
with bit-identical expectation semantics.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..config import default_jitter
from ..likelihoods.base import Likelihood
from ..ops.sampling import reparameterize
from ..params import Module, static_field
from .svgp import SVGP

__all__ = ["SGP", "SMGP", "SMGPModified"]


class SGP(Module):
    """Scalable GP base: one prediction layer + broadcasting likelihood
    (reference models.py:23-41)."""

    likelihood: Likelihood
    pred_layer: SVGP
    num_samples: int = static_field(default=1)
    num_data: int = static_field(default=None)

    def predict_y(self, Xnew, S: int = 1):
        """Per-expert predictive moments, tiled to [S, N, K] for API parity
        with reference models.py:38-41 (rows are identical across S)."""
        Fmu, Fvar = self.pred_layer.predict_f(Xnew)
        mean, var = self.likelihood.predict_mean_and_var(Fmu, Fvar)
        tile = lambda a: jnp.broadcast_to(a[None], (S,) + a.shape)
        return tile(mean), tile(var)


class SMGP(SGP):
    """Mixture of GPs for regression / density estimation / data association
    (reference models.py:44-103)."""

    assign_layer: SVGP = None
    K: int = static_field(default=3)
    temperature: float = static_field(default=1e-2)
    # Straight-through-style Gumbel gradient: forward W is the exact
    # tau=temperature sample (reference semantics, models.py:60); when set,
    # gradients flow through a softmax at this softer temperature instead.
    # Rationale: at tau=1e-2 the exact gradient through non-dominant
    # experts underflows fp32 (logit gap > ~0.88 ⇒ weights < 1e-38 flush
    # to zero; f64 keeps a trickle down to gap ~7.5 that Adam's
    # normalization amplifies into real updates).  Measured
    # catastrophically biased; None = exact gradients (default).
    st_backward_tau: float = static_field(default=None)

    # -- assignment weights ------------------------------------------------
    def draw_noise(self, key: jax.Array, N: int, S: int, dtype):
        """(z, g): Gaussian and Gumbel noise, each [S, N, K].

        Drawn separately from the model state so the ELBO can be evaluated
        identically on one device or with N sharded over a mesh (the noise
        arrays shard along their N axis; see parallel/sharded.py).
        """
        k1, k2 = jax.random.split(key)
        shape = (S, N, self.K)
        z = jax.random.normal(k1, shape, dtype=dtype)
        g = jax.random.gumbel(k2, shape, dtype=dtype)
        return z, g

    def W_from_noise(self, Xnew: jax.Array, z: jax.Array, g: jax.Array):
        """Gumbel-softmax assignment samples W [S, N, K] from given noise.

        Equivalent to reference W_dist (models.py:55-61): logits are a
        reparameterized draw from the assignment-layer marginals, pushed
        through RelaxedOneHotCategorical(temperature): softmax((α+g)/τ).
        """
        amu, avar = self.assign_layer.predict_f(Xnew)            # [N, K]
        return self._W_from_marginals(amu, avar, z, g)

    def sample_W(self, key: jax.Array, Xnew: jax.Array, S: int):
        """Draw S Gumbel-softmax assignment samples W [S, N, K]."""
        amu, _ = self.assign_layer.predict_f(Xnew)
        z, g = self.draw_noise(key, Xnew.shape[0], S, amu.dtype)
        return self.W_from_noise(Xnew, z, g)

    # -- ELBO --------------------------------------------------------------
    def E_log_p_Y(self, key, X, Y):
        z, g = self.draw_noise(key, X.shape[0], self.num_samples, X.dtype)
        return self.E_log_p_Y_from_noise(X, Y, z, g)

    def _marginals(self, X):
        """((fmu, fvar), (amu, avar)) for both layers.

        Kept as two separate conditional chains: stacking them into one
        batched chol/solve would copy Kmn and q_sqrt into the stack, and
        XLA already overlaps the two independent chains.
        """
        return (self.pred_layer.predict_f(X),
                self.assign_layer.predict_f(X))

    def _W_from_marginals(self, amu, avar, z, g):
        log_assign = reparameterize(amu, avar, z)                # [S, N, K]
        tau = jnp.asarray(self.temperature, log_assign.dtype)
        W = jax.nn.softmax((log_assign + g) / tau, axis=-1)
        if self.st_backward_tau is not None:
            # Forward value: the exact tau=temperature sample.  Gradient:
            # through a softer softmax that does not underflow fp32 (see
            # the field comment).
            tb = jnp.asarray(self.st_backward_tau, log_assign.dtype)
            W_soft = jax.nn.softmax((log_assign + g) / tb, axis=-1)
            W = W_soft + jax.lax.stop_gradient(W - W_soft)
        from .. import config as _config
        if _config.w_flush_min() is not None:
            # Ablation probe: mimic fp32 flush-to-zero inside f64.
            thr = jnp.asarray(_config.w_flush_min(), W.dtype)
            W = jnp.where(W < thr, jnp.zeros_like(W), W)
        return W

    def E_log_p_Y_from_noise(self, X, Y, z, g):
        (fmu, fvar), (amu, avar) = self._marginals(X)
        return self.E_log_p_from_marginals(fmu, fvar, amu, avar, z, g, Y)

    def E_log_p_from_marginals(self, fmu, fvar, amu, avar, z, g, Y):
        """Data-fit term from precomputed layer marginals: [N].

        Split out from E_log_p_Y_from_noise so mesh-sharded paths (see
        parallel/inducing.py, where the marginals come from a distributed
        conditional) reuse the exact same sampling/weighting semantics.
        """
        S = z.shape[0]
        W = self._W_from_marginals(amu, avar, z, g)              # [S, N, K]
        ve = self.likelihood.variational_expectations(fmu, fvar, Y)
        summed = jnp.sum(ve[None] * W, axis=2)                   # [S, N]
        return jax.nn.logsumexp(summed, axis=0) - math.log(S)    # [N]

    def elbo(self, key: jax.Array, X: jax.Array, Y: jax.Array) -> jax.Array:
        """reference _build_likelihood (models.py:69-79)."""
        if self.num_data is None:
            raise ValueError(
                "SMGP needs num_data (total training-set size) to scale the "
                "KL term; pass num_data=N at construction.")
        from ..utils.shapes import ShapeChecker
        chk = ShapeChecker()   # check_shapes analog, reference models.py:4
        chk.check(X, "N D", "X")
        chk.check(Y, "N .", "Y")
        L = jnp.mean(self.E_log_p_Y(key, X, Y))
        kl = self.pred_layer.prior_kl() + self.assign_layer.prior_kl()
        return L - kl / self.num_data

    def training_loss(self, key, X, Y):
        return -self.elbo(key, X, Y)

    # -- prediction --------------------------------------------------------
    def predict_assign(self, Xnew):
        """softmax of mean assignment logits [N, K] (reference models.py:85-89).

        The reference signature takes S and tiles X over it before averaging
        the logit means (models.py:86-88) — but the tiles are identical, so
        the average is a no-op; this implementation drops the dead parameter
        and evaluates the marginal mean once.
        """
        amu, _ = self.assign_layer.predict_f(Xnew)
        return jax.nn.softmax(amu, axis=-1)

    def predict_density(self, Xnew: jax.Array, Ynew: jax.Array) -> jax.Array:
        """Mixture predictive log-density  log Σ_k π_k(x) p_k(y|x)  per point.

        π_k = softmax assignment probabilities (predict_assign); p_k = the
        likelihood's predictive density under expert k's marginals.  Not in
        the reference's API (it only plots); provided as the natural
        evaluation metric (NLPD) for the demo workloads.
        """
        pi = self.predict_assign(Xnew)                           # [N, K]
        Fmu, Fvar = self.pred_layer.predict_f(Xnew)
        # Delegate the density to the likelihood: correct for MultiClass /
        # Bernoulli experts, not just Gaussian.
        log_pk = self.likelihood.predict_density_per_expert(
            Fmu, Fvar, Ynew)                                     # [N, K]
        return jax.nn.logsumexp(jnp.log(pi + 1e-12) + log_pk, axis=-1)

    def predict_samples(self, key: jax.Array, Xnew: jax.Array, S: int = 1):
        """Mixture draws (samples_y, samples_f), each [S, N, 1]
        (reference models.py:91-103; note the reference reuses one z for
        both the y- and f-samples — preserved here)."""
        kW, kz = jax.random.split(key)
        W = self.sample_W(kW, Xnew, S)                           # [S, N, K]
        Fmu, Fvar = self.pred_layer.predict_f(Xnew)              # [N, K]
        mean, var = self.likelihood.predict_mean_and_var(Fmu, Fvar)
        z = jax.random.normal(kz, (S,) + Fmu.shape, dtype=Fmu.dtype)
        samples_y = jnp.sum(reparameterize(mean, var, z) * W, axis=2,
                            keepdims=True)
        samples_f = jnp.sum(reparameterize(Fmu, Fvar, z) * W, axis=2,
                            keepdims=True)
        return samples_y, samples_f


class SMGPModified(SMGP):
    """Variant with a second broadcast likelihood on the assignment layer —
    used by the multiclass demos (reference models.py:106-123)."""

    assign_likelihood: Likelihood = None

    def E_log_p_Y_from_noise(self, X, Y, z, g):
        (fmu, fvar), (amu, avar) = self._marginals(X)
        return self.E_log_p_from_marginals(fmu, fvar, amu, avar, z, g, Y)

    def E_log_p_from_marginals(self, fmu, fvar, amu, avar, z, g, Y):
        S = z.shape[0]
        logS = math.log(S)
        W = self._W_from_marginals(amu, avar, z, g)              # [S, N, K]

        ve_a = self.assign_likelihood.variational_expectations(amu, avar, Y)
        E_log_p_A = jnp.sum(ve_a[None] * W, axis=2) - logS       # [S, N]

        ve_y = self.likelihood.variational_expectations(fmu, fvar, Y)
        E_log_p_y = jnp.sum(ve_y[None] * W, axis=2) - logS       # [S, N]

        return (jax.nn.logsumexp(E_log_p_A, axis=0)
                + jax.nn.logsumexp(E_log_p_y, axis=0))           # [N]
