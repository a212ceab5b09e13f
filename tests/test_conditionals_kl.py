"""base_conditional and gauss_kl vs dense numpy oracles.

The oracle implements the textbook SVGP posterior directly:
whitened: f|u ~ N(A^T q_mu, Knn - A^T A + A^T S S^T A), A = Lm^-1 Kmn.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg

from modulatedgps_tpu.ops.conditionals import base_conditional
from modulatedgps_tpu.ops.kl import gauss_kl
from modulatedgps_tpu.ops import kernels as kmod


def _setup(rng, M=13, N=9, K=3, D=2):
    Z = rng.normal(size=(M, D))
    X = rng.normal(size=(N, D))
    kern = kmod.SquaredExponential.create(1.2, 0.8)
    Kmm = np.asarray(kern.K(jnp.asarray(Z))) + 1e-6 * np.eye(M)
    Kmn = np.asarray(kern.K(jnp.asarray(Z), jnp.asarray(X)))
    Knn = np.asarray(kern.K(jnp.asarray(X)))
    q_mu = rng.normal(size=(M, K))
    q_sqrt = np.tril(rng.normal(size=(K, M, M)) * 0.3) + \
        np.eye(M) * 0.8
    return Kmm, Kmn, Knn, q_mu, q_sqrt


def _oracle(Kmm, Kmn, Knn_full, q_mu, q_sqrt, white):
    M, K = q_mu.shape
    Lm = np.linalg.cholesky(Kmm)
    A = scipy.linalg.solve_triangular(Lm, Kmn, lower=True)
    base_var = Knn_full - A.T @ A
    if not white:
        A = scipy.linalg.solve_triangular(Lm.T, A, lower=False)
    fmean = A.T @ q_mu
    fvars = []
    for k in range(K):
        Sk = np.tril(q_sqrt[k])
        cov = base_var + A.T @ Sk @ Sk.T @ A
        fvars.append(cov)
    return fmean, np.stack(fvars)


def test_conditional_white_diag(rng):
    Kmm, Kmn, Knn, q_mu, q_sqrt = _setup(rng)
    fmean, fvar = base_conditional(jnp.asarray(Kmn), jnp.asarray(Kmm),
                                   jnp.asarray(np.diag(Knn)),
                                   jnp.asarray(q_mu),
                                   q_sqrt=jnp.asarray(q_sqrt),
                                   full_cov=False, white=True)
    want_mean, want_cov = _oracle(Kmm, Kmn, Knn, q_mu, q_sqrt, white=True)
    np.testing.assert_allclose(np.asarray(fmean), want_mean, rtol=1e-8, atol=1e-10)
    want_var = np.stack([np.diag(c) for c in want_cov], axis=1)  # [N, K]
    np.testing.assert_allclose(np.asarray(fvar), want_var, rtol=1e-8, atol=1e-10)


def test_conditional_nonwhite_diag(rng):
    Kmm, Kmn, Knn, q_mu, q_sqrt = _setup(rng)
    fmean, fvar = base_conditional(jnp.asarray(Kmn), jnp.asarray(Kmm),
                                   jnp.asarray(np.diag(Knn)),
                                   jnp.asarray(q_mu),
                                   q_sqrt=jnp.asarray(q_sqrt),
                                   full_cov=False, white=False)
    want_mean, want_cov = _oracle(Kmm, Kmn, Knn, q_mu, q_sqrt, white=False)
    np.testing.assert_allclose(np.asarray(fmean), want_mean, rtol=1e-8, atol=1e-10)
    want_var = np.stack([np.diag(c) for c in want_cov], axis=1)
    np.testing.assert_allclose(np.asarray(fvar), want_var, rtol=1e-8, atol=1e-10)


def test_conditional_full_cov(rng):
    Kmm, Kmn, Knn, q_mu, q_sqrt = _setup(rng)
    fmean, fvar = base_conditional(jnp.asarray(Kmn), jnp.asarray(Kmm),
                                   jnp.asarray(Knn), jnp.asarray(q_mu),
                                   q_sqrt=jnp.asarray(q_sqrt),
                                   full_cov=True, white=True)
    want_mean, want_cov = _oracle(Kmm, Kmn, Knn, q_mu, q_sqrt, white=True)
    np.testing.assert_allclose(np.asarray(fmean), want_mean, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(fvar), want_cov, rtol=1e-8, atol=1e-10)


def test_conditional_diag_q_sqrt(rng):
    Kmm, Kmn, Knn, q_mu, _ = _setup(rng)
    M, K = q_mu.shape
    q_diag = np.abs(rng.normal(size=(M, K))) + 0.1
    fmean, fvar = base_conditional(jnp.asarray(Kmn), jnp.asarray(Kmm),
                                   jnp.asarray(np.diag(Knn)),
                                   jnp.asarray(q_mu),
                                   q_sqrt=jnp.asarray(q_diag),
                                   full_cov=False, white=True)
    q_full = np.stack([np.diag(q_diag[:, k]) for k in range(K)])
    want_mean, want_cov = _oracle(Kmm, Kmn, Knn, q_mu, q_full, white=True)
    np.testing.assert_allclose(np.asarray(fmean), want_mean, rtol=1e-8)
    want_var = np.stack([np.diag(c) for c in want_cov], axis=1)
    np.testing.assert_allclose(np.asarray(fvar), want_var, rtol=1e-8, atol=1e-10)


def test_prior_conditional_no_qsqrt(rng):
    """q_sqrt=None: fvar = Knn - A^T A broadcast over K."""
    Kmm, Kmn, Knn, q_mu, _ = _setup(rng)
    fmean, fvar = base_conditional(jnp.asarray(Kmn), jnp.asarray(Kmm),
                                   jnp.asarray(np.diag(Knn)),
                                   jnp.asarray(q_mu), q_sqrt=None,
                                   full_cov=False, white=True)
    Lm = np.linalg.cholesky(Kmm)
    A = scipy.linalg.solve_triangular(Lm, Kmn, lower=True)
    want_var = np.diag(Knn) - np.sum(A ** 2, axis=0)
    np.testing.assert_allclose(np.asarray(fvar),
                               np.tile(want_var[:, None], (1, 3)), rtol=1e-8)


# ---------------------------------------------------------------- gauss_kl

def _kl_oracle(q_mu, q_sqrt, Kmm=None):
    M, K = q_mu.shape
    total = 0.0
    for k in range(K):
        S = np.tril(q_sqrt[k]) if q_sqrt.ndim == 3 else np.diag(q_sqrt[:, k])
        cov = S @ S.T
        P = np.eye(M) if Kmm is None else Kmm
        Pinv = np.linalg.inv(P)
        kl = 0.5 * (np.trace(Pinv @ cov) + q_mu[:, k] @ Pinv @ q_mu[:, k]
                    - M + np.linalg.slogdet(P)[1] - np.linalg.slogdet(cov)[1])
        total += kl
    return total


def test_gauss_kl_whitened(rng):
    M, K = 11, 3
    q_mu = rng.normal(size=(M, K))
    q_sqrt = np.tril(rng.normal(size=(K, M, M)) * 0.2) + np.eye(M)
    got = float(gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_sqrt)))
    np.testing.assert_allclose(got, _kl_oracle(q_mu, q_sqrt), rtol=1e-9)


def test_gauss_kl_unwhitened(rng):
    M, K = 7, 2
    q_mu = rng.normal(size=(M, K))
    q_sqrt = np.tril(rng.normal(size=(K, M, M)) * 0.2) + np.eye(M)
    A = rng.normal(size=(M, M))
    Kmm = A @ A.T + M * np.eye(M)
    got = float(gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_sqrt), jnp.asarray(Kmm)))
    np.testing.assert_allclose(got, _kl_oracle(q_mu, q_sqrt, Kmm), rtol=1e-8)


def test_gauss_kl_diag(rng):
    M, K = 9, 4
    q_mu = rng.normal(size=(M, K))
    q_diag = np.abs(rng.normal(size=(M, K))) + 0.5
    got = float(gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_diag)))
    np.testing.assert_allclose(got, _kl_oracle(q_mu, q_diag), rtol=1e-9)


def test_gauss_kl_custom_vjp_grad_parity(rng):
    """The whitened-tril KL's analytic VJP (ops/kl.py::_kl_white_tril,
    added to kill the dense diag scatter-add in the train step's backward)
    must match autodiff of the plain closed form exactly, and must leave
    the upper triangle's cotangent at zero."""
    M, K = 13, 3
    q_mu = jnp.asarray(rng.normal(size=(M, K)))
    q_sqrt = jnp.asarray(np.tril(rng.normal(size=(K, M, M)) * 0.2)
                         + np.eye(M))

    def plain(q_mu, q_sqrt):
        Lq = jnp.tril(q_sqrt)
        d = jnp.diagonal(Lq, axis1=-2, axis2=-1)
        return 0.5 * (jnp.sum(jnp.square(q_mu)) - M * K
                      - 2.0 * jnp.sum(jnp.log(jnp.abs(d)))
                      + jnp.sum(jnp.square(Lq)))

    g_mu, g_sq = jax.grad(lambda m, s: gauss_kl(m, s, assume_tril=True),
                          argnums=(0, 1))(q_mu, q_sqrt)
    e_mu, e_sq = jax.grad(plain, argnums=(0, 1))(q_mu, q_sqrt)
    np.testing.assert_allclose(np.asarray(g_mu), np.asarray(e_mu), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g_sq), np.asarray(e_sq),
                               rtol=1e-12, atol=1e-12)
    upper = np.triu(np.ones((M, M)), k=1).astype(bool)
    assert np.all(np.asarray(g_sq)[:, upper] == 0.0)
    # value parity through both entry points
    np.testing.assert_allclose(
        float(gauss_kl(q_mu, q_sqrt, assume_tril=True)),
        float(gauss_kl(q_mu, q_sqrt)), rtol=1e-12)


def test_gauss_kl_zero_at_init(rng):
    """Whitened KL at the SVGP init (q_mu=0, q_sqrt=I) must be exactly 0 —
    property from SURVEY.md §4."""
    M, K = 25, 3
    q_mu = np.zeros((M, K))
    q_sqrt = np.broadcast_to(np.eye(M), (K, M, M)).copy()
    got = float(gauss_kl(jnp.asarray(q_mu), jnp.asarray(q_sqrt)))
    assert abs(got) < 1e-12


def test_conditional_fast_solves_matches(rng):
    """inverse+matmul solve path == substitution path (fp64 tight)."""
    from modulatedgps_tpu.ops import linalg
    Kmm, Kmn, Knn, q_mu, q_sqrt = _setup(rng)
    args = (jnp.asarray(Kmn), jnp.asarray(Kmm), jnp.asarray(np.diag(Knn)),
            jnp.asarray(q_mu))
    kw = dict(q_sqrt=jnp.asarray(q_sqrt), full_cov=False, white=False)
    m1, v1 = base_conditional(*args, **kw)
    linalg.set_fast_solves(True)
    try:
        m2, v2 = base_conditional(*args, **kw)
    finally:
        linalg.set_fast_solves(None)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-9,
                               atol=1e-11)


def test_expand_independent_outputs(rng):
    """full_output_cov post-processing (reference MixtureGPs/models.py:130,144):
    independent latents -> (block-)diagonal output covariance."""
    from modulatedgps_tpu.ops.conditionals import expand_independent_outputs
    N, K = 5, 3
    # diag variance [N, K] -> [N, K, K] diagonal matrices
    v = jnp.asarray(rng.standard_normal((N, K)) ** 2)
    out = expand_independent_outputs(v, full_cov=False, full_output_cov=True)
    assert out.shape == (N, K, K)
    for n in range(N):
        np.testing.assert_allclose(np.asarray(out[n]), np.diag(np.asarray(v[n])))
    # full covariance [K, N, N] -> [N, K, N, K] block-diagonal over outputs
    A = rng.standard_normal((K, N, N))
    full = jnp.asarray(A @ np.swapaxes(A, -1, -2))
    out4 = expand_independent_outputs(full, full_cov=True, full_output_cov=True)
    assert out4.shape == (N, K, N, K)
    ref = np.zeros((N, K, N, K))
    for k in range(K):
        ref[:, k, :, k] = np.asarray(full[k])
    np.testing.assert_allclose(np.asarray(out4), ref)
    # identity when full_output_cov is off
    assert expand_independent_outputs(v, False, False) is v
    assert expand_independent_outputs(full, True, False) is full


def test_predict_f_full_output_cov(rng):
    """SVGP.predict_f / PrecomputedPosterior.predict_f honor full_output_cov."""
    from modulatedgps_tpu.models.svgp import SVGP
    from modulatedgps_tpu.models.posterior import precompute_posterior
    k = kmod.SquaredExponential.create(variance=1.3, lengthscales=0.7)
    Z = rng.standard_normal((7, 1))
    m = SVGP.create(k, Z, num_latent_gps=3)
    m = m.replace(q_mu=m.q_mu.replace_raw(
        jnp.asarray(rng.standard_normal((7, 3)))))
    X = rng.standard_normal((4, 1))
    mu, var = m.predict_f(jnp.asarray(X))
    mu2, var4 = m.predict_f(jnp.asarray(X), full_output_cov=True)
    np.testing.assert_allclose(np.asarray(mu2), np.asarray(mu))
    assert var4.shape == (4, 3, 3)
    np.testing.assert_allclose(
        np.asarray(var4), np.asarray(var)[:, :, None] * np.eye(3), rtol=1e-12)
    post = precompute_posterior(m)
    _, pvar4 = post.predict_f(jnp.asarray(X), full_output_cov=True)
    np.testing.assert_allclose(np.asarray(pvar4), np.asarray(var4), rtol=1e-8)


@pytest.mark.parametrize("M", [1, 6, 40])
@pytest.mark.parametrize("source", ["parameter", "raw"])
def test_gauss_kl_analytic_vjp_matches_autodiff(rng, source, M):
    """The whitened KL's analytic VJP against autodiff of the closed form,
    both for q_sqrt from a Parameter "tril" transform (assume_tril) and for
    a raw array with a non-zero upper triangle (masked inside gauss_kl)."""
    from modulatedgps_tpu.params import Parameter
    K = 3
    q_mu = jnp.asarray(rng.normal(size=(M, K)))
    raw = jnp.asarray(rng.normal(size=(K, M, M)) * 0.2 + np.eye(M))

    def plain(q_mu, raw):
        Lq = jnp.tril(raw)
        d = jnp.diagonal(Lq, axis1=-2, axis2=-1)
        return 0.5 * (jnp.sum(jnp.square(q_mu)) - M * K
                      - 2.0 * jnp.sum(jnp.log(jnp.abs(d)))
                      + jnp.sum(jnp.square(Lq)))

    if source == "parameter":
        p = Parameter(raw, transform="tril")

        def kl(q_mu, r):
            return gauss_kl(q_mu, p.replace_raw(r).value, assume_tril=True)
    else:
        kl = gauss_kl
    got = jax.grad(kl, argnums=(0, 1))(q_mu, raw)
    want = jax.grad(plain, argnums=(0, 1))(q_mu, raw)
    np.testing.assert_allclose(float(kl(q_mu, raw)), float(plain(q_mu, raw)),
                               rtol=1e-12)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
    upper = np.triu(np.ones((M, M)), k=1).astype(bool)
    assert np.all(np.asarray(got[1])[:, upper] == 0.0)
