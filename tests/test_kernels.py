"""Kernel correctness vs direct O(N*M*D) loops and scipy distances."""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy.spatial.distance import cdist

from modulatedgps_tpu.ops import kernels as K


def _naive_rbf(X, Z, var, ls):
    d2 = cdist(X / ls, Z / ls, "sqeuclidean")
    return var * np.exp(-0.5 * d2)


def test_square_distance_matches_scipy(rng):
    X = rng.normal(size=(37, 3))
    Z = rng.normal(size=(21, 3))
    got = np.asarray(K.square_distance(jnp.asarray(X), jnp.asarray(Z)))
    want = cdist(X, Z, "sqeuclidean")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_square_distance_self_zero_diag(rng):
    X = rng.normal(size=(50, 2)) * 100.0  # large values stress the expansion
    d2 = np.asarray(K.square_distance(jnp.asarray(X), None))
    assert np.all(np.diag(d2) >= 0.0)
    np.testing.assert_allclose(np.diag(d2), 0.0, atol=1e-8)


def test_rbf_matches_naive(rng):
    X = rng.normal(size=(10, 2))
    Z = rng.normal(size=(7, 2))
    k = K.SquaredExponential.create(variance=0.5, lengthscales=0.7)
    got = np.asarray(k.K(jnp.asarray(X), jnp.asarray(Z)))
    np.testing.assert_allclose(got, _naive_rbf(X, Z, 0.5, 0.7), rtol=1e-6, atol=1e-8)


def test_rbf_ard_lengthscales(rng):
    X = rng.normal(size=(9, 3))
    ls = np.array([0.5, 1.0, 2.0])
    k = K.SquaredExponential.create(variance=2.0, lengthscales=ls)
    got = np.asarray(k.K(jnp.asarray(X)))
    want = _naive_rbf(X, X, 2.0, ls)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_kdiag_equals_diag_of_K(rng):
    X = rng.normal(size=(12, 2))
    for k in [K.SquaredExponential.create(0.3, 0.9),
              K.Matern12.create(1.1, 0.6),
              K.Matern32.create(0.7, 1.3),
              K.Matern52.create(2.0, 0.4)]:
        full = np.asarray(k.K(jnp.asarray(X)))
        diag = np.asarray(k.K_diag(jnp.asarray(X)))
        np.testing.assert_allclose(diag, np.diag(full), rtol=1e-6, atol=1e-9)


def test_matern32_closed_form(rng):
    X = rng.normal(size=(6, 1))
    Z = rng.normal(size=(5, 1))
    var, ls = 1.3, 0.8
    k = K.Matern32.create(var, ls)
    r = cdist(X, Z) / ls
    want = var * (1 + np.sqrt(3) * r) * np.exp(-np.sqrt(3) * r)
    np.testing.assert_allclose(np.asarray(k.K(jnp.asarray(X), jnp.asarray(Z))),
                               want, rtol=1e-6)


def test_white_kernel(rng):
    X = rng.normal(size=(8, 2))
    Z = rng.normal(size=(4, 2))
    k = K.White.create(0.25)
    np.testing.assert_allclose(np.asarray(k.K(jnp.asarray(X))),
                               0.25 * np.eye(8), atol=1e-12)
    np.testing.assert_allclose(np.asarray(k.K(jnp.asarray(X), jnp.asarray(Z))),
                               np.zeros((8, 4)), atol=1e-12)


def test_sum_product_combinators(rng):
    X = rng.normal(size=(5, 2))
    a = K.SquaredExponential.create(1.0, 1.0)
    b = K.Matern32.create(0.5, 2.0)
    Xj = jnp.asarray(X)
    np.testing.assert_allclose(np.asarray((a + b).K(Xj)),
                               np.asarray(a.K(Xj)) + np.asarray(b.K(Xj)), rtol=1e-12)
    np.testing.assert_allclose(np.asarray((a * b).K(Xj)),
                               np.asarray(a.K(Xj)) * np.asarray(b.K(Xj)), rtol=1e-12)


def test_batched_leading_dims(rng):
    X = rng.normal(size=(4, 10, 2))
    Z = rng.normal(size=(7, 2))
    k = K.SquaredExponential.create(0.9, 1.1)
    got = np.asarray(k.K(jnp.asarray(X), jnp.asarray(Z)))
    assert got.shape == (4, 10, 7)
    for s in range(4):
        np.testing.assert_allclose(got[s], _naive_rbf(X[s], Z, 0.9, 1.1), rtol=1e-6, atol=1e-8)


def test_kernel_psd(rng):
    X = rng.normal(size=(30, 2))
    k = K.SquaredExponential.create(1.0, 0.5)
    Kxx = np.asarray(k.K(jnp.asarray(X)))
    eigs = np.linalg.eigvalsh(Kxx)
    assert eigs.min() > -1e-8


_STATIONARY = {
    "SquaredExponential": lambda r2: np.exp(-0.5 * r2),
    "Matern12": lambda r2: np.exp(-np.sqrt(r2)),
    "Matern32": lambda r2: (1 + np.sqrt(3 * r2)) * np.exp(-np.sqrt(3 * r2)),
    "Matern52": lambda r2: (1 + np.sqrt(5 * r2) + 5.0 / 3.0 * r2)
    * np.exp(-np.sqrt(5 * r2)),
}


@pytest.mark.parametrize("D", [1, 4, 90])
@pytest.mark.parametrize("name", sorted(_STATIONARY))
def test_stationary_kxz_matches_numpy(rng, name, D):
    """K(X, Z) of each stationary kernel against NumPy by direct
    differences, with ARD lengthscales, at input widths from 1 to 90."""
    X = rng.normal(size=(29, D))
    Z = rng.normal(size=(17, D))
    ls = 0.5 + rng.uniform(size=D) * np.sqrt(D)
    var = 1.7
    kern = getattr(K, name).create(variance=var, lengthscales=ls)
    got = np.asarray(kern.K(jnp.asarray(X), jnp.asarray(Z)))
    diff = (X[:, None, :] - Z[None, :, :]) / ls
    want = var * _STATIONARY[name](np.sum(diff * diff, axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
