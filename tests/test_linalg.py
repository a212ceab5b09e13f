"""Dense linear algebra of the conditional chain (ops/linalg.py) against
SciPy/NumPy and autodiff oracles: the triangular solves, the fast-solves
route, and the solve-free custom pullbacks (plain jnp, no kernels)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg

from modulatedgps_tpu.ops import linalg


def _spd(rng, M, dtype=np.float32, batch=()):
    A = rng.normal(size=batch + (M, M))
    K = A @ np.swapaxes(A, -1, -2) / M + np.eye(M)
    return K.astype(dtype)


@pytest.fixture(autouse=True)
def _default_solve_form():
    yield
    linalg.set_fast_solves(None)


def _close_scaled(got, ref, rtol, atol):
    s = float(np.max(np.abs(np.asarray(ref)))) or 1.0
    np.testing.assert_allclose(np.asarray(got) / s, np.asarray(ref) / s,
                               rtol=rtol, atol=atol)


# ------------------------------------------------------- solve_triangular

@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("layout", ["single", "batched", "broadcast"])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("lower", [True, False])
def test_solve_triangular_matches_scipy(rng, lower, trans, layout, n):
    M, B = 23, 3
    Lb = np.linalg.cholesky(_spd(rng, M, np.float64, (B,)))
    if not lower:
        Lb = np.swapaxes(Lb, -1, -2)
    Rb = rng.normal(size=(B, M, n))
    if layout == "single":
        L, R = Lb[0], Rb[0]
    elif layout == "batched":
        L, R = Lb, Rb
    else:                                   # one factor, batched RHS
        L, R = Lb[0], Rb
    got = np.asarray(linalg.solve_triangular(jnp.asarray(L), jnp.asarray(R),
                                             lower=lower, trans=trans))
    Ls = np.broadcast_to(L, R.shape[:-2] + (M, M))
    want = np.stack([scipy.linalg.solve_triangular(
        l, r, lower=lower, trans="T" if trans else "N")
        for l, r in zip(Ls.reshape(-1, M, M), R.reshape(-1, M, n))])
    np.testing.assert_allclose(got, want.reshape(R.shape), rtol=1e-10,
                               atol=1e-10)


# ------------------------------------------------------ the fast-solves route

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fast_solves_switch_selects_the_form(rng, dtype):
    """By default a small float32 factor takes the fast form and a float64
    one substitution; set_fast_solves(True/False) forces the form, None
    restores the choice.  The fast form routes cholesky, triangular_inverse
    and whiten_solve through the solve-free custom pullbacks, whose jaxprs
    then carry custom_vjp calls."""
    K = jnp.asarray(_spd(rng, 8, dtype))
    B = jnp.asarray(rng.normal(size=(8, 3)).astype(dtype))

    def vjp_calls():
        return str(jax.make_jaxpr(lambda k, b: (
            linalg.cholesky(k), linalg.triangular_inverse(k),
            linalg.whiten_solve(k, b)))(K, B)).count("custom_vjp_call")

    default = dtype == np.float32
    assert linalg.fast_solves(8, dtype) == default
    assert vjp_calls() == (3 if default else 0)
    linalg.set_fast_solves(True)
    assert linalg.fast_solves(8, dtype)
    assert vjp_calls() == 3
    linalg.set_fast_solves(False)
    assert not linalg.fast_solves(8, dtype)
    assert vjp_calls() == 0
    linalg.set_fast_solves(None)
    assert vjp_calls() == (3 if default else 0)


@pytest.mark.parametrize("M, dtype, fast", [
    (1, np.float32, True), (1024, np.float32, True),
    (linalg.FAST_SOLVES_MAX_M, np.float32, True),
    (linalg.FAST_SOLVES_MAX_M + 1, np.float32, False),
    (4096, np.float32, False), (64, np.float64, False),
    (64, np.float16, False)])
def test_fast_solves_default_by_size_and_dtype(M, dtype, fast):
    """The default form follows the factor's size and dtype only."""
    assert linalg.fast_solves(M, dtype) == fast
    L = jax.ShapeDtypeStruct((M, M), dtype)
    jaxpr = str(jax.make_jaxpr(linalg.triangular_inverse)(L))
    assert ("custom_vjp_call" in jaxpr) == fast


def test_fast_solves_routing_parity(rng):
    """triangular_inverse, solve_lower and their gradients agree between
    the fast form and substitution (float32)."""
    M, N = 320, 64
    L = jnp.asarray(np.linalg.cholesky(_spd(rng, M)))
    B = jnp.asarray(rng.normal(size=(M, N)).astype(np.float32))

    def run():
        inv = linalg.triangular_inverse(L)
        slv = linalg.solve_lower(L, B)
        g = jax.grad(lambda L_: jnp.sum(linalg.solve_lower(L_, B) ** 2))(L)
        return inv, slv, g

    linalg.set_fast_solves(False)
    ref = run()
    linalg.set_fast_solves(True)
    got = run()
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(ref[1]),
                               rtol=2e-4, atol=2e-4)
    _close_scaled(got[2], ref[2], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("M", [1, 7, 64, 256])
def test_trinv_solve_free_vjp(rng, M):
    """triangular_inverse's fast pullback (Lbar = -tril(X^T Xbar X^T), no
    triangular solve in the backward) matches autodiff of the solve."""
    N = 96
    L = jnp.asarray(np.linalg.cholesky(_spd(rng, M, np.float64)))
    B = jnp.asarray(rng.normal(size=(M, N)))

    def loss(L_):
        Li = linalg.triangular_inverse(L_)
        return jnp.sum((Li @ B) ** 2) + jnp.sum(Li[M // 2])

    linalg.set_fast_solves(False)
    g_ref = jax.grad(loss)(L)
    linalg.set_fast_solves(True)
    g_new = jax.grad(loss)(L)
    _close_scaled(g_new, g_ref, rtol=1e-8, atol=1e-10)


def test_trinv_solve_free_vjp_float32(rng):
    """The solve-free inverse pullback in float32 at M=256, through a
    composite loss."""
    M, N = 256, 96
    L = jnp.asarray(np.linalg.cholesky(_spd(rng, M)))
    B = jnp.asarray(rng.normal(size=(M, N)).astype(np.float32))

    def loss(L_):
        Li = linalg.triangular_inverse(L_)
        return jnp.sum((Li @ B) ** 2) + jnp.sum(Li[10])

    linalg.set_fast_solves(False)
    g_ref = jax.grad(loss)(L)
    linalg.set_fast_solves(True)
    g_new = jax.grad(loss)(L)
    _close_scaled(g_new, g_ref, rtol=1e-4, atol=1e-5)


# ------------------------------------------- Murray and whiten-solve pullbacks

_TOL = {np.float32: (1e-3, 1e-4), np.float64: (1e-8, 1e-10)}


def _grads(fn, *args, argnums=0):
    """(reference autodiff grads, fast-form grads) of ``fn``."""
    linalg.set_fast_solves(False)
    ref = jax.grad(fn, argnums=argnums)(*args)
    linalg.set_fast_solves(True)
    got = jax.grad(fn, argnums=argnums)(*args)
    return ref, got


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("M", [1, 7, 64, 256])
def test_chol_pullback_matches_autodiff(rng, M, dtype):
    """cholesky's fast pullback (Murray 2016, closed with one triangular
    inverse) matches XLA's Cholesky VJP."""
    K = jnp.asarray(_spd(rng, M, dtype))
    C = jnp.asarray(rng.normal(size=(M, M)).astype(dtype))

    def loss(Km):
        L = linalg.cholesky(Km)
        return jnp.sum(C * L) + jnp.sum(L[M // 2] ** 2)

    ref, got = _grads(loss, K)
    _close_scaled(got, ref, *_TOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("M", [1, 7, 64, 256])
def test_whiten_solve_pullback_matches_autodiff(rng, M, dtype):
    """whiten_solve's composite pullback matches autodiff of cholesky ->
    triangular solve, through a loss that also uses A elementwise."""
    N = 33
    Kmm = jnp.asarray(_spd(rng, M, dtype))
    Kmn = jnp.asarray(rng.normal(size=(M, N)).astype(dtype))
    C = jnp.asarray(rng.normal(size=(M, N)).astype(dtype))

    def loss(Km, B):
        A = linalg.whiten_solve(Km, B)
        return jnp.sum(A ** 2) + jnp.sum(C * A)

    ref, got = _grads(loss, Kmm, Kmn, argnums=(0, 1))
    for g, r in zip(got, ref):
        _close_scaled(g, r, *_TOL[dtype])


def test_chol_pullback_batched(rng):
    """The Murray pullback on a [B, M, M] stack of factors."""
    K = jnp.asarray(_spd(rng, 16, np.float64, (3,)))
    C = jnp.asarray(rng.normal(size=(3, 16, 16)))
    ref, got = _grads(lambda Km: jnp.sum(C * linalg.cholesky(Km)), K)
    _close_scaled(got, ref, *_TOL[np.float64])


def test_whiten_solve_pullback_batched(rng):
    """The composite pullback with matching [B, ...] batch dims."""
    Kmm = jnp.asarray(_spd(rng, 16, np.float64, (3,)))
    Kmn = jnp.asarray(rng.normal(size=(3, 16, 9)))
    ref, got = _grads(lambda a, b: jnp.sum(linalg.whiten_solve(a, b) ** 3),
                      Kmm, Kmn, argnums=(0, 1))
    for g, r in zip(got, ref):
        _close_scaled(g, r, *_TOL[np.float64])


@pytest.mark.parametrize("shared_kmm", [True, False])
def test_whiten_solve_pullback_under_vmap(rng, shared_kmm):
    """The custom pullbacks vmap: one shared Kmm against a batch of Kmn
    panels (its cotangent sums over the batch), or both batched."""
    B, M, N = 4, 12, 7
    Kmm = _spd(rng, M, np.float64, () if shared_kmm else (B,))
    Kmn = rng.normal(size=(B, M, N))
    axes = (None if shared_kmm else 0, 0)

    def loss(a, b):
        A = jax.vmap(linalg.whiten_solve, in_axes=axes)(a, b)
        return jnp.sum(jnp.sin(A))

    ref, got = _grads(loss, jnp.asarray(Kmm), jnp.asarray(Kmn),
                      argnums=(0, 1))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        _close_scaled(g, r, *_TOL[np.float64])


@pytest.mark.parametrize("M", [1, 7, 64])
def test_chol_pullback_under_vmap(rng, M):
    K = jnp.asarray(_spd(rng, M, np.float64, (3,)))
    ref, got = _grads(
        lambda Km: jnp.sum(jax.vmap(linalg.cholesky)(Km) ** 2), K)
    _close_scaled(got, ref, *_TOL[np.float64])


def test_whiten_solve_fused_pullback(rng):
    """The composite pullback in float32 at M=256, forward against the
    substitution oracle."""
    M, N = 256, 96
    Kmat = jnp.asarray(_spd(rng, M))
    Kmn = jnp.asarray(rng.normal(size=(M, N)).astype(np.float32))
    C = jnp.asarray(rng.normal(size=(M, N)).astype(np.float32))

    def loss(Km, B):
        A = linalg.whiten_solve(Km, B)
        return jnp.sum(A ** 2) + jnp.sum(C * A)

    linalg.set_fast_solves(False)
    fwd_ref = loss(Kmat, Kmn)
    g_ref = jax.grad(loss, argnums=(0, 1))(Kmat, Kmn)
    linalg.set_fast_solves(True)
    fwd_new = loss(Kmat, Kmn)
    g_new = jax.grad(loss, argnums=(0, 1))(Kmat, Kmn)
    np.testing.assert_allclose(float(fwd_new), float(fwd_ref),
                               rtol=1e-4, atol=1e-4)
    for got, ref in zip(g_new, g_ref):
        _close_scaled(got, ref, rtol=1e-3, atol=1e-4)


def test_chol_substitution_free_pullback(rng):
    """cholesky's fast pullback in float32 at M=256 matches XLA's
    built-in Cholesky VJP."""
    M = 256
    Kmat = jnp.asarray(_spd(rng, M))
    C = jnp.asarray(rng.normal(size=(M, M)).astype(np.float32))

    def loss(Km):
        L = linalg.cholesky(Km)
        return jnp.sum(C * L) + jnp.sum(L[3] ** 2)

    ref, got = _grads(loss, Kmat)
    _close_scaled(got, ref, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ training dtype

def test_compute_dtype_master_weights(rng):
    """make_train_step(compute_dtype=f32) with f64 params: loss computed in
    f32, params/moments stay f64, and one step moves params like the f32
    regime (not the f64 one) while storing the update at f64."""
    import optax
    from modulatedgps_tpu.training import make_train_step
    import modulatedgps_tpu as mgp
    from modulatedgps_tpu.ops.kernels import SquaredExponential
    from modulatedgps_tpu.likelihoods import Gaussian

    Z = rng.normal(size=(8, 1))
    model = mgp.SMGP(
        likelihood=Gaussian.create(variance=0.5, D=2),
        pred_layer=mgp.SVGP.create(SquaredExponential.create(0.5, 0.5), Z,
                                   num_latent_gps=2),
        assign_layer=mgp.SVGP.create(SquaredExponential.create(0.1, 1.0), Z,
                                     num_latent_gps=2),
        K=2, num_samples=4, num_data=32)
    X = jnp.asarray(rng.normal(size=(32, 1)))
    Y = jnp.asarray(rng.normal(size=(32, 1)))
    assert model.pred_layer.q_mu.value.dtype == jnp.float64

    init_fn, step_fn = make_train_step(optax.adam(1e-2),
                                       compute_dtype=jnp.float32)
    state = init_fn(model, jax.random.PRNGKey(0))
    state, loss = jax.jit(step_fn)(state, X, Y)
    assert loss.dtype == jnp.float32
    q_mu = state.model.pred_layer.q_mu.value
    assert q_mu.dtype == jnp.float64
    assert not np.allclose(np.asarray(q_mu),
                           np.asarray(model.pred_layer.q_mu.value))
