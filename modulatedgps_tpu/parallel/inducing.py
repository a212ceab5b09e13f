"""Inducing-point (large-M) model sharding: the end-to-end training path.

SURVEY.md §2.4 / BASELINE.md north star: M=4096+ inducing points with the
M x M factorization itself sharded over the mesh — the work the reference
delegates to one tf.linalg.cholesky inside gpflow (reached from reference
MixtureGPs/models.py:141), here distributed because a single chip can't
hold/afford the O(M^3) chain at scale.

Layout over one mesh axis (default 'data', P devices):

  Z      [M, D]     -> P(axis, None)        contiguous block rows
  q_mu   [M, K]     -> P(axis, None)        block rows
  q_sqrt [K, M, M]  -> P(None, None, axis)  contiguous block COLUMNS
  X, Y   [N, ...]   -> P(axis)              batch rows
  kernel hypers / likelihood variance: replicated.

Inside one ``shard_map`` the whitened conditional runs as the local-shard
program (collectives explicit) with A kept BATCH-COLUMN sharded so that no
collective's payload grows with N:

  Zg   = all_gather(Z)                      # [M, D], tiny
  Kuu  = rows of K(Z,Z)+jit                 # local [M/P, M]
  L    = blocked._chol_local(Kuu)           # distributed Cholesky
  Lg   = all_gather(L)                      # [M, M] — N-independent
  Kmn  = K(Zg, X_loc)                       # local [M, N/P], no comms
  A    = solve_lower(Lg, Kmn)               # LOCAL full-M TRSM on the
                                            #   device's own batch columns
                                            #   (FLOPs M^2 N / P, 0 comms;
                                            #   routed Pallas TRSM applies)
  fmean= A^T all_gather(q_mu)               # [N/P, K] local ([M,K] gather)
  fvar = Kdiag(X_loc) - colsum A^2          # fully local
         + quad_ring(Lq, A)                 # see below

The q_sqrt quadratic sum_p (Lq^T A)^2[p, n] couples every global column p
of Lq with every local batch column a_n.  Instead of all-gathering A
(payload M*N — the O(M*N) pathology this layout exists to avoid), the
column-sharded Lq blocks rotate around a ppermute ring: P-1 steps, each
device accumulating its local columns' partial sums over the visiting
p-block.  Per-device payload = K*M^2*(P-1)/P per layer, INDEPENDENT OF N
(forward and, by ppermute-transpose symmetry, backward).  Measured
tradeoff: at N < K*M a one-shot all_gather(A) would move fewer bytes
(M*N), but its payload and its [M, N] per-device materialization grow
unboundedly with N, which is exactly the weak-scaling failure diagnosed in
the round-3 audit; the ring's payload is the size of Lq itself with O(1/P)
peak memory, and the chain is compute-dominated at the north-star shape.
The global tril mask is applied to the raw leaf before the ring
(Parameter's tril transform would tril the LOCAL block with local indices
— wrong under column sharding).

The whitened KL is exact with the same layout: ||q_mu||^2 is row-sharded,
||tril(q_sqrt)||^2 column-sharded, and log-diagonal entries live at local
column p == global row d*M/P + p.

Whiten=True only (the product default — every reference demo constructs
SVGP(whiten=True), reference demos/demo_tf2.py:43-46); the unwhitened
second solve (L^T) would need a distributed backward substitution.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import default_jitter
from ..ops.linalg import solve_lower
from .blocked import _chol_local

__all__ = [
    "inducing_specs",
    "inducing_shard_state",
    "inducing_sharded_elbo",
    "inducing_sharded_predict_f",
    "make_inducing_sharded_train_step",
]


# ----------------------------------------------------------------- placement

def _spec_for(path, leaf, axis: str) -> P:
    """PartitionSpec for one leaf of a model / TrainState pytree.

    Matches by array meaning (field name + rank), so the same rule shards
    the model, the grads and the Adam moment trees (optax states mirror the
    param tree's key paths).
    """
    if not hasattr(leaf, "ndim"):
        return P()
    names = [getattr(p, "name", None) for p in path]
    if "Z" in names and leaf.ndim == 2:
        return P(axis, None)
    if "q_mu" in names and leaf.ndim == 2:
        return P(axis, None)
    if "q_sqrt" in names and leaf.ndim == 3:
        return P(None, None, axis)
    return P()


def inducing_specs(tree, axis: str = "data"):
    """Pytree of PartitionSpecs with the inducing state sharded (see module
    docstring) and everything else replicated."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: _spec_for(path, leaf, axis), tree)


def inducing_shard_state(mesh: Mesh, state, axis: str = "data"):
    """Place a model or TrainState with its inducing tensors mesh-sharded."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jax.device_put(
            leaf, NamedSharding(mesh, _spec_for(path, leaf, axis)))
        if hasattr(leaf, "ndim") else leaf,
        state)


# ------------------------------------------------------- local-shard program

def _check_layer(layer):
    if not layer.whiten:
        raise NotImplementedError(
            "inducing-sharded conditional supports whiten=True only")
    if layer.q_sqrt.raw.ndim != 3 or layer.q_sqrt.transform != "tril":
        raise NotImplementedError(
            "inducing-sharded conditional needs a [K, M, M] tril q_sqrt")


def _quad_ring(Lq_loc, A_loc, *, axis: str, nshards: int):
    """extra[k, n] = sum over ALL global columns p of (Lq[:, :, p]^T a_n)^2
    for this device's local batch columns a_n, computed by rotating the
    column-sharded (pre-masked) Lq blocks around a ppermute ring.

    Per-device collective payload: (nshards-1)/nshards * K*M^2 — independent
    of N in both the forward and the transposed (backward) program.
    """
    dtype = A_loc.dtype
    extra = jnp.zeros((Lq_loc.shape[0], A_loc.shape[1]), dtype)
    perm = [(i, (i + 1) % nshards) for i in range(nshards)]
    blk = Lq_loc
    for s in range(nshards):
        lta = jnp.einsum("kmp,mn->kpn", blk, A_loc,
                         preferred_element_type=dtype)      # [K, M/P, N/P]
        extra = extra + jnp.sum(jnp.square(lta), axis=1)
        if s < nshards - 1:
            blk = jax.lax.ppermute(blk, axis, perm)
    return extra                                            # [K, N/P]


def _conditional_local(layer, X_loc, *, axis: str, block: int, nshards: int):
    """Whitened SVGP conditional with M sharded; returns batch-sharded
    (fmean [N/P, K], fvar [N/P, K]) for this device's X rows.

    Collective payloads (per device, per call): all_gather Z [M,D],
    all_gather L [M,M], all_gather q_mu [M,K], Lq ring K*M^2*(P-1)/P,
    plus the distributed Cholesky's internal O(M*block) panels — none of
    them a function of N (module docstring)."""
    Z_loc = layer.Z.value                         # [M/P, D]
    q_mu_loc = layer.q_mu.value                   # [M/P, K]
    q_sqrt_raw = layer.q_sqrt.raw                 # [K, M, M/P] column block
    dtype = Z_loc.dtype
    rpd = Z_loc.shape[0]
    M = q_sqrt_raw.shape[1]
    d = jax.lax.axis_index(axis)
    gloc = d * rpd + jnp.arange(rpd)              # global ids of local rows/cols

    Zg = jax.lax.all_gather(Z_loc, axis, tiled=True)        # [M, D]

    jit = jnp.asarray(default_jitter(dtype), dtype)
    Kuu_loc = layer.kernel.K(Z_loc, Zg) + jit * (
        gloc[:, None] == jnp.arange(M)[None, :]).astype(dtype)
    L_loc = _chol_local(Kuu_loc, axis=axis, block=block)    # [M/P, M]
    Lg = jax.lax.all_gather(L_loc, axis, tiled=True)        # [M, M]

    # Each device solves the full-M TRSM for ITS OWN batch columns only:
    # zero communication, M^2 N/P FLOPs, one dense local solve.
    Kmn_loc = layer.kernel.K(Zg, X_loc)                     # [M, N/P]
    A_loc = solve_lower(Lg, Kmn_loc)                        # [M, N/P]

    Knn_loc = layer.kernel.K_diag(X_loc)                    # [N/P]
    fvar0 = Knn_loc - jnp.sum(jnp.square(A_loc), axis=0)    # [N/P]
    q_mu_g = jax.lax.all_gather(q_mu_loc, axis, tiled=True)  # [M, K]
    fmean = jnp.matmul(A_loc.T, q_mu_g,
                       preferred_element_type=dtype)        # [N/P, K]

    tril_mask = (jnp.arange(M)[:, None] >= gloc[None, :]).astype(dtype)
    Lq_loc = q_sqrt_raw * tril_mask[None]                   # [K, M, M/P]
    extra = _quad_ring(Lq_loc, A_loc, axis=axis, nshards=nshards)
    fvar = fvar0[:, None] + extra.T                         # [N/P, K]
    return fmean, fvar


def _kl_local(layer, *, axis: str) -> jax.Array:
    """Whitened gauss_kl (ops/kl.py semantics) on the sharded layout.
    Returns the full (replicated) KL scalar."""
    q_mu_loc = layer.q_mu.value
    q_sqrt_raw = layer.q_sqrt.raw                 # [K, M, M/P]
    rpd = q_sqrt_raw.shape[-1]
    M = q_sqrt_raw.shape[1]
    Klat = q_mu_loc.shape[1]
    d = jax.lax.axis_index(axis)
    gloc = d * rpd + jnp.arange(rpd)
    dtype = q_mu_loc.dtype

    mahal = jax.lax.psum(jnp.sum(jnp.square(q_mu_loc)), axis)
    tril_mask = (jnp.arange(M)[:, None] >= gloc[None, :]).astype(dtype)
    trace = jax.lax.psum(jnp.sum(jnp.square(q_sqrt_raw * tril_mask[None])),
                         axis)
    diag_mask = (jnp.arange(M)[:, None] == gloc[None, :]).astype(dtype)
    diag = jnp.sum(q_sqrt_raw * diag_mask[None], axis=1)    # [K, M/P]
    logdet = 2.0 * jax.lax.psum(jnp.sum(jnp.log(jnp.abs(diag))), axis)
    return 0.5 * (mahal - jnp.asarray(M * Klat, dtype) - logdet + trace)


# --------------------------------------------------------------- public API

def _block_for(M: int, nshards: int, block: int | None) -> int:
    rpd = M // nshards
    if block is None:
        block = min(128, rpd)
    return block


def inducing_sharded_elbo(model, key: jax.Array, X: jax.Array, Y: jax.Array,
                          mesh: Mesh, *, axis: str = "data",
                          block: int | None = None) -> jax.Array:
    """SMGP/SMGPModified ELBO with the inducing state sharded over ``axis``.

    Algebraically identical to model.elbo on replicated state (tested to fp
    tolerance); the O(M^3) Cholesky/TRSM chain and the O(M^2 N K) q_sqrt
    quadratic run distributed.  The model pytree may be passed replicated or
    already placed with inducing_shard_state — shard_map reshards by spec.
    """
    _check_layer(model.pred_layer)
    _check_layer(model.assign_layer)
    n_total = X.shape[0]
    M = model.pred_layer.q_sqrt.raw.shape[1]
    nshards = mesh.shape[axis]
    block = _block_for(M, nshards, block)
    z, g = model.draw_noise(key, n_total, model.num_samples, X.dtype)

    def local(model, z, g, X, Y):
        fmu, fvar = _conditional_local(model.pred_layer, X, axis=axis,
                                       block=block, nshards=nshards)
        amu, avar = _conditional_local(model.assign_layer, X, axis=axis,
                                       block=block, nshards=nshards)
        e = model.E_log_p_from_marginals(fmu, fvar, amu, avar, z, g, Y)
        fit = jax.lax.psum(jnp.sum(e), axis) / n_total
        kl = (_kl_local(model.pred_layer, axis=axis)
              + _kl_local(model.assign_layer, axis=axis))
        return fit - kl / model.num_data

    return shard_map(
        local, mesh=mesh,
        in_specs=(inducing_specs(model, axis),
                  P(None, axis), P(None, axis), P(axis), P(axis)),
        out_specs=P(),
    )(model, z, g, X, Y)


def inducing_sharded_predict_f(layer, Xnew: jax.Array, mesh: Mesh, *,
                               axis: str = "data", block: int | None = None):
    """predict_f for one SVGP layer with mesh-sharded inducing state.

    Returns (fmean, fvar) [N, K] global arrays sharded over ``axis`` on N.
    """
    _check_layer(layer)
    M = layer.q_sqrt.raw.shape[1]
    nshards = mesh.shape[axis]
    block = _block_for(M, nshards, block)
    f = shard_map(
        partial(_conditional_local, axis=axis, block=block, nshards=nshards),
        mesh=mesh,
        in_specs=(inducing_specs(layer, axis), P(axis)),
        out_specs=(P(axis, None), P(axis, None)),
    )
    return f(layer, Xnew)


def make_inducing_sharded_train_step(optimizer, mesh: Mesh, *,
                                     axis: str = "data",
                                     block: int | None = None,
                                     donate: bool = True):
    """(init_fn, step_fn) training an SMGP whose inducing state is sharded.

    init_fn(model, key) places the TrainState (params AND Adam moments) with
    inducing_shard_state; step_fn(state, X, Y) expects X/Y sharded over
    ``axis`` and differentiates through the shard_map'd ELBO — gradients of
    sharded leaves come back sharded, so the optimizer update stays local.
    """
    from ..training.loop import make_train_step

    def loss_fn(model, key, X, Y):
        return -inducing_sharded_elbo(model, key, X, Y, mesh,
                                      axis=axis, block=block)

    base_init, base_step = make_train_step(optimizer, loss_fn=loss_fn)

    def init_fn(model, key):
        return inducing_shard_state(mesh, base_init(model, key), axis)

    step_fn = jax.jit(base_step, donate_argnums=(0,) if donate else ())
    return init_fn, step_fn
