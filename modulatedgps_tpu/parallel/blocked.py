"""Inducing-point model sharding: blocked Cholesky / TRSM across devices.

SURVEY.md §2.4/§5.7: at reference scales (M=25) the inducing state is
replicated, but the scaled north-star config (M=4096+) wants the M x M
factorization itself sharded over the mesh — the GP analog of sequence
parallelism ("the sequence-parallel hard case": block-cyclic Cholesky +
all-gathered TRSM panels).  The reference has no distributed layer at all
(its Cholesky is a single tf.linalg.cholesky inside gpflow, reached from
reference MixtureGPs/models.py:141).

Layout: the SPD matrix (and any right-hand sides) are sharded by
*contiguous block rows* over one mesh axis; every function here is the
local-shard program of a ``shard_map`` (lock-step SPMD with explicit
collectives):

  - ``distributed_cholesky``: right-looking blocked factorization.  Per
    panel j: the owner's diagonal block is factorized and psum-broadcast,
    every device TRSMs its local panel rows, one tiled all_gather shares
    the panel column, and the trailing update is a local matmul (masked —
    no cross-device traffic).  Comm per panel: B^2 psum + M*B all-gather.
  - ``distributed_solve_lower``: blocked forward substitution; per panel
    the owner's solved X_j block is psum-broadcast and folded into every
    device's remaining local rows.

Numerics match jnp.linalg.cholesky / triangular_solve to fp tolerance
(tests run on an 8-virtual-device CPU mesh, fp64).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

__all__ = ["distributed_cholesky", "distributed_solve_lower"]

# The trailing and substitution updates feed the next diagonal block's
# Cholesky; one-pass reduced-precision products (TF32 on a GPU) leave
# errors above the jitter-sized small eigenvalues and the factorization
# goes NaN at M=4096 in float32.
_HI = jax.lax.Precision.HIGHEST


def _i32(v):
    return jnp.asarray(v, jnp.int32)


def _owner_block(arr_loc, j0: jax.Array, width: int, ncols: int,
                 col0, rpd: int, axis: str):
    """Extract the [width, ncols] block whose global row offset is j0 from
    whichever device owns it, and psum-broadcast it to all devices."""
    d = jax.lax.axis_index(axis)
    off = _i32(j0) - d * rpd
    own = (off >= 0) & (off + width <= rpd)
    offc = jnp.clip(off, 0, rpd - width)
    blk = jax.lax.dynamic_slice(arr_loc, (offc, _i32(col0)), (width, ncols))
    return jax.lax.psum(jnp.where(own, blk, jnp.zeros_like(blk)), axis), own, offc


def _chol_local(A_loc, *, axis: str, block: int):
    """Local-shard blocked Cholesky.  A_loc: [rpd, M] contiguous block rows
    of a global SPD matrix; returns the same rows of the lower factor."""
    rpd, M = A_loc.shape
    d = jax.lax.axis_index(axis)
    grow = d * rpd + jnp.arange(rpd)                     # global row ids
    gcol = jnp.arange(M)                                 # global col ids
    nb = M // block
    L_loc = jnp.zeros_like(A_loc)

    def step(j, carry):
        A_loc, L_loc = carry
        j0 = j * block

        diag, own, offc = _owner_block(A_loc, j0, block, block, j0, rpd, axis)
        # Non-owners feed zeros into the psum; the owner's block is the
        # current trailing diagonal block, SPD by induction.
        Ljj = jnp.linalg.cholesky(diag)

        # Local panel rows: rows strictly below the diagonal block get
        # A[:, j] Ljj^-T; rows at/above it get 0 (then the owner re-inserts
        # Ljj for its diagonal rows).
        Pcol = jax.lax.dynamic_slice(A_loc, (_i32(0), _i32(j0)), (rpd, block))
        Lpan = jax.lax.linalg.triangular_solve(
            Ljj, Pcol, left_side=False, lower=True, transpose_a=True)
        Lpan = jnp.where((grow >= j0 + block)[:, None], Lpan, 0.0)
        keep = jax.lax.dynamic_slice(Lpan, (offc, _i32(0)), (block, block))
        Lpan = jax.lax.dynamic_update_slice(
            Lpan, jnp.where(own, Ljj, keep), (offc, _i32(0)))

        # Share the full panel column, then rank-B update of the trailing
        # submatrix (columns > j0+block-1) — local matmul, no comm.
        Lcol = jax.lax.all_gather(Lpan, axis, tiled=True)        # [M, block]
        Lcol_trail = jnp.where((gcol >= j0 + block)[:, None], Lcol, 0.0)
        A_loc = A_loc - jnp.matmul(Lpan, Lcol_trail.T, precision=_HI,
                                   preferred_element_type=A_loc.dtype)
        L_loc = jax.lax.dynamic_update_slice(L_loc, Lpan, (_i32(0), _i32(j0)))
        return A_loc, L_loc

    _, L_loc = jax.lax.fori_loop(0, nb, step, (A_loc, L_loc))
    return L_loc


def _solve_lower_local(L_loc, B_loc, *, axis: str, block: int):
    """Local-shard blocked forward substitution: solve L X = B with L and B
    sharded by the same contiguous block rows."""
    rpd, M = L_loc.shape
    N = B_loc.shape[-1]
    d = jax.lax.axis_index(axis)
    grow = d * rpd + jnp.arange(rpd)
    nb = M // block
    X_loc = jnp.zeros_like(B_loc)

    def step(j, carry):
        X_loc, B_loc = carry
        j0 = j * block
        Ljj, own, offc = _owner_block(L_loc, j0, block, block, j0, rpd, axis)
        Bj, _, _ = _owner_block(B_loc, j0, block, N, 0, rpd, axis)
        Xj = jax.lax.linalg.triangular_solve(
            Ljj, Bj, left_side=True, lower=True)                 # [block, N]

        # Fold X_j into every device's remaining rows (rows < j0 have zero
        # L entries in this column block, so the mask only protects the
        # already-consumed diagonal rows).
        Lcolj = jax.lax.dynamic_slice(L_loc, (_i32(0), _i32(j0)), (rpd, block))
        upd = jnp.matmul(Lcolj, Xj, precision=_HI,
                         preferred_element_type=B_loc.dtype)
        B_loc = B_loc - jnp.where((grow >= j0 + block)[:, None], upd, 0.0)

        keep = jax.lax.dynamic_slice(X_loc, (offc, _i32(0)), (block, N))
        X_loc = jax.lax.dynamic_update_slice(
            X_loc, jnp.where(own, Xj, keep), (offc, _i32(0)))
        return X_loc, B_loc

    X_loc, _ = jax.lax.fori_loop(0, nb, step, (X_loc, B_loc))
    return X_loc


def _check(M: int, mesh: Mesh, axis: str, block: int):
    nd = mesh.shape[axis]
    if M % nd:
        raise ValueError(f"M={M} must be a multiple of the '{axis}' axis "
                         f"size {nd}")
    rpd = M // nd
    if rpd % block:
        raise ValueError(f"rows-per-device {rpd} must be a multiple of "
                         f"block={block}")


def distributed_cholesky(A: jax.Array, mesh: Mesh, *, axis: str = "data",
                         block: int = 128) -> jax.Array:
    """Lower Cholesky factor of a global SPD [M, M] matrix, computed with
    the rows sharded in contiguous blocks over ``axis``.  Returns the
    factor with the same row sharding."""
    _check(A.shape[-1], mesh, axis, block)
    f = shard_map(partial(_chol_local, axis=axis, block=block), mesh=mesh,
                  in_specs=P(axis, None), out_specs=P(axis, None))
    return f(A)


def distributed_solve_lower(L: jax.Array, B: jax.Array, mesh: Mesh, *,
                            axis: str = "data", block: int = 128) -> jax.Array:
    """Solve L X = B for lower-triangular row-sharded L and row-sharded B."""
    _check(L.shape[-1], mesh, axis, block)
    f = shard_map(partial(_solve_lower_local, axis=axis, block=block),
                  mesh=mesh,
                  in_specs=(P(axis, None), P(axis, None)),
                  out_specs=P(axis, None))
    return f(L, B)
