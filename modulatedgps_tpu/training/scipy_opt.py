"""Scipy-driven full-batch optimization (L-BFGS-B by default).

Parity with ``gpflow.optimizers.Scipy`` as used by the reference's sanity
demos (reference demos/from_online/demo_SVGP.py:20-21 and
demo_SVGP_bernoulli.py:20-32: ``opt.minimize(model.training_loss_closure(),
model.trainable_variables, options=dict(maxiter=...))``).

The model pytree's trainable leaves (Parameter.trainable=True, in raw /
unconstrained space) are packed into one float64 vector for scipy; the
objective and its gradient are a single jitted JAX value_and_grad call, so
every scipy line-search evaluation is one XLA dispatch.  Frozen leaves
(set_trainable(..., False) analog) are held constant outside the vector.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..params import trainable_mask

__all__ = ["run_scipy"]


def _is_float(leaf) -> bool:
    return jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating)


def run_scipy(model, loss_fn: Callable | None = None, *, data: tuple = (),
              maxiter: int = 1000, method: str = "L-BFGS-B",
              verbose: bool = False, options=None):
    """Minimize ``loss_fn(model, *data)`` over the trainable leaves with scipy.

    loss_fn defaults to ``lambda m: m.training_loss()`` (internal-data
    models such as VGP).  ``data`` arrays are threaded through the jitted
    objective as ARGUMENTS — never close the loss over device arrays (XLA
    would bake them into the program as constants).  Returns ``(optimized_model, scipy_result)``.
    """
    from scipy.optimize import minimize

    if loss_fn is None:
        loss_fn = lambda m: m.training_loss()
    data = tuple(jnp.asarray(d) for d in data)

    leaves, treedef = jax.tree_util.tree_flatten(model)
    mask = jax.tree_util.tree_flatten(trainable_mask(model))[0]
    train_idx = [i for i, (leaf, m) in enumerate(zip(leaves, mask))
                 if m and _is_float(leaf)]
    if not train_idx:
        raise ValueError("model has no trainable floating-point leaves")
    frozen_idx = [i for i in range(len(leaves)) if i not in set(train_idx)]
    # Frozen leaves (incl. data arrays on internal-data models like VGP) are
    # passed as jit ARGUMENTS, never closed over (XLA would bake them into
    # the program as constants).
    frozen_vals = tuple(leaves[i] for i in frozen_idx)
    shapes = [leaves[i].shape for i in train_idx]
    dtypes = [leaves[i].dtype for i in train_idx]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    offsets = np.cumsum([0] + sizes)

    def assemble(vec, frozen):
        new_leaves = [None] * len(leaves)
        for j, i in enumerate(train_idx):
            seg = vec[int(offsets[j]):int(offsets[j + 1])]
            new_leaves[i] = seg.reshape(shapes[j]).astype(dtypes[j])
        for j, i in enumerate(frozen_idx):
            new_leaves[i] = frozen[j]
        return jax.tree_util.tree_unflatten(treedef, new_leaves)

    @jax.jit
    def value_and_grad(vec, frozen, data):
        return jax.value_and_grad(
            lambda v: loss_fn(assemble(v, frozen), *data))(vec)

    x0 = np.concatenate([np.asarray(leaves[i], np.float64).ravel()
                         for i in train_idx])
    vec_dtype = jnp.zeros(0).dtype if all(d == jnp.float32 for d in dtypes) \
        else jnp.float64

    evals = {"n": 0}

    def fun(x):
        v, g = value_and_grad(jnp.asarray(x, vec_dtype), frozen_vals, data)
        evals["n"] += 1
        if verbose and evals["n"] % 20 == 0:
            print(f"  scipy eval {evals['n']}: loss={float(v):.6f}")
        return float(v), np.asarray(g, np.float64)

    result = minimize(fun, x0, jac=True, method=method,
                      options={"maxiter": maxiter, **(options or {})})
    if verbose:
        print(f"scipy {method}: {result.message} "
              f"(nit={result.nit}, loss={result.fun:.6f})")
    opt_model = assemble(jnp.asarray(result.x, vec_dtype), frozen_vals)
    return opt_model, result
