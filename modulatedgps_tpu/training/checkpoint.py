"""Checkpoint / resume (SURVEY.md §5.4 — absent in the reference, required
for preemption-safe training).

All state is an explicit pytree (model params + Adam moments + step + RNG
key), so a checkpoint is just its flattened leaves.  Stored as .npz — no
extra deps, readable anywhere; structure is re-derived from a template
pytree at restore time.
"""
from __future__ import annotations

import os

import jax
import numpy as np

__all__ = ["save_checkpoint", "restore_checkpoint"]


def save_checkpoint(path: str, state) -> None:
    leaves, _ = jax.tree_util.tree_flatten(state)
    for x in leaves:
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            raise ValueError(
                "save_checkpoint: leaf spans multiple hosts; gather first "
                "(jax.experimental.multihost_utils.process_allgather) and "
                "save from the coordinator (parallel.multihost.is_coordinator)")
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: a preempted save never corrupts the file


def restore_checkpoint(path: str, template):
    """Restore into the structure of ``template`` (same model/optimizer)."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    with np.load(path) as data:
        if len(data.files) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(data.files)} leaves, template has {len(leaves)}")
        new_leaves = []
        for i, old in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if isinstance(old, jax.Array):
                # Re-place with the template's sharding so a mesh-placed
                # TrainState restores sharded, not on the default device.
                new = jax.device_put(jax.numpy.asarray(arr, dtype=old.dtype),
                                     old.sharding)
            elif hasattr(old, "dtype"):
                new = jax.numpy.asarray(arr, dtype=old.dtype)
            else:
                new = arr
            new_leaves.append(new)
    return jax.tree_util.tree_unflatten(treedef, new_leaves)
