"""Device mesh + sharding placement (SURVEY.md §2.4, §5.8).

The reference has no distributed layer at all (single-process TF).  Here the
NCCL-equivalent is GSPMD over a ``jax.sharding.Mesh``:

  axes: ('data', 'expert')
   - 'data'   : shards the minibatch N — ELBO terms and gradients are
                all-reduced by XLA-inserted psums (NCCL on GPUs);
   - 'expert' : shards the K mixture components — q_mu [M, K] on its K
                axis, q_sqrt [K, M, M] on its leading axis, per-expert
                likelihood variance (1, K) — the GP analog of expert/tensor
                parallelism.  Kernel hyperparameters and Z stay replicated
                (tiny).

K in the reference demos is 2..4, which rarely divides a mesh: when
K % expert_size != 0 the expert placement degrades gracefully to
replication (SURVEY.md §7.3 "degenerate-K sharding").
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..params import Parameter

__all__ = ["make_mesh", "shard_batch", "replicate_state", "expert_shard_state"]


def make_mesh(num_data: int | None = None, num_expert: int = 1,
              devices=None) -> Mesh:
    """Mesh(('data','expert')).  Defaults: all devices on 'data'."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if num_data is None:
        num_data = n // num_expert
    if num_data * num_expert != n:
        raise ValueError(f"mesh {num_data}x{num_expert} != {n} devices")
    arr = np.asarray(devices).reshape(num_data, num_expert)
    return Mesh(arr, ("data", "expert"))


def shard_batch(mesh: Mesh, *arrays):
    """Place host arrays with the batch dim sharded over 'data'."""
    sh = NamedSharding(mesh, P("data"))
    out = tuple(jax.device_put(jax.numpy.asarray(a), sh) for a in arrays)
    return out if len(out) > 1 else out[0]


def replicate_state(mesh: Mesh, state):
    """Fully replicate a pytree (model or TrainState) over the mesh."""
    sh = NamedSharding(mesh, P())
    return jax.device_put(state, sh)


def _expert_spec_for(path: tuple, leaf) -> P | None:
    """PartitionSpec for an expert-shardable leaf, else None (replicate).

    Recognized (by array meaning, not by name):
      q_mu        [M, K]    -> P(None, 'expert')
      q_sqrt tril [K, M, M] -> P('expert', None, None)
      q_sqrt diag [M, K]    -> P(None, 'expert')
      likelihood variance (1, K) -> P(None, 'expert')
    """
    names = [getattr(p, "name", None) for p in path]
    if "q_mu" in names and leaf.ndim == 2:
        return P(None, "expert")
    if "q_sqrt" in names:
        if leaf.ndim == 3:
            return P("expert", None, None)
        if leaf.ndim == 2:
            return P(None, "expert")
    if "variance" in names and "likelihood" in names and leaf.ndim == 2:
        return P(None, "expert")
    return None


def expert_shard_state(mesh: Mesh, state, K: int):
    """Place a pytree with per-expert tensors sharded over 'expert'.

    Falls back to full replication when K doesn't divide the expert axis.
    """
    esize = mesh.shape["expert"]
    if esize == 1 or K % esize != 0:
        return replicate_state(mesh, state)

    repl = NamedSharding(mesh, P())

    def place(path, leaf):
        if not hasattr(leaf, "ndim"):
            return leaf
        spec = _expert_spec_for(path, leaf)
        sh = NamedSharding(mesh, spec) if spec is not None else repl
        return jax.device_put(leaf, sh)

    return jax.tree_util.tree_map_with_path(place, state)
