"""Subprocess worker for the real multi-process multihost test.

Launched by tests/test_multihost.py as one of two OS processes, each with 4
virtual CPU devices, forming a 2-process x 4-device (8 global devices)
jax.distributed job.  Exercises the production bootstrap path
(parallel.multihost.initialize_multihost -> jax.distributed.initialize), the
global ('data','expert') mesh, a cross-process psum, and the checkpoint
guard for non-addressable arrays (training/checkpoint.py:22-26).

reference: N/A — the reference has no distributed layer (SURVEY.md §2.4);
this validates the §5.8 subsystem this build adds.

Protocol: argv = [process_id, num_processes, coordinator_address, outdir].
Writes <outdir>/ok_<pid>.json on success; any exception exits non-zero.
"""
import json
import os
import sys

# Local CPU backend, 4 virtual devices — must precede jax import.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def main() -> None:
    process_id = int(sys.argv[1])
    num_processes = int(sys.argv[2])
    coordinator_address = sys.argv[3]
    outdir = sys.argv[4]

    from modulatedgps_tpu.parallel.multihost import (
        initialize_multihost, global_mesh, is_coordinator)

    # The production bootstrap: must run before ANY backend touch.
    initialize_multihost(coordinator_address=coordinator_address,
                         num_processes=num_processes, process_id=process_id)

    assert jax.process_count() == num_processes, jax.process_count()
    assert jax.process_index() == process_id, jax.process_index()
    assert len(jax.devices()) == 4 * num_processes, len(jax.devices())
    assert len(jax.local_devices()) == 4, len(jax.local_devices())
    assert is_coordinator() == (process_id == 0)

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = global_mesh(num_expert=2)
    assert mesh.shape["data"] == 4 and mesh.shape["expert"] == 2

    # Cross-process collective: a global array sharded over 'data' spans both
    # processes; the jitted global sum forces an XLA all-reduce across them.
    n_global = 32
    x_full = np.arange(n_global, dtype=np.float64)
    sh = NamedSharding(mesh, P("data"))
    x = jax.make_array_from_callback(
        (n_global,), sh, lambda idx: x_full[idx])
    assert not x.is_fully_addressable
    total = jax.jit(lambda a: jax.numpy.sum(a),
                    out_shardings=NamedSharding(mesh, P()))(x)
    np.testing.assert_allclose(np.asarray(total), x_full.sum())

    # Checkpoint guard: saving a non-addressable leaf must raise with the
    # gather-first guidance, on every process.
    from modulatedgps_tpu.training.checkpoint import (
        save_checkpoint, restore_checkpoint)
    ckpt = os.path.join(outdir, "state.npz")
    try:
        save_checkpoint(ckpt, {"x": x})
    except ValueError as e:
        assert "gather first" in str(e)
    else:
        raise AssertionError("save_checkpoint accepted a non-addressable leaf")

    # The documented workflow: process_allgather, save from the coordinator.
    from jax.experimental import multihost_utils
    gathered = multihost_utils.process_allgather(x, tiled=True)
    np.testing.assert_allclose(np.asarray(gathered), x_full)
    if is_coordinator():
        save_checkpoint(ckpt, {"x": gathered})
    multihost_utils.sync_global_devices("ckpt_saved")
    restored = restore_checkpoint(ckpt, {"x": np.zeros_like(x_full)})
    np.testing.assert_allclose(restored["x"], x_full)

    with open(os.path.join(outdir, f"ok_{process_id}.json"), "w") as f:
        json.dump({"process_id": process_id,
                   "devices": len(jax.devices()),
                   "total": float(np.asarray(total))}, f)


if __name__ == "__main__":
    main()
