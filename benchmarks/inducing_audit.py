"""HLO collective-payload audit of the inducing-sharded train step.

Round-3 verdict item: parallel/inducing.py all-gathered the full [M, N]
A-panel every step (M=4096 x N=16384 f32 = 268 MB per layer, forward and
re-gathered in the backward) — the same O(N) collective pathology the
round-2 data-parallel audit fixed for the replicated
path.  Round 4 restructured the conditional (see parallel/inducing.py
module docstring): A stays batch-column sharded (local full-M TRSM per
device, zero comms) and the q_sqrt quadratic rotates the column-sharded
Lq blocks around a ppermute ring, so every collective payload is a
function of (M, K, D, P) only.

This harness compiles the full train step on the 8-virtual-device CPU
mesh at two N values, tabulates every collective with its payload bytes,
and verifies (a) the collective multiset is identical across N — payload
independent of N — and (b) the per-step payload matches the
by-construction accounting.  Pinned by
tests/test_inducing_sharded.py::TestCollectiveAudit.

Usage:  python benchmarks/inducing_audit.py [--M 1024] [--out FILE]
Emits one JSON line on stdout; diagnostics on stderr.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys


def log(*a):
    print(*a, file=sys.stderr, flush=True)


_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "s64": 8, "u64": 8, "pred": 1, "u8": 1, "s8": 1}


def _shape_bytes(shape: str) -> int:
    """Total bytes of an HLO shape string like 'f64[8,64,8]' or a tuple."""
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape):
        dt, dims = m.group(1), m.group(2)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def collective_table(hlo_text: str):
    rows = collections.Counter()
    for line in hlo_text.splitlines():
        m = re.search(
            r"=\s*((?:\([^)]*\))|(?:\S+))\s+"
            r"(all-gather|all-reduce|reduce-scatter|collective-permute"
            r"|all-to-all)\(", line)
        if m:
            shape = m.group(1).split("{")[0]
            rows[(m.group(2), shape)] += 1
    return [{"op": op, "shape": shp, "count": c,
             "bytes_each": _shape_bytes(shp),
             "bytes_total": c * _shape_bytes(shp)}
            for (op, shp), c in sorted(rows.items())]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--M", type=int, default=1024)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--D", type=int, default=4)
    p.add_argument("--Ns", type=int, nargs=2, default=[512, 4096])
    p.add_argument("--out", default=None)
    args = p.parse_args()

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import optax

    from modulatedgps_tpu.ops.kernels import SquaredExponential
    from modulatedgps_tpu.likelihoods import Gaussian
    from modulatedgps_tpu.models import SVGP, SMGP
    from modulatedgps_tpu.parallel import (make_mesh, shard_batch)
    from modulatedgps_tpu.parallel.inducing import (
        make_inducing_sharded_train_step)

    mesh = make_mesh(num_data=8, num_expert=1)
    Pdev = 8
    M, K, D = args.M, args.K, args.D
    rng = np.random.default_rng(0)

    def build(N):
        lik = Gaussian.create(0.5, D=K)
        pred = SVGP.create(SquaredExponential.create(0.5, 0.5),
                           rng.normal(size=(M, D)), num_latent_gps=K)
        assign = SVGP.create(SquaredExponential.create(0.1, 1.0),
                             rng.normal(size=(M, D)), num_latent_gps=K)
        model = SMGP(likelihood=lik, pred_layer=pred, assign_layer=assign,
                     K=K, num_samples=4, num_data=N)
        X = jnp.asarray(rng.uniform(-3, 3, size=(N, D)))
        Y = jnp.asarray(rng.normal(size=(N, 1)))
        return model, X, Y

    tables = {}
    for N in args.Ns:
        model, X, Y = build(N)
        init_fn, step_fn = make_inducing_sharded_train_step(
            optax.adam(1e-2), mesh, donate=False)
        state = init_fn(model, jax.random.PRNGKey(0))
        Xs, Ys = shard_batch(mesh, X, Y)
        log(f"lowering N={N} ...")
        hlo = step_fn.lower(state, Xs, Ys).compile().as_text()
        tables[str(N)] = collective_table(hlo)
        # sanity: the step actually runs
        state, loss = step_fn(state, Xs, Ys)
        assert np.isfinite(float(loss))

    sig = {n: sorted((r["op"], r["shape"], r["count"]) for r in t)
           for n, t in tables.items()}
    n_small, n_large = map(str, args.Ns)
    independent = sig[n_small] == sig[n_large]
    total_bytes = sum(r["bytes_total"] for r in tables[n_large])

    # By-construction accounting (per layer, fp64 on this audit mesh):
    # fwd: ag Z [M,D] + ag L [M,M] + ag q_mu [M,K] + ring (P-1) x [K,M,M/P]
    # chol internals: per panel psum [B,B] + ag [M,B] (M/B panels)
    # bwd: transposes of the above (reduce-scatter / reversed ring).
    itemsize = 8
    per_layer_fwd = itemsize * (M * D + M * M + M * K
                                + (Pdev - 1) * K * M * (M // Pdev))
    expected_dominant = 2 * 2 * per_layer_fwd  # 2 layers x (fwd + bwd)

    out = {
        "metric": "inducing_collective_audit",
        "config": {"M": M, "K": K, "D": D, "Ns": args.Ns, "mesh": Pdev,
                   "dtype": "f64", "backend": "cpu-simulated"},
        "payload_independent_of_N": independent,
        "collectives": tables,
        "total_collective_bytes_at_N_large": total_bytes,
        "by_construction_dominant_bytes": expected_dominant,
        "note": ("all payloads are functions of (M, K, D, P) only; the "
                 "round-3 [M, N] A-panel all-gather is gone — A is "
                 "batch-column sharded, the q_sqrt quadratic rotates Lq "
                 "blocks (K*M^2*(P-1)/P per layer per direction)"),
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
