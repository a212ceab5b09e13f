"""Inducing-point (large-M) sharded training path (parallel/inducing.py).

The north-star capability (BASELINE.md: M=4096 sharded over the mesh): the
O(M^3) Cholesky/TRSM chain and the O(M^2 N K) q_sqrt quadratic run
distributed via shard_map, and the result is algebraically identical to the
replicated single-device model.  All tests run on the 8-virtual-device CPU
mesh in float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from modulatedgps_tpu.ops.kernels import SquaredExponential
from modulatedgps_tpu.likelihoods import Gaussian
from modulatedgps_tpu.models import SVGP, SMGP
from modulatedgps_tpu.parallel import (make_mesh, shard_batch,
                                       make_parallel_train_step,
                                       inducing_sharded_elbo,
                                       inducing_sharded_predict_f,
                                       inducing_shard_state)
from modulatedgps_tpu.parallel.inducing import (
    make_inducing_sharded_train_step, inducing_specs)


def _model(rng, M, K=3, D=2, N=32, randomize=True):
    lik = Gaussian.create(0.5, D=K)
    pred = SVGP.create(SquaredExponential.create(0.5, 0.5),
                       rng.normal(size=(M, D)), num_latent_gps=K)
    assign = SVGP.create(SquaredExponential.create(0.1, 1.0),
                         rng.normal(size=(M, D)), num_latent_gps=K)
    if randomize:
        # Non-trivial variational state so every term is exercised.
        def rnd(layer, seed):
            k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
            q_mu = 0.3 * jax.random.normal(k1, (M, K))
            q_sqrt = (jnp.tril(0.1 * jax.random.normal(k2, (K, M, M)))
                      + jnp.eye(M) * 0.8)
            return layer.replace(q_mu=layer.q_mu.replace_raw(q_mu),
                                 q_sqrt=layer.q_sqrt.replace_raw(q_sqrt))
        pred, assign = rnd(pred, 1), rnd(assign, 2)
    model = SMGP(likelihood=lik, pred_layer=pred, assign_layer=assign,
                 K=K, num_samples=5, num_data=N)
    X = jnp.asarray(rng.uniform(-3, 3, size=(N, D)))
    Y = jnp.asarray(rng.normal(size=(N, 1)))
    return model, X, Y


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(num_data=8, num_expert=1)


class TestParity:
    def test_elbo_matches_replicated(self, rng, mesh):
        model, X, Y = _model(rng, M=64)
        key = jax.random.PRNGKey(0)
        e_ref = float(model.elbo(key, X, Y))
        e_sh = float(jax.jit(
            lambda m, k, x, y: inducing_sharded_elbo(m, k, x, y, mesh))(
            model, key, X, Y))
        np.testing.assert_allclose(e_sh, e_ref, rtol=1e-12)

    def test_elbo_matches_replicated_M2048(self, rng, mesh):
        """The VERDICT north-star scale: M=2048 sharded 256 rows/device."""
        model, X, Y = _model(rng, M=2048, N=64, randomize=False)
        key = jax.random.PRNGKey(0)
        e_ref = float(jax.jit(lambda m, k, x, y: m.elbo(k, x, y))(
            model, key, X, Y))
        e_sh = float(jax.jit(
            lambda m, k, x, y: inducing_sharded_elbo(m, k, x, y, mesh))(
            model, key, X, Y))
        np.testing.assert_allclose(e_sh, e_ref, rtol=1e-10)

    def test_predict_f_matches_layer(self, rng, mesh):
        model, X, _ = _model(rng, M=64, N=40)
        mu_r, var_r = model.pred_layer.predict_f(X)
        mu_s, var_s = inducing_sharded_predict_f(model.pred_layer, X, mesh)
        np.testing.assert_allclose(np.asarray(mu_s), np.asarray(mu_r),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(np.asarray(var_s), np.asarray(var_r),
                                   rtol=1e-10, atol=1e-12)

    def test_grad_matches_replicated(self, rng, mesh):
        model, X, Y = _model(rng, M=64)
        key = jax.random.PRNGKey(0)
        g_ref = jax.jit(jax.grad(lambda m: m.elbo(key, X, Y)))(model)
        g_sh = jax.jit(jax.grad(
            lambda m: inducing_sharded_elbo(m, key, X, Y, mesh)))(model)
        for a, b in zip(jax.tree_util.tree_leaves(g_ref),
                        jax.tree_util.tree_leaves(g_sh)):
            np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                       rtol=1e-8, atol=1e-10)


class TestTraining:
    def test_training_trajectory_matches_replicated(self, rng, mesh):
        """5 Adam steps at M=512: the sharded step (distributed chol/TRSM,
        sharded Adam moments) reproduces the replicated trajectory."""
        from modulatedgps_tpu.training import make_train_step
        model, X, Y = _model(rng, M=512, N=64, randomize=False)
        opt = optax.adam(1e-2)

        init_r, step_r = make_train_step(opt)
        step_r = jax.jit(step_r)
        state_r = init_r(model, jax.random.PRNGKey(0))

        init_s, step_s = make_inducing_sharded_train_step(opt, mesh,
                                                          donate=False)
        state_s = init_s(model, jax.random.PRNGKey(0))
        Xs, Ys = shard_batch(mesh, X, Y)

        losses_r, losses_s = [], []
        for _ in range(5):
            state_r, lr_ = step_r(state_r, X, Y)
            state_s, ls_ = step_s(state_s, Xs, Ys)
            losses_r.append(float(lr_))
            losses_s.append(float(ls_))
        np.testing.assert_allclose(losses_s, losses_r, rtol=1e-9)
        # Convergence: continue on the (verified-identical) replicated step,
        # which is cheap, and check the loss trends down past the MC noise.
        for _ in range(40):
            state_r, lr_ = step_r(state_r, X, Y)
            losses_r.append(float(lr_))
        assert np.mean(losses_r[-5:]) < np.mean(losses_r[:5])

    def test_make_parallel_train_step_routing(self, rng, mesh):
        """shard_inducing=True routes to the distributed path and the state
        placement is really sharded (q_sqrt columns, q_mu/Z rows)."""
        model, X, Y = _model(rng, M=64, randomize=False)
        init_fn, step_fn = make_parallel_train_step(
            optax.adam(1e-2), mesh, K=3, shard_inducing=True, donate=False)
        state = init_fn(model, jax.random.PRNGKey(0))
        from jax.sharding import NamedSharding, PartitionSpec as P
        q_sqrt = state.model.pred_layer.q_sqrt.raw
        assert q_sqrt.sharding.spec == P(None, None, "data")
        assert state.model.pred_layer.q_mu.raw.sharding.spec == P("data", None)
        # Adam moments mirror the placement (paths match by field name).
        mu_tree = state.opt_state[0].mu
        assert mu_tree.pred_layer.q_sqrt.raw.sharding.spec == \
            P(None, None, "data")
        Xs, Ys = shard_batch(mesh, X, Y)
        state2, loss = step_fn(state, Xs, Ys)
        assert np.isfinite(float(loss))
        # Placement preserved through the step.
        assert state2.model.pred_layer.q_sqrt.raw.sharding.spec == \
            P(None, None, "data")

    def test_shard_experts_and_inducing_conflict(self, mesh):
        with pytest.raises(ValueError, match="pick one"):
            make_parallel_train_step(optax.adam(1e-2), mesh, K=3,
                                     shard_experts=True, shard_inducing=True)

    def test_whiten_false_not_supported(self, rng, mesh):
        model, X, Y = _model(rng, M=64, randomize=False)
        model = model.replace(
            pred_layer=model.pred_layer.replace(whiten=False))
        with pytest.raises(NotImplementedError, match="whiten"):
            inducing_sharded_elbo(model, jax.random.PRNGKey(0), X, Y, mesh)


def _collective_shapes(hlo_text):
    """Multiset of (op, result-shape) for every collective in compiled HLO."""
    import re
    out = []
    for line in hlo_text.splitlines():
        m = re.search(
            r"=\s*((?:\([^)]*\))|(?:\S+))\s+"
            r"(all-gather|all-reduce|reduce-scatter|collective-permute"
            r"|all-to-all)\(", line)
        if m:
            shape = m.group(1).split("{")[0]
            out.append((m.group(2), shape))
    return sorted(out)


class TestCollectiveAudit:
    """Round-4 restructure pin: the inducing-sharded train step's collective
    payload must not be a function of N (round 3 all-gathered the [M, N]
    A-panel every step — the exact weak-scaling pathology diagnosed for the
    data-parallel path in round 2)."""

    def _lowered_collectives(self, rng, mesh, N):
        model, X, Y = _model(rng, M=64, N=N, randomize=False)
        init_fn, step_fn = make_inducing_sharded_train_step(
            optax.adam(1e-2), mesh, donate=False)
        state = init_fn(model, jax.random.PRNGKey(0))
        Xs, Ys = shard_batch(mesh, X, Y)
        hlo = step_fn.lower(state, Xs, Ys).compile().as_text()
        return _collective_shapes(hlo)

    def test_payload_independent_of_N(self, rng, mesh):
        # N per device: 16 vs 128 — any N-shaped collective would change
        # its result shape between the two compiles.
        c_small = self._lowered_collectives(rng, mesh, N=128)
        c_large = self._lowered_collectives(rng, mesh, N=1024)
        assert c_small == c_large, (
            "collective payload changed with N:\n"
            f"N=128:  {c_small}\nN=1024: {c_large}")

    def test_no_full_A_panel_gather(self, rng, mesh):
        """No collective result holds an [*, N_local*P]-shaped operand: the
        A panel stays batch-column sharded; the Lq ring moves [K, M, M/P]
        blocks via collective-permute."""
        colls = self._lowered_collectives(rng, mesh, N=1024)
        assert any(op == "collective-permute" for op, _ in colls), colls
        for op, shape in colls:
            assert "1024" not in shape and "128," not in shape, (op, shape)


def test_inducing_specs_shapes(rng):
    model, _, _ = _model(rng, M=64, randomize=False)
    from jax.sharding import PartitionSpec as P
    specs = inducing_specs(model, "data")
    assert specs.pred_layer.q_sqrt.raw == P(None, None, "data")
    assert specs.pred_layer.Z.raw == P("data", None)
    assert specs.likelihood.variance.raw == P()


def test_inducing_audit_n_independent():
    """The committed HLO audit (benchmarks/inducing_audit.py) records
    collective payloads independent of N: the Lq ppermute ring, no
    all-to-all."""
    import glob
    import json
    import os
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = sorted(glob.glob(os.path.join(repo, "INDUCING_AUDIT_r*.json")))
    assert paths, "no INDUCING_AUDIT_r*.json artifact committed"
    with open(paths[-1]) as f:
        d = json.load(f)
    assert d["payload_independent_of_N"] is True
    ops = {r["op"] for t in d["collectives"].values() for r in t}
    assert "collective-permute" in ops   # the Lq ring
    assert "all-to-all" not in ops
