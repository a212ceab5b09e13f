"""Training-infrastructure tests: checkpoints, loader, metrics, evaluation."""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from modulatedgps_tpu.data import minibatch_iterator
from modulatedgps_tpu.training import (make_train_step, save_checkpoint,
                                       restore_checkpoint)
from modulatedgps_tpu.utils.metrics import MetricsLogger
from modulatedgps_tpu.ops.kernels import SquaredExponential
from modulatedgps_tpu.likelihoods import Gaussian
from modulatedgps_tpu.models import SVGP, SMGP


def _model(rng, K=2, M=8, N=30):
    lik = Gaussian.create(0.5, D=K)
    mk = lambda: SVGP.create(SquaredExponential.create(0.5, 0.5),
                             rng.normal(size=(M, 1)), num_latent_gps=K)
    model = SMGP(likelihood=lik, pred_layer=mk(), assign_layer=mk(),
                 K=K, num_samples=3, num_data=N)
    X = jnp.asarray(rng.uniform(-3, 3, size=(N, 1)))
    Y = jnp.asarray(rng.normal(size=(N, 1)))
    return model, X, Y


def test_minibatch_iterator_full_shuffle_per_epoch(rng):
    X = np.arange(10)[:, None].astype(float)
    Y = X.copy()
    it = minibatch_iterator(X, Y, batch_size=5, seed=3)
    epoch1 = np.concatenate([next(it)[0] for _ in range(2)]).ravel()
    epoch2 = np.concatenate([next(it)[0] for _ in range(2)]).ravel()
    # each epoch covers all points exactly once
    np.testing.assert_array_equal(np.sort(epoch1), np.arange(10))
    np.testing.assert_array_equal(np.sort(epoch2), np.arange(10))
    assert not np.array_equal(epoch1, epoch2)  # reshuffled


def test_minibatch_iterator_deterministic_same_seed():
    X = np.arange(20)[:, None].astype(float)
    it1 = minibatch_iterator(X, X, 8, seed=7)
    it2 = minibatch_iterator(X, X, 8, seed=7)
    for _ in range(5):
        a, _ = next(it1)
        b, _ = next(it2)
        np.testing.assert_array_equal(a, b)


def test_minibatch_drops_ragged_tail():
    X = np.arange(10)[:, None].astype(float)
    it = minibatch_iterator(X, X, 4, seed=0)
    for _ in range(6):
        xb, yb = next(it)
        assert xb.shape == (4, 1)  # never a ragged 2-row batch


def test_checkpoint_roundtrip_trainstate(rng, tmp_path):
    model, X, Y = _model(rng)
    init_fn, step_fn = make_train_step(optax.adam(1e-2))
    state = init_fn(model, jax.random.PRNGKey(0))
    state, _ = jax.jit(step_fn)(state, X, Y)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state)
    state2 = restore_checkpoint(path, state)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(state2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # training continues identically from the restored state
    s1, l1 = jax.jit(step_fn)(state, X, Y)
    s2, l2 = jax.jit(step_fn)(state2, X, Y)
    np.testing.assert_allclose(float(l1), float(l2), rtol=0)


def test_checkpoint_resume_after_interrupt(rng, tmp_path):
    """Simulated preemption: save mid-training, restore, final states match
    an uninterrupted run (SURVEY §5.3/§5.4 semantics)."""
    model, X, Y = _model(rng)
    init_fn, step_fn = make_train_step(optax.adam(1e-2))
    jstep = jax.jit(step_fn)
    # uninterrupted: 6 steps
    s = init_fn(model, jax.random.PRNGKey(0))
    for _ in range(6):
        s, _ = jstep(s, X, Y)
    # interrupted at 3
    s2 = init_fn(model, jax.random.PRNGKey(0))
    for _ in range(3):
        s2, _ = jstep(s2, X, Y)
    path = str(tmp_path / "mid.npz")
    save_checkpoint(path, s2)
    s3 = restore_checkpoint(path, init_fn(model, jax.random.PRNGKey(0)))
    for _ in range(3):
        s3, _ = jstep(s3, X, Y)
    for a, b in zip(jax.tree_util.tree_leaves(s.model),
                    jax.tree_util.tree_leaves(s3.model)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12, atol=1e-15)


def test_metrics_logger_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    ml = MetricsLogger(path, verbose=False)
    ml.log(5, elbo=-1.5)
    ml.log(10, elbo=-1.2, extra=3)
    ml.close()
    recs = [json.loads(l) for l in open(path)]
    assert recs[0]["step"] == 5 and recs[0]["elbo"] == -1.5
    assert recs[1]["extra"] == 3
    assert "steps_per_sec" in recs[1]


def test_evaluation_metrics(rng):
    from modulatedgps_tpu.utils.evaluation import (mixture_rmse, mixture_nlpd,
                                                   assignment_accuracy)
    model, X, Y = _model(rng)
    rmse = mixture_rmse(model, X, Y)
    nlpd = mixture_nlpd(model, X, Y)
    assert np.isfinite(rmse) and np.isfinite(nlpd)
    labels = np.zeros(X.shape[0], dtype=int)
    acc = assignment_accuracy(model, X, labels)
    assert 0.0 <= acc <= 1.0


def test_predict_density_matches_manual(rng):
    model, X, Y = _model(rng)
    ld = np.asarray(model.predict_density(X, Y))
    pi = np.asarray(model.predict_assign(X))
    Fmu, Fvar = model.pred_layer.predict_f(X)
    mean, var = model.likelihood.predict_mean_and_var(Fmu, Fvar)
    mean, var = np.asarray(mean), np.asarray(var)
    from scipy.stats import norm
    pk = norm.pdf(np.asarray(Y), loc=mean, scale=np.sqrt(var))
    want = np.log((pi * pk).sum(-1) + 0.0)
    np.testing.assert_allclose(ld, want, rtol=1e-6)


def test_checkpoint_restores_mesh_sharding(rng, tmp_path):
    """A mesh-placed TrainState must come back with the template's sharding
    (not gathered onto the default device)."""
    import optax
    from modulatedgps_tpu.parallel import make_mesh, make_parallel_train_step
    from modulatedgps_tpu.training import save_checkpoint, restore_checkpoint

    mesh = make_mesh(num_data=4, num_expert=2)
    model, X, Y = _model(rng)
    init_fn, step_fn = make_parallel_train_step(
        optax.adam(1e-2), mesh, K=model.K, shard_experts=True)
    state = init_fn(model, jax.random.PRNGKey(0))
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, state)
    restored = restore_checkpoint(path, state)
    for a, b in zip(jax.tree_util.tree_leaves(state),
                    jax.tree_util.tree_leaves(restored)):
        assert a.sharding == b.sharding, (a.sharding, b.sharding)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_run_adam_periodic_checkpoint_and_resume(rng, tmp_path):
    """run_adam(checkpoint_every=N, resume=True) reproduces an
    uninterrupted run exactly (given a fast-forwarded data iterator)."""
    from modulatedgps_tpu.training import run_adam

    model, X, Y = _model(rng)
    path = str(tmp_path / "state.npz")

    def batches():
        while True:
            yield X, Y

    m_full, _, _ = run_adam(model, 6, batches(), 1e-2,
                            key=jax.random.PRNGKey(0), verbose=False)
    # preempted at 3 (checkpoint saved), then resumed to 6
    run_adam(model, 3, batches(), 1e-2, key=jax.random.PRNGKey(0),
             verbose=False, checkpoint_path=path, checkpoint_every=3)
    m_res, iters, _ = run_adam(model, 6, batches(), 1e-2,
                               key=jax.random.PRNGKey(0), verbose=False,
                               checkpoint_path=path, checkpoint_every=3,
                               resume=True)
    assert iters and iters[0] > 3   # continued, not restarted
    for a, b in zip(jax.tree_util.tree_leaves(m_full),
                    jax.tree_util.tree_leaves(m_res)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-12, atol=1e-15)


def test_run_adam_final_checkpoint_not_stale(rng, tmp_path):
    """With num_iter not a multiple of checkpoint_every, the checkpoint file
    must still hold the FINAL TrainState (ADVICE r1: the last N-1 steps were
    silently unpersisted), and a completed run must resume as a no-op instead
    of crashing."""
    from modulatedgps_tpu.training import run_adam
    from modulatedgps_tpu.training.checkpoint import restore_checkpoint
    from modulatedgps_tpu.training.loop import make_train_step
    import optax

    model, X, Y = _model(rng)
    path = str(tmp_path / "state.npz")

    def batches():
        while True:
            yield X, Y

    # 7 steps, checkpoint_every=3: final save must happen at step 7.
    m7, _, _ = run_adam(model, 7, batches(), 1e-2, key=jax.random.PRNGKey(0),
                        verbose=False, checkpoint_path=path, checkpoint_every=3)
    init_fn, _ = make_train_step(optax.adam(1e-2))
    template = init_fn(model, jax.random.PRNGKey(0))
    saved = restore_checkpoint(path, template)
    assert int(saved.step) == 7
    for a, b in zip(jax.tree_util.tree_leaves(m7),
                    jax.tree_util.tree_leaves(saved.model)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # Rerun of the completed run: resumes at 7 >= num_iter, runs 0 steps,
    # returns empty history without error and leaves the checkpoint intact.
    m_again, iters, elbos = run_adam(model, 7, batches(), 1e-2,
                                     key=jax.random.PRNGKey(0), verbose=False,
                                     checkpoint_path=path, checkpoint_every=3,
                                     resume=True)
    assert iters == [] and elbos == []
    for a, b in zip(jax.tree_util.tree_leaves(m7),
                    jax.tree_util.tree_leaves(m_again)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_run_adam_warns_checkpoint_every_without_path(rng):
    import warnings
    from modulatedgps_tpu.training import run_adam
    model, X, Y = _model(rng)

    def batches():
        while True:
            yield X, Y

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        run_adam(model, 2, batches(), 1e-2, verbose=False, checkpoint_every=5)
    assert any("checkpoint_every" in str(x.message) for x in w)


def test_run_adam_multistart_selects_and_continues(rng):
    """Multi-start (r5 jitter-basin mitigation): trains num_starts probe
    replicas, picks the best probe ELBO, and the continuation equals an
    uninterrupted single run of the winning replica (same key + iterator
    stream, Adam moments carried through)."""
    from modulatedgps_tpu.data import minibatch_iterator
    from modulatedgps_tpu.training import run_adam_multistart
    from modulatedgps_tpu.training.loop import make_train_step
    import optax

    model, X, Y = _model(rng)
    Xn, Yn = np.asarray(X), np.asarray(Y)
    mk = lambda s: minibatch_iterator(Xn, Yn, 10, seed=s)
    key = jax.random.PRNGKey(7)
    m_ms, iters, elbos, info = run_adam_multistart(
        model, 30, mk, 1e-2, num_starts=3, probe_iters=10,
        probe_data=(X, Y), eval_keys=2, key=key, verbose=False)
    assert info["num_starts"] == 3 and 0 <= info["winner"] < 3
    assert len(info["probe_scores"]) == 3
    assert iters and iters[-1] == 30

    # reference: a single uninterrupted run of the winner replica
    w = info["winner"]
    init_fn, step_fn = make_train_step(optax.adam(1e-2))
    st = init_fn(model, jax.random.fold_in(key, w))
    it = mk(w)
    sfn = jax.jit(step_fn)
    for _ in range(30):
        Xb, Yb = next(it)
        st, _ = sfn(st, Xb, Yb)
    for a, b in zip(jax.tree.leaves(m_ms), jax.tree.leaves(st.model)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
