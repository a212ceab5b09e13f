"""Adam training loop: the analog of reference utils/training_utils.py:4-28.

Differences by design:
 - the optimization step is one jitted function (model pytree in, model
   pytree out) — no Python-side optimizer state mutation;
 - RNG is an explicit threefry key chain, not a global seed;
 - ELBO logging every `log_every` steps reuses the loss evaluated *inside*
   the step (the reference runs a second full forward pass per log —
   utils/training_utils.py:20);
 - KeyboardInterrupt-safe, returns (iters, elbos) like run_adam.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Iterator

import jax
import jax.numpy as jnp
import optax

from ..params import Module, apply_trainable_mask, trainable_mask

__all__ = ["TrainState", "make_train_step", "run_adam",
           "run_adam_multistart"]


class TrainState(Module):
    model: Any
    opt_state: Any
    step: jax.Array
    key: jax.Array


def make_train_step(optimizer, loss_fn: Callable | None = None,
                    compute_dtype=None, loss_island_dtype=None):
    """Build (init_fn, step_fn) for a model with ``training_loss(key, X, Y)``.

    step_fn(state, X, Y) -> (state, loss) is jit-compatible; gradients of
    non-trainable Parameters are masked to zero (gpflow set_trainable parity).

    ``compute_dtype`` enables master-weight mixed precision: parameters and
    optimizer state stay in their stored dtype (e.g. float64) while the loss
    — forward AND backward — is computed after casting every float leaf to
    ``compute_dtype`` (e.g. float32).  The cast's transpose casts gradients
    back up, so Adam moments and the parameter update run in the stored
    dtype; this isolates/avoids update-arithmetic rounding while keeping
    compute at matmul-friendly precision.

    ``loss_island_dtype`` is the complement (the round-3 ablation's directly
    implied arm): parameters, Adam state and the CONDITIONAL chains stay in
    the stored dtype (e.g. float32), while everything downstream of the
    layer marginals — reparameterized sampling, Gumbel-softmax weights,
    variational expectations, logsumexp, and the prior KLs — is computed in
    ``loss_island_dtype`` (e.g. float64) after casting the marginals (and,
    for the KL, the variational parameters) up.  The cast's transpose brings
    gradients back down at the marginal boundary, so the O(M^2 N) compute
    stays in the stored dtype and only the cheap [S, N, K] elementwise reduction +
    the KL pay for high precision.  Requires an SMGP-family model (uses
    ``_marginals`` / ``E_log_p_from_marginals``).
    """

    def init_fn(model, key) -> TrainState:
        return TrainState(model=model, opt_state=optimizer.init(model),
                          step=jnp.zeros((), jnp.int32), key=key)

    def _cast(tree, dt):
        return jax.tree.map(
            lambda x: x.astype(dt)
            if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
            else x, tree)

    def default_loss(model, key, X, Y):
        if compute_dtype is not None:
            model = _cast(model, compute_dtype)
            X = _cast(X, compute_dtype)
            Y = _cast(Y, compute_dtype)
        if loss_island_dtype is None:
            return model.training_loss(key, X, Y)
        dt = loss_island_dtype
        pdt = model.pred_layer.q_mu.raw.dtype
        (fmu, fvar), (amu, avar) = model._marginals(X.astype(pdt))
        z, g = model.draw_noise(key, X.shape[0], model.num_samples, dt)
        m_hi = _cast(model, dt)
        e = m_hi.E_log_p_from_marginals(
            fmu.astype(dt), fvar.astype(dt), amu.astype(dt), avar.astype(dt),
            z, g, Y.astype(dt))
        kl = m_hi.pred_layer.prior_kl() + m_hi.assign_layer.prior_kl()
        return -(jnp.mean(e) - kl / model.num_data)

    loss = loss_fn or default_loss

    def step_fn(state: TrainState, X, Y):
        key, sub = jax.random.split(state.key)
        loss_val, grads = jax.value_and_grad(loss)(state.model, sub, X, Y)
        grads = apply_trainable_mask(grads, trainable_mask(state.model))
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.model)
        model = optax.apply_updates(state.model, updates)
        return TrainState(model=model, opt_state=opt_state,
                          step=state.step + 1, key=key), loss_val

    return init_fn, step_fn


def run_adam(model, num_iter: int, train_iter: Iterator, lr: float,
             key: jax.Array | None = None, log_every: int = 5,
             verbose: bool = True, compile: bool = True,
             callback: Callable | None = None,
             checkpoint_path: str | None = None, checkpoint_every: int = 0,
             resume: bool = False, compute_dtype=None,
             loss_island_dtype=None, optimizer=None):
    """Train with Adam; returns (model, iters, elbos).

    Contract parity with reference run_adam (utils/training_utils.py:4-28):
    prints an iter/ELBO table every ``log_every`` steps and stops gracefully
    on KeyboardInterrupt, returning history so far.  ``train_iter`` yields
    (X, Y) minibatches.

    Preemption safety (SURVEY.md §5.3/§5.4): with ``checkpoint_path`` +
    ``checkpoint_every=N`` the FULL TrainState (params, Adam moments, step,
    RNG key) is saved atomically every N steps; ``resume=True`` restores it
    and continues from the recorded step, so a preempted run converges to
    the same state as an uninterrupted one.  The caller owns ``train_iter``:
    for bit-exact reproduction fast-forward it to the restored step.

    ``optimizer`` (any optax GradientTransformation) replaces the default
    ``optax.adam(lr)``.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if checkpoint_every and not checkpoint_path:
        import warnings
        warnings.warn("checkpoint_every is set but checkpoint_path is None — "
                      "no checkpoints will be saved", stacklevel=2)
    if optimizer is None:
        optimizer = optax.adam(lr)
    init_fn, step_fn = make_train_step(optimizer, compute_dtype=compute_dtype,
                                       loss_island_dtype=loss_island_dtype)
    if compile:
        step_fn = jax.jit(step_fn)
    state = init_fn(model, key)
    start = 0
    if resume and checkpoint_path:
        import os
        from .checkpoint import restore_checkpoint
        if os.path.exists(checkpoint_path):
            state = restore_checkpoint(checkpoint_path, state)
            start = int(state.step)
            if verbose:
                print(f"resumed from {checkpoint_path} at step {start}")
                if start >= num_iter:
                    print(f"restored step {start} >= num_iter {num_iter}: "
                          "training already complete, no new steps will run")

    if verbose:
        print(f"{'iter':>5s}{'ELBO:':>24s}")
    iters, elbos = [], []
    try:
        for i in range(start + 1, num_iter + 1):
            X, Y = next(train_iter)
            state, loss = step_fn(state, X, Y)
            if i % log_every == 0:
                elbo = -float(loss)
                if verbose:
                    print(f"{i:>5d}{elbo:>24.6f}")
                iters.append(i)
                elbos.append(elbo)
                if callback is not None:
                    callback(i, elbo, state)
            if (checkpoint_path and checkpoint_every
                    and i % checkpoint_every == 0):
                from .checkpoint import save_checkpoint
                save_checkpoint(checkpoint_path, state)
    except KeyboardInterrupt:
        print("stopping training")

    if checkpoint_path and checkpoint_every and int(state.step) > start:
        # Persist the final TrainState even when num_iter isn't a multiple
        # of checkpoint_every, so the file always holds the state returned.
        from .checkpoint import save_checkpoint
        save_checkpoint(checkpoint_path, state)

    return state.model, iters, elbos


def run_adam_multistart(model, num_iter: int, make_train_iter, lr: float,
                        *, num_starts: int = 4, probe_iters: int = 400,
                        probe_data=None, eval_keys: int = 4,
                        key: jax.Array | None = None, log_every: int = 5,
                        verbose: bool = True, compile: bool = True,
                        optimizer=None):
    """Multi-start Adam: basin selection against the jitter-floor lottery.

    The float32 ablation study's attribution:
    at the 1e-4 jitter floor float32 requires, 2-3 of 8 seeds land in a
    worse optimization basin — a property of the loss landscape shared by
    pure float64 at the same jitter, not of f32 arithmetic.  The
    mitigation is to stop betting on one seed: train ``num_starts`` short
    replicas (distinct RNG keys + minibatch streams), score each on a
    common full-data ELBO estimate, and continue ONLY the winner — with
    its TrainState (Adam moments, RNG chain) intact, so the continuation
    is exactly what an uninterrupted single run of the winning seed would
    have produced.

    ``make_train_iter(s)`` must return a fresh (X, Y) minibatch iterator
    for replica ``s`` (e.g. ``lambda s: minibatch_iterator(X, Y, 500,
    seed=s)``).  ``probe_data=(X, Y)`` is the scoring set (defaults to the
    first probe batch of replica 0 — pass the full training set for a
    lower-variance score).  Cost: ``num_starts * probe_iters`` extra
    training steps plus ``num_starts * eval_keys`` ELBO evaluations.

    Returns ``(model, iters, elbos, info)`` where info records per-replica
    probe scores and the winner index.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    if optimizer is None:
        optimizer = optax.adam(lr)
    init_fn, step_fn = make_train_step(optimizer)
    if compile:
        step_fn = jax.jit(step_fn)
    probe_iters = min(probe_iters, num_iter)

    # --- probe phase: B replicas, probe_iters steps each -------------------
    iters_by_replica = [make_train_iter(s) for s in range(num_starts)]
    states = [init_fn(model, jax.random.fold_in(key, s))
              for s in range(num_starts)]
    for s in range(num_starts):
        it = iters_by_replica[s]
        st = states[s]
        for _ in range(probe_iters):
            X, Y = next(it)
            st, _ = step_fn(st, X, Y)
        states[s] = st

    # --- score on a common full-data ELBO estimate -------------------------
    if probe_data is None:
        probe_data = next(make_train_iter(0))
    Xp, Yp = probe_data

    def _score(m, k):
        return -m.training_loss(k, Xp, Yp)

    score_fn = jax.jit(_score) if compile else _score
    ekeys = [jax.random.PRNGKey(977 + i) for i in range(eval_keys)]
    scores = [float(sum(score_fn(states[s].model, k) for k in ekeys))
              / eval_keys for s in range(num_starts)]
    winner = max(range(num_starts), key=lambda s: scores[s])
    if verbose:
        for s, sc in enumerate(scores):
            tag = " <- winner" if s == winner else ""
            print(f"replica {s}: probe ELBO {sc:.6f}{tag}")

    # --- continue the winner ----------------------------------------------
    state = states[winner]
    it = iters_by_replica[winner]
    iters, elbos = [], []
    if verbose:
        print(f"{'iter':>5s}{'ELBO:':>24s}")
    try:
        for i in range(probe_iters + 1, num_iter + 1):
            X, Y = next(it)
            state, loss = step_fn(state, X, Y)
            if i % log_every == 0:
                elbo = -float(loss)
                if verbose:
                    print(f"{i:>5d}{elbo:>24.6f}")
                iters.append(i)
                elbos.append(elbo)
    except KeyboardInterrupt:
        print("stopping training")

    info = {"probe_scores": scores, "winner": winner,
            "probe_iters": probe_iters, "num_starts": num_starts}
    return state.model, iters, elbos, info
