"""Smoke run of the SMGP train-and-serve path on one GPU.

    python chip_smoke.py             # one GPU: phases 1-7
    python chip_smoke.py --four-gpu  # four GPUs: the sharded steps only

Drives the north-star model (batch 8192, M=4096, K=8, S=16, D=4, float32,
random weights from a seed) through the entry points a user calls —
``run_adam``, ``precompute_smgp`` -> ``predict_y`` — and checks it against
a plain float64 reference.  One process; each phase prints its own lines
and any failure ends the run with a non-zero exit before the last line.
The last line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}

Phases: 1 device, 2 matmul precision probe, 3 training at M=4096 and
M=1024, 4 serving, 5 comparison with the float64 reference, 6 the
fast-solves A/B, 7 XLA times of the ops the earlier hand-written kernels
covered.  Without a GPU it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.scipy.linalg import solve_triangular

from modulatedgps_tpu.data.loader import minibatch_iterator
from modulatedgps_tpu.likelihoods import Gaussian
from modulatedgps_tpu.models import SMGP, SVGP
from modulatedgps_tpu.models.posterior import precompute_smgp
from modulatedgps_tpu.ops import linalg
from modulatedgps_tpu.ops.kernels import SquaredExponential
from modulatedgps_tpu.ops.kl import gauss_kl
from modulatedgps_tpu.parallel import (make_mesh, make_parallel_train_step,
                                       shard_batch)
from modulatedgps_tpu.params import Parameter
from modulatedgps_tpu.training import make_train_step, run_adam
from modulatedgps_tpu.utils.profiling import time_fn
from modulatedgps_tpu.utils.runtime import enable_compile_cache, require_gpu

K = 8
S = 16
D = 4
BATCH = 8192
NUM_DATA = 1_000_000
LR = 5e-3
JITTER_F32 = 1e-4           # config.default_jitter(float32)
TEMPERATURE = 1e-2          # SMGP.temperature

# ---------------------------------------------------------------------------
# Phase 5 tolerances.
#
# Every compared quantity q (loss, KL, marginals, the head's cotangents,
# gradient leaves) is scored by its normwise relative error against the
# float64 HIGHEST reference, evaluated at the same float32-rounded inputs:
#     err(q) = ||q - q_f64|| / ||q_f64||
# for the product (float32, default matmul precision, the product's solve
# form) and for the float32 floor: the same plain reference run in float32,
# once at HIGHEST and once with its two products (fmean = A^T q_mu and the
# q_sqrt quadratic) at DEFAULT precision, as the product runs them (one-pass
# TF32 on this card family, phase 2); err_floor is the larger of the two.
# q passes when
#     err_product(q) <= max(TOL[kind of q], RATIO * err_floor(q)).
#
# The gradient is judged in two parts, split at the layer terms (both
# layers' marginals and KLs), because end to end it is not a well-posed
# float32 quantity: the tau=1e-2 Gumbel-softmax head multiplies the ~1e-3
# error that any float32 evaluation leaves in the assignment marginals by
# 1/tau per near-tie sample, so the assignment-layer gradients come out
# anywhere from 3e-4 to 8e-2 off depending on which GEMM algorithms the
# compiler picks.  Instead:
#   - the head (variational expectations, Gumbel-softmax, logsumexp) is
#     evaluated by each side at the exact terms, giving its cotangents
#     dloss/d<marginal> and the likelihood gradient;
#   - each side pulls the exact cotangent back through its own terms
#     (kernel, Cholesky, solves, q_sqrt quadratic, KL), giving every layer
#     leaf's gradient.
# Their sum is the gradient when both parts are exact.
# TOL: what a one-pass TF32-class product (the precision probe's DEFAULT
#   class on this card family: ~5e-4 relative per input rounding) may leave
#   in a well-conditioned quantity, with a margin of ~40 for marginals and
#   gradients; the scalars average over the batch and the K experts, so
#   they get a tenth of that.
# RATIO: the inducing-input and hyperparameter gradients run through the
#   Cholesky pullback at M=4096 and jitter 1e-4, where float32 itself is
#   the floor (cond(Kmm) ~1e6); there the product may be at most 4x worse
#   than float32 evaluated exactly.
TOL = {"scalar": 2e-3, "marginal": 2e-2, "grad": 2e-2}
RATIO = 4.0


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_name_and_power_limit() -> str:
    """Card name and power limit, read by a child process that stays off
    JAX (a second JAX process could not open the card)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def final_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


# ------------------------------------------------------------------ the model

def build_model(M: int, dtype, seed: int = 0):
    """The north-star SMGP (bench.py's configuration) at inducing count M."""
    rng = np.random.default_rng(seed)
    pred = SVGP.create(SquaredExponential.create(0.5, 0.5, dtype=dtype),
                       rng.normal(size=(M, D)), num_latent_gps=K, dtype=dtype)
    assign = SVGP.create(SquaredExponential.create(0.1, 1.0, dtype=dtype),
                         rng.normal(size=(M, D)), num_latent_gps=K,
                         dtype=dtype)
    return SMGP(likelihood=Gaussian.create(variance=0.5, D=K, dtype=dtype),
                pred_layer=pred, assign_layer=assign, K=K, num_samples=S,
                num_data=NUM_DATA)


def make_data(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-3, 3, size=(n, D)), rng.normal(size=(n, 1))


def perturb(model, seed: int = 2):
    """A trained-like variational state (q_mu ~ 0.3 N, q_sqrt = 0.9 I +
    0.05 tril N).  At the whitened init the marginals do not depend on Z,
    so the true Z gradient is 0 and any comparison there is void."""
    rng = np.random.default_rng(seed)
    layers = {}
    for name in ("pred_layer", "assign_layer"):
        layer = getattr(model, name)
        M = layer.Z.shape[0]
        dt = layer.q_mu.dtype
        q_mu = 0.3 * rng.normal(size=(M, K))
        q_sqrt = 0.9 * np.eye(M) + 0.05 * np.tril(rng.normal(size=(K, M, M)))
        layers[name] = layer.replace(
            q_mu=Parameter(jnp.asarray(q_mu, dt)),
            q_sqrt=Parameter(jnp.asarray(q_sqrt, dt), transform="tril"))
    return model.replace(**layers)


def cast(tree, dtype):
    return jax.tree.map(
        lambda x: x.astype(dtype) if hasattr(x, "dtype")
        and jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


# ------------------------------------------------------- the plain reference

MARGINALS = ("fmean", "fvar", "amean", "avar")


def reference_terms(model, X, *, jitter: float = JITTER_F32,
                    precision=jax.lax.Precision.HIGHEST):
    """Both layers' marginals and whitened KLs from the raw parameters, in
    plain jnp, sharing no code with the package beyond reading the pytree:
    kernel by direct differences, Cholesky, triangular solve, dense q_sqrt
    quadratic, closed-form whitened KL.  ``precision`` is that of its two
    products (fmean and the quadratic)."""
    hi = precision
    softplus = jax.nn.softplus

    def layer_terms(layer):
        var = softplus(layer.kernel.variance.raw)
        ls = softplus(layer.kernel.lengthscales.raw)
        Z = layer.Z.raw
        q_mu = layer.q_mu.raw
        Lq = jnp.tril(layer.q_sqrt.raw)
        M = Z.shape[0]

        def k(a, b):
            d = (a[:, None, :] - b[None, :, :]) / ls
            return var * jnp.exp(-0.5 * jnp.sum(d * d, axis=-1))

        L = jnp.linalg.cholesky(k(Z, Z) + jitter * jnp.eye(M, dtype=Z.dtype))
        A = solve_triangular(L, k(Z, X), lower=True)             # [M, N]
        fmean = jnp.matmul(A.T, q_mu, precision=hi)              # [N, K]
        B = jnp.einsum("mn,kmp->knp", A, Lq, precision=hi)       # [K, N, M]
        fvar = (var - jnp.sum(A * A, axis=0))[:, None] \
            + jnp.sum(B * B, axis=-1).T                          # [N, K]
        d = jnp.diagonal(Lq, axis1=-2, axis2=-1)
        kl = 0.5 * (jnp.sum(q_mu * q_mu) - M * q_mu.shape[1]
                    - 2.0 * jnp.sum(jnp.log(jnp.abs(d)))
                    + jnp.sum(Lq * Lq))
        return fmean, fvar, kl

    fmu, fvar, kl_p = layer_terms(model.pred_layer)
    amu, avar, kl_a = layer_terms(model.assign_layer)
    return {"fmean": fmu, "fvar": fvar, "amean": amu, "avar": avar,
            "kl_pred": kl_p, "kl_assign": kl_a}


# The float32 floor's second evaluation: the products at the product's
# matmul precision.
reference_terms_at_default = functools.partial(
    reference_terms, precision=jax.lax.Precision.DEFAULT)


def reference_head(model, terms, Y, z, g, *, jitter: float = JITTER_F32):
    """The SMGP training loss from the layer terms, in plain jnp: Gaussian
    variational expectations, Gumbel-softmax weights, logsumexp over
    samples, KLs over num_data."""
    sig2 = jax.nn.softplus(model.likelihood.variance.raw)        # [1, K]
    ve = (-0.5 * math.log(2 * math.pi) - 0.5 * jnp.log(sig2)
          - 0.5 * ((Y - terms["fmean"]) ** 2 + terms["fvar"]) / sig2)
    logits = terms["amean"] + z * jnp.sqrt(terms["avar"] + jitter)
    W = jax.nn.softmax((logits + g) / TEMPERATURE, axis=-1)      # [S, N, K]
    e = jax.nn.logsumexp(jnp.sum(ve * W, axis=-1), axis=0) - math.log(
        z.shape[0])
    kl = terms["kl_pred"] + terms["kl_assign"]
    return -(jnp.mean(e) - kl / model.num_data)


def reference_loss(model, X, Y, z, g, *, jitter: float = JITTER_F32):
    """(loss, terms) of the plain reference."""
    terms = reference_terms(model, X, jitter=jitter)
    return reference_head(model, terms, Y, z, g, jitter=jitter), terms


def product_terms(model, X):
    """The layer terms through the package's own path (default precision,
    custom pullbacks as the product picks them)."""
    fmu, fvar = model.pred_layer.predict_f(X)
    amu, avar = model.assign_layer.predict_f(X)
    return {"fmean": fmu, "fvar": fvar, "amean": amu, "avar": avar,
            "kl_pred": model.pred_layer.prior_kl(),
            "kl_assign": model.assign_layer.prior_kl()}


def product_head(model, terms, Y, z, g):
    e = model.E_log_p_from_marginals(*(terms[k] for k in MARGINALS), z, g, Y)
    kl = terms["kl_pred"] + terms["kl_assign"]
    return -(jnp.mean(e) - kl / model.num_data)


def product_loss(model, X, Y, z, g):
    """(loss, terms) through the package's own path."""
    terms = product_terms(model, X)
    return product_head(model, terms, Y, z, g), terms


@functools.partial(jax.jit, static_argnums=(0, 1))
def _side(terms_fn, head_fn, model, X, Y, z, g, exact, ct):
    """One side of phase 5: the loss end to end and the terms at this
    side's own evaluation; the head's cotangents and the likelihood
    gradient at the exact terms ``exact``; the pullback of the exact
    cotangent ``ct`` through this side's terms (see the tolerance notes)."""
    terms, pullback = jax.vjp(lambda m: terms_fn(m, X), model)
    out = {"loss": head_fn(model, terms, Y, z, g), **terms}
    g_head, ct_own = jax.grad(head_fn, argnums=(0, 1))(model, exact, Y, z, g)
    out.update({f"dloss/d{k}": ct_own[k] for k in MARGINALS})
    grads = jax.tree.map(jnp.add, g_head, pullback(ct)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out["grad" + jax.tree_util.keystr(path)] = leaf
    return out


def _numpy(out: dict) -> dict:
    return {k: np.asarray(v, np.float64) for k, v in out.items()}


def _kind(name: str) -> str:
    if name.startswith(("grad", "dloss")):
        return "grad"
    if name in ("loss", "kl_pred", "kl_assign"):
        return "scalar"
    return "marginal"


def _relerr(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def reference_numbers(M: int, batch: int, *, seed: int = 0):
    """Phase 5's float64 truth and float32 floors at inducing count M and
    batch size ``batch``, and the float32 arguments for ``_side``.

    The noise is drawn once with SMGP.draw_noise; model, data and noise are
    rounded to float32 first, and the truth is evaluated at those values."""
    f32, f64 = jnp.float32, jnp.float64
    Xn, Yn = make_data(batch, seed + 1)
    with jax.enable_x64(True):
        model = cast(perturb(build_model(M, f64, seed), seed + 2), f32)
        z, g = model.draw_noise(jax.random.PRNGKey(seed), batch, S, f64)
        inputs = (model, jnp.asarray(Xn, f32), jnp.asarray(Yn, f32),
                  z.astype(f32), g.astype(f32))
        model64, X64, Y64, z64, g64 = cast(inputs, f64)
        exact = jax.jit(reference_terms)(model64, X64)
        ct = jax.jit(jax.grad(reference_head, argnums=1))(
            model64, exact, Y64, z64, g64)
        truth = _numpy(_side(reference_terms, reference_head, model64, X64,
                             Y64, z64, g64, exact, ct))
        args32 = (*inputs, cast(exact, f32), cast(ct, f32))
        del model64, X64, Y64, z64, g64, exact, ct
        with jax.default_matmul_precision("highest"):
            floor = _numpy(_side(reference_terms, reference_head, *args32))
        floor_default = _numpy(_side(reference_terms_at_default,
                                     reference_head, *args32))
    return truth, (floor, floor_default), args32


class Row(NamedTuple):
    name: str
    product: float        # err_product
    floor: float          # the float32 floor at HIGHEST
    floor_default: float  # the float32 floor with DEFAULT-precision products
    tol: float
    ok: bool


def judge(truth: dict, floors: tuple, product: dict) -> list[Row]:
    rows = []
    for name in truth:
        ep = _relerr(product[name], truth[name])
        ef = [_relerr(f[name], truth[name]) for f in floors]
        tol = max(TOL[_kind(name)], RATIO * max(ef))
        rows.append(Row(name, ep, *ef, tol, ep <= tol))
    return rows


def compare_to_reference(M: int, batch: int, *, seed: int = 0):
    """Phase 5 at inducing count M and batch size ``batch``; the caller
    fails the run on any row that is not ok."""
    truth, floors, args32 = reference_numbers(M, batch, seed=seed)
    product = _numpy(_side(product_terms, product_head, *args32))
    return judge(truth, floors, product)


# -------------------------------------------------------------------- phases

def phase_device():
    devices = jax.devices()
    log(f"[1] devices: {devices}")
    log(f"[1] device_kind: {devices[0].device_kind}; count: {len(devices)}; "
        f"jax {jax.__version__}")
    log(f"[1] nvidia-smi name, power.limit: "
        f"{nvidia_smi_name_and_power_limit()}")
    return devices


def precision_probe(n: int = 4096, seed: int = 0) -> dict:
    """Relative error of one [n,n]x[n,n] float32 product at each matmul
    precision against the float64 product of the same (float32) inputs."""
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.normal(size=(n, n)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(n, n)), jnp.float32)
    with jax.enable_x64(True):
        ref = np.asarray(jnp.matmul(a.astype(jnp.float64),
                                    b.astype(jnp.float64)))
    errs = {}
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        p = getattr(jax.lax.Precision, name)
        c = jax.jit(lambda x, y, p=p: jnp.matmul(x, y, precision=p))(a, b)
        errs[name] = _relerr(np.asarray(c, np.float64), ref)
    return errs


def _precision_class(err: float) -> str:
    if err < 3e-6:
        return "full float32 (or a 3-pass split)"
    if err < 1e-4:
        return "3-pass bf16 class"
    if err < 1.5e-3:
        return "one-pass TF32 class"
    return "one-pass bf16 class"


def phase_precision(n: int = 4096):
    errs = precision_probe(n)
    for name, e in errs.items():
        log(f"[2] f32 matmul {n}^3 precision={name}: rel err vs f64 "
            f"{e:.3e} ({_precision_class(e)})")


def _peak_bytes(device) -> int | None:
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def train(M: int, steps: int, *, batch: int = BATCH, seed: int = 0,
          tag: str = "[3]"):
    """~``steps`` run_adam steps at inducing count M; returns the model."""
    f32 = jnp.float32
    model = build_model(M, f32, seed)
    Xn, Yn = make_data(4 * batch, seed + 1)
    Xb, Yb = jnp.asarray(Xn[:batch], f32), jnp.asarray(Yn[:batch], f32)

    # The step run_adam jits (product-default optimizer), compiled once
    # here for its compile time and memory analysis.
    init_fn, step_fn = make_train_step(optax.adam(LR))
    state = init_fn(model, jax.random.PRNGKey(seed))
    t0 = time.perf_counter()
    compiled = jax.jit(step_fn).lower(state, Xb, Yb).compile()
    log(f"{tag} M={M} batch={batch}: train-step compile (set-up) "
        f"{time.perf_counter() - t0:.2f} s")
    log(f"{tag} M={M}: memory_analysis: {compiled.memory_analysis()}")
    del compiled, state

    batches = ((jnp.asarray(x, f32), jnp.asarray(y, f32)) for x, y in
               minibatch_iterator(Xn, Yn, batch, seed=seed,
                                  use_native=False))
    t0 = time.perf_counter()
    model, iters, elbos = run_adam(model, steps, batches, LR,
                                   key=jax.random.PRNGKey(seed), log_every=1,
                                   verbose=False)
    wall = time.perf_counter() - t0
    if len(elbos) != steps or not np.all(np.isfinite(elbos)):
        raise RuntimeError(f"M={M}: non-finite or missing ELBOs {elbos}")
    log(f"{tag} M={M}: {steps} run_adam steps in {wall:.2f} s (first step "
        f"compiles); ELBO {elbos[0]:.6f} -> {elbos[-1]:.6f}, all finite")
    log(f"{tag} M={M}: peak_bytes_in_use "
        f"{_peak_bytes(jax.devices()[0])}")
    return model


def serve(model, sizes=(1024, 4096, 8192), *, seed: int = 3,
          tag: str = "[4]"):
    """precompute_smgp, then predict_y on a few batches.  Then, at a
    trained-like variational state (perturb), the served marginals of both
    layers on the largest batch are compared with the float64 reference's
    (tolerance TOL["marginal"])."""
    dt = model.pred_layer.q_mu.dtype
    precompute = jax.jit(precompute_smgp)
    t0 = time.perf_counter()
    serving = precompute(model)
    jax.block_until_ready(serving)
    log(f"{tag} precompute_smgp (M={model.pred_layer.Z.shape[0]}): "
        f"{time.perf_counter() - t0:.2f} s incl. compile")
    predict = jax.jit(lambda m, x: m.predict_y(x))
    rng = np.random.default_rng(seed)
    for n in sizes:
        X = jnp.asarray(rng.uniform(-3, 3, size=(n, D)), dt)
        mean, var = predict(serving, X)
        mean, var = np.asarray(mean), np.asarray(var)
        if mean.shape != (1, n, K) or var.shape != (1, n, K):
            raise RuntimeError(f"predict_y shapes {mean.shape}, {var.shape}")
        if not np.all(np.isfinite(mean)) or not np.all(var > 0):
            raise RuntimeError(f"predict_y at n={n}: non-finite mean or "
                               "non-positive variance")
        log(f"{tag} predict_y n={n}: mean [{mean.min():.4f}, "
            f"{mean.max():.4f}], var [{var.min():.4f}, {var.max():.4f}]")

    model = perturb(model, seed)
    serving = precompute(model)
    Xn = rng.uniform(-3, 3, size=(sizes[-1], D))
    with jax.enable_x64(True):
        f64 = jnp.float64
        truth = jax.jit(reference_terms)(cast(model, f64),
                                         jnp.asarray(Xn, f64))
    X = jnp.asarray(Xn, dt)
    served = jax.jit(lambda m, x: (m.pred_layer.predict_f(x),
                                   m.assign_layer.predict_f(x)))(serving, X)
    missed = []
    for name, got in zip(("fmean", "fvar", "amean", "avar"),
                         (*served[0], *served[1])):
        err = _relerr(np.asarray(got, np.float64), np.asarray(truth[name]))
        ok = err <= TOL["marginal"]
        log(f"{tag} served {name} n={len(Xn)}: rel err vs float64 reference "
            f"{err:.3e} (tol {TOL['marginal']:.0e}) {'ok' if ok else 'MISS'}")
        if not ok:
            missed.append(name)
    if missed:
        raise RuntimeError(f"serving: outside tolerance: {missed}")


def phase_compare(sizes=(4096, 1024), batch: int = BATCH):
    """Phase 5 at each size, the product in its default solve form there."""
    missed = []
    for M in sizes:
        form = "fast" if linalg.fast_solves(M, jnp.float32) else "substitution"
        rows = compare_to_reference(M, batch)
        log(f"[5] M={M} batch={batch} ({form}): float32 product vs float64 "
            "HIGHEST reference (normwise relative errors; f32 floor at "
            "HIGHEST / at DEFAULT)")
        for r in rows:
            log(f"[5]   {r.name:<44s} product {r.product:.3e}  floor "
                f"{r.floor:.3e} / {r.floor_default:.3e}  tol {r.tol:.3e}  "
                f"{'ok' if r.ok else 'MISS'}")
        missed += [f"M={M} {r.name}" for r in rows if not r.ok]
    if missed:
        raise RuntimeError(f"phase 5: outside tolerance: {missed}")


def time_train_step(M: int, steps: int = 10, trials: int = 3,
                    batch: int = BATCH, seed: int = 0) -> float:
    """Best-of-``trials`` seconds per train step (donated state, windows of
    ``steps`` calls ended by block_until_ready, after one warm-up call)."""
    f32 = jnp.float32
    init_fn, step_fn = make_train_step(optax.adam(LR))
    state = init_fn(build_model(M, f32, seed), jax.random.PRNGKey(seed))
    Xn, Yn = make_data(batch, seed + 1)
    X, Y = jnp.asarray(Xn, f32), jnp.asarray(Yn, f32)
    fn = jax.jit(step_fn, donate_argnums=(0,))
    state, loss = fn(state, X, Y)
    jax.block_until_ready(loss)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = fn(state, X, Y)
        jax.block_until_ready(loss)
        best = min(best, (time.perf_counter() - t0) / steps)
    if not np.isfinite(float(loss)):
        raise RuntimeError(f"M={M}: non-finite loss in timing")
    return best


def phase_fast_solves_ab(card: str, sizes=(4096, 2048, 1024),
                        batch: int = BATCH):
    """Train step with the fast-solves form on and off, in turns; the
    default is the choice by size and dtype (linalg.fast_solves)."""
    for M in sizes:
        times = {}
        try:
            for mode in (True, False, False, True):
                linalg.set_fast_solves(mode)
                times.setdefault(mode, []).append(
                    time_train_step(M, batch=batch))
        finally:
            linalg.set_fast_solves(None)
        on, off = min(times[True]), min(times[False])
        log(f"[6] M={M} batch={batch} train step ({card}): fast solves on "
            f"{on * 1e3:.3f} ms ({', '.join(f'{t * 1e3:.3f}' for t in times[True])}), "
            f"off {off * 1e3:.3f} ms ({', '.join(f'{t * 1e3:.3f}' for t in times[False])}); "
            f"faster: {'on' if on < off else 'off'}; default: "
            f"{'on' if linalg.fast_solves(M, jnp.float32) else 'off'}")


def op_costs(M: int, N: int) -> dict:
    """FLOPs and bytes of each op phase 7 times, from shapes (float32)."""
    f = 4
    kmm = K * M * M
    return {
        "kxz_build": (2 * M * N * D + 6 * M * N, f * (M * N + (M + N) * D)),
        "triangular_inverse": (M ** 3, 2 * f * M * M),   # TRSM, M RHS
        "chol_pullback (dense)": (6 * M ** 3, 5 * f * M * M),
        "quad_fwd B=A^T tril(L)": (2 * K * N * M * M,
                                   f * (M * N + kmm + K * N * M)),
        "quad_grad dL=A dB": (2 * K * N * M * M,
                              f * (M * N + K * N * M + kmm)),
        "quad_grad dA=dB L^T": (2 * K * N * M * M,
                                f * (K * N * M + kmm + M * N)),
        "whitened_kl": (3 * kmm, f * kmm),
        "whitened_kl_vjp": (3 * kmm, 2 * f * kmm),
        "adam_2x[K,M,M]": (2 * 12 * kmm, 2 * 7 * f * kmm),
    }


def phase_op_times(card: str, M: int = 4096, N: int = BATCH, seed: int = 0):
    """XLA times of the ops the removed hand-written kernels covered — the
    baselines any later GPU kernel has to beat."""
    f32 = jnp.float32
    model = perturb(build_model(M, f32, seed), seed + 2)
    layer = model.pred_layer
    Xn, _ = make_data(N, seed + 1)
    X = jnp.asarray(Xn, f32)
    Z = layer.Z.value
    L = jnp.linalg.cholesky(layer.kuu())
    Linv = linalg.triangular_inverse(L)
    A = jax.jit(lambda L, Kmn: jax.lax.linalg.triangular_solve(
        L, Kmn, left_side=True, lower=True))(L, layer.kernel.K(Z, X))
    Lq = layer.q_sqrt.value
    q_mu = layer.q_mu.value
    dB = jax.random.normal(jax.random.PRNGKey(seed), (K, N, M), f32)
    kl_grad = jax.grad(lambda m, s: gauss_kl(m, s, assume_tril=True),
                       argnums=(0, 1))
    opt = optax.adam(LR)
    params = (layer.q_sqrt.raw, model.assign_layer.q_sqrt.raw)
    grads = (Lq, Lq)
    opt_state = opt.init(params)

    def adam(p, g, s):
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s

    ops = {
        "kxz_build": (lambda k, Z, X: k.K(Z, X), (layer.kernel, Z, X)),
        "triangular_inverse": (linalg.triangular_inverse, (L,)),
        "chol_pullback (dense)": (linalg.chol_pullback,
                                  (L, Linv, jnp.tril(Lq[0]))),
        "quad_fwd B=A^T tril(L)": (
            lambda A, Lq: jnp.matmul(A.T[None], Lq), (A, Lq)),
        "quad_grad dL=A dB": (
            lambda A, dB: jnp.tril(jnp.einsum("mn,knp->kmp", A, dB)),
            (A, dB)),
        "quad_grad dA=dB L^T": (
            lambda dB, Lq: jnp.einsum("knp,kmp->mn", dB, Lq), (dB, Lq)),
        "whitened_kl": (lambda m, s: gauss_kl(m, s, assume_tril=True),
                        (q_mu, Lq)),
        "whitened_kl_vjp": (kl_grad, (q_mu, Lq)),
        "adam_2x[K,M,M]": (adam, (params, grads, opt_state)),
    }
    costs = op_costs(M, N)
    for name, (fn, args) in ops.items():
        t = time_fn(jax.jit(fn), *args, iters=10, warmup=2)
        flops, nbytes = costs[name]
        log(f"[7] M={M} N={N} {name:<24s} {t * 1e3:9.3f} ms  "
            f"{flops / 1e9:10.2f} GFLOP {nbytes / 1e9:8.3f} GB  "
            f"-> {flops / t / 1e12:7.2f} TFLOP/s {nbytes / t / 1e9:8.1f} GB/s"
            f"  ({card})")


def phase_four_gpu(M: int = 4096, N: int = BATCH, steps: int = 3,
                   seed: int = 0, devices=None):
    """Data-parallel and inducing-sharded steps over four cards, each
    compared with the single-card step on the same global batch."""
    devices = list(devices if devices is not None else jax.devices())
    if len(devices) != 4:
        raise RuntimeError(f"--four-gpu needs 4 devices, found {len(devices)}")
    f32 = jnp.float32
    model = perturb(build_model(M, f32, seed), seed + 2)
    Xn, Yn = make_data(N, seed + 1)
    key = jax.random.PRNGKey(seed)

    def run(init_fn, step_fn, X, Y):
        state = init_fn(model, key)
        losses = []
        for _ in range(steps):
            state, loss = step_fn(state, X, Y)
            losses.append(float(loss))
        return losses

    X1 = jax.device_put(jnp.asarray(Xn, f32), devices[0])
    Y1 = jax.device_put(jnp.asarray(Yn, f32), devices[0])
    init1, step1 = make_train_step(optax.adam(LR))
    single = run(init1, jax.jit(step1), X1, Y1)
    del X1, Y1
    log(f"[8] single card M={M} N={N}: losses {single}")

    cases = {
        "data-parallel 2x2 ('data','expert')": (
            make_mesh(num_data=2, num_expert=2, devices=devices),
            dict(shard_experts=True)),
        "inducing-sharded 4x1": (
            make_mesh(num_data=4, num_expert=1, devices=devices),
            dict(shard_inducing=True)),
    }
    failed = []
    for name, (mesh, kw) in cases.items():
        init_fn, step_fn = make_parallel_train_step(
            optax.adam(LR), mesh, K=K, donate=False, **kw)
        Xs, Ys = shard_batch(mesh, jnp.asarray(Xn, f32), jnp.asarray(Yn, f32))
        losses = run(init_fn, step_fn, Xs, Ys)
        errs = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
        ok = all(e <= TOL["scalar"] for e in errs)
        log(f"[8] {name} M={M} N={N}: losses {losses}; rel diff vs single "
            f"card {['%.2e' % e for e in errs]} (tol {TOL['scalar']:.0e}) "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError(f"four-gpu: loss mismatch in {failed}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four-gpu", action="store_true",
                   help="run only the four-card sharded steps")
    args = p.parse_args(argv)

    require_gpu()
    log(f"compile cache: {enable_compile_cache()}")
    devices = phase_device()
    card = nvidia_smi_name_and_power_limit()
    if args.four_gpu:
        phase_four_gpu(devices=devices)
        print(final_line(devices), flush=True)
        return 0
    if len(devices) != 1:
        raise RuntimeError(f"expected one GPU, found {len(devices)}")

    phase_precision()
    model = train(4096, 10)
    train(1024, 10)
    serve(model)
    del model
    phase_compare()
    phase_fast_solves_ab(card)
    phase_op_times(card)
    print(final_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
