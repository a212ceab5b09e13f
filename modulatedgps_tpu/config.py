"""Global numerics configuration.

The reference inherits gpflow's config (float64 default, jitter 1e-6; see
reference MixtureGPs/models.py:16-17).  The default dtype here follows
JAX's x64 flag: tests enable x64 on CPU for parity with float64
references, while accelerator runs use float32 with a jitter floor.
"""
from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp

__all__ = [
    "default_float",
    "default_jitter",
    "set_default_jitter",
    "as_default_float",
    "config_context",
    "enable_debug_checks",
]


@dataclasses.dataclass
class _Config:
    # gpflow default_jitter() == 1e-6 (reference MixtureGPs/models.py:17);
    # that value assumes float64.  float32 (the accelerator path) needs a
    # larger floor or chol(Kuu) goes NaN at M ≳ few hundred — SURVEY.md §7.3.
    jitter: float = 1e-6
    jitter_f32: float = 1e-4
    # If None, resolve from jax_enable_x64 at call time.
    float_override: jnp.dtype | None = None
    # Ablation probe (the float32 ablation study's arm f64_ftz): flush
    # Gumbel-softmax weights below this threshold to exact zero, mimicking
    # fp32's flush-to-zero inside an otherwise-f64 run.  The probe isolates
    # whether the fp32 convergence gap is the sub-1e-38 gradient trickle
    # through near-one-hot assignment weights (tau=1e-2 saturates fp32's
    # exp once logit gaps exceed ~0.88).  None = off (production).
    w_flush_min: float | None = None


_CONFIG = _Config()


def w_flush_min() -> float | None:
    return _CONFIG.w_flush_min


def set_w_flush_min(value: float | None) -> None:
    _CONFIG.w_flush_min = value


def default_float() -> jnp.dtype:
    """float64 when x64 is enabled (CPU parity mode), else float32."""
    if _CONFIG.float_override is not None:
        return _CONFIG.float_override
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def default_jitter(dtype=None) -> float:
    """Jitter for the given dtype (defaults to default_float())."""
    dt = jnp.dtype(dtype if dtype is not None else default_float())
    if dt == jnp.float64:
        return _CONFIG.jitter
    return max(_CONFIG.jitter, _CONFIG.jitter_f32)


def set_default_jitter(value: float, *, f32_floor: float | None = None) -> None:
    """Set the base jitter.  float32 callers still get
    max(value, jitter_f32) unless ``f32_floor`` is also given — the floor
    exists because f32 chol(Kuu) goes NaN at M >~ few hundred with 1e-6,
    but SMALL-M f32 models can legitimately run below it (measured: the
    1e-4 floor, not the f32 dtype, is what degrades flagship convergence
    in the float32 ablation study)."""
    _CONFIG.jitter = float(value)
    if f32_floor is not None:
        _CONFIG.jitter_f32 = float(f32_floor)


def as_default_float(x) -> jax.Array:
    return jnp.asarray(x, dtype=default_float())


def enable_debug_checks(nans: bool = True, checks: bool = False) -> None:
    """Numerics sanitizer mode (SURVEY.md §5.2 — the race/NaN-detection
    analog): ``jax_debug_nans`` makes any NaN-producing op raise with a
    de-optimized re-run pinpointing it; ``jax_enable_checks`` turns on
    JAX's internal invariant checks.  Both slow execution — development
    only (demos expose this as ``--debug-nans``)."""
    jax.config.update("jax_debug_nans", bool(nans))
    if checks:
        jax.config.update("jax_enable_checks", True)


@contextlib.contextmanager
def config_context(jitter: float | None = None, float_override=None):
    old = dataclasses.replace(_CONFIG)
    try:
        if jitter is not None:
            _CONFIG.jitter = jitter
        if float_override is not None:
            _CONFIG.float_override = jnp.dtype(float_override)
        yield
    finally:
        _CONFIG.jitter = old.jitter
        _CONFIG.float_override = old.float_override
