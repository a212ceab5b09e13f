"""Process set-up shared by the entry points (chip_smoke.py, bench.py, the
demos): the persistent compilation cache and the GPU requirement."""
from __future__ import annotations

import os

import jax

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache", "require_gpu"]

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache lives at ``<repo>/.jax_cache``
    (a fixed path, since the path is part of the cache key).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR


def require_gpu() -> list:
    """The GPU devices, or exit non-zero: measurement paths never fall back
    to the CPU."""
    try:
        backend = jax.default_backend()
    except RuntimeError as e:          # no backend could be initialized
        raise SystemExit(f"no GPU found: {e}") from None
    if backend != "gpu":
        raise SystemExit(f"this needs a GPU; JAX found only {backend!r} "
                         "devices")
    return jax.devices()
