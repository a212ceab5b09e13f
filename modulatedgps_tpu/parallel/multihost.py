"""Multi-host entry (SURVEY.md §5.8): jax.distributed bootstrap + global
mesh construction across hosts.

Single-host (including the 8-virtual-CPU-device test harness) is the
degenerate case: initialize() is a no-op and the global mesh equals the
local one.
"""
from __future__ import annotations

import jax

from .mesh import make_mesh

__all__ = ["initialize_multihost", "global_mesh", "is_coordinator"]

_initialized = False


# Env markers that mean "this process is part of a multi-process job"
# whose coordinator is named explicitly.
_MULTIPROC_ENV_MARKERS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         force: bool = False) -> None:
    """Initialize jax.distributed when running multi-process.

    With no arguments, a multi-process environment is detected from the
    standard markers (_MULTIPROC_ENV_MARKERS): explicit
    JAX_COORDINATOR_ADDRESS setups.
    ``force=True`` skips detection and always calls initialize (for
    environments with non-standard markers).  Single-process is a no-op.
    """
    global _initialized
    if _initialized:
        return
    # Decide WITHOUT touching the jax backend: jax.distributed.initialize
    # must run before any backend call (e.g. jax.process_count() would
    # initialize the backend and make distributed init a no-op-too-late).
    import os
    env_multiproc = any(v in os.environ for v in _MULTIPROC_ENV_MARKERS)
    if coordinator_address is None and num_processes is None \
            and not env_multiproc and not force:
        # single-process (CLI/dev) — nothing to do
        _initialized = True
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    _initialized = True


def global_mesh(num_expert: int = 1):
    """('data','expert') mesh over all global devices; 'data' spans hosts."""
    return make_mesh(num_expert=num_expert, devices=jax.devices())


def is_coordinator() -> bool:
    return jax.process_index() == 0
