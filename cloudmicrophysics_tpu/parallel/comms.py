"""Communication / sharding layer.

The reference has no internal parallelism — its ecosystem delegates to
ClimaComms (MPI context + device abstraction; see SURVEY.md §2.5). The
JAX equivalent is a device mesh + GSPMD sharding:

* microphysics is vertical-column-local, so the only meaningful axis is
  the horizontal ``columns`` axis — pure data parallelism with **zero**
  cross-chip communication in the hot loop (no halos: sedimentation is a
  within-column stencil);
* diagnostics reductions (`psum` over columns) ride ICI;
* multi-host initialization mirrors ClimaComms' "context + device" shape.

Mirrors the usage in ``/root/reference/test/gpu_tests.jl:3-4`` and the
ClimaComms dev guide (``docs/dev-guides/AGENTS.md:51``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = [
    "initialize_distributed",
    "column_mesh",
    "column_sharding",
    "replicated",
    "shard_columns",
]

COLUMN_AXIS = "columns"


def _distributed_is_initialized() -> bool:
    """True iff ``jax.distributed.initialize`` has already run."""
    # Public API first (added in newer JAX); fall back to probing the
    # private global state, and treat any relocation of that module in a
    # future JAX as "not initialized" rather than an import-time failure.
    is_init = getattr(jax.distributed, "is_initialized", None)
    if callable(is_init):
        return bool(is_init())
    try:
        state = getattr(jax._src.distributed, "global_state", None)
        return state is not None and state.client is not None
    except AttributeError:
        return False


def initialize_distributed(**kwargs) -> None:
    """Multi-host initialization (``jax.distributed.initialize``).

    Call once at program start. Idempotent: a second call is a no-op.
    With no arguments on a plain single host (no cluster environment for
    JAX to auto-detect) this is a no-op, so drivers can call it
    unconditionally. When the caller supplies explicit coordination
    arguments, genuine failures (bad coordinator address, port clash, ...)
    propagate — they are configuration errors the caller must see.
    """
    if _distributed_is_initialized():
        return
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        if kwargs:
            raise  # explicit configuration that failed: surface it
        # bare call on a single host: either no auto-detectable cluster
        # ("coordinator_address should be defined", ValueError) or the XLA
        # backend is already up single-process (RuntimeError) — expected
        # no-op in both cases


def column_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over all (or the given) devices along ``columns``."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (COLUMN_AXIS,))


def column_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (column) axis across the mesh."""
    return NamedSharding(mesh, PartitionSpec(COLUMN_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully replicated sharding (e.g. for scalars / parameters)."""
    return NamedSharding(mesh, PartitionSpec())


def shard_columns(tree, mesh: Mesh):
    """Place every array leaf with its leading axis sharded over columns."""
    sh = column_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), tree)
