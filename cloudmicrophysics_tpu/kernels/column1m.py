"""Fused 1M column step as a Pallas kernel for the GPU's Triton route.

Each program steps a ``(block_cols, nlev)`` tile of all seven prognostic
fields with the *same* jnp physics as
:func:`cloudmicrophysics_tpu.models.column.step_column_1m`. The Triton
route cannot shift a tile along the level axis, so the sedimentation
inflow of level k is computed from a second load of the tile offset by one
level (masked at the top level), which recomputes the fall speeds of the
level above.
"""

from __future__ import annotations

import functools

from ..models.column import ColumnState, _psd_1m, _sed_fluxes_1m, _step_1m
from ._column import column_step_call

__all__ = ["step_column_1m_triton"]


def step_column_1m_triton(state: ColumnState, mp, tps, tv, dt, dz,
                          mode: str = "instantaneous", nsub: int = 1,
                          sediment_cloud: bool = True,
                          interpret: bool = False) -> ColumnState:
    """Triton-route version of ``step_column_1m`` (same signature, plus
    ``interpret`` for CPU tests). ``nlev`` must be a power of two.

    Measured on an H100 at 524,288 x 128 f32: 4.44-4.56 ms per step
    against 9.57-9.65 ms for XLA's fusion of ``step_column_1m`` (400 W
    power limit; PERF.md)."""
    step = functools.partial(_step_1m, mp=mp, tps=tps, tv=tv, dt=dt, dz=dz,
                             mode=mode, nsub=nsub,
                             sediment_cloud=sediment_cloud)

    def fluxes(s):
        return _sed_fluxes_1m(s, _psd_1m(s, mp)[1], mp, tv, sediment_cloud)

    return column_step_call(
        state, lambda s, inflow: step(s, inflow=inflow), fluxes,
        interpret=interpret)
