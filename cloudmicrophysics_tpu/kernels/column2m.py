"""Fused 2M warm-rain column step as a Pallas kernel for the GPU's Triton
route: the construction of :mod:`.column1m` applied to
:func:`cloudmicrophysics_tpu.models.column.step_column_2m`.
"""

from __future__ import annotations

from ..models.column import ColumnState2M, _sed_fluxes_2m, _step_2m
from ._column import column_step_call

__all__ = ["step_column_2m_triton"]


def step_column_2m_triton(state: ColumnState2M, mp, tps, dt, dz,
                          interpret: bool = False) -> ColumnState2M:
    """Triton-route version of ``step_column_2m`` (reached through
    ``step_column_2m(impl="pallas")``). ``nlev`` must be a power of two.

    Measured on an H100 at 524,288 x 128 f32: 4.93 ms per step against
    6.84-6.86 ms for XLA's fusion of the plain step (400 W power limit;
    PERF.md)."""
    return column_step_call(
        state, lambda s, inflow: _step_2m(s, mp, tps, dt, dz, inflow),
        lambda s: _sed_fluxes_2m(s, mp), interpret=interpret)
