"""Column model driver (L6): ``(ncol, nlev)`` arrays + sedimentation.

The reference library is pointwise; the host model applies terminal
velocities in an upwind vertical flux (see
``/root/reference/test/gpu_clima_core_test.jl:34-40`` mimicking the
ClimaAtmos use). This module supplies that host-model role:

* state is a pytree of device-resident ``(ncol, nlev)`` arrays;
* all process rates are one fused elementwise pass (BMT-1M);
* sedimentation is a first-order upwind donor-cell flux — a per-column
  *shift*, not a scan: level k receives the flux from level k+1 above, so
  the whole update is ``roll`` + elementwise, which XLA fuses with the
  process kernel. Zero cross-column communication; columns shard freely
  over the device mesh (pure data parallelism, SURVEY.md §2.5).

Convention: level index k increases upward (k = 0 is the surface);
hydrometeors fall toward k = 0. The flux through the bottom interface is
the surface precipitation rate diagnostic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import Array

from ..ops import m1 as CM1
from ..ops import noneq as CMNonEq
from ..ops import thermo as TDI
from ..parameters.m1 import Microphysics1MParams
from ..parameters.terminal_velocity import TerminalVelocityParams
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..ops.states import MicroState, ThermoState
from . import tendencies as BMT

__all__ = ["ColumnState", "ColumnState2M", "ColumnStateP3",
           "sedimentation_tendency", "step_column_1m", "step_column_2m",
           "step_column_p3", "surface_precip_rate"]


class ColumnState(NamedTuple):
    """Prognostic column state; every field is ``(ncol, nlev)``."""

    rho: Array     # air density [kg/m^3] (held fixed)
    T: Array       # temperature [K]
    q_tot: Array
    q_lcl: Array
    q_icl: Array
    q_rai: Array
    q_sno: Array


def sedimentation_tendency(rho, q, w, dz):
    """Upwind donor-cell sedimentation: ``dq/dt = (F_in - F_out)/(rho dz)``
    with ``F_k = rho_k w_k q_k`` falling downward (toward k = 0).

    The incoming flux at level k is the outgoing flux of level k+1; the top
    level has no inflow. Implemented as a shift along the level axis —
    elementwise + static slice, fully fusable.
    """
    F = rho * w * q  # downward mass flux [kg/m^2/s]
    return _flux_divergence(F, _from_level_above(F), rho, dz)


def _from_level_above(F):
    """Inflow at each level: the flux of the level above; the top gets 0."""
    return jnp.concatenate([F[..., 1:], jnp.zeros_like(F[..., :1])], axis=-1)


def _flux_divergence(F, F_in, rho, dz):
    return (F_in - F) / (rho * dz)


def surface_precip_rate(state: ColumnState, mp: Microphysics1MParams,
                        tv: TerminalVelocityParams):
    """Surface rain + snow flux [kg/m^2/s] (positive down)."""
    q_rai0 = state.q_rai[..., 0]
    q_sno0 = state.q_sno[..., 0]
    rho0 = state.rho[..., 0]
    w_rai = CM1.terminal_velocity(
        mp.precip.rain, mp.terminal_velocity.rain, rho0, q_rai0)
    w_sno = CM1.terminal_velocity(
        mp.precip.snow, mp.terminal_velocity.snow, rho0, q_sno0)
    return rho0 * (w_rai * q_rai0 + w_sno * q_sno0)


def step_column_1m(
    state: ColumnState,
    mp: Microphysics1MParams,
    tps: ThermodynamicsParameters,
    tv: TerminalVelocityParams,
    dt,
    dz,
    mode: str = "instantaneous",
    nsub: int = 1,
    sediment_cloud: bool = True,
) -> ColumnState:
    """One explicit Euler step: fused process rates + sedimentation.

    Everything is one jit-able function of the column state, the natural
    unit for sharding over the column axis.
    """
    return _step_1m(state, mp, tps, tv, dt, dz, mode, nsub, sediment_cloud,
                    lambda F: tuple(map(_from_level_above, F)))


def _psd_1m(state: ColumnState, mp: Microphysics1MParams):
    """Clamped micro state and PSD parameters of a 1M column state."""
    # the clamps mirror microphysics_source_terms_1m so the shared sd is
    # identical
    from ..utils.special import clamp_to_nonneg

    micro = MicroState(
        clamp_to_nonneg(state.q_tot), clamp_to_nonneg(state.q_lcl),
        clamp_to_nonneg(state.q_icl), clamp_to_nonneg(state.q_rai),
        clamp_to_nonneg(state.q_sno))
    thermo = ThermoState(clamp_to_nonneg(state.rho), state.T)
    return micro, CM1.size_distr_parameters(mp, micro, thermo)


def _sed_fluxes_1m(state: ColumnState, sd, mp, tv, sediment_cloud: bool):
    """Downward mass fluxes ``rho w q`` of ``(q_lcl, q_icl, q_rai, q_sno)``.

    ``sd`` is the state's :class:`SizeDistParams`, shared with the process
    rates. Without ``sediment_cloud`` only the rain and snow fluxes are
    returned.
    """
    # terminal velocities per reference src/parameters/TerminalVelocity.jl:
    # 356-366 usage table
    w_rai = CM1.terminal_velocity(
        mp.precip.rain, mp.terminal_velocity.rain, state.rho, state.q_rai,
        v0=sd.v0_rai, lambda_inv=sd.lambda_inv_rai,
        log_lambda_inv=sd.log_lambda_inv_rai)
    w_sno = CM1.terminal_velocity(
        mp.precip.snow, mp.terminal_velocity.snow, state.rho, state.q_sno,
        v0=sd.v0_sno, lambda_inv=sd.lambda_inv_sno,
        log_lambda_inv=sd.log_lambda_inv_sno)
    pairs = [(w_rai, state.q_rai), (w_sno, state.q_sno)]
    if sediment_cloud:
        w_lcl = CMNonEq.terminal_velocity(
            mp.cloud.liquid, tv.stokes, state.rho, state.q_lcl)
        w_icl = CMNonEq.terminal_velocity(
            mp.cloud.ice, tv.chen2022.small_ice, state.rho, state.q_icl)
        pairs = [(w_lcl, state.q_lcl), (w_icl, state.q_icl)] + pairs
    return tuple(state.rho * w * q for w, q in pairs)


def _step_1m(state, mp, tps, tv, dt, dz, mode, nsub, sediment_cloud,
             inflow):
    """:func:`step_column_1m` with the level-above inflow supplied by
    ``inflow(fluxes) -> fluxes_in`` (a kernel that cannot shift a tile
    along the level axis computes it from a shifted load instead)."""
    micro, sd = _psd_1m(state, mp)

    rates = BMT.bulk_tendencies_1m(
        mp, tps, state.rho, state.T,
        state.q_tot, state.q_lcl, state.q_icl, state.q_rai, state.q_sno,
        mode=mode, dt=dt, nsub=nsub,
        sd=sd if mode != "linearized_average" else None,
    )

    # sedimentation shares the PSD solve with the process rates
    F = _sed_fluxes_1m(state, sd, mp, tv, sediment_cloud)
    sed = [_flux_divergence(f, f_in, state.rho, dz)
           for f, f_in in zip(F, inflow(F))]
    if not sediment_cloud:
        sed = [jnp.zeros_like(state.q_lcl)] * 2 + sed
    sed_lcl, sed_icl, sed_rai, sed_sno = sed

    q_lcl = state.q_lcl + dt * (rates.dq_lcl_dt + sed_lcl)
    q_icl = state.q_icl + dt * (rates.dq_icl_dt + sed_icl)
    q_rai = state.q_rai + dt * (rates.dq_rai_dt + sed_rai)
    q_sno = state.q_sno + dt * (rates.dq_sno_dt + sed_sno)

    # latent heating from phase changes (vapor <-> condensate terms only
    # enter via the aggregated cloud tendencies here; full energy coupling
    # lives in the host model). T-dependent latent heats and moist cp match
    # the process rates (ops/thermo mirrors reference
    # src/ThermodynamicsInterface.jl:9-125), not the dry constants.
    Lv = TDI.latent_heat_vapor(tps, state.T)
    Ls = TDI.latent_heat_sublim(tps, state.T)
    cp = TDI.cp_m(tps, micro.q_tot, micro.q_lcl + micro.q_rai,
                  micro.q_icl + micro.q_sno)
    T_new = state.T + dt * (
        Lv * (rates.dq_lcl_dt + rates.dq_rai_dt)
        + Ls * (rates.dq_icl_dt + rates.dq_sno_dt)
    ) / cp

    # total water loses what falls out (sedimentation of all species)
    q_tot = state.q_tot + dt * (sed_lcl + sed_icl + sed_rai + sed_sno)

    clamp = lambda q: jnp.maximum(q, jnp.zeros_like(q))
    return ColumnState(
        rho=state.rho, T=T_new, q_tot=clamp(q_tot),
        q_lcl=clamp(q_lcl), q_icl=clamp(q_icl),
        q_rai=clamp(q_rai), q_sno=clamp(q_sno),
    )


class ColumnState2M(NamedTuple):
    """2-moment prognostic column; every field is ``(ncol, nlev)``."""

    rho: Array
    T: Array
    q_tot: Array
    q_lcl: Array
    n_lcl: Array   # specific droplet number [1/kg]
    q_rai: Array
    n_rai: Array


def step_column_2m(state: "ColumnState2M", mp, tps: ThermodynamicsParameters,
                   dt, dz, impl: str = "xla") -> "ColumnState2M":
    """One explicit Euler step of the SB2006 warm-rain column: fused
    process rates + number- and mass-weighted rain sedimentation
    (the 2M analog of :func:`step_column_1m`; velocities per reference
    src/Microphysics2M.jl:685-739, applied in the host-model upwind flux).

    ``impl`` selects the compiled form (identical math):

    * ``"xla"`` (default) — XLA's fusion of the jnp step; any backend;
    * ``"pallas"`` — the Triton-route kernel
      (:func:`..kernels.column2m.step_column_2m_triton`), faster on the
      GPU (PERF.md); needs a GPU and a power-of-two ``nlev``, and raises
      on any other backend.
    """
    if impl == "pallas":
        import jax

        from ..kernels.column2m import step_column_2m_triton

        if jax.default_backend() != "gpu":
            raise ValueError(
                "impl='pallas' compiles for the GPU; the backend is "
                f"{jax.default_backend()!r}")
        return step_column_2m_triton(state, mp, tps, dt, dz)
    if impl != "xla":
        raise ValueError(f"unknown impl {impl!r} (expected 'xla'|'pallas')")
    return _step_2m(state, mp, tps, dt, dz,
                    lambda F: tuple(map(_from_level_above, F)))


def _sed_fluxes_2m(state: "ColumnState2M", mp):
    """Downward rain mass and number fluxes ``rho w q``, ``rho w n``."""
    from ..ops import m2 as CM2

    vt_n, vt_m = CM2.rain_terminal_velocity(
        mp.warm_rain.seifert_beheng, _chen_or_sb(mp), state.q_rai,
        state.rho, state.n_rai * state.rho)
    return state.rho * vt_m * state.q_rai, state.rho * vt_n * state.n_rai


def _step_2m(state, mp, tps, dt, dz, inflow):
    """:func:`step_column_2m` with the level-above inflow supplied by
    ``inflow(fluxes) -> fluxes_in`` (see :func:`_step_1m`)."""
    rates = BMT.bulk_tendencies_2m(
        mp, tps, state.rho, state.T, state.q_tot, state.q_lcl, state.n_lcl,
        state.q_rai, state.n_rai)

    F = _sed_fluxes_2m(state, mp)
    sed_q_rai, sed_n_rai = (_flux_divergence(f, f_in, state.rho, dz)
                            for f, f_in in zip(F, inflow(F)))

    clamp = lambda q: jnp.maximum(q, jnp.zeros_like(q))
    Lv = TDI.latent_heat_vapor(tps, state.T)
    cp = TDI.cp_m(tps, state.q_tot, state.q_lcl + state.q_rai,
                  jnp.zeros_like(state.q_lcl))
    T_new = state.T + dt * Lv / cp * (rates.dq_lcl_dt + rates.dq_rai_dt)
    return ColumnState2M(
        rho=state.rho, T=T_new,
        q_tot=clamp(state.q_tot + dt * sed_q_rai),
        q_lcl=clamp(state.q_lcl + dt * rates.dq_lcl_dt),
        n_lcl=clamp(state.n_lcl + dt * rates.dn_lcl_dt),
        q_rai=clamp(state.q_rai + dt * (rates.dq_rai_dt + sed_q_rai)),
        n_rai=clamp(state.n_rai + dt * (rates.dn_rai_dt + sed_n_rai)),
    )


def _chen_or_sb(mp):
    """Rain fall-speed parameterization for the 2M column, taken from the
    params tree (``mp.warm_rain.terminal_velocity``): SB2006 Rogers-type
    or Chen2022 (reference src/Microphysics2M.jl:685-739 dispatch),
    selected via ``microphysics_2m_params(rain_velocity=...)``."""
    from ..parameters.terminal_velocity import SB2006VelType

    vel = getattr(mp.warm_rain, "terminal_velocity", None)
    return SB2006VelType() if vel is None else vel


class ColumnStateP3(NamedTuple):
    """2M warm rain + P3 ice prognostic column; fields are ``(ncol, nlev)``.

    Prognostics follow the P3 sandbox + 2M coupling of the reference
    (``src/BulkMicrophysicsTendencies.jl:898-930``, ``p3_sandbox``): SB2006
    cloud/rain mass & number plus the four P3 ice variables (ice mass,
    ice number, rime mass, rime volume), all specific (per kg of air).
    """

    rho: Array
    T: Array
    q_tot: Array
    q_lcl: Array
    n_lcl: Array
    q_rai: Array
    n_rai: Array
    q_ice: Array   # total ice specific content [kg/kg]
    n_ice: Array   # ice specific number [1/kg]
    q_rim: Array   # rime mass [kg/kg]
    b_rim: Array   # rime volume [m^3/kg]


def step_column_p3(state: "ColumnStateP3", mp, tps: ThermodynamicsParameters,
                   dt, dz, loglambda_guess=None, col_chunks: int = None):
    """One explicit Euler step of the full 2M warm rain + P3 ice column.

    Per step: (1) solve the P3 PSD slope ``log lambda`` per cell (fixed-
    iteration Brent, warm-startable from the previous step — the
    substepping semantics of reference ``src/P3_size_distribution.jl:284``,
    with the solve held out of AD exactly as the reference's tests pin,
    ``test/ad_compat_tests.jl:16-19``); (2) fused 2M+P3 process rates;
    (3) upwind sedimentation with number-/mass-weighted fall speeds for
    rain (SB2006) and ice (P3 quadrature, Chen2022 + aspect ratio).

    Returns ``(new_state, loglambda)`` so the host can warm-start the
    next step's shape solve.

    ``col_chunks``: optionally evaluate the step over that many
    ``ncol`` chunks via :func:`..perf.chunked_cells` (identical math;
    bounds the working set of the shared node tables; the benchmarks use
    ~16k grid points per chunk).
    ``ncol`` must be divisible by it. On a multi-device mesh apply the
    chunking per shard — call this inside ``jax.shard_map`` over the
    columns axis (see perf.chunked_cells docstring) — so the sequential
    chunk loop never spans device boundaries.
    """
    import jax

    if col_chunks:
        from ..perf import chunked_cells

        return chunked_cells(
            lambda s, g: step_column_p3(s, mp, tps, dt, dz, g),
            col_chunks)(state, loglambda_guess)

    from ..ops import m2 as CM2
    from ..ops import p3 as P3
    from .p3_tendencies import p3_step_aux

    ice = mp.ice
    sb = mp.warm_rain.seifert_beheng
    rho = state.rho

    L_ice = state.q_ice * rho
    N_ice = state.n_ice * rho
    L_rim = state.q_rim * rho
    B_rim = state.b_rim * rho
    pstate = P3.state_from_prognostic(ice.scheme, L_ice, N_ice, L_rim, B_rim)
    loglam = jax.lax.stop_gradient(
        P3.get_distribution_loglambda(pstate, loglambda_guess))

    # ONE sanitized state + ice node table for the whole step: the
    # tendency assembly and the sedimentation velocities contract the
    # same bounds/velocity/PSD tables. Cells without real ice get
    # placeholder velocities from the sanitized state, but their
    # sedimentation fluxes are exactly zero (flux = rho w q with q = 0).
    aux = p3_step_aux(mp, rho, state.q_ice, state.n_ice, state.q_rim,
                      state.b_rim, loglam)

    rates = BMT.bulk_tendencies_2m(
        mp, tps, rho, state.T, state.q_tot, state.q_lcl, state.n_lcl,
        state.q_rai, state.n_rai, state.q_ice, state.n_ice,
        state.q_rim, state.b_rim, loglam, p3_aux=aux)

    # rain sedimentation (SB2006 number/mass-weighted fall speeds)
    vt_n_rai, vt_m_rai = CM2.rain_terminal_velocity(
        sb, _chen_or_sb(mp), state.q_rai, rho, state.n_rai * rho)
    sed_q_rai = sedimentation_tendency(rho, state.q_rai, vt_m_rai, dz)
    sed_n_rai = sedimentation_tendency(rho, state.n_rai, vt_n_rai, dz)

    # ice sedimentation: P3 bulk fall speeds; rime advects with the bulk
    # ice mass flux (single-category scheme — all ice falls together)
    vt_n_ice = P3.ice_terminal_velocity_number_weighted(
        ice.terminal_velocity, rho, aux.state, aux.loglam, nodes=aux.nodes)
    vt_m_ice = P3.ice_terminal_velocity_mass_weighted(
        ice.terminal_velocity, rho, aux.state, aux.loglam, nodes=aux.nodes)
    sed_q_ice = sedimentation_tendency(rho, state.q_ice, vt_m_ice, dz)
    sed_n_ice = sedimentation_tendency(rho, state.n_ice, vt_n_ice, dz)
    sed_q_rim = sedimentation_tendency(rho, state.q_rim, vt_m_ice, dz)
    sed_b_rim = sedimentation_tendency(rho, state.b_rim, vt_m_ice, dz)

    Lv = TDI.latent_heat_vapor(tps, state.T)
    Lf = TDI.latent_heat_fusion(tps, state.T)
    cp = TDI.cp_m(tps, state.q_tot, state.q_lcl + state.q_rai, state.q_ice)
    T_new = state.T + dt * (
        Lv * (rates.dq_lcl_dt + rates.dq_rai_dt + rates.dq_ice_dt)
        + Lf * rates.dq_ice_dt) / cp

    clamp = lambda q: jnp.maximum(q, jnp.zeros_like(q))
    new = ColumnStateP3(
        rho=rho, T=T_new,
        q_tot=clamp(state.q_tot
                    + dt * (sed_q_rai + sed_q_ice)),
        q_lcl=clamp(state.q_lcl + dt * rates.dq_lcl_dt),
        n_lcl=clamp(state.n_lcl + dt * rates.dn_lcl_dt),
        q_rai=clamp(state.q_rai + dt * (rates.dq_rai_dt + sed_q_rai)),
        n_rai=clamp(state.n_rai + dt * (rates.dn_rai_dt + sed_n_rai)),
        q_ice=clamp(state.q_ice + dt * (rates.dq_ice_dt + sed_q_ice)),
        n_ice=clamp(state.n_ice + dt * (rates.dn_ice_dt + sed_n_ice)),
        q_rim=clamp(state.q_rim + dt * (rates.dq_rim_dt + sed_q_rim)),
        b_rim=clamp(state.b_rim + dt * (rates.db_rim_dt + sed_b_rim)),
    )
    # rime invariants: q_rim <= q_ice, b_rim consistent
    new = new._replace(q_rim=jnp.minimum(new.q_rim, new.q_ice))
    return new, loglam
