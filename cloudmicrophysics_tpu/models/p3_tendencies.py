"""2-moment + P3 ice fused tendencies.

JAX port of ``/root/reference/src/BulkMicrophysicsTendencies.jl:898-1083``:
warm-rain SB2006 tendencies plus the P3 ice processes — liquid-ice
collisions, ice self-collection, melting, F23 deposition nucleation,
F23-capped Bigg immersion freezing, sublimation/deposition relaxation with
rime drain, ice number adjustment, and Bigg rain freezing.

``loglambda`` is an *input* (solved outside — substepping semantics; AD
holds it fixed, matching the reference's contract). The reference gates
the expensive collision block behind ``q_ice > eps``; here the block is
computed unconditionally on sanitized state and masked — the branchless
equivalent (all cells of a batch run the same code path).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..ops import ice_nucleation as CM_HetIce
from ..ops import m2 as CM2
from ..ops import p3 as P3
from ..ops import p3_processes as P3P
from ..ops import thermo as TDI
from ..ops.noneq import _relaxation_tendency, dqcld_dT, gamma_helper
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import (
    clamp_to_nonneg,
    eps_numerics_2M_M,
    eps_numerics_2M_N,
    float_dtype,
)
from .tendencies import Tendencies2M

TPS = ThermodynamicsParameters
PI = jnp.pi


def _subdep_rate(tau, tps, rho, T, q_tot, q_lcl, q_rai, q_ice):
    """Constant-timescale ice dep/subl relaxation (reference
    CMNonEq._conv_q_vap_to_q_icl_const without the INP limiter — the
    BMT applies its own above-freezing clamp)."""
    Rv = tps.R_v
    Ls = TDI.latent_heat_sublim(tps, T)
    cp_air = TDI.cp_m(tps, q_tot, q_lcl + q_rai, q_ice)
    qv = TDI.q_vap(q_tot, q_lcl + q_rai, q_ice)
    qv_sat = TDI.saturation_vapor_specific_content_over_ice(tps, T, rho)
    Gamma_i = gamma_helper(Ls, cp_air, dqcld_dT(qv_sat, Ls, Rv, T))
    timescale = tau * Gamma_i
    return _relaxation_tendency(qv - qv_sat, q_ice, timescale, timescale)


class P3StepAux(NamedTuple):
    """Step-shared sanitized P3 evaluation context.

    Built once per step (``p3_step_aux``) and reused by the tendency
    assembly AND the column driver's sedimentation velocities — one
    state construction, one bounds solve, one velocity/PSD node-table
    evaluation for everything that contracts the ice PSD.
    """

    state: object     # sanitized P3State
    loglam: object    # sanitized log_lambda
    has_ice: object   # mask of cells with real ice
    nodes: object     # IceQuadNodes on the sanitized state


def p3_step_aux(mp, rho, q_ice, n_ice, q_rim, b_rim,
                log_lambda) -> P3StepAux:
    """Sanitized state + shared quadrature nodes for one P3 step.

    Placeholder values keep every intermediate finite where ice is
    absent; consumers mask with ``has_ice`` (the branchless equivalent
    of the reference's ``q_ice > eps`` gate)."""
    dt = float_dtype(rho, q_ice)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    q_ice = clamp_to_nonneg(q_ice)
    n_ice = clamp_to_nonneg(n_ice)
    L_ice, N_ice = q_ice * rho, n_ice * rho
    L_rim, B_rim = clamp_to_nonneg(q_rim) * rho, clamp_to_nonneg(b_rim) * rho
    has_ice = (q_ice > em) & (n_ice > en)
    L_ice_s = jnp.where(has_ice, L_ice, 1e-6)
    N_ice_s = jnp.where(has_ice, N_ice, 1e3)
    L_rim_s = jnp.where(has_ice, L_rim, 0.0)
    B_rim_s = jnp.where(has_ice, B_rim, 0.0)
    loglam_s = jnp.where(has_ice & jnp.isfinite(log_lambda),
                         log_lambda, 8.0)
    state = P3.state_from_prognostic(mp.ice.scheme, L_ice_s, N_ice_s,
                                     L_rim_s, B_rim_s)
    nodes = P3.ice_quadrature_nodes(mp.ice.terminal_velocity, rho, state,
                                    loglam_s, p=1e-6, quad=mp.ice.quad)
    # Pin the shared tables as materialized values: without the barrier
    # XLA duplicates the whole bounds-solve + velocity/PSD node-table
    # producer chain into EVERY consumer fusion (collisions, self-
    # collection, melt, sedimentation velocities) — measured ~2x the
    # transcendental volume of the full 2M+P3 step at GL-16. Only the
    # cell-shaped arrays go through the barrier (the params pytree keeps
    # its Python-float leaves as trace-time constants).
    # CMT_NO_AUX_BARRIER=1 disables it (A/B knob: recompute-in-consumers
    # vs materialize-to-device-memory; not yet measured on the GPU).
    import os as _os

    import jax as _jax

    if not _os.environ.get("CMT_NO_AUX_BARRIER"):
        # Only the table streams every consumer actually contracts (D,
        # v, n*w, bnds) go through the barrier; the raw n and w columns
        # stay unbarriered pass-throughs so they dead-code-eliminate
        # when nothing downstream reads them.
        (arrs, loglam_s, has_ice, nd) = _jax.lax.optimization_barrier((
            (state.rho_q_ice, state.rho_n_ice, state.F_rim, state.rho_rim,
             state.rho_g, state.D_th, state.D_gr, state.D_cr),
            loglam_s, has_ice, (nodes.D, nodes.v, nodes.nw, nodes.bnds)))
        state = P3.P3State(state.params, *arrs)
        nodes = P3.IceQuadNodes(D=nd[0], w=nodes.w, v=nd[1], n=nodes.n,
                                nw=nd[2], bnds=nd[3])
    return P3StepAux(state=state, loglam=loglam_s, has_ice=has_ice,
                     nodes=nodes)


def ice_tendencies_2m_p3(
    mp, tps: TPS, rho, T, q_tot, q_lcl, n_lcl, q_rai, n_rai,
    q_ice, n_ice, q_rim, b_rim, log_lambda, inpc_log_shift, warm,
    aux: P3StepAux = None,
) -> Tendencies2M:
    """Add the P3 ice tendencies to precomputed warm-rain tendencies."""
    dt = float_dtype(rho, T)
    em = eps_numerics_2M_M(dt)
    zero = jnp.zeros_like(jnp.asarray(rho) * jnp.asarray(T))

    q_ice = zero if q_ice is None else clamp_to_nonneg(q_ice)
    n_ice = zero if n_ice is None else clamp_to_nonneg(n_ice)
    q_rim = zero if q_rim is None else clamp_to_nonneg(q_rim)
    b_rim = zero if b_rim is None else clamp_to_nonneg(b_rim)
    log_lambda = zero if log_lambda is None else jnp.asarray(log_lambda, dt)
    inpc_log_shift = zero if inpc_log_shift is None \
        else jnp.asarray(inpc_log_shift, dt)

    dq_lcl_dt, dn_lcl_dt, dq_rai_dt, dn_rai_dt = warm

    ice = mp.ice
    p3 = ice.scheme
    vel = ice.terminal_velocity
    pdf_c, pdf_r = ice.cloud_pdf, ice.rain_pdf
    quad = ice.quad

    # volumetric quantities
    L_lcl, L_rai = q_lcl * rho, q_rai * rho
    N_lcl, N_rai = n_lcl * rho, n_rai * rho

    if aux is None:
        aux = p3_step_aux(mp, rho, q_ice, n_ice, q_rim, b_rim, log_lambda)
    state, loglam_s, has_ice, ice_nodes = (
        aux.state, aux.loglam, aux.has_ice, aux.nodes)

    dq_ice_dt = zero
    dn_ice_dt = zero
    dq_rim_dt = zero
    db_rim_dt = zero

    # --- Liquid-ice collisions (masked) ---
    coll = P3P.bulk_liquid_ice_collision_sources(
        state, loglam_s, pdf_c, pdf_r, L_lcl, N_lcl, L_rai, N_rai,
        mp.warm_rain.air_properties, tps, vel, rho, T, quad=quad,
        ice_nodes=ice_nodes)
    mask = lambda v: jnp.where(has_ice, v, zero)
    dq_lcl_dt = dq_lcl_dt + mask(coll.dq_c)
    dq_rai_dt = dq_rai_dt + mask(coll.dq_r)
    dn_lcl_dt = dn_lcl_dt + mask(coll.dN_c) / rho
    dn_rai_dt = dn_rai_dt + mask(coll.dN_r) / rho
    dq_ice_dt = dq_ice_dt + mask(coll.dL_ice) / rho
    dq_rim_dt = dq_rim_dt + mask(coll.dL_rim) / rho
    db_rim_dt = db_rim_dt + mask(coll.dB_rim) / rho

    # --- Ice self-collection (aggregation) ---
    agg = P3P.ice_self_collection(state, loglam_s, vel, rho, quad=quad,
                                  nodes=ice_nodes)
    dn_ice_dt = dn_ice_dt - mask(agg) / rho

    # --- Melting (above freezing) ---
    melt_dN, melt_dL = P3P.ice_melt(vel, mp.warm_rain.air_properties, tps,
                                    T, rho, state, loglam_s, quad=quad,
                                    nodes=ice_nodes)
    is_warm = T > tps.T_freeze
    melt_mask = lambda v: jnp.where(has_ice & is_warm, v, zero)
    dq_ice_melt = melt_mask(melt_dL) / rho
    dn_ice_melt = melt_mask(melt_dN) / rho
    dq_rai_dt = dq_rai_dt + dq_ice_melt
    dn_rai_dt = dn_rai_dt + dn_ice_melt
    dq_ice_dt = dq_ice_dt - dq_ice_melt
    dn_ice_dt = dn_ice_dt - dn_ice_melt
    rho_rim_safe = jnp.where(state.rho_rim > 0, state.rho_rim,
                             jnp.ones_like(state.rho_rim))
    dq_rim_dt = dq_rim_dt - dq_ice_melt * state.F_rim
    db_rim_dt = db_rim_dt - jnp.where(
        state.rho_rim > 0, dq_ice_melt * state.F_rim / rho_rim_safe, zero)

    # --- F23 deposition nucleation (vapor -> pristine ice) ---
    # The INPC climatology comes from the params tree
    # (reference mp.ice.ice_nucleation, Microphysics2MParams.jl:65,101)
    # so perturbed/calibrated F23 parameters flow into both budgets.
    f23 = ice.ice_nucleation
    tau_act = ice.inp_depletion_model.tau_act
    D_nuc = 10e-6
    m_nuc = p3.rho_i * PI / 6 * D_nuc**3
    n_active = CM_HetIce.n_active(ice.inp_depletion_model, n_ice)
    dep_n, dep_q = CM_HetIce.deposition_rate_frostenberg(
        f23, tps, T, rho, q_tot, q_lcl + q_rai, q_ice, n_active,
        m_nuc, tau_act=tau_act, inpc_log_shift=inpc_log_shift)
    dn_ice_dt = dn_ice_dt + dep_n
    dq_ice_dt = dq_ice_dt + dep_q

    # --- F23-capped Bigg immersion freezing of cloud droplets ---
    cld_n, cld_q = CM_HetIce.liquid_freezing_rate_cloud(
        ice.rain_freezing, pdf_c, tps, q_lcl, rho, N_lcl, T)
    cap = CM_HetIce.immersion_limit_rate(
        f23, T, rho, tau=tau_act, inpc_log_shift=inpc_log_shift,
        n_active_proxy=n_active)
    dn_imm = jnp.minimum(cld_n, cap)
    cld_n_safe = jnp.where(cld_n > 0, cld_n, jnp.ones_like(cld_n))
    dq_imm = jnp.where(cld_n > 0, cld_q * dn_imm / cld_n_safe, zero)
    dq_lcl_dt = dq_lcl_dt - dq_imm
    dn_lcl_dt = dn_lcl_dt - dn_imm
    dq_ice_dt = dq_ice_dt + dq_imm
    dn_ice_dt = dn_ice_dt + dn_imm
    dq_rim_dt = dq_rim_dt + dq_imm           # frozen drop: F_rim = 1
    db_rim_dt = db_rim_dt + dq_imm / p3.rho_i

    # --- Ice sublimation / deposition relaxation ---
    q_ice_safe = jnp.where(q_ice > em, q_ice, jnp.ones_like(q_ice))
    n_per_q = jnp.where(q_ice > em, n_ice / q_ice_safe, zero)
    dq_dep = _subdep_rate(mp.warm_rain.subdep.tau_relax, tps, rho, T,
                          q_tot, q_lcl, q_rai, q_ice)
    dq_dep = jnp.where(T > tps.T_freeze, jnp.minimum(dq_dep, zero), dq_dep)
    dn_dep = jnp.where(dq_dep < 0, n_per_q * dq_dep, zero)
    dq_ice_dt = dq_ice_dt + dq_dep
    dn_ice_dt = dn_ice_dt + dn_dep
    dq_sub = jnp.minimum(dq_dep, zero)
    dq_rim_dt = dq_rim_dt + dq_sub * state.F_rim
    db_rim_dt = db_rim_dt + jnp.where(
        state.rho_rim > 0, dq_sub * state.F_rim / rho_rim_safe, zero)

    # --- Ice number adjustment (mass limits; reference
    # BulkMicrophysicsTendencies.jl:1056-1064, TODO values promoted into
    # IceNumberAdjustment on the params tree) ---
    na = ice.numadj
    dn_ice_dt = dn_ice_dt + CM2.number_tendency_from_mass_limits(
        na.x_min, na.x_max, na.tau, q_ice, n_ice)

    # --- Bigg rain freezing (fully rimed) ---
    rf_n, rf_q = CM_HetIce.liquid_freezing_rate_rain(
        ice.rain_freezing, pdf_r, tps, q_rai, rho, N_rai, T)
    dq_rai_dt = dq_rai_dt - rf_q
    dn_rai_dt = dn_rai_dt - rf_n
    dq_ice_dt = dq_ice_dt + rf_q
    dn_ice_dt = dn_ice_dt + rf_n
    dq_rim_dt = dq_rim_dt + rf_q
    db_rim_dt = db_rim_dt + rf_q / p3.rho_i

    return Tendencies2M(dq_lcl_dt, dn_lcl_dt, dq_rai_dt, dn_rai_dt,
                        dq_ice_dt, dn_ice_dt, dq_rim_dt, db_rim_dt)
