"""P3 microphysical processes: melting, liquid-ice collisions (the roofline
double integral), and ice self-collection.

JAX port of ``/root/reference/src/P3_processes.jl``:

* :func:`het_ice_nucleation` — ABIFM immersion on cloud drops (``:20-45``);
* :func:`ice_melt` — ventilation melt integral (``:64-94``);
* :func:`bulk_liquid_ice_collision_sources` — the 2-D collision integral
  producing the 10-component integrand (QCFRZ...wet-growth indicator) with
  freezing/shedding split, the quadrature cloud inner integral, and a
  **three-mode rain inner integral** (per-cell-node quadrature /
  kink-split quadrature / the reference's closed-form incomplete-gamma
  flux sums with a crossover-diameter Brent solve) (``:152-655``);
* :func:`ice_self_collection` — cusp-split double integral (``:676-712``).

Array mapping (SURVEY.md §7 hard part #1): fixed node counts; the inner
liquid node axis is a leading array axis stacked on the outer ice node
axis, so the whole double integral is one fused (n_l x n_i x cell)
elementwise block contracted by two dots — no data-dependent trip counts.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import Array

from ..parameters.common import AirProperties
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.quadrature import QuadratureRule, default_quadrature
from ..utils.special import clamp_to_nonneg, float_dtype, machine_eps
from . import common as CO
from . import ice_nucleation as CMI
from . import m2 as CM2
from . import p3 as P3
from . import thermo as TDI

TPS = ThermodynamicsParameters
PI = jnp.pi

__all__ = [
    "het_ice_nucleation",
    "ice_melt",
    "bulk_liquid_ice_collision_sources",
    "ice_self_collection",
    "compute_max_freeze_rate",
    "compute_local_rime_density",
]


# Shared node helpers (moved to utils.quadrature so ops.p3 can build the
# once-per-step IceQuadNodes context without a circular import).
from ..utils.quadrature import nodes as _nodes  # noqa: E402
from ..utils.quadrature import segment_nodes as _segment_nodes  # noqa: E402


def _node_iter(quad: QuadratureRule, a, b):
    """Yield ``(x_j, w_j)`` per quadrature node WITHOUT materializing the
    ``(n, *shape)`` node array — inner integrals accumulate node-by-node so
    no ``(n_inner, n_outer, *cell)`` tensor ever exists (at production
    shapes that tensor is >100 MB and XLA spills it to HBM)."""
    dt = float_dtype(a, b)
    y_np, w_np = quad.nodes_weights()
    a = jnp.asarray(a, dt)
    b = jnp.asarray(b, dt)
    valid = a < b
    a_s = jnp.where(valid, a, jnp.ones_like(a))
    b_s = jnp.where(valid, b, 2 * jnp.ones_like(b))
    scale = (b_s - a_s) / 2
    mid = (a_s + b_s) / 2
    zero = jnp.zeros_like(scale)
    import numpy as _np

    if isinstance(y_np, _np.ndarray):
        # host-side rule (e.g. GaussLegendre): slice to PYTHON scalars
        # before any jnp conversion, so the nodes fold into the traced
        # arithmetic as literals
        for yj, wj in zip(y_np.reshape(-1).tolist(),
                          w_np.reshape(-1).tolist()):
            x = scale * yj + mid
            yield x, jnp.where(valid, wj * scale, zero)
        return
    # static-index slices: the tables may be traced pytree leaves
    # (Tabulated rules ride through jit), but their length is static
    y_arr = jnp.asarray(y_np, dt)
    w_arr = jnp.asarray(w_np, dt)
    # Tabulated tables bake in (1, 1) trailing broadcast axes for the
    # (ncol, nlev) tile case; drop any that exceed the cell rank so the
    # yielded nodes match the bounds' shape exactly (static shape logic)
    excess = (y_arr.ndim - 1) - jnp.ndim(scale)
    for j in range(int(y_arr.shape[0])):
        yj, wj = y_arr[j], w_arr[j]
        if excess > 0:
            yj = yj.reshape(yj.shape[excess:])
            wj = wj.reshape(wj.shape[excess:])
        x = scale * yj + mid
        yield x, jnp.where(valid, wj * scale, zero)


# ---------------------------------------------------------------------------
# Heterogeneous nucleation (reference src/P3_processes.jl:20-45)
# ---------------------------------------------------------------------------

def het_ice_nucleation(aerosol, tps: TPS, q_lcl, N_lcl, RH, T, rho_a):
    """ABIFM immersion freezing of cloud droplets. Returns
    ``(dNdt [1/m^3/s], dLdt [kg/m^3/s])``."""
    J = CMI.ABIFM_J(aerosol, RH - CO.a_w_ice(tps, T))
    A_aer = 1e-10  # assumed aerosol surface area (reference TODO)
    JA = jnp.where(jnp.isfinite(J), J * A_aer, jnp.zeros_like(J))
    dNdt = clamp_to_nonneg(JA * N_lcl)
    dLdt = clamp_to_nonneg(JA * q_lcl * rho_a)
    return dNdt, dLdt


# ---------------------------------------------------------------------------
# Melting (reference src/P3_processes.jl:64-94)
# ---------------------------------------------------------------------------

def ice_melt(velocity_params, aps: AirProperties, tps: TPS, T_a, rho_a,
             state: P3.P3State, loglambda, quad=None, nodes=None):
    """Ventilation-integral melt rate (QIMLT). Returns (dNdt, dLdt).

    Pass ``nodes`` (a step-shared :class:`P3.IceQuadNodes`) to reuse the
    bounds/velocity/PSD node tables; ``quad`` is then ignored."""
    if quad is None:
        quad = default_quadrature()
    dt = float_dtype(T_a, rho_a)
    L_f = TDI.latent_heat_fusion(tps, T_a)
    T_freeze = state.params.T_freeze
    vent = state.params.vent

    if nodes is None:
        nodes = P3.ice_quadrature_nodes(velocity_params, rho_a, state,
                                        loglambda, 1e-6, quad)
    x = nodes.D

    F_v = CO.ventilation_factor(vent, aps, nodes.v, x)
    integrand = P3.d_ice_mass_dD(state, x) * F_v * nodes.nw / x
    fac = 4 * aps.K_therm / L_f * (T_a - T_freeze)
    dLdt_raw = fac * jnp.sum(integrand, axis=0)

    dLdt = clamp_to_nonneg(dLdt_raw)  # only melting, not fusion
    q_safe = jnp.maximum(state.rho_q_ice, jnp.asarray(jnp.finfo(dt).tiny, dt))
    dNdt = state.rho_n_ice / q_safe * dLdt
    return dNdt, dLdt


# ---------------------------------------------------------------------------
# Collision machinery (reference src/P3_processes.jl:112-279)
# ---------------------------------------------------------------------------

def collision_cross_section_coeffs(state, D_i):
    """(k0, k1, k2) of ``sigma(D_i, D_l) = k0 + k1 D_l + k2 D_l^2``."""
    r_i = jnp.sqrt(P3.ice_area(state, D_i) / PI)
    return PI * r_i**2, PI * r_i, PI / 4


def compute_max_freeze_rate(aps: AirProperties, tps: TPS, velocity_params,
                            rho_a, T_a, state):
    """Musil 1970 dry-growth thermodynamic freezing limit; returns a
    function of D_i (reference src/P3_processes.jl:184-219)."""
    dt = float_dtype(rho_a, T_a)
    cp_l = tps.cp_l
    T_frz = tps.T_freeze
    Lv = TDI.latent_heat_vapor(tps, T_a)
    L_f = TDI.latent_heat_fusion(tps, T_a)
    dT = T_frz - T_a
    drho_v_sat = rho_a * (
        TDI.p2q(tps, T_frz, rho_a,
                TDI.saturation_vapor_pressure_over_ice(tps, T_frz))
        - TDI.p2q(tps, T_a, rho_a,
                  TDI.saturation_vapor_pressure_over_ice(tps, T_a)))
    v_term = P3.ice_particle_terminal_velocity(velocity_params, rho_a, state)
    denom = L_f - cp_l * dT
    big = jnp.asarray(jnp.finfo(dt).max, dt)

    def max_freeze_rate(D_i, v_at_D=None):
        # v_at_D: optional precomputed terminal velocity at D_i (shared
        # IceQuadNodes table) — skips a per-node Chen2022 re-evaluation
        v = v_term(D_i) if v_at_D is None else v_at_D
        F_v = CO.ventilation_factor(state.params.vent, aps, v, D_i)
        denom_safe = jnp.where(denom > 0, denom, jnp.ones_like(denom))
        rate = 2 * (PI * D_i) * F_v \
            * (aps.K_therm * dT + Lv * aps.D_vapor * drho_v_sat) / denom_safe
        rate = jnp.where(denom > 0, rate, big)  # cold regime: f_frz -> 1
        return jnp.where(T_a >= T_frz, jnp.zeros_like(rate), rate)

    return max_freeze_rate


def compute_local_rime_density(velocity_params, rho_a, T, state):
    """Cober & List 1993 local rime density as a function of (D_i, D_l)
    (reference src/P3_processes.jl:266-279)."""
    T_c = T - state.params.T_freeze
    v_ice = P3.ice_particle_terminal_velocity(velocity_params, rho_a, state)
    aiu, bi, ciu = CO.chen2022_vel_coeffs_rain(velocity_params.rain, rho_a)
    dt0 = float_dtype(T)
    T_c_safe = jnp.where(jnp.abs(T_c) > 0, T_c,
                         -jnp.asarray(machine_eps(dt0), dt0))
    # reciprocal hoisted to cell shape: Ri is evaluated on the full
    # (liquid x ice x cell) pair space, where a divide per pair is one
    # of the largest cheap-op terms of the collision kernel
    inv_2Tc = 1e6 / (2 * T_c_safe)

    def rho_rim_local(D_i, D_l, v_i_at=None, v_rel=None):
        # v_i_at: optional precomputed ice velocity at D_i (IceQuadNodes);
        # v_rel: optional precomputed |v_ice(D_i) - v_liq(D_l)| (skips
        # both velocity evaluations)
        if v_rel is None:
            v_liq = CO.chen2022_velocity_sum(aiu, bi, ciu, D_l)
            v_rel = jnp.abs(
                (v_ice(D_i) if v_i_at is None else v_i_at) - v_liq)
        Ri = D_l * v_rel * inv_2Tc
        return state.params.rho_rim_local(Ri)

    return rho_rim_local


# ---------------------------------------------------------------------------
# The 2-D liquid-ice collision integral
# (reference src/P3_processes.jl:283-567)
# ---------------------------------------------------------------------------

class CollisionSources(NamedTuple):
    """Bulk tendencies from liquid-ice collisions
    (reference src/P3_processes.jl:606-655)."""

    dq_c: Array      # cloud mass tendency [kg/kg/s]
    dq_r: Array      # rain mass tendency [kg/kg/s]
    dN_c: Array      # cloud number tendency [1/m^3/s]
    dN_r: Array      # rain number tendency [1/m^3/s]
    dL_rim: Array    # rime mass tendency [kg/m^3/s]
    dL_ice: Array    # ice mass tendency [kg/m^3/s]
    dB_rim: Array    # rime volume tendency [m^3/m^3/s]


def _endpoint_ladders(z0, alpha_safe, D):
    """Unregularized incomplete gammas ``gamma(z0+m, alpha D)`` (lower) and
    ``Gamma(z0+m, alpha D)`` (upper) for ``m = 0..5``, from ONE fixed-
    iteration :func:`P3.gamma_inc` evaluation per ladder.

    The lower ladder runs DOWN from ``z0+5`` via
    ``gamma(s, y) = (gamma(s+1, y) + y^s e^-y) / s`` and the upper ladder
    runs UP from ``z0`` via ``Gamma(s+1, y) = s Gamma(s, y) + y^s e^-y`` —
    both recurrences are subtraction-free (every term positive), so the
    laddered values carry the same rounding accuracy as direct evaluation
    while doing ~6x less fixed-iteration loop work. This is the dominant
    cost of the P3 collision kernel (the reference evaluates the
    flux sums moment-by-moment, src/P3_processes.jl:344-415; the ladder
    computes identical mathematics).
    """
    dt = float_dtype(alpha_safe, D)
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)
    y = alpha_safe * D
    logy = jnp.log(jnp.maximum(y, tiny))
    P_hi, _ = P3.gamma_inc(z0 + 5.0, y)
    _, Q_lo = P3.gamma_inc(z0 + 0.0, y)
    lo = [None] * 6
    up = [None] * 6
    lo[5] = P_hi * jnp.exp(P3.lgamma(z0 + 5.0))
    up[0] = Q_lo * jnp.exp(P3.lgamma(z0 + 0.0))
    for m in range(4, -1, -1):
        s = z0 + m
        lo[m] = (lo[m + 1] + jnp.exp(s * logy - y)) / s
    for m in range(5):
        s = z0 + m
        up[m + 1] = s * up[m] + jnp.exp(s * logy - y)
    return lo, up, y


def _moments_from_ladders(z0, alpha, alpha_safe, lad1, lad2, D1, D2):
    """``J_m = int_{D1}^{D2} D^(z0-1+m) e^(-alpha D) dD`` for ``m = 0..5``
    from precomputed endpoint ladders (same selection/guards as
    :func:`P3.gamma_inc_moment`: lower-gamma difference when the upper
    endpoint is left of the peak region, upper-gamma difference otherwise,
    floored at 0; 0 for collapsed intervals, NaN for alpha <= 0)."""
    dt = float_dtype(alpha, D1, D2)
    lo1, up1, _ = lad1
    lo2, up2, y2 = lad2
    log_alpha = jnp.log(alpha_safe)
    out = []
    for m in range(6):
        z = z0 + m
        d_lo = jnp.maximum(lo2[m] - lo1[m], 0.0)
        d_up = jnp.maximum(up1[m] - up2[m], 0.0)
        d = jnp.where(y2 < z + 1, d_lo, d_up)
        J = d * jnp.exp(-z * log_alpha)
        J = jnp.where(D2 > D1, J, jnp.zeros_like(J))
        out.append(jnp.where(alpha > 0, J, jnp.asarray(jnp.nan, dt)))
    return out


def _crossover_diameter(v_target, v_l_fn, D_min, D_max, dt):
    """Diameter where the liquid velocity equals ``v_target`` — fixed
    iteration Brent (reference src/P3_processes.jl:326-339)."""
    f = lambda D: v_l_fn(D) - v_target
    f_lo = f(D_min + jnp.zeros_like(v_target))
    f_hi = f(D_max + jnp.zeros_like(v_target))
    n_iters = 10 if dt == jnp.float64 else 8
    return P3._brent_fixed(f, D_min + jnp.zeros_like(v_target), f_lo,
                           D_max + jnp.zeros_like(v_target), f_hi, n_iters)


def bulk_liquid_ice_collision_sources(
    state: P3.P3State, loglambda, pdf_c, pdf_r, L_c, N_c, L_r, N_r,
    aps: AirProperties, tps: TPS, vel, rho_a, T, quad=None,
    rain_inner: str = "quadrature", ice_nodes=None,
) -> CollisionSources:
    """Bulk rates from ice-liquid collisions: nested quadrature over
    (ice nodes x liquid nodes) with the Musil freezing/shedding split and
    wet-growth densification (reference src/P3_processes.jl:533-655).

    The cloud inner integral uses quadrature. The rain inner integral
    (``rain_inner``) is one of

    * ``"quadrature"`` (default): Gauss nodes over the per-CELL rain
      window ``[r_lo, r_hi]`` — the node positions are independent of
      the ice node, so the transcendental factors (Chen2022 rain
      velocity, rain PSD, drop mass) are evaluated once per liquid node
      and broadcast across the whole ice axis; the (ice x liquid) cross
      space is pure polynomial arithmetic. The ``|v_i - v_l|`` kink is
      integrated through un-split: the rain PSD decays fast enough that
      the kink neighborhood carries little mass (measured <=3e-3
      relative on the bulk moments at GL-8 vs a GL-64 split reference —
      an order below the GL-8 quadrature-ladder gate). No crossover
      solve needed;
    * ``"quadrature_split"``: Gauss nodes split at the velocity-
      crossover diameter ``D*`` (fixed-iteration Brent) — each side of
      the kink is smooth, so per-segment quadrature converges
      spectrally (matches the closed form to 1e-11 at f64/GL-16). ``D*``
      depends on the ice node, so every liquid-node factor is
      re-evaluated per (ice node, cell) — ~3x the transcendental
      volume of ``"quadrature"``;
    * ``"closed_form"``: the reference's incomplete-gamma flux sums
      (``src/P3_processes.jl:326-427``) via shared two-sided endpoint
      ladders — the exactness anchor; each incomplete gamma is a fixed
      40-iteration series/continued-fraction loop on the VPU, ~15x the
      cost of the split quadrature.

    ``tests/test_p3_processes.py`` pins all three against each other.

    The liquid (inner) axis of the two default cross spaces runs at HALF
    the ice order (floor 8): the liquid integrands are single-window and
    smooth apart from the integrated-through rain kink, so their
    quadrature error is far below the ice axis' regime-kink error, while
    every liquid node multiplies the whole (liquid x ice x cell) pair
    space — the single largest wall-time term of the fused P3 step
    measured so far. ``"quadrature_split"``/``"closed_form"`` keep the full order
    (they are the accuracy anchors).
    """
    if quad is None:
        quad = default_quadrature()
    from ..utils.quadrature import GaussLegendre

    liquid_quad = GaussLegendre(max(quad.n // 2, 8)) \
        if quad.n > 8 else quad
    dt = float_dtype(rho_a, T)
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)
    tau_wet = state.params.tau_wet
    rho_i = state.params.rho_i
    D_shd = 1e-3  # shed drop size [m] (reference TODO)
    rho_w = pdf_c.rho_w

    m_liq = lambda D: rho_w * CO.volume_sphere_D(D)

    # PSDs
    n_c = lambda D: CM2.size_distribution_cloud(pdf_c, L_c / rho_a, rho_a,
                                                N_c, D)

    # One tail quantile for every entry point: the same physical inputs
    # must give the same collision sources whether or not a shared node
    # table is passed (the shared IceQuadNodes context also pins 1e-6).
    p = 1e-6
    c_lo, c_hi = CM2.size_distribution_bounds_cloud(pdf_c, L_c / rho_a,
                                                    rho_a, N_c, p)
    r_lo, r_hi = CM2.size_distribution_bounds_rain(pdf_r, L_r / rho_a,
                                                   rho_a, N_r, p)

    # velocities
    aiu, bi, ciu = CO.chen2022_vel_coeffs_rain(vel.rain, rho_a)
    v_liq = lambda D: CO.chen2022_velocity_sum(aiu, bi, ciu, D)

    rho_rim_loc = compute_local_rime_density(vel, rho_a, T, state)
    max_frz = compute_max_freeze_rate(aps, tps, vel, rho_a, T, state)

    # --- outer ice nodes: (n_i_nodes, *cell) ---
    if ice_nodes is None:
        ice_nodes = P3.ice_quadrature_nodes(vel, rho_a, state, loglambda,
                                            p, quad)
    Di = ice_nodes.D
    v_i_at_Di = ice_nodes.v
    k0, k1, k2 = collision_cross_section_coeffs(state, Di)

    # --- cloud inner integral by quadrature: liquid axis leads (XLA
    # fuses the broadcast + reduction without materializing the full
    # (n_l, n_ice_nodes, *cell) tensor) ---
    Dl_c, wl_c = _nodes(liquid_quad, c_lo, c_hi)   # (n_l, *cell)
    Dl = Dl_c[:, None]                          # (n_l, 1, *cell)
    # quadrature weight and mass folded into the per-NODE factors so the
    # pair space multiplies each only once
    nw_c = (n_c(Dl_c) * wl_c)[:, None]
    nwm_c = nw_c * m_liq(Dl)
    K = (k2 * Dl + k1[None]) * Dl + k0[None]
    v_rel_c = jnp.abs(v_i_at_Di[None] - v_liq(Dl_c)[:, None])
    dV = K * v_rel_c  # E = 1
    t1 = dV * nw_c
    t2 = dV * nwm_c
    t3 = t2 / rho_rim_loc(Di[None], Dl, v_rel=v_rel_c)
    dN_c_col = jnp.sum(t1, axis=0)              # per ice node
    dM_c_col = jnp.sum(t2, axis=0)
    dB_c_col = jnp.sum(t3, axis=0)

    # --- rain inner integral ---
    rain_params = CM2.pdf_rain_parameters(pdf_r, L_r / rho_a, rho_a, N_r)
    N0r, Dr_mean = rain_params.N0r, rain_params.Dr_mean
    rain_valid = (N0r > 0) & (r_hi > r_lo)
    r_lo_s = jnp.where(rain_valid, r_lo, jnp.ones_like(r_lo))
    r_hi_s = jnp.where(rain_valid, r_hi, 2 * jnp.ones_like(r_hi))
    n_r = lambda D: CM2.size_distribution_rain(pdf_r, L_r / rho_a,
                                               rho_a, N_r, D)

    if rain_inner == "quadrature":
        # Per-cell fixed nodes (see docstring): evaluate every liquid-
        # node factor once on (n_l, *cell), broadcast across the ice
        # axis. Invalid rain windows integrate over the dummy [1, 2] m
        # window where n_r underflows to 0 and are masked below anyway.
        Dl_r, wl_r = _nodes(liquid_quad, r_lo_s, r_hi_s)  # (n_l, *cell)
        v_l = v_liq(Dl_r)
        nw_r = (n_r(Dl_r) * wl_r)[:, None]
        nwm_r = nw_r * m_liq(Dl_r)[:, None]
        Dlr = Dl_r[:, None]
        K_n = (k2 * Dlr + k1[None]) * Dlr + k0[None]
        v_rel = jnp.abs(v_i_at_Di[None] - v_l[:, None])
        dV_r = K_n * v_rel
        t2 = dV_r * nwm_r
        t3 = t2 / rho_rim_loc(Di[None], Dlr, v_rel=v_rel)
        dN_r_col = jnp.sum(dV_r * nw_r, axis=0)
        dM_r_col = jnp.sum(t2, axis=0)
        dB_r_col = jnp.sum(t3, axis=0)
    elif rain_inner == "quadrature_split":
        # A wrong crossover (no crossing in the window: Brent
        # unbracketed) only moves the split point of a then-smooth
        # integrand — never the value.
        Dstar = _crossover_diameter(v_i_at_Di, v_liq, r_lo_s, r_hi_s, dt)
        zero = jnp.zeros_like(k0)
        dN_r_col, dM_r_col, dB_r_col = zero, zero, zero
        lo_b = r_lo_s + jnp.zeros_like(Dstar)
        hi_b = r_hi_s + jnp.zeros_like(Dstar)
        for a, b in ((lo_b, Dstar), (Dstar, hi_b)):
            Dl_n, w_n = _nodes(quad, a, b)   # (n_l, n_i, *cell)
            K_n = (k2 * Dl_n + k1[None]) * Dl_n + k0[None]
            t1 = K_n * jnp.abs(v_i_at_Di[None] - v_liq(Dl_n)) \
                * n_r(Dl_n)
            t2 = t1 * m_liq(Dl_n)
            t3 = t2 / rho_rim_loc(Di[None], Dl_n, v_i_at_Di[None])
            dN_r_col = dN_r_col + jnp.sum(t1 * w_n, axis=0)
            dM_r_col = dM_r_col + jnp.sum(t2 * w_n, axis=0)
            dB_r_col = dB_r_col + jnp.sum(t3 * w_n, axis=0)
    else:
        # Closed form: flux sums per velocity term via two-sided gamma
        # ladders — the six consecutive moment exponents (pexp in {0, 3}
        # x polynomial k in {0, 1, 2}) share endpoint ladders, so each of
        # the four exponential velocity terms costs one gamma_inc pair
        # per endpoint instead of six per moment (reference flux
        # structure: src/P3_processes.jl:344-415).
        Dstar = _crossover_diameter(v_i_at_Di, v_liq, r_lo_s, r_hi_s, dt)
        lam_r = 1 / jnp.maximum(Dr_mean, tiny)

        def segment_moment_diffs(z0, alpha):
            alpha_safe = jnp.maximum(alpha, tiny)
            lad_lo = _endpoint_ladders(z0, alpha_safe, r_lo_s)
            lad_st = _endpoint_ladders(z0, alpha_safe, Dstar)
            lad_hi = _endpoint_ladders(z0, alpha_safe, r_hi_s)
            JA = _moments_from_ladders(z0, alpha, alpha_safe, lad_lo,
                                       lad_st, r_lo_s, Dstar)
            JB = _moments_from_ladders(z0, alpha, alpha_safe, lad_st,
                                       lad_hi, Dstar, r_hi_s)
            return [a - b for a, b in zip(JA, JB)]

        JD_v = segment_moment_diffs(1.0, lam_r)
        JD_j = [segment_moment_diffs(bi[j] + 1, lam_r + ciu[j])
                for j in range(3)]
        kpoly = (k0, k1, k2)

        def crossing(pexp):
            s = v_i_at_Di * sum(kpoly[i] * JD_v[pexp + i] for i in range(3))
            for j in range(3):
                s = s - aiu[j] * sum(kpoly[i] * JD_j[j][pexp + i]
                                     for i in range(3))
            return s

        mfac = rho_w * PI / 6
        dN_r_col = N0r * crossing(0)
        dM_r_col = N0r * mfac * crossing(3)

        # rain rime-volume inner integral by quadrature
        Dl_r, wl_r = _nodes(quad, r_lo, r_hi)
        Dlr = Dl_r[:, None]
        wlr = wl_r[:, None]
        n_r_v = CM2.size_distribution_rain(pdf_r, L_r / rho_a, rho_a, N_r,
                                           Dlr)
        K_r = k0[None] + k1[None] * Dlr + k2 * Dlr**2
        dV_r = K_r * jnp.abs(v_i_at_Di[None] - v_liq(Dlr))
        t3_r = dV_r * n_r_v * m_liq(Dlr) \
            / rho_rim_loc(Di[None], Dlr, v_i_at_Di[None])
        dB_r_col = jnp.sum(t3_r * wlr, axis=0)

    bad = ~(jnp.isfinite(dN_r_col) & jnp.isfinite(dM_r_col)) | ~rain_valid
    dN_r_col = jnp.where(bad, jnp.zeros_like(dN_r_col), dN_r_col)
    dM_r_col = jnp.where(bad, jnp.zeros_like(dM_r_col), dM_r_col)
    dB_r_col = jnp.where(bad, jnp.zeros_like(dB_r_col), dB_r_col)

    # --- outer assembly: freezing/shedding split per ice node ---
    dM_col = dM_c_col + dM_r_col
    dM_frz = jnp.minimum(dM_col, max_frz(Di, v_i_at_Di))
    dM_col_safe = jnp.where(dM_col == 0, jnp.ones_like(dM_col), dM_col)
    f_frz = jnp.where(dM_col == 0, jnp.zeros_like(dM_col),
                      dM_frz / dM_col_safe)
    wet = (dM_col > dM_frz).astype(dt)

    niwi = ice_nodes.nw
    contract = lambda v: jnp.sum(niwi * v, axis=0)
    QCFRZ = contract(dM_c_col * f_frz)
    QCSHD = contract(dM_c_col * (1 - f_frz))
    NCCOL = contract(dN_c_col)
    QRFRZ = contract(dM_r_col * f_frz)
    QRSHD = contract(dM_r_col * (1 - f_frz))
    NRCOL = contract(dN_r_col)
    int_M_col = contract(dM_col)
    BCCOL = contract(dB_c_col * f_frz)
    BRCOL = contract(dB_r_col * f_frz)
    int_wet_M_col = contract(wet * dM_col)

    # --- bulk sources (reference :606-655) ---
    M_safe = jnp.where(int_M_col == 0, jnp.ones_like(int_M_col), int_M_col)
    f_wet = jnp.where(int_M_col == 0, jnp.zeros_like(int_M_col),
                      int_wet_M_col / M_safe)
    NRSHD = QRSHD / m_liq(jnp.asarray(D_shd, dt))

    F_rim, rho_rim = state.F_rim, state.rho_rim
    rho_rim_safe = jnp.where(rho_rim > 0, rho_rim, jnp.ones_like(rho_rim))
    B_rim = jnp.where(rho_rim > 0, state.rho_q_ice * F_rim / rho_rim_safe,
                      jnp.zeros_like(rho_rim))
    QIWET = f_wet * state.rho_q_ice * (1 - F_rim) / tau_wet
    BIWET = f_wet * (state.rho_q_ice / rho_i - B_rim) / tau_wet

    return CollisionSources(
        dq_c=(-QCFRZ - QCSHD) / rho_a,
        dq_r=(-QRFRZ + QCSHD) / rho_a,
        dN_c=-NCCOL,
        dN_r=-NRCOL + NRSHD,
        dL_rim=QCFRZ + QRFRZ + QIWET,
        dL_ice=QCFRZ + QRFRZ,
        dB_rim=BCCOL + BRCOL + BIWET,
    )


# ---------------------------------------------------------------------------
# Ice self-collection (reference src/P3_processes.jl:676-712)
# ---------------------------------------------------------------------------

def ice_self_collection(state: P3.P3State, loglambda, vel, rho_a, quad=None,
                        nodes=None, inner: str = "blocked"):
    """Aggregation loss rate of ice number [1/m^3/s] — the symmetric
    double integral ``1/2 ∬ n(D1) n(D2) K(D1, D2) |v(D1) - v(D2)|``
    (reference src/P3_processes.jl:676-712), computed as the ordered-pair
    integral over ``D2 < D1``. Two modes:

    * ``"blocked"`` (default): segment-blocked hybrid on the step-shared
      node table. The ordered-pair domain splits into (a) CROSS-SEGMENT
      blocks — ``D2`` in a strictly lower mass-law segment than ``D1``,
      where ``v1 >= v2`` up to a measured <=1e-3 weighted inversion
      share, so ``K |v1 - v2|`` separates over the ``pi (r1 + r2)^2``
      expansion into six cumulative moments of the tabulated ``v``/
      ``n w`` columns (O(n) work, ZERO fresh transcendentals), and
      (b) the four WITHIN-SEGMENT triangles ``a_s < D2 < D1``,
      integrated with a few fresh inner nodes per outer node. Each
      within-segment span is short, single-regime, and entirely below
      the ``D2 = D1`` cusp, so low-order Gauss-Legendre converges fast —
      unlike the round-4 ``"triangle"`` inner, whose half-order axis
      spanned up to four segments of C0-kinked integrand in one rule
      (its GL-8 error breached 5e-2 on large-aggregate states). Fresh
      Chen2022 evaluations per cell drop from ``(n/2) * 4n`` to
      ``~(n/4) * 4n`` while accuracy IMPROVES: max err vs a GL-64
      cusp-split reference over 5 curated states 5.5e-3 at GL-16
      (triangle: 1.07e-2), 4.6e-2 at GL-8 (5.9e-2)
      (tests/test_p3_processes.py cross-pins the modes).
    * ``"triangle"``: the round-4 form — inner nodes over the full
      ``[D_lo, D1]`` at half order, doubled by symmetry. Kept as a
      cross-pin anchor.

    Pass ``nodes`` (step-shared :class:`P3.IceQuadNodes`) to reuse the
    bounds/velocity/PSD tables.
    """
    from ..utils.quadrature import GaussLegendre

    if quad is None:
        quad = default_quadrature()
    dt = float_dtype(rho_a, loglambda)

    if nodes is None:
        p = machine_eps(dt)
        nodes = P3.ice_quadrature_nodes(vel, rho_a, state, loglambda, p,
                                        quad)

    D1, w1 = nodes.D, nodes.w                  # (n1, *cell)
    n1_of_D1 = nodes.n

    if inner == "blocked":
        n_i = P3.size_distribution(state, loglambda)
        v_ice = P3.ice_particle_terminal_velocity(vel, rho_a, state)
        v1 = nodes.v
        r1 = jnp.sqrt(P3.ice_area(state, D1) / PI)
        nw = nodes.nw
        n = quad.n
        n_seg = len(nodes.bnds) - 1
        total = jnp.zeros_like(loglambda + jnp.asarray(rho_a, dt))

        # (a) cross-segment blocks from the shared tables, SEPARATED:
        # for D2 in a strictly lower segment than D1, v(D1) >= v(D2) on
        # all but a vanishing weight of node pairs (measured inverted
        # |dv|-weight share <= 1e-3 across the curated states — small
        # velocity dips across segment boundaries from the aspect-ratio
        # factor), so |v1 - v2| = v1 - v2 and the pair kernel
        # K (v1 - v2) factorizes over the K = pi (r1 + r2)^2 expansion
        # into six cumulative moments S_m = sum nw r^m,
        # T_m = sum nw r^m v of the lower segments — O(n) instead of the
        # O(n^2) pair space, with the residual an order below the
        # certified quadrature error (recertified in the ladder tests).
        seg_sums = []
        for t in range(n_seg):
            sl = slice(t * n, (t + 1) * n)
            nwt, rt, vt_ = nw[sl], r1[sl], v1[sl]
            nwr = nwt * rt
            nwr2 = nwr * rt
            seg_sums.append((
                jnp.sum(nwt, axis=0), jnp.sum(nwr, axis=0),
                jnp.sum(nwr2, axis=0), jnp.sum(nwt * vt_, axis=0),
                jnp.sum(nwr * vt_, axis=0), jnp.sum(nwr2 * vt_, axis=0)))
        prefix = [tuple(jnp.zeros_like(x) for x in seg_sums[0])]
        for t in range(n_seg - 1):
            prefix.append(tuple(a + b for a, b in
                                zip(prefix[-1], seg_sums[t])))
        for s in range(1, n_seg):
            sl_o = slice(s * n, (s + 1) * n)
            S0, S1, S2, T0, T1, T2 = prefix[s]
            ri, vi = r1[sl_o], v1[sl_o]
            cross_i = PI * (ri * ri * (vi * S0 - T0)
                            + 2 * ri * (vi * S1 - T1)
                            + (vi * S2 - T2))
            total = total + jnp.sum(cross_i * nw[sl_o], axis=0)

        # (b) within-segment triangles: fresh quarter-order inner nodes
        # (floor 4: at GL-8 two nodes were measured to lose the
        # steep-PSD states) over the smooth, single-regime span [a_s, D1].
        # (Interpolating v/r from the tabulated segment columns instead
        # of fresh Chen2022 evaluations was tried and rejected: the tail
        # segment's node spacing is too coarse for linear-in-D velocity
        # on large-aggregate states — GL-16 error 5.2e-3 -> 2.1e-2.)
        for s in range(n_seg):
            # the tail (partially-rimed) segment carries the aggregate
            # mass and its span is the longest — give it 1.5x the inner
            # order (measured: recovers most of the uniform-order-6
            # accuracy gain at ~1/4 of its cost)
            n_in = max(n // 4, 6) if s == n_seg - 1 else max(n // 4, 4)
            inner_quad = GaussLegendre(n_in)
            sl_o = slice(s * n, (s + 1) * n)
            D1_s, v1_s, r1_s = D1[sl_o], v1[sl_o], r1[sl_o]
            a_s = nodes.bnds[s] + jnp.zeros_like(D1_s)
            acc = jnp.zeros_like(D1_s)
            for D2, w2 in _node_iter(inner_quad, a_s, D1_s):
                v2 = v_ice(D2)
                r2 = jnp.sqrt(P3.ice_area(state, D2) / PI)
                K = PI * (r1_s + r2) ** 2
                acc = acc + K * jnp.abs(v1_s - v2) * n_i(D2) * w2
            total = total + jnp.sum(acc * nw[sl_o], axis=0)
        return total

    # --- "triangle": cusp-split inner axis at half order (floor 4) ---
    n_i = P3.size_distribution(state, loglambda)
    v_ice = P3.ice_particle_terminal_velocity(vel, rho_a, state)
    # host-side rule: _node_iter slices it to SCALAR nodes
    inner_quad = GaussLegendre(max(quad.n // 2, 4))
    D_lo = nodes.bnds[0]

    def lower_triangle(r1, v1, D1_c):
        # inner nodes over [D_lo, D1], accumulated node-by-node (no
        # (n_inner, n_outer, *cell) tensor — see _node_iter)
        acc = jnp.zeros_like(D1_c)
        for D2, w2 in _node_iter(inner_quad,
                                 D_lo + jnp.zeros_like(D1_c), D1_c):
            v2 = v_ice(D2)
            r2 = jnp.sqrt(P3.ice_area(state, D2) / PI)
            K = PI * (r1 + r2) ** 2
            acc = acc + K * jnp.abs(v1 - v2) * n_i(D2) * w2
        return acc

    v1 = nodes.v
    r1 = jnp.sqrt(P3.ice_area(state, D1) / PI)
    inner = lower_triangle(r1, v1, D1)
    return jnp.sum(inner * n1_of_D1 * w1, axis=0)
