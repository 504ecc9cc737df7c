"""P3 scheme core: state, thresholds, size distribution, shape solver,
integral properties, and terminal velocities.

JAX port of the reference P3 files:

* ``src/P3_particle_properties.jl`` — ``P3State`` with thresholds cached at
  construction; numerically stable ``get_rho_d`` via exprel phi-functions;
  branchless 5-regime selection; mass/area/density/aspect-ratio laws.
* ``src/P3_size_distribution.jl`` — log-space incomplete-gamma moments,
  mu(lambda) laws, segment-summed mass moments via logsumexp, and the
  **shape solver**: fixed-iteration branchless Brent over ``logLdivN``
  with optional warm-start bracket narrowing.
* ``src/P3_integral_properties.jl`` — quantile integral bounds, ``D_m``.
* ``src/P3_terminal_velocity.jl`` — piecewise Chen 2022 ice velocity with
  aspect-ratio factor; number-/mass-weighted bulk velocities by quadrature.

Everything is elementwise over cell state; quadrature contracts a static
node axis (SURVEY.md §2.1). The shape solver runs a static trip count
(8 @ f32 / 10 @ f64) — the reference's warp-convergence discipline, which
is also what XLA requires.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax.numpy as jnp
from jax import Array, lax

from ..parameters.p3 import (
    OBLATE,
    ParametersP3,
    SlopeConstant,
    SlopePowerLaw,
)
from ..parameters.terminal_velocity import Chen2022VelType
from ..utils.quadrature import QuadratureRule, default_quadrature
from ..utils.special import (
    cbrt,
    eps_numerics_2M_M,
    eps_numerics_2M_N,
    eps_numerics_P3_B,
    expm1,
    float_dtype,
    gamma_inc,
    lgamma,
    logsumexp,
    machine_eps,
    rime_density,
    rime_mass_fraction,
)
from . import common as CO

PI = jnp.pi

__all__ = [
    "P3State",
    "p3_state",
    "state_from_prognostic",
    "get_rho_d",
    "get_rho_g",
    "segment_boundaries",
    "regime_value",
    "ice_mass",
    "ice_mass_coeffs",
    "ice_area",
    "ice_density",
    "d_ice_mass_dD",
    "phi_i",
    "aspect_ratio_factor",
    "get_mu",
    "log_nprime_ice",
    "size_distribution",
    "loggamma_inc_moment",
    "gamma_inc_moment",
    "loggamma_moment",
    "logmass_gamma_moment",
    "logLdivN",
    "get_logN0",
    "get_distribution_loglambda",
    "get_distribution_loglambda_all_solutions",
    "integral_bounds",
    "D_m",
    "IceQuadNodes",
    "ice_quadrature_nodes",
    "ice_particle_terminal_velocity",
    "ice_terminal_velocity_number_weighted",
    "ice_terminal_velocity_mass_weighted",
]


# ---------------------------------------------------------------------------
# exprel phi-functions (reference src/P3_particle_properties.jl:118-153)
# ---------------------------------------------------------------------------

def _exprel1(x):
    """``(exp(x) - 1) / x``, stable at 0."""
    dt = float_dtype(x)
    small = jnp.abs(x) < 1e-8
    x_safe = jnp.where(small, jnp.ones_like(x), x)
    out = expm1(x_safe) / x_safe
    return jnp.where(small, 1 + x / 2, out)


_EXPREL2_COEFFS = tuple(1.0 / math.factorial(i + 1) for i in range(1, 9))


def _exprel2(x):
    """``(exp(x) - 1 - x) / x^2`` with Taylor fallback for small |x|."""
    small = jnp.abs(x) < 0.2
    x_safe = jnp.where(small, jnp.ones_like(x), x)
    direct = (expm1(x_safe) - x_safe) / (x_safe * x_safe)
    # Horner over Python-scalar coefficients (an unrolled polyval): keeps
    # the table out of the jaxpr so Pallas kernels don't capture it.
    taylor = jnp.zeros_like(x)
    for c in _EXPREL2_COEFFS[::-1]:
        taylor = taylor * x + c
    return jnp.where(small, taylor, direct)


def get_rho_d(mass, F_rim, rho_rim):
    """Density of the unrimed portion, exact stable form
    (reference src/P3_particle_properties.jl:191-199; validated to 1e-5
    vs BigFloat in the reference's p3_rho_d_stability tests)."""
    dt = float_dtype(F_rim, rho_rim)
    p = 1 / (3 - mass.beta_va)
    # clamp so log1p stays finite for F_rim -> 1 (state construction clamps
    # F_rim <= 1 - eps anyway)
    F = jnp.minimum(F_rim, 1 - machine_eps(dt))
    logFu = jnp.log1p(-F)
    phi1 = _exprel1(logFu)
    phi1mp = _exprel1((1 - p) * logFu)
    H = (-p * _exprel2(-p * logFu) - (1 - p) * _exprel2((1 - p) * logFu))
    G = H - phi1mp * phi1
    return -(rho_rim * phi1 * phi1mp) / G


def weighted_average(f_a, a, b):
    return f_a * a + (1 - f_a) * b


def get_rho_g(F_rim, rho_rim, rho_d):
    """Graupel density (MM2015 Eq 16)."""
    return weighted_average(F_rim, rho_rim, rho_d)


def _threshold(mass, rho):
    """``(6 alpha_va / (pi rho))^(1/(3 - beta_va))``
    (reference src/P3_particle_properties.jl:244)."""
    return (6 * mass.alpha_va / (PI * rho)) ** (1 / (3 - mass.beta_va))


class P3State(NamedTuple):
    """P3 state with thresholds cached at construction
    (reference src/P3_particle_properties.jl:20-56)."""

    params: ParametersP3
    rho_q_ice: Array   # volumetric ice mass [kg/m^3]
    rho_n_ice: Array   # volumetric ice number [1/m^3]
    F_rim: Array       # rime mass fraction
    rho_rim: Array     # rime density [kg/m^3]
    rho_g: Array       # graupel density [kg/m^3]
    D_th: Array
    D_gr: Array        # inf when F_rim = 0
    D_cr: Array        # inf when F_rim = 0


def p3_state(params: ParametersP3, rho_q_ice, rho_n_ice, F_rim,
             rho_rim) -> P3State:
    dt = float_dtype(rho_q_ice, rho_n_ice, F_rim, rho_rim)
    rho_q_ice, rho_n_ice, F_rim, rho_rim = (
        jnp.asarray(v, dt) for v in (rho_q_ice, rho_n_ice, F_rim, rho_rim))
    rho_d = get_rho_d(params.mass, F_rim, rho_rim)
    rho_g = get_rho_g(F_rim, rho_rim, rho_d)
    D_th = _threshold(params.mass, params.rho_i) + jnp.zeros_like(F_rim)
    unrimed = F_rim == 0
    inf = jnp.asarray(jnp.inf, dt)
    rho_g_safe = jnp.where(unrimed, jnp.ones_like(rho_g), rho_g)
    D_gr = jnp.where(unrimed, inf, _threshold(params.mass, rho_g_safe))
    D_cr = jnp.where(
        unrimed, inf,
        _threshold(params.mass, rho_g_safe * jnp.maximum(
            1 - F_rim, machine_eps(dt))))
    return P3State(params, rho_q_ice, rho_n_ice, F_rim, rho_rim,
                   rho_g, D_th, D_gr, D_cr)


def state_from_prognostic(params: ParametersP3, rho_q_ice, rho_n_ice,
                          rho_q_rim, rho_b_rim) -> P3State:
    """Regularised state construction from volumetric prognostics
    (reference src/P3_particle_properties.jl:101-106)."""
    dt = float_dtype(rho_q_ice, rho_n_ice, rho_q_rim, rho_b_rim)
    F_rim = jnp.minimum(rime_mass_fraction(rho_q_rim, rho_q_ice),
                        1 - machine_eps(dt))
    rho_rim = jnp.minimum(rime_density(rho_q_rim, rho_b_rim),
                          0.8 * params.rho_l)
    return p3_state(params, rho_q_ice, rho_n_ice, F_rim, rho_rim)


def segment_boundaries(state: P3State, D_min=0.0, D_max=jnp.inf):
    """(D_min, D_th, D_gr, D_cr, D_max) clamped into the window
    (reference src/P3_particle_properties.jl:287-292)."""
    D_min = jnp.asarray(D_min, float_dtype(state.D_th)) \
        + jnp.zeros_like(state.D_th)
    D_max = jnp.asarray(D_max, float_dtype(state.D_th)) \
        + jnp.zeros_like(state.D_th)
    clamp = lambda D: jnp.clip(D, D_min, D_max)
    return (D_min, clamp(state.D_th), clamp(state.D_gr), clamp(state.D_cr),
            D_max)


def regime_value(state: P3State, D, small, unrimed, dense_rimed, graupel,
                 partially_rimed):
    """Branchless 5-regime select
    (reference src/P3_particle_properties.jl:320-332)."""
    vals = jnp.broadcast_arrays(
        *(jnp.asarray(v, float_dtype(D)) for v in
          (small, unrimed, dense_rimed, graupel, partially_rimed)))
    small, unrimed, dense_rimed, graupel, partially_rimed = vals
    return jnp.where(
        D < state.D_th, small,
        jnp.where(state.F_rim == 0, unrimed,
                  jnp.where(D < state.D_gr, dense_rimed,
                            jnp.where(D < state.D_cr, graupel,
                                      partially_rimed))))


def ice_mass_coeffs(state: P3State, D):
    """(a, b) of the regime mass power law ``a D^b``
    (reference src/P3_particle_properties.jl:346-359)."""
    dt = float_dtype(D)
    params = state.params
    alpha, beta = params.mass.alpha_va, params.mass.beta_va
    epsB = eps_numerics_P3_B(dt)
    Fu = jnp.maximum(1 - state.F_rim, epsB)
    a = regime_value(state, D, params.rho_i * PI / 6, alpha, alpha,
                     state.rho_g * PI / 6, alpha / Fu)
    b = regime_value(state, D, 3.0, beta, beta, 3.0, beta)
    return a, b


def ice_mass(state: P3State, D):
    a, b = ice_mass_coeffs(state, D)
    return a * D**b


def ice_density(state: P3State, D):
    return ice_mass(state, D) / CO.volume_sphere_D(D)


def d_ice_mass_dD(state: P3State, D):
    a, b = ice_mass_coeffs(state, D)
    return a * b * D ** (b - 1)


def ice_area(state: P3State, D):
    """Regime cross-sectional area
    (reference src/P3_particle_properties.jl:419-428)."""
    area = state.params.area
    spherical = D**2 * PI / 4
    nonspherical = area.gamma * D**area.sigma
    return regime_value(
        state, D, spherical, nonspherical, nonspherical, spherical,
        weighted_average(state.F_rim, spherical, nonspherical))


def _phi_material_density(state: P3State, D):
    rho_i = state.params.rho_i
    return regime_value(state, D, rho_i, rho_i, rho_i, state.rho_g, rho_i)


def phi_i(state: P3State, D):
    """Oblate aspect ratio ``phi = 3 sqrt(pi) m / (4 rho a^(3/2))``
    (reference src/P3_particle_properties.jl:464-475)."""
    dt = float_dtype(D)
    m = ice_mass(state, D)
    a = ice_area(state, D)
    rho = _phi_material_density(state, D)
    a_safe = jnp.maximum(a, jnp.asarray(jnp.finfo(dt).tiny, dt))
    phi_ob = 3 * jnp.sqrt(jnp.asarray(PI, dt)) * m \
        / (4 * rho * a_safe * jnp.sqrt(a_safe))
    return jnp.where(D == 0, jnp.zeros_like(phi_ob), phi_ob)


def aspect_ratio_factor(state: P3State, D):
    """Terminal-velocity aspect-ratio factor: ``cbrt(phi_i)`` for Oblate,
    1 otherwise (reference src/P3_integral_properties.jl functors)."""
    if state.params.aspect_ratio == OBLATE:
        return cbrt(phi_i(state, D))
    return jnp.ones_like(jnp.asarray(D))


# ---------------------------------------------------------------------------
# Size distribution (reference src/P3_size_distribution.jl)
# ---------------------------------------------------------------------------

def get_mu(slope, loglambda):
    """mu(lambda) law (reference src/P3_size_distribution.jl:171-173)."""
    if isinstance(slope, SlopePowerLaw):
        return jnp.clip(slope.a * jnp.exp(loglambda) ** slope.b - slope.c,
                        0.0, slope.mu_max)
    if isinstance(slope, SlopeConstant):
        return jnp.asarray(slope.mu, float_dtype(loglambda)) \
            + jnp.zeros_like(loglambda)
    raise TypeError(f"unknown slope law {type(slope)}")


def loggamma_inc_moment(D1, D2, mu, loglambda, k=0.0, scale=1.0,
                        lo_is_zero=False, hi_is_inf=False):
    """``log(scale * int_D1^D2 D^(mu+k) e^(-lambda D) dD)`` via regularized
    incomplete gammas in log space
    (reference src/P3_size_distribution.jl:97-109).

    ``lo_is_zero`` / ``hi_is_inf`` are STATIC flags for the outermost
    segments of the full-support mass moment, where ``gamma_inc`` is
    analytic — ``P(z, 0) = 0`` / ``Q(z, inf) = 0`` — and the fixed
    40-iteration evaluation can be skipped entirely (2 of the 8
    gamma_inc per shape-solver residual evaluation)."""
    dt = float_dtype(D1, D2, mu, loglambda)
    z = k + mu + 1
    one = jnp.ones_like(z)
    zero = jnp.zeros_like(z)
    if lo_is_zero:
        p1, q1 = zero, one
    else:
        x1 = D1 * jnp.exp(loglambda)
        p1, q1 = gamma_inc(z, x1)
    if hi_is_inf:
        p2, q2 = one, zero
        x2 = jnp.asarray(jnp.inf, dt) + zero
    else:
        x2 = D2 * jnp.exp(loglambda)
        p2, q2 = gamma_inc(z, x2)
    dq = jnp.where(x2 < z + 1, p2 - p1, q1 - q2)
    dq = jnp.maximum(dq, machine_eps(dt))
    out = -z * loglambda + lgamma(z) + jnp.log(dq) \
        + jnp.log(jnp.asarray(scale, dt))
    return jnp.where(D1 < D2, out, jnp.asarray(-jnp.inf, dt))


def gamma_inc_moment(D1, D2, p, alpha):
    """``int_D1^D2 D^p e^(-alpha D) dD`` in linear space
    (reference src/P3_size_distribution.jl:121-133)."""
    dt = float_dtype(D1, D2, alpha)
    z = p + 1
    x1 = alpha * D1
    x2 = alpha * D2
    p1, q1 = gamma_inc(z, x1)
    p2, q2 = gamma_inc(z, x2)
    dq = jnp.where(x2 < z + 1, p2 - p1, q1 - q2)
    dq = jnp.maximum(dq, 0.0)
    alpha_safe = jnp.maximum(alpha, jnp.asarray(jnp.finfo(dt).tiny, dt))
    out = jnp.exp(lgamma(z)) * dq / alpha_safe**z
    out = jnp.where(D2 > D1, out, jnp.zeros_like(out))
    return jnp.where(alpha > 0, out, jnp.asarray(jnp.nan, dt))


def loggamma_moment(mu, loglambda, k=0.0, scale=1.0):
    """``log(scale * int_0^inf D^(mu+k) e^(-lambda D) dD)``
    (reference src/P3_size_distribution.jl:153-157)."""
    dt = float_dtype(mu, loglambda)
    z = k + mu + 1
    return -z * loglambda + lgamma(z) + jnp.log(jnp.asarray(scale, dt))


def logmass_gamma_moment(state: P3State, mu, loglambda, n=0.0):
    """``log(int_0^inf D^n m(D) G(D) dD)`` — segment-summed via logsumexp
    (reference src/P3_size_distribution.jl:193-200)."""
    bnds = segment_boundaries(state)
    moments = []
    last = len(bnds) - 2
    for i, (D_lo, D_hi) in enumerate(zip(bnds[:-1], bnds[1:])):
        a, b = ice_mass_coeffs(state, (D_lo + D_hi) / 2)
        # fold the coefficient a into log space directly (a > 0);
        # the support is [0, inf) so the outermost gamma_inc endpoint
        # evaluations are analytic (see loggamma_inc_moment)
        dt = float_dtype(D_lo)
        m = loggamma_inc_moment(D_lo, D_hi, mu, loglambda, b + n, 1.0,
                                lo_is_zero=(i == 0),
                                hi_is_inf=(i == last)) \
            + jnp.log(jnp.maximum(a, jnp.asarray(jnp.finfo(dt).tiny, dt)))
        # collapsed segments contribute -inf (excluded from logsumexp)
        m = jnp.where(D_lo < D_hi, m, jnp.asarray(-jnp.inf, dt))
        moments.append(m)
    stacked = jnp.stack(jnp.broadcast_arrays(*moments), axis=-1)
    return logsumexp(stacked, axis=-1)


def logLdivN(state: P3State, loglambda):
    """``log(L/N)`` (reference src/P3_size_distribution.jl:211-216)."""
    mu = get_mu(state.params.slope, loglambda)
    logLdivN0 = logmass_gamma_moment(state, mu, loglambda, n=0.0)
    logNdivN0 = loggamma_moment(mu, loglambda, k=0.0)
    return logLdivN0 - logNdivN0


def get_logN0(N_ice, mu, loglambda):
    """(reference src/P3_size_distribution.jl:233-237)."""
    dt = float_dtype(N_ice, loglambda)
    N_safe = jnp.maximum(N_ice, jnp.asarray(jnp.finfo(dt).tiny, dt))
    return jnp.log(N_safe) - loggamma_moment(mu, loglambda, k=0.0)


def log_nprime_ice(state: P3State, loglambda):
    """Return ``(log_N0, mu, lambda)`` of ``log n(D) = log_N0 + mu log D
    - lambda D`` (reference P3LogNumberFunctor)."""
    mu = get_mu(state.params.slope, loglambda)
    log_N0 = get_logN0(state.rho_n_ice, mu, loglambda)
    return log_N0, mu, jnp.exp(loglambda)


def size_distribution(state: P3State, loglambda):
    """Return ``n(D)`` as a closure (D may carry a leading node axis)."""
    log_N0, mu, lam = log_nprime_ice(state, loglambda)

    def n(D):
        dt = float_dtype(D)
        D_safe = jnp.maximum(D, jnp.asarray(jnp.finfo(dt).tiny, dt))
        return jnp.exp(log_N0 + mu * jnp.log(D_safe) - lam * D)

    return n


# ---------------------------------------------------------------------------
# Shape solver (reference src/P3_size_distribution.jl:240-353)
# ---------------------------------------------------------------------------

def _brent_fixed(f, lo, f_lo, hi, f_hi, n_iters: int,
                 unroll=None):
    """Fixed-iteration branchless Brent's method (Press et al. ``zbrent``).

    Runs exactly ``n_iters`` iterations (no early exit — warp convergence;
    reference ``FixedIterations`` tolerance) with ``where``-based updates:
    inverse-quadratic / secant interpolation with the Press acceptance
    conditions, falling back to bisection. Converges superlinearly on the
    near-linear shape function, matching the reference's RootSolvers
    BrentsMethod budget (8 @ f32 / 10 @ f64).
    """
    dt = float_dtype(lo, hi)
    eps = machine_eps(dt)
    tiny = jnp.asarray(jnp.finfo(dt).tiny, dt)

    a, fa = lo, f_lo
    b, fb = hi, f_hi
    c, fc = b, fb
    d = b - a
    e = b - a

    def body(_, carry):
        a, fa, b, fb, c, fc, d, e = carry

        # re-bracket: if fb and fc share a sign, reset c to a
        same_sign = fb * fc > 0
        c = jnp.where(same_sign, a, c)
        fc = jnp.where(same_sign, fa, fc)
        d = jnp.where(same_sign, b - a, d)
        e = jnp.where(same_sign, b - a, e)

        # ensure |fc| >= |fb| (b is the best estimate)
        swap = jnp.abs(fc) < jnp.abs(fb)
        a = jnp.where(swap, b, a)
        b = jnp.where(swap, c, b)
        c = jnp.where(swap, a, c)
        fa = jnp.where(swap, fb, fa)
        fb = jnp.where(swap, fc, fb)
        fc = jnp.where(swap, fa, fc)

        tol1 = 2 * eps * jnp.abs(b)
        xm = (c - b) / 2

        # attempt inverse quadratic / secant interpolation
        can_interp = (jnp.abs(e) >= tol1) & (jnp.abs(fa) > jnp.abs(fb))
        fa_safe = jnp.where(jnp.abs(fa) > 0, fa, tiny)
        fc_safe = jnp.where(jnp.abs(fc) > 0, fc, tiny)
        s = fb / fa_safe
        secant = a == c
        # secant: p = 2 xm s, q = 1 - s
        p_sec = 2 * xm * s
        q_sec = 1 - s
        # inverse quadratic
        q_i = fa / fc_safe
        r_i = fb / fc_safe
        p_iqi = s * (2 * xm * q_i * (q_i - r_i) - (b - a) * (r_i - 1))
        q_iqi = (q_i - 1) * (r_i - 1) * (s - 1)
        p = jnp.where(secant, p_sec, p_iqi)
        q = jnp.where(secant, q_sec, q_iqi)
        q = jnp.where(p > 0, -q, q)
        p = jnp.abs(p)
        q_safe = jnp.where(jnp.abs(q) > 0, q, tiny)
        accept = can_interp & (
            2 * p < jnp.minimum(3 * xm * q - jnp.abs(tol1 * q),
                                jnp.abs(e * q)))
        e_new = jnp.where(accept, d, xm)
        d_new = jnp.where(accept, p / q_safe, xm)

        a_new, fa_new = b, fb
        # minimum step of tol1 in the direction of xm
        step = jnp.where(jnp.abs(d_new) > tol1, d_new,
                         jnp.where(xm >= 0, tol1, -tol1))
        b_new = b + step
        fb_new = f(b_new)
        return a_new, fa_new, b_new, fb_new, c, fc, d_new, e_new

    # unroll where loop_unroll() says so, when f is cheap (e.g. the
    # collision crossover solve): the 8 loop carries are full-size arrays
    # and a rolled loop round-trips them through device memory every
    # iteration. Callers whose f is itself a large
    # graph (the shape solver: gamma_inc segment moments per iteration)
    # pass unroll=False — there the 8x HLO duplication blows up compile
    # time for a minor runtime gain (the gamma_inc loops inside the body
    # are already unrolled; see utils.special.loop_unroll).
    if unroll is None:
        from ..utils.special import loop_unroll

        unroll = loop_unroll()
    a, fa, b, fb, c, fc, d, e = lax.fori_loop(
        0, n_iters, body, (a, fa, b, fb, c, fc, d, e),
        unroll=unroll)
    # return the best of the final pair
    return jnp.where(jnp.abs(fb) <= jnp.abs(fc), b, c)


def get_distribution_loglambda(state: P3State, loglambda_guess=None,
                               loglambda_min=2.0, loglambda_max=17.0):
    """Solve ``logLdivN(loglambda) = log(L/N)`` for the PSD slope.

    Fixed-iteration (8 @ f32 / 10 @ f64) branchless Brent over the bracket
    ``[2, 17]``, with optional warm-start bracket narrowing
    (reference src/P3_size_distribution.jl:284-353). Returns ``log(0)``
    (-inf) where ice is absent.
    """
    dt = float_dtype(state.rho_q_ice, state.rho_n_ice)
    em = eps_numerics_2M_M(dt)
    en = eps_numerics_2M_N(dt)
    empty = (state.rho_n_ice < en) | (state.rho_q_ice < em)

    q_safe = jnp.maximum(state.rho_q_ice, jnp.asarray(jnp.finfo(dt).tiny, dt))
    n_safe = jnp.maximum(state.rho_n_ice, jnp.asarray(jnp.finfo(dt).tiny, dt))
    target = jnp.log(q_safe) - jnp.log(n_safe)

    def shape_problem(loglam):
        return logLdivN(state, loglam) - target

    lo = jnp.asarray(loglambda_min, dt) + jnp.zeros_like(target)
    hi = jnp.asarray(loglambda_max, dt) + jnp.zeros_like(target)
    f_lo = shape_problem(lo)
    f_hi = shape_problem(hi)

    # degenerate bracket -> nearest endpoint
    degenerate = ~jnp.isfinite(f_lo) | ~jnp.isfinite(f_hi) | (f_lo * f_hi > 0)
    endpoint = jnp.where(jnp.abs(f_lo) <= jnp.abs(f_hi), lo, hi)

    # warm-start narrowing (reference :336-353)
    if loglambda_guess is not None:
        p = jnp.asarray(loglambda_guess, dt) + jnp.zeros_like(lo)
        valid = jnp.isfinite(p) & (lo < p) & (p < hi)
        p_clean = jnp.where(valid, p, lo)
        f_p = shape_problem(p_clean)
        valid = valid & jnp.isfinite(f_p)
        left = valid & (f_lo * f_p < 0)
        right = valid & ~left
        hi = jnp.where(left, p_clean, hi)
        f_hi = jnp.where(left, f_p, f_hi)
        lo = jnp.where(right, p_clean, lo)
        f_lo = jnp.where(right, f_p, f_lo)

    n_iters = 10 if dt == jnp.float64 else 8
    root = _brent_fixed(shape_problem, lo, f_lo, hi, f_hi, n_iters,
                        unroll=False)
    root = jnp.where(degenerate, endpoint, root)
    return jnp.where(empty, jnp.asarray(-jnp.inf, dt), root)


def get_distribution_loglambda_from_prognostic(
        params: ParametersP3, rho_q_ice, rho_n_ice, rho_q_rim, rho_b_rim,
        loglambda_guess=None):
    """Shape solve directly from volumetric prognostics — sugar over
    :func:`state_from_prognostic` + :func:`get_distribution_loglambda`
    (reference src/P3_size_distribution.jl `get_distribution_logλ_from_prognostic`,
    tested in test/ad_compat_tests.jl:178-186)."""
    state = state_from_prognostic(params, rho_q_ice, rho_n_ice,
                                  rho_q_rim, rho_b_rim)
    return get_distribution_loglambda(state, loglambda_guess)


# ---------------------------------------------------------------------------
# Integral properties (reference src/P3_integral_properties.jl)
# ---------------------------------------------------------------------------

def integral_bounds(state: P3State, loglambda, p, moment_order=0.0):
    """Quantile-based integration bounds clamped through the segment
    boundaries (reference src/P3_integral_properties.jl:34-45)."""
    from ..utils.distributions import generalized_gamma_quantile_unit_mu

    dt = float_dtype(loglambda)
    k = get_mu(state.params.slope, loglambda) + moment_order
    lam = jnp.exp(loglambda)
    # 4 Halley steps: tail-window bounds need far less precision than the
    # quadrature truncation error they control (see gamma_inc_inv)
    D_min = generalized_gamma_quantile_unit_mu(k, lam, jnp.asarray(p, dt),
                                               n_iters=4)
    D_max = generalized_gamma_quantile_unit_mu(k, lam,
                                               jnp.asarray(1 - p, dt),
                                               n_iters=4)
    return segment_boundaries(state, D_min, D_max)


def D_m(state: P3State, loglambda):
    """Mass-weighted mean particle size [m]
    (reference src/P3_integral_properties.jl:56-61)."""
    dt = float_dtype(loglambda)
    mu = get_mu(state.params.slope, loglambda)
    mw = logmass_gamma_moment(state, mu, loglambda, n=1.0)
    log_N0 = get_logN0(state.rho_n_ice, mu, loglambda)
    q_safe = jnp.maximum(state.rho_q_ice, jnp.asarray(jnp.finfo(dt).tiny, dt))
    return jnp.exp(log_N0 + mw) / q_safe


# ---------------------------------------------------------------------------
# Shared quadrature-node context
# ---------------------------------------------------------------------------

class IceQuadNodes(NamedTuple):
    """Ice PSD quadrature nodes with the two expensive per-node fields
    evaluated once: the piecewise Chen2022 terminal velocity (several
    pow/exp per node) and the size distribution (exp per node).

    Every bulk ice integral in a P3 step — liquid-ice collisions, ice
    self-collection (outer axis), melt, number-/mass-weighted terminal
    velocities — contracts against the SAME ice-node axis. The reference
    evaluates each integral independently (host-side broadcasting,
    src/P3_terminal_velocity.jl:73-135, src/P3_processes.jl:449-567); the
    v(D)/n(D) node tables are the dominant per-node arithmetic, so
    they are computed once per step and threaded into each consumer.
    """

    D: Array     # (n_segments * n_quad, *cell) segment-concatenated nodes
    w: Array     # matching weights (zero on collapsed segments)
    v: Array     # terminal velocity at D [m/s]
    n: Array     # size distribution at D [1/m^4]
    nw: Array    # n * w — EVERY bulk contraction uses only this product,
                 # so consumers read one table stream instead of two
    bnds: tuple  # the (D_min, D_th, D_gr, D_cr, D_max) window


def ice_quadrature_nodes(velocity_params: Chen2022VelType, rho_a,
                         state: P3State, loglambda, p=1e-6,
                         quad: Optional[QuadratureRule] = None
                         ) -> IceQuadNodes:
    """Build the shared per-step ice node context (tail quantile ``p``)."""
    from ..utils.quadrature import segment_nodes

    if quad is None:
        quad = default_quadrature()
    bnds = integral_bounds(state, loglambda, p)
    D, w = segment_nodes(quad, bnds)
    v = ice_particle_terminal_velocity(velocity_params, rho_a, state)(D)
    n = size_distribution(state, loglambda)(D)
    return IceQuadNodes(D=D, w=w, v=v, n=n, nw=n * w, bnds=bnds)


# ---------------------------------------------------------------------------
# Terminal velocity (reference src/P3_terminal_velocity.jl)
# ---------------------------------------------------------------------------

def ice_particle_terminal_velocity(velocity_params: Chen2022VelType, rho_a,
                                   state: P3State):
    """Return ``v(D)``: piecewise small/large Chen2022 ice velocity times
    the aspect-ratio factor (reference src/P3_terminal_velocity.jl:12-45)."""
    rho_i = 916.7  # matches the reference's hardcoded value (:100)
    aiu_s, bi_s, ciu_s = CO.chen2022_vel_coeffs_small_ice(
        velocity_params.small_ice, rho_a, rho_i)
    aiu_l, bi_l, ciu_l = CO.chen2022_vel_coeffs_large_ice(
        velocity_params.large_ice, rho_a, rho_i)
    cutoff = velocity_params.small_ice.cutoff

    def v_term(D):
        v_small = CO.chen2022_velocity_sum(aiu_s, bi_s, ciu_s, D)
        v_large = CO.chen2022_velocity_sum(aiu_l, bi_l, ciu_l, D)
        v = jnp.where(D <= cutoff, v_small, v_large)
        return v * aspect_ratio_factor(state, D)

    return v_term


def _weighted_velocity(velocity_params, rho_a, state, loglambda, p, quad,
                       mass_weighted: bool, nodes=None):
    dt = float_dtype(rho_a, loglambda)
    eps = machine_eps(dt)
    empty = (state.rho_n_ice < eps) | (state.rho_q_ice < eps)

    if nodes is None:
        nodes = ice_quadrature_nodes(velocity_params, rho_a, state,
                                     loglambda, p, quad)

    integrand = nodes.nw * nodes.v
    if mass_weighted:
        integrand = integrand * ice_mass(state, nodes.D)
        denom = state.rho_q_ice
    else:
        denom = state.rho_n_ice

    val = jnp.sum(integrand, axis=0)
    denom_safe = jnp.maximum(denom, jnp.asarray(jnp.finfo(dt).tiny, dt))
    out = val / denom_safe
    return jnp.where(empty, jnp.zeros_like(out), out)


def ice_terminal_velocity_number_weighted(
    velocity_params: Chen2022VelType, rho_a, state: P3State, loglambda,
    p=1e-6, quad: Optional[QuadratureRule] = None,
    nodes: Optional[IceQuadNodes] = None,
):
    """Number-weighted bulk ice fall speed by quadrature
    (reference src/P3_terminal_velocity.jl:73-135). Pass ``nodes`` to
    reuse a step-shared :class:`IceQuadNodes` (``p``/``quad`` ignored)."""
    if quad is None:
        quad = default_quadrature()
    return _weighted_velocity(velocity_params, rho_a, state, loglambda, p,
                              quad, mass_weighted=False, nodes=nodes)


def ice_terminal_velocity_mass_weighted(
    velocity_params: Chen2022VelType, rho_a, state: P3State, loglambda,
    p=1e-6, quad: Optional[QuadratureRule] = None,
    nodes: Optional[IceQuadNodes] = None,
):
    """Mass-weighted bulk ice fall speed by quadrature."""
    if quad is None:
        quad = default_quadrature()
    return _weighted_velocity(velocity_params, rho_a, state, loglambda, p,
                              quad, mass_weighted=True, nodes=nodes)


def get_distribution_loglambda_all_solutions(state: P3State,
                                             n_scan: int = 401):
    """All candidate ``loglambda`` roots of the shape problem
    (reference src/P3_size_distribution.jl:365-384; experimental — only
    the SlopePowerLaw mu(lambda) law can be multi-rooted).

    XLA-native variant of the reference's host-side sign-change scan:
    ``logLdivN`` is evaluated on a static ``n_scan``-point grid over
    ``lambda in [1e2, 1e6]``; the fixed-iteration Brent solver then runs
    on EVERY adjacent pair, with non-bracketing pairs masked to NaN.
    Returns a ``(n_scan - 1,)`` array of roots (NaN where no sign change).
    """
    dt = float_dtype(state.rho_q_ice, state.rho_n_ice)
    q_safe = jnp.maximum(state.rho_q_ice,
                         jnp.asarray(jnp.finfo(dt).tiny, dt))
    n_safe = jnp.maximum(state.rho_n_ice,
                         jnp.asarray(jnp.finfo(dt).tiny, dt))
    target = jnp.log(q_safe) - jnp.log(n_safe)

    grid = jnp.asarray(
        jnp.log(10.0) * jnp.linspace(2.0, 6.0, n_scan), dt)
    import jax

    f = jax.vmap(lambda ll: logLdivN(state, ll) - target)(grid)
    lo, hi = grid[:-1], grid[1:]
    bracketed = f[:-1] * f[1:] < 0

    roots = jax.vmap(
        lambda a, b: get_distribution_loglambda(
            state, loglambda_min=a, loglambda_max=b))(lo, hi)
    return jnp.where(bracketed, roots, jnp.full_like(roots, jnp.nan))
