"""ARG2000 aerosol activation.

JAX port of ``/root/reference/src/AerosolActivation.jl``: per-mode
mean hygroscopicity, critical supersaturation, maximum supersaturation
(ARG eq 11/12 with Korolev-Mazin alpha/gamma and liquid/ice
condensation-sink corrections), and activated number/mass via erf/erfc.

Modes are a static tuple — the per-mode loop unrolls at trace time and XLA
fuses it, mirroring the reference's ntuple/Val unrolling.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.special import erf, erfc

from ..parameters.aerosol import (
    AerosolActivationParameters,
    AerosolDistribution,
    ModeB,
    ModeKappa,
)
from ..parameters.common import AirProperties
from ..parameters.thermodynamics import ThermodynamicsParameters
from ..utils.special import float_dtype, machine_eps
from . import common as CO
from . import thermo as TDI

TPS = ThermodynamicsParameters
PI = jnp.pi

__all__ = [
    "coeff_of_curvature",
    "mean_hygroscopicity_parameter",
    "critical_supersaturation",
    "max_supersaturation",
    "N_activated_per_mode",
    "M_activated_per_mode",
    "total_N_activated",
    "total_M_activated",
]


def coeff_of_curvature(ap: AerosolActivationParameters, T):
    """Kelvin curvature coefficient A
    (reference src/AerosolActivation.jl:35-40)."""
    return 2 * ap.sigma * ap.M_w / ap.rho_w / ap.R / T


def mean_hygroscopicity_parameter(ap: AerosolActivationParameters,
                                  ad: AerosolDistribution):
    """Per-mode hygroscopicity: mass-weighted B (Mode_B) or volume-weighted
    kappa (Mode_kappa) (reference src/AerosolActivation.jl:55-95)."""
    out = []
    for mode in ad.modes:
        if isinstance(mode, ModeB):
            nom = sum(
                m * d * o * s / mm
                for m, d, o, s, mm in zip(
                    mode.mass_mix_ratio, mode.dissoc, mode.osmotic_coeff,
                    mode.soluble_mass_frac, mode.molar_mass)
            )
            den = sum(
                m / rho for m, rho in zip(mode.mass_mix_ratio,
                                          mode.aerosol_density))
            out.append(nom / den * ap.M_w / ap.rho_w)
        elif isinstance(mode, ModeKappa):
            out.append(sum(v * k for v, k in zip(mode.vol_mix_ratio,
                                                 mode.kappa)))
        else:
            raise TypeError(f"unknown mode type {type(mode)}")
    return tuple(out)


def critical_supersaturation(ap: AerosolActivationParameters,
                             ad: AerosolDistribution, T):
    """Per-mode critical supersaturation
    (reference src/AerosolActivation.jl:107-118)."""
    A = coeff_of_curvature(ap, T)
    hygro = mean_hygroscopicity_parameter(ap, ad)
    return tuple(
        2 / jnp.sqrt(jnp.asarray(h, float_dtype(T)))
        * (A / 3 / mode.r_dry) ** 1.5
        for h, mode in zip(hygro, ad.modes)
    )


def max_supersaturation(ap: AerosolActivationParameters,
                        ad: AerosolDistribution, aip: AirProperties,
                        tps: TPS, T, p, w, q_tot, q_liq, q_ice,
                        N_liq=0.0, N_ice=0.0):
    """Maximum supersaturation: ARG eq 11/12 + Korolev-Mazin alpha/gamma +
    liquid/ice condensation-sink correction
    (reference src/AerosolActivation.jl:138-200)."""
    dt = float_dtype(T, p, w)
    eps = machine_eps(dt)
    R_v = tps.R_v
    R_m = TDI.gas_constant_air(tps, q_tot, q_liq, q_ice)
    cp_m = TDI.cp_m(tps, q_tot, q_liq, q_ice)
    Lv = TDI.latent_heat_vapor(tps, T)
    rho_air = TDI.air_density(tps, T, p, q_tot, q_liq, q_ice)
    p_v = (q_tot - q_liq - q_ice) * rho_air * R_v * T
    p_vs = TDI.saturation_vapor_pressure_over_liquid(tps, T)
    G = CO.G_func_liquid(aip, tps, T) / ap.rho_w

    alpha = p_v / p_vs * (Lv * ap.g / R_v / cp_m / T**2 - ap.g / R_m / T)
    gamma = (R_v * T / p_vs
             + p_v / p_vs * R_m * Lv**2 / R_v / cp_m / T / p)

    A = coeff_of_curvature(ap, T)
    sqrt_awG = jnp.sqrt(alpha * w / G)
    zeta = 2 * A / 3 * sqrt_awG

    Sm = critical_supersaturation(ap, ad, T)

    tmp = jnp.zeros_like(T)
    for Sm_i, mode in zip(Sm, ad.modes):
        f = ap.f1 * jnp.exp(ap.f2 * jnp.log(jnp.asarray(mode.stdev, dt)) ** 2)
        g = ap.g1 + ap.g2 * jnp.log(jnp.asarray(mode.stdev, dt))
        eta = sqrt_awG**3 / (2 * PI * ap.rho_w * gamma * mode.N)
        tmp = tmp + 1 / Sm_i**2 * (
            f * (zeta / eta) ** ap.p1
            + g * (Sm_i**2 / (eta + 3 * zeta)) ** ap.p2
        )
    S_max_ARG = 1 / jnp.sqrt(tmp)

    # condensation-sink corrections from preexisting liquid / ice
    N_liq = jnp.asarray(N_liq, dt)
    N_ice = jnp.asarray(N_ice, dt)
    N_liq_safe = jnp.maximum(N_liq, eps)
    r_liq = jnp.where(
        N_liq < eps, jnp.zeros_like(T),
        (rho_air * q_liq / N_liq_safe / ap.rho_w / (4 / 3 * PI)) ** (1 / 3))
    K_liq = 4 * PI * ap.rho_w * N_liq * r_liq * G * gamma

    Ls = TDI.latent_heat_sublim(tps, T)
    gamma_i = (R_v * T / p_vs
               + p_v / p_vs * R_m * Lv * Ls / R_v / cp_m / T / p)
    N_ice_safe = jnp.maximum(N_ice, eps)
    r_ice = jnp.where(
        N_ice < eps, jnp.zeros_like(T),
        (rho_air * q_ice / N_ice_safe / ap.rho_i / (4 / 3 * PI)) ** (1 / 3))
    rhoG_i = CO.G_func_ice(aip, tps, T)
    xi = (TDI.saturation_vapor_pressure_over_liquid(tps, T)
          / TDI.saturation_vapor_pressure_over_ice(tps, T))
    K_ice = 4 * PI * N_ice * r_ice * rhoG_i * gamma_i

    S_max = S_max_ARG * (alpha * w - K_ice * (xi - 1)) / (
        alpha * w + (K_liq + K_ice * xi) * S_max_ARG)
    return jnp.maximum(S_max, jnp.zeros_like(S_max))


def N_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice,
                         N_liq=0.0, N_ice=0.0):
    """Per-mode activated number via erf
    (reference src/AerosolActivation.jl:235-259)."""
    dt = float_dtype(T, p, w)
    smax = max_supersaturation(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                               q_ice, N_liq, N_ice)
    smax_safe = jnp.maximum(smax, jnp.asarray(jnp.finfo(dt).tiny, dt))
    sm = critical_supersaturation(ap, ad, T)
    out = []
    for sm_i, mode in zip(sm, ad.modes):
        u_i = (2 * jnp.log(sm_i / smax_safe) / 3 / jnp.sqrt(jnp.asarray(2.0, dt))
               / jnp.log(jnp.asarray(mode.stdev, dt)))
        out.append(mode.N * 0.5 * (1 - erf(u_i)))
    return tuple(out)


def M_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice,
                         N_liq=0.0, N_ice=0.0):
    """Per-mode activated mass via erfc
    (reference src/AerosolActivation.jl:294-321)."""
    dt = float_dtype(T, p, w)
    smax = max_supersaturation(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                               q_ice, N_liq, N_ice)
    smax_safe = jnp.maximum(smax, jnp.asarray(jnp.finfo(dt).tiny, dt))
    sm = critical_supersaturation(ap, ad, T)
    out = []
    for sm_i, mode in zip(sm, ad.modes):
        M_i = sum(mm * mr for mm, mr in zip(mode.molar_mass,
                                            mode.mass_mix_ratio))
        fac = 3 * jnp.log(jnp.asarray(mode.stdev, dt)) \
            * jnp.sqrt(jnp.asarray(2.0, dt)) / 2
        u_i = jnp.log(sm_i / smax_safe) / fac
        out.append(M_i / 2 * erfc(u_i - fac))
    return tuple(out)


def total_N_activated(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice,
                      N_liq=0.0, N_ice=0.0):
    return sum(N_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                                    q_ice, N_liq, N_ice))


def total_M_activated(ap, ad, aip, tps, T, p, w, q_tot, q_liq, q_ice,
                      N_liq=0.0, N_ice=0.0):
    return sum(M_activated_per_mode(ap, ad, aip, tps, T, p, w, q_tot, q_liq,
                                    q_ice, N_liq, N_ice))
