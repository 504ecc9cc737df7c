"""Precipitation susceptibility: d ln(process) / d ln(q, N).

JAX port of ``/root/reference/src/PrecipitationSusceptibility.jl`` —
the reference uses ForwardDiff gradients in log space; here it is a direct
``jax.grad`` of the log-rate (free in JAX, per SURVEY.md §7 step 6).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from ..parameters import m2 as P2
from . import m2 as CM2

__all__ = [
    "PrecipSusceptibilityRates",
    "precipitation_susceptibility_autoconversion",
    "precipitation_susceptibility_accretion",
]


class PrecipSusceptibilityRates(NamedTuple):
    d_ln_pp_d_ln_q_lcl: Array
    d_ln_pp_d_ln_q_rai: Array
    d_ln_pp_d_ln_N_lcl: Array
    d_ln_pp_d_ln_N_rai: Array


def _log_susceptibility(rate_fn, q_lcl, q_rai, rho, N_lcl):
    """Gradient of log(rate) wrt log of each (positive) argument."""
    logs = jnp.stack([
        jnp.log(jnp.abs(jnp.asarray(q_lcl, float))),
        jnp.log(jnp.abs(jnp.asarray(q_rai, float))),
        jnp.log(jnp.abs(jnp.asarray(rho, float))),
        jnp.log(jnp.abs(jnp.asarray(N_lcl, float))),
    ])

    def f(x):
        e = jnp.exp(x)
        return jnp.log(rate_fn(e[0], e[1], e[2], e[3]))

    grad = jax.grad(f)(logs)
    return PrecipSusceptibilityRates(
        d_ln_pp_d_ln_q_lcl=grad[0],
        d_ln_pp_d_ln_q_rai=grad[1],
        d_ln_pp_d_ln_N_lcl=grad[3],
        d_ln_pp_d_ln_N_rai=jnp.zeros_like(grad[0]),
    )


def precipitation_susceptibility_autoconversion(sb: P2.SB2006, q_lcl, q_rai,
                                                rho, N_lcl):
    """Log-derivatives of the SB2006 autoconversion rain production
    (reference src/PrecipitationSusceptibility.jl:36-51)."""
    return _log_susceptibility(
        lambda ql, qr, r, nl: CM2.autoconversion(
            sb.acnv, sb.pdf_c, ql, qr, r, nl).dq_rai_dt,
        q_lcl, q_rai, rho, N_lcl)


def precipitation_susceptibility_accretion(sb: P2.SB2006, q_lcl, q_rai,
                                           rho, N_lcl):
    """Log-derivatives of the SB2006 accretion rain production
    (reference src/PrecipitationSusceptibility.jl:66-79)."""
    return _log_susceptibility(
        lambda ql, qr, r, nl: CM2.accretion(sb, ql, qr, r, nl).dq_rai_dt,
        q_lcl, q_rai, rho, N_lcl)
