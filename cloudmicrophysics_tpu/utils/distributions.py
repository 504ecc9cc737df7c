"""Size-distribution tools (generalized gamma + exponential).

JAX port of the reference ``src/DistributionTools.jl`` — closed-form
quantiles / CDFs / moments used mostly by the 2-moment scheme and the P3
integral bounds.
"""

from __future__ import annotations

import jax.numpy as jnp

from .special import expm1, fac, gamma_inc, gamma_inc_inv, lgamma

__all__ = [
    "generalized_gamma_quantile",
    "generalized_gamma_quantile_unit_mu",
    "generalized_gamma_cdf",
    "generalized_gamma_moment",
    "exponential_cdf",
    "exponential_quantile",
    "exponential_moment",
]


def log1mexp(x):
    """Stable ``log(1 - exp(x))`` for ``x <= 0``."""
    log2 = jnp.log(jnp.asarray(2.0, jnp.result_type(x, float)))
    x_hi = jnp.minimum(x, -jnp.finfo(jnp.result_type(x, float)).tiny)
    return jnp.where(
        x > -log2,
        jnp.log(-expm1(x_hi)),
        jnp.log1p(-jnp.exp(x_hi)),
    )


def generalized_gamma_quantile(nu, mu, B, Y, n_iters=None):
    """Quantile of ``g(x) = A x^nu exp(-B x^mu)``
    (reference ``src/DistributionTools.jl:44-48``).

    ``n_iters`` forwards to :func:`gamma_inc_inv` — integration-bound
    call sites pass a reduced Halley count (see that docstring)."""
    kw = {} if n_iters is None else {"n_iters": n_iters}
    z = gamma_inc_inv((nu + 1) / mu, Y, 1 - Y, **kw)
    return (z / B) ** (1 / mu)


def generalized_gamma_quantile_unit_mu(nu, B, Y, n_iters=None):
    """``mu == 1`` special case — hot P3 ``integral_bounds`` path
    (reference ``src/DistributionTools.jl:57-58``)."""
    kw = {} if n_iters is None else {"n_iters": n_iters}
    return gamma_inc_inv(nu + 1, Y, 1 - Y, **kw) / B


def generalized_gamma_cdf(nu, mu, B, x):
    """CDF ``P(X <= x)`` of the generalized gamma distribution
    (reference ``src/DistributionTools.jl:77-87``)."""
    x_safe = jnp.maximum(x, jnp.zeros_like(x))
    p, _ = gamma_inc((nu + 1) / mu, B * x_safe**mu)
    return jnp.where(x <= 0, jnp.zeros_like(p), p)


def generalized_gamma_moment(nu, mu, B, N, n):
    """n-th physical moment ``M^n = N B^(-n/mu) G((nu+1+n)/mu)/G((nu+1)/mu)``
    (SB2006 Eq 82; reference ``src/DistributionTools.jl:109-112``)."""
    return N * B ** (-n / mu) * jnp.exp(
        lgamma((nu + 1 + n) / mu) - lgamma((nu + 1) / mu)
    )


def exponential_cdf(D_mean, D):
    """CDF of ``n(D) = N0 exp(-D/D_mean)``
    (reference ``src/DistributionTools.jl:131-139``)."""
    p = jnp.exp(log1mexp(-D / D_mean))
    return jnp.where(D < 0, jnp.zeros_like(p), p)


def exponential_quantile(D_mean, Y):
    """Quantile ``D = -D_mean log(1 - Y)``
    (reference ``src/DistributionTools.jl:158-165``)."""
    return -D_mean * jnp.log1p(-Y)


def exponential_moment(D_mean, N, n: int):
    """n-th moment ``M^n = N n! D_mean^n``
    (reference ``src/DistributionTools.jl:189-191``)."""
    return N * fac(n) * D_mean**n
