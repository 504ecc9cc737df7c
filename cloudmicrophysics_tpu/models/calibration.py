"""Ensemble Kalman Inversion (EKI) calibration over the parcel model.

JAX re-design of the reference's EKP-based ABIFM calibration
(``/root/reference/papers/ice_nucleation_2024/calibration.jl:294-410``):
the forward map is the jitted, **vmapped** parcel model — all ensemble
members run as one batched device computation per iteration — and the
EKI update is a few small matmuls.

Provides a generic :func:`eki_calibrate` plus the ABIFM (m, c) perfect-model
recovery workflow mirrored from the reference tests
(``test/ice_nucleation_calibration.jl``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = ["EKIResult", "eki_calibrate", "uki_calibrate", "calibrate_abifm"]


class EKIResult(NamedTuple):
    theta: Array          # calibrated parameter means, shape (n_params,)
    ensemble: Array       # final ensemble, shape (n_params, n_ens)
    errors: Array         # data misfit per iteration
    iterations: int


def eki_calibrate(
    forward_map: Callable[[Array], Array],
    prior_mean,
    prior_std,
    y_obs,
    noise_cov,
    n_ensemble: int = 25,
    n_iterations: int = 10,
    rng_key=None,
) -> EKIResult:
    """Basic Ensemble Kalman Inversion.

    ``forward_map(theta_batch)`` maps a ``(n_ens, n_params)`` parameter
    batch to ``(n_ens, n_obs)`` predictions — typically a ``vmap`` of a
    jitted model, so each EKI iteration is one fused device computation.

    The update is the standard EKI step
    ``theta <- theta + C_tg (C_gg + Gamma)^-1 (y - g)`` with sample
    covariances over the ensemble.
    """
    if rng_key is None:
        rng_key = jax.random.PRNGKey(24)
    prior_mean = jnp.asarray(prior_mean, jnp.float64)
    prior_std = jnp.asarray(prior_std, jnp.float64)
    y_obs = jnp.asarray(y_obs, jnp.float64)
    noise_cov = jnp.asarray(noise_cov, jnp.float64)
    n_params = prior_mean.shape[0]
    n_obs = y_obs.shape[0]

    rng_key, sub = jax.random.split(rng_key)
    theta = prior_mean[None, :] + prior_std[None, :] * jax.random.normal(
        sub, (n_ensemble, n_params), jnp.float64)

    errors = []
    for it in range(n_iterations):
        g = jnp.asarray(forward_map(theta), jnp.float64)  # (n_ens, n_obs)
        g_mean = jnp.mean(g, axis=0)
        t_mean = jnp.mean(theta, axis=0)
        dg = g - g_mean
        dt = theta - t_mean
        C_tg = dt.T @ dg / (n_ensemble - 1)          # (n_params, n_obs)
        C_gg = dg.T @ dg / (n_ensemble - 1)          # (n_obs, n_obs)
        K = C_tg @ jnp.linalg.solve(C_gg + noise_cov, jnp.eye(n_obs))
        # perturbed observations
        rng_key, sub = jax.random.split(rng_key)
        y_pert = y_obs[None, :] + jax.random.multivariate_normal(
            sub, jnp.zeros(n_obs), noise_cov, (n_ensemble,))
        theta = theta + (y_pert - g) @ K.T
        err = float(jnp.mean(jnp.sum((g_mean - y_obs) ** 2)))
        errors.append(err)

    return EKIResult(theta=jnp.mean(theta, axis=0), ensemble=theta.T,
                     errors=jnp.asarray(errors), iterations=n_iterations)


def uki_calibrate(
    forward_map: Callable[[Array], Array],
    prior_mean,
    prior_std,
    y_obs,
    noise_cov,
    n_iterations: int = 25,
    alpha_reg: float = 1.0,
) -> EKIResult:
    """Unscented Kalman Inversion (Huang, Schneider & Stuart 2022) — the
    reference's second calibration mode
    (papers/ice_nucleation_2024/calibration.jl:364-410, ``EKP.Unscented``).

    Deterministic sigma-point ensemble (2p+1 members for p parameters),
    no sampling noise; ``forward_map`` has the same batched contract as
    :func:`eki_calibrate`. With ``alpha_reg < 1`` the prior regularizes
    each prediction step."""
    prior_mean = jnp.asarray(prior_mean, jnp.float64)
    prior_std = jnp.asarray(prior_std, jnp.float64)
    y_obs = jnp.asarray(y_obs, jnp.float64)
    Gamma = jnp.asarray(noise_cov, jnp.float64)
    p = prior_mean.shape[0]

    r = prior_mean
    C0 = jnp.diag(prior_std**2)
    m, C = prior_mean, C0
    Sigma_nu = 2.0 * Gamma
    Sigma_omega = max(2.0 - alpha_reg**2, 0.0) * C0

    # unscented weights (kappa = 0, standard symmetric set, a = 1/sqrt(p+l))
    lam = 1.0
    w0 = lam / (p + lam)
    wj = 1.0 / (2 * (p + lam))
    weights = jnp.concatenate([jnp.asarray([w0]), jnp.full((2 * p,), wj)])

    errors = []
    theta = None
    for _ in range(n_iterations):
        # prediction
        m_hat = r + alpha_reg * (m - r)
        C_hat = alpha_reg**2 * C + Sigma_omega
        # sigma points: m_hat, m_hat +- sqrt((p+lam) C_hat) columns
        L = jnp.linalg.cholesky((p + lam) * C_hat
                                + 1e-12 * jnp.eye(p))
        theta = jnp.concatenate(
            [m_hat[None, :], m_hat[None, :] + L.T, m_hat[None, :] - L.T],
            axis=0)                                     # (2p+1, p)
        g = jnp.asarray(forward_map(theta), jnp.float64)  # (2p+1, n_obs)
        y_hat = weights @ g
        dth = theta - m_hat
        dg = g - y_hat
        C_ty = (dth * weights[:, None]).T @ dg
        C_yy = (dg * weights[:, None]).T @ dg + Sigma_nu
        K = C_ty @ jnp.linalg.solve(C_yy, jnp.eye(C_yy.shape[0]))
        m = m_hat + K @ (y_obs - y_hat)
        C = C_hat - K @ C_ty.T
        errors.append(float(jnp.sum((y_hat - y_obs) ** 2)))

    return EKIResult(theta=m, ensemble=theta.T,
                     errors=jnp.asarray(errors), iterations=n_iterations)


def calibrate_abifm(ic, t_end, parcel_kwargs, y_obs, noise_std=0.05,
                    prior_mean=(40.0, -6.0), prior_std=(15.0, 5.0),
                    n_ensemble=25, n_iterations=8, observable="frozen_frac",
                    n_obs_times=5, method="EKI"):
    """Calibrate ABIFM ``(m, c)`` against observed frozen fractions from a
    parcel simulation — the reference's ice_nucleation_2024 workflow with
    the parcel ensemble as one vmapped forward map."""
    import dataclasses

    from ..parameters.aerosol_species import Illite
    from . import parcel as PM

    base_aerosol = Illite()

    def single(theta):
        aerosol = dataclasses.replace(base_aerosol, ABIFM_m=theta[0],
                                      ABIFM_c=theta[1])
        params = PM.parcel_params(aerosol=aerosol, **parcel_kwargs)
        traj = PM.run_parcel(ic, 0.0, t_end, params)
        N_tot = traj.N_liq + traj.N_ice
        frozen_frac = traj.N_ice / jnp.maximum(N_tot, 1.0)
        idx = jnp.linspace(0, frozen_frac.shape[0] - 1, n_obs_times
                           ).astype(int)
        return frozen_frac[idx]

    forward = jax.jit(jax.vmap(single))
    n_obs = len(y_obs)
    noise_cov = np.eye(n_obs) * noise_std**2
    if method == "UKI":
        return uki_calibrate(forward, prior_mean, prior_std, y_obs,
                             noise_cov, n_iterations=n_iterations)
    return eki_calibrate(forward, prior_mean, prior_std, y_obs, noise_cov,
                         n_ensemble=n_ensemble, n_iterations=n_iterations)
