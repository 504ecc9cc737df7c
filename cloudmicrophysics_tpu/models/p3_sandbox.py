"""Minimal P3 ice sandbox driver.

JAX port of ``/root/reference/p3_sandbox/p3_sandbox.jl``: a
4-variable ODE ``[N_ice, q_ice, q_rim, B_rim]`` with ABIFM immersion
nucleation as the (only) source, Euler-stepped with ``lax.scan``. A
development scaffold for exercising the P3 state/threshold machinery.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import Array, lax

from ..ops import common as CMO
from ..ops import ice_nucleation as CMI
from ..ops import p3 as P3
from ..parameters.p3 import ParametersP3
from ..parameters.thermodynamics import ThermodynamicsParameters

PI = jnp.pi

__all__ = ["P3SandboxState", "run_p3_sandbox"]


class P3SandboxState(NamedTuple):
    N_ice: Array
    q_ice: Array
    q_rim: Array
    B_rim: Array


def run_p3_sandbox(ic: P3SandboxState, t_0, t_end, dt,
                   p3: ParametersP3, tps: ThermodynamicsParameters,
                   aerosol, T, p_air, q_vap, q_liq, N_liq, r_liq):
    """Euler-step the sandbox ODE; returns the trajectory and the final
    P3 state thresholds (D_th, D_gr, D_cr, rho_g)."""
    n_steps = int(round((t_end - t_0) / dt))
    q_tot = q_vap + q_liq

    R_a = jnp.asarray(tps.R_d * (1 - q_tot)
                      + tps.R_v * (q_tot - q_liq), float)
    e = q_vap * p_air * tps.R_v / R_a
    da_w = CMO.a_w_eT(tps, e, T) - CMO.a_w_ice(tps, T)
    J_imm = CMI.ABIFM_J(aerosol, da_w)
    dN_dt = J_imm * N_liq * 4 * PI * r_liq**2

    def step(y, _):
        y_new = P3SandboxState(
            N_ice=y.N_ice + dt * dN_dt,
            q_ice=y.q_ice, q_rim=y.q_rim, B_rim=y.B_rim)
        return y_new, y_new

    _, traj = lax.scan(step, ic, None, length=n_steps)

    # thresholds from the final rime state
    F_rim = jnp.where(traj.q_ice[-1] > 0,
                      traj.q_rim[-1] / jnp.maximum(traj.q_ice[-1], 1e-30),
                      jnp.zeros_like(traj.q_ice[-1]))
    rho_rim = jnp.where(traj.B_rim[-1] > 0,
                        traj.q_rim[-1] / jnp.maximum(traj.B_rim[-1], 1e-30),
                        jnp.zeros_like(traj.B_rim[-1]))
    state = P3.p3_state(p3, traj.q_ice[-1], traj.N_ice[-1], F_rim, rho_rim)
    thresholds = (state.D_th, state.D_gr, state.D_cr, state.rho_g)
    return traj, thresholds
