"""Alpert-Knopf immersion-freezing box model (L6 driver).

JAX port of ``/root/reference/box/box.jl``: a cooling box of
droplets freezing via ABIFM. Two variants:

* :func:`run_box` — deterministic rate ``dN_ice/dt = J(T) N_liq A``;
* :func:`run_box_stochastic` — the Alpert & Knopf 2016 per-droplet
  binomial-sampling variant, with a per-droplet surface-area vector: each
  droplet freezes with probability ``1 - exp(-A_j J dt)`` per step (frozen
  droplets are removed). Implemented as a ``lax.scan`` over a static
  droplet axis with jax PRNG — fully vectorized (no per-droplet Python
  loop) and vmap-able over ensembles.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array, lax

from ..ops import common as CMO
from ..ops import ice_nucleation as CMI
from ..parameters.thermodynamics import ThermodynamicsParameters

__all__ = ["BoxState", "run_box", "run_box_stochastic"]


class BoxState(NamedTuple):
    T: Array       # temperature [K]
    A_sum: Array   # total available surface area [m^2]
    N_liq: Array   # droplet number [1/m^3 or count]
    N_ice: Array   # ice number


def run_box(ic: BoxState, t_0, t_end, tps: ThermodynamicsParameters,
            aerosol, cooling_rate, A_aero, dt):
    """Deterministic ABIFM freezing in a cooling box
    (reference box/box.jl:11-40). Returns the trajectory."""
    n_steps = int(round((t_end - t_0) / dt))

    def step(y, _):
        da = 1 - CMO.a_w_ice(tps, y.T)
        J = CMI.ABIFM_J(aerosol, da)
        rate = jnp.where(y.N_liq > 0, J * y.N_liq * A_aero,
                         jnp.zeros_like(y.N_liq))
        y_new = BoxState(
            T=y.T - cooling_rate * dt,
            A_sum=y.A_sum,
            N_liq=y.N_liq - rate * dt,
            N_ice=y.N_ice + rate * dt,
        )
        return y_new, y_new

    _, traj = lax.scan(step, ic, None, length=n_steps)
    return BoxState(*(
        jnp.concatenate([jnp.expand_dims(jnp.asarray(a), 0), b])
        for a, b in zip(ic, traj)))


def run_box_stochastic(T0, Aj, t_0, t_end, tps: ThermodynamicsParameters,
                       aerosol, cooling_rate, dt, rng_key):
    """Stochastic per-droplet freezing (Alpert & Knopf 2016;
    reference box/box.jl:45-96).

    ``Aj`` is the per-droplet surface-area vector (static length = droplet
    count). Returns ``(T, N_liq, N_ice, A_sum)`` trajectories.
    """
    n_steps = int(round((t_end - t_0) / dt))
    Aj = jnp.asarray(Aj)

    def step(carry, _):
        T, frozen, key = carry
        da = 1 - CMO.a_w_ice(tps, T)
        J = CMI.ABIFM_J(aerosol, da)
        # freezing probability per droplet this step (A&K 2016 eq 10)
        P_frz = 1 - jnp.exp(-Aj * J * dt)
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, Aj.shape, P_frz.dtype)
        freeze_event = (u < P_frz) & ~frozen
        frozen = frozen | freeze_event
        T_new = T - cooling_rate * dt
        n_liq = jnp.sum(~frozen)
        n_ice = jnp.sum(frozen)
        a_sum = jnp.sum(jnp.where(frozen, jnp.zeros_like(Aj), Aj))
        return (T_new, frozen, key), (T_new, n_liq, n_ice, a_sum)

    init = (jnp.asarray(T0, Aj.dtype),
            jnp.zeros(Aj.shape, bool), rng_key)
    _, (T, n_liq, n_ice, a_sum) = lax.scan(step, init, None, length=n_steps)
    return T, n_liq, n_ice, a_sum
