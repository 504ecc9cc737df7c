"""Shared helpers for the example scripts (reference parcel/ParcelCommon.jl).

Each example mirrors one of the reference's ``parcel/Example_*.jl`` /
``box/*.jl`` validation scripts: same initial conditions and process
selection, output printed as numbers instead of CairoMakie figures.
Run any example directly: ``python examples/parcel_liquid_only.py``.
"""

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax

# Examples run on CPU by default (fast compile, full-precision f64
# transcendentals); set CMT_PLATFORM=gpu to run on the GPU.
jax.config.update("jax_platforms", os.environ.get("CMT_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from cloudmicrophysics_tpu.models import parcel as PM
from cloudmicrophysics_tpu.ops import thermo as TDI
from cloudmicrophysics_tpu.parameters import ThermodynamicsParameters

F = jnp.float64
TPS = ThermodynamicsParameters()


def parcel_ic(p_air, T, q_vap, q_liq, q_ice, N_aer, N_liq, N_ice,
              ln_inpc=0.0, tps=TPS):
    """Initial ParcelState from primitive variables (reference
    parcel examples' ``get_initial_condition`` wrapper)."""
    q_tot = q_vap + q_liq + q_ice
    R_a = (tps.R_d * (1 - q_tot) + tps.R_v * q_vap)
    e_sl = TDI.saturation_vapor_pressure_over_liquid(tps, F(T))
    e = q_vap * p_air * tps.R_v / R_a
    return PM.ParcelState(
        S_l=F(e / e_sl), p_air=F(p_air), T=F(T), q_vap=F(q_vap),
        q_liq=F(q_liq), q_ice=F(q_ice), N_aer=F(N_aer), N_liq=F(N_liq),
        N_ice=F(N_ice), ln_inpc=F(ln_inpc))


def vapor_mixing_to_q(c_v, tps=TPS):
    """Vapor volume mixing ratio -> specific content
    (reference Example_Jensen_et_al_2022.jl:28-31)."""
    eps_m = tps.R_d / tps.R_v
    return eps_m / (eps_m - 1 + 1 / c_v)


def frozen_fraction(traj):
    tot = jnp.maximum(traj.N_liq + traj.N_ice, 1.0)
    return traj.N_ice / tot


def summarize(name, traj, every=None):
    S_i_end = None
    print(f"== {name} ==")
    print(f"  t_end: S_l={float(traj.S_l[-1]):.4f} "
          f"T={float(traj.T[-1]):.2f} K "
          f"q_liq={float(traj.q_liq[-1]):.3e} "
          f"q_ice={float(traj.q_ice[-1]):.3e} "
          f"N_liq={float(traj.N_liq[-1]):.3e} "
          f"N_ice={float(traj.N_ice[-1]):.3e}")
    print(f"  peak supersaturation S_l-1 = "
          f"{float(jnp.max(traj.S_l)) - 1:.4%} at "
          f"t={float(jnp.argmax(traj.S_l))} steps")
    return traj
