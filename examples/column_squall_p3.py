"""Idealized mixed-phase column with the full 2M warm rain + P3 ice step.

The flagship driver end-to-end: a supersaturated mid-level cloud layer
over a sub-cloud layer, stepped with ``step_column_p3`` (shape solve
warm-started between steps). Prints a compact budget every N steps and
the final surface precipitation diagnostic — the host-model usage
pattern (reference ``test/gpu_clima_core_test.jl:34-40`` role, here with
ice).

Run: ``python examples/column_squall_p3.py [--ncol 256] [--nlev 64]
[--nsteps 120] [--order 8]``
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ncol", type=int, default=256)
    ap.add_argument("--nlev", type=int, default=64)
    ap.add_argument("--nsteps", type=int, default=120)
    ap.add_argument("--dt", type=float, default=2.0)
    ap.add_argument("--dz", type=float, default=250.0)
    ap.add_argument("--order", type=int, default=8)
    ap.add_argument("--col-chunks", type=int, default=None,
                    help="evaluate the step over N ncol chunks "
                    "(perf.chunked_cells; the benchmarks use ~16k grid "
                    "points per chunk)")
    cli = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    import cloudmicrophysics_tpu as cm
    from cloudmicrophysics_tpu.models.column import (
        ColumnStateP3,
        step_column_p3,
    )

    tps = cm.parameters.ThermodynamicsParameters()
    mp = cm.parameters.microphysics_2m_params(
        with_ice=True, quadrature_order=cli.order)

    ncol, nlev = cli.ncol, cli.nlev
    # idealized profiles: T decreasing with height through freezing,
    # a liquid cloud layer in the lower-middle, ice aloft
    z = np.linspace(0.0, cli.dz * (nlev - 1), nlev)
    T_prof = 292.0 - 7.0e-3 * z                      # through 0 C mid-column
    rho_prof = 1.2 * np.exp(-z / 8500.0)
    cloud = np.exp(-((z - 2500.0) / 900.0) ** 2)      # liquid layer
    anvil = np.exp(-((z - 9000.0) / 1500.0) ** 2)     # ice layer

    tile = lambda p: jnp.asarray(np.broadcast_to(p, (ncol, nlev)),
                                 jnp.float32)
    st = ColumnStateP3(
        rho=tile(rho_prof), T=tile(T_prof),
        q_tot=tile(9e-3 * np.exp(-z / 3000.0)),
        q_lcl=tile(1.2e-3 * cloud), n_lcl=tile(1.0e8 * cloud),
        q_rai=tile(2e-4 * cloud), n_rai=tile(8e5 * cloud),
        q_ice=tile(6e-4 * anvil), n_ice=tile(1.2e5 * anvil),
        q_rim=tile(1.5e-4 * anvil), b_rim=tile(3e-7 * anvil),
    )

    step = jax.jit(lambda s, g: step_column_p3(s, mp, tps, cli.dt,
                                               cli.dz, g,
                                               col_chunks=cli.col_chunks))
    guess = None
    path_b = lambda q: float(jnp.sum(st.rho[0] * q[0]) * cli.dz)
    print(f"{'step':>5s} {'LWP[kg/m2]':>11s} {'RWP':>8s} {'IWP':>8s} "
          f"{'T_sfc[K]':>9s}")
    for i in range(cli.nsteps):
        st, guess = step(st, guess)
        if i % max(cli.nsteps // 6, 1) == 0 or i == cli.nsteps - 1:
            lwp = float(jnp.sum(st.rho[0] * st.q_lcl[0]) * cli.dz)
            rwp = float(jnp.sum(st.rho[0] * st.q_rai[0]) * cli.dz)
            iwp = float(jnp.sum(st.rho[0] * (st.q_ice[0])) * cli.dz)
            print(f"{i:5d} {lwp:11.5f} {rwp:8.5f} {iwp:8.5f} "
                  f"{float(st.T[0, 0]):9.2f}")

    for leaf in jax.tree_util.tree_leaves(st):
        assert np.all(np.isfinite(np.asarray(leaf)))
    print(f"final column-0 budgets: LWP={path_b(st.q_lcl):.5f} "
          f"RWP={path_b(st.q_rai):.5f} IWP={path_b(st.q_ice):.5f} "
          f"rime fraction="
          f"{float(jnp.sum(st.q_rim) / jnp.maximum(jnp.sum(st.q_ice), 1e-12)):.3f}")


if __name__ == "__main__":
    main()
