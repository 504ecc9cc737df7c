"""Multi-kernel throughput suite (one JSON line per kernel).

Complements the driver-facing ``bench.py`` (which reports the single
headline 1M number) with per-scheme throughputs on the available device:

* ``1m_step``    — fused 1M bulk tendencies + sedimentation (ncol, nlev),
                   XLA's fusion and the Triton kernel (``1m_step_triton``)
* ``2m_step``    — the 2M warm-rain column step, XLA and ``impl="pallas"``
* ``2m_warm``    — fused SB2006 warm-rain tendencies
* ``2m_p3``      — warm rain + full P3 ice (shape solve outside, collision
                   quadrature inside) — the heaviest kernel
* ``parcel``     — Euler-scan parcel steps/s (latency-bound scan)

Each row is compiled once and timed with ``perf.time_steps`` (every call
fenced by ``jax.block_until_ready``); every line names the device and the
card's power limit. Needs a GPU.

Usage: ``python benchmarks/bench_suite.py [--n 4096]``
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--nlev", type=int, default=128)
    ap.add_argument("--p3-orders", type=str, default="16,8",
                    help="quadrature orders for the 2m_p3 rows (the GL-16 "
                    "default and the ladder-verified GL-8 fast setting)")
    args_cli = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from __graft_entry__ import _build, _enable_compile_cache

    _enable_compile_cache()

    import cloudmicrophysics_tpu as cm
    from cloudmicrophysics_tpu.models.tendencies import bulk_tendencies_2m
    from cloudmicrophysics_tpu.perf import gpu_label, time_steps

    label = gpu_label()
    tps = cm.parameters.ThermodynamicsParameters()
    F = jnp.float32
    N = args_cli.n * args_cli.nlev
    f = lambda v: jnp.full((N,), v, F)

    def row(name, fn, args, n_pts, n=10):
        # print each line as it lands so a late failure still leaves the
        # earlier numbers on stdout
        _, ms, _, _ = time_steps(fn, args, n)
        print(json.dumps({
            "metric": f"{name} throughput",
            "value": n_pts / (float(np.median(ms)) / 1e3),
            "unit": "grid-points/s" if name != "parcel" else "steps/s",
            "stat": "median",
            "batch": n_pts,
            "device": label,
        }), flush=True)

    # --- 1M fused step (same step as bench.py) ---
    step1, state1 = _build(ncol=args_cli.n, nlev=args_cli.nlev,
                           dtype=jnp.float32)
    row("1m_step", step1, (state1,), N)
    from cloudmicrophysics_tpu.kernels import step_column_1m_triton

    mp1, tv1 = (cm.parameters.microphysics_1m_params(),
                cm.parameters.terminal_velocity_params())
    row("1m_step_triton", lambda s: step_column_1m_triton(
        s, mp1, tps, tv1, 1.0, 100.0), (state1,), N)

    # --- 2M warm-rain column step, both compiled forms ---
    from cloudmicrophysics_tpu.models.column import (
        ColumnState2M,
        step_column_2m,
    )

    mp2 = cm.parameters.microphysics_2m_params()
    fc2 = lambda v: jnp.full((args_cli.n, args_cli.nlev), v, F)
    st2 = ColumnState2M(rho=fc2(1.1), T=fc2(288.0), q_tot=fc2(6e-3),
                        q_lcl=fc2(1e-3), n_lcl=fc2(9e7), q_rai=fc2(5e-4),
                        n_rai=fc2(9e5))
    for impl in ("xla", "pallas"):
        row(f"2m_step_{impl}", lambda s, impl=impl: step_column_2m(
            s, mp2, tps, 1.0, 100.0, impl=impl), (st2,), N)

    # --- 2M warm-rain tendencies ---
    a2 = (f(1.1), f(288.0), f(6e-3), f(1e-3), f(9e7), f(5e-4), f(9e5))
    row("2m_warm", lambda *a: bulk_tendencies_2m(mp2, tps, *a), a2, N)

    # --- 2M + P3 ice (pointwise; loglambda solved once, held) ---
    from cloudmicrophysics_tpu.ops import p3 as P3

    n3 = max(N // 16, 1024)
    f3 = lambda v: jnp.full((n3,), v, F)
    p3_orders = [int(o) for o in args_cli.p3_orders.split(",") if o]

    from cloudmicrophysics_tpu.perf import chunked_cells

    for order in p3_orders:
        mp3 = cm.parameters.microphysics_2m_params(with_ice=True,
                                                   quadrature_order=order)
        ps0 = P3.state_from_prognostic(
            mp3.ice.scheme, f3(1e-4 * 1.1), f3(9e4 * 1.1), f3(3e-5 * 1.1),
            f3(3e-5 / 400 * 1.1))
        ll3 = P3.get_distribution_loglambda(ps0)
        a3 = (f3(1.1), f3(263.0), f3(4e-3), f3(5e-4), f3(9e7), f3(2e-4),
              f3(9e5), f3(1e-4), f3(9e4), f3(3e-5), f3(3e-5 / 400), ll3)
        # ~16k cells per chunk, as in bench.py
        tend = chunked_cells(
            lambda *a, mp3=mp3: bulk_tendencies_2m(mp3, tps, *a),
            max(n3 // 16384, 1))
        row(f"2m_p3_gl{order}", tend, a3, n3, n=5)

    # --- full P3 column step (shape solve + processes + sedimentation),
    #     at the GL-8 fast setting ---
    from cloudmicrophysics_tpu.models.column import (
        ColumnStateP3,
        step_column_p3,
    )

    mp3c = cm.parameters.microphysics_2m_params(
        with_ice=True, quadrature_order=p3_orders[-1])
    ncol3, nlev3 = max(args_cli.n // 16, 64), args_cli.nlev
    fc = lambda v: jnp.full((ncol3, nlev3), v, F)
    st3 = ColumnStateP3(rho=fc(1.1), T=fc(263.0), q_tot=fc(6e-3),
                        q_lcl=fc(1e-3), n_lcl=fc(9e7), q_rai=fc(5e-4),
                        n_rai=fc(9e5), q_ice=fc(5e-4), n_ice=fc(1e5),
                        q_rim=fc(1e-4), b_rim=fc(2e-7))
    # column chunking (col_chunks -> perf.chunked_cells) at ~16k grid
    # points per chunk, as for the flat batch above
    cc = max(ncol3 * nlev3 // 16384, 1)
    while ncol3 % cc:
        cc -= 1
    step3 = lambda st, ll: step_column_p3(st, mp3c, tps, 1.0, 100.0, ll,
                                          col_chunks=cc)
    st3, loglam0 = jax.jit(step3)(st3, None)
    row(f"p3_column_step_gl{p3_orders[-1]}", step3, (st3, loglam0),
        ncol3 * nlev3, n=5)

    # --- parcel scan (steps/s; latency-bound) ---
    from cloudmicrophysics_tpu.models import parcel as PM

    ic = PM.ParcelState(S_l=F(1.02), p_air=F(8e4), T=F(278.0),
                        q_vap=F(6e-3), q_liq=F(1e-3), q_ice=F(0.0),
                        N_aer=F(1e8), N_liq=F(1e8), N_ice=F(0.0),
                        ln_inpc=F(0.0))
    params = PM.parcel_params(condensation_growth="Condensation",
                              const_dt=0.1, w=1.0)
    n_steps = 1000
    row("parcel", lambda ic: PM.run_parcel(ic, 0.0, n_steps * 0.1, params),
        (ic,), n_steps)


if __name__ == "__main__":
    main()
