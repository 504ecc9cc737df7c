"""Roofline analysis for the fused column steps (1M / 2M / 2M+P3) on a GPU.

Times each step (``perf.time_steps``: compiled once, each call fenced by
``jax.block_until_ready``) and compares it with two ceilings measured in
the same run, so the report can name the wall:

* the **measured copy roof**: a plain jitted copy moving the same bytes
  at the same shape, the device memory bandwidth this card reaches;
* the **transcendental rate**: a chained-``exp`` microbench. The column
  physics does no matrix products, so an elementwise step that misses the
  copy roof is spending the gap in the SMs' float32 arithmetic and
  special-function units.

``wall`` is "hbm" when a step reaches >= 70% of the measured copy roof,
else "compute". Each row also gives its share of the card's published
memory bandwidth (``PEAKS``). Prints one JSON line per row; needs a GPU.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Published peaks by JAX device_kind. Source: NVIDIA H100 data sheet, SXM
# part, at its full 700 W power limit (a card set lower cannot hold its
# top clock under load; the label printed with every row gives the limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12},
}


def peaks(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(PEAKS)}") from None


def _row(name, ms, n_pts, nbytes, copy_bw, hbm_bw):
    dt = min(ms) / 1e3
    achieved = nbytes / dt
    frac_copy = achieved / copy_bw
    return {
        "metric": name,
        "ms_per_step": min(ms),
        "ms_per_step_median": sorted(ms)[len(ms) // 2],
        "grid_points_per_s": n_pts / dt,
        "analytic_bytes_per_step": nbytes,
        "achieved_GBps": achieved / 1e9,
        "copy_roof_GBps": copy_bw / 1e9,
        "fraction_of_copy_roof": frac_copy,
        "fraction_of_hbm_datasheet": achieved / hbm_bw,
        "wall": "hbm" if frac_copy >= 0.7 else "compute",
        "stat": "best of the timed calls (median alongside)",
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ncol", type=int, default=524288)
    ap.add_argument("--nlev", type=int, default=128)
    ap.add_argument("--p3-ncol", type=int, default=4096,
                    help="column count for the (much heavier) P3 step")
    ap.add_argument("--p3-nlev", type=int, default=64)
    cli = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _build, _enable_compile_cache

    _enable_compile_cache()

    import cloudmicrophysics_tpu as cm
    from cloudmicrophysics_tpu.models.column import (
        ColumnState2M,
        ColumnStateP3,
        step_column_2m,
        step_column_p3,
    )
    from cloudmicrophysics_tpu.perf import gpu_label, time_steps

    label = gpu_label()
    hbm_bw = peaks(label["kind"])["hbm_bytes_per_s"]
    ncol, nlev = cli.ncol, cli.nlev
    N = ncol * nlev
    tps = cm.parameters.ThermodynamicsParameters()
    rows = []

    # --- measured copy roof: one read + one write of the 1M state -------
    step1, state1 = _build(ncol=ncol, nlev=nlev, dtype=jnp.float32)
    packed = jnp.stack(list(state1))
    copy_bytes = packed.size * 4 * 2
    _, ms, _, _ = time_steps(lambda x: x * 1.0000001, (packed,), 20)
    copy_bw = copy_bytes / (min(ms) / 1e3)
    rows.append({
        "metric": "copy_roof",
        "ms_per_step": min(ms),
        "bytes_per_step": copy_bytes,
        "achieved_GBps": copy_bw / 1e9,
        "fraction_of_hbm_datasheet": copy_bw / hbm_bw,
    })
    del packed

    # --- transcendental rate: chained exp at the same footprint ---------
    CHAIN = 64

    def exp_chain(x):
        for _ in range(CHAIN):
            x = jnp.exp(-x)          # stays in [e^-1, 1]
        return x

    _, ms, _, _ = time_steps(exp_chain, (jnp.full((N,), 0.5, jnp.float32),),
                             10)
    exp_rate = N * CHAIN / (min(ms) / 1e3)
    rows.append({"metric": "exp_rate", "exp_per_s": exp_rate,
                 "chain": CHAIN, "elements": N})

    # --- 1M fused step: XLA's fusion and the Triton kernel --------------
    from cloudmicrophysics_tpu.kernels import step_column_1m_triton

    mp1, tv = (cm.parameters.microphysics_1m_params(),
               cm.parameters.terminal_velocity_params())
    _, ms, _, _ = time_steps(step1, (state1,), 20)
    rows.append(_row("1m_column_step", ms, N, 14 * 4 * N, copy_bw, hbm_bw))
    _, ms, _, _ = time_steps(lambda s: step_column_1m_triton(
        s, mp1, tps, tv, 1.0, 100.0), (state1,), 20)
    rows.append(_row("1m_column_step_triton", ms, N, 14 * 4 * N, copy_bw,
                     hbm_bw))
    del state1

    # --- 2M warm-rain column step -----------------------------------------
    mp2 = cm.parameters.microphysics_2m_params()
    f = lambda v: jnp.full((ncol, nlev), v, jnp.float32)
    st2 = ColumnState2M(rho=f(1.1), T=f(288.0), q_tot=f(6e-3),
                        q_lcl=f(1e-3), n_lcl=f(9e7), q_rai=f(5e-4),
                        n_rai=f(9e5))
    for impl in ("xla", "pallas"):
        _, ms, _, _ = time_steps(lambda x, impl=impl: step_column_2m(
            x, mp2, tps, 1.0, 100.0, impl=impl), (st2,), 20)
        rows.append(_row(f"2m_column_step_{impl}", ms, N, 14 * 4 * N,
                         copy_bw, hbm_bw))
    del st2

    # --- full 2M+P3 column step (shape solve warm-started) -------------
    pncol, pnlev = cli.p3_ncol, cli.p3_nlev
    pN = pncol * pnlev
    mp3 = cm.parameters.microphysics_2m_params(with_ice=True)
    g = lambda v: jnp.full((pncol, pnlev), v, jnp.float32)
    st3 = ColumnStateP3(rho=g(1.1), T=g(263.0), q_tot=g(6e-3),
                        q_lcl=g(1e-3), n_lcl=g(9e7), q_rai=g(5e-4),
                        n_rai=g(9e5), q_ice=g(5e-4), n_ice=g(1e5),
                        q_rim=g(1e-4), b_rim=g(2e-7))
    p3_step = jax.jit(
        lambda st, ll: step_column_p3(st, mp3, tps, 1.0, 100.0, ll))
    st3, ll3 = p3_step(st3, None)
    _, ms, _, _ = time_steps(p3_step, (st3, ll3), 10)
    # 11 prognostic fields + loglambda, read + written
    rows.append(_row("p3_column_step", ms, pN, 12 * 4 * 2 * pN, copy_bw,
                     hbm_bw))
    rows[-1]["batch"] = [pncol, pnlev]
    rows[-1]["quadrature_order"] = 16  # library default (GL-16)
    # exp-equivalents per point the step could afford at the measured
    # exp rate: how far it is from a pure transcendental budget
    rows[-1]["exp_equivalents_per_point_budget"] = (
        exp_rate * min(ms) / 1e3 / pN)

    for r in rows:
        r["device"] = label
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
