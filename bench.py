"""Benchmark: grid-points/s of the fused column microphysics on one GPU.

Prints one JSON line per step, each naming the device and the card's
power limit:

* the fused 2M+P3 bulk tendencies at GL-16 on 2,097,152 cells, chunked
  ~16k cells per ``lax.map`` iteration;
* the fused 1M column step (all process rates + sedimentation) at
  524,288 x 128 columns, through its Triton-route kernel (faster than
  XLA's fusion of the plain step on the H100; PERF.md).

Each step is compiled once and timed over 20 calls (10 for P3), each
fenced by ``jax.block_until_ready``; the line gives the best and the
median. Needs a GPU.
"""

import json

import numpy as np


def _line(metric, cells, ms, label, **extra):
    return json.dumps({
        "metric": metric,
        "value": cells / (min(ms) / 1e3),
        "unit": "grid-points/s",
        "stat": "best",
        "median_value": cells / (float(np.median(ms)) / 1e3),
        "calls": len(ms),
        "device": label,
        **extra,
    })


def main():
    import jax.numpy as jnp

    from __graft_entry__ import _build, _enable_compile_cache
    from cloudmicrophysics_tpu.perf import gpu_label, time_steps

    _enable_compile_cache()
    label = gpu_label()

    print(_bench_p3_gl16(label), flush=True)

    from cloudmicrophysics_tpu.kernels import step_column_1m_triton
    from cloudmicrophysics_tpu.parameters import (
        ThermodynamicsParameters, microphysics_1m_params,
        terminal_velocity_params)

    ncol, nlev = 524288, 128
    _, state = _build(ncol=ncol, nlev=nlev, dtype=jnp.float32)
    mp, tps, tv = (microphysics_1m_params(), ThermodynamicsParameters(),
                   terminal_velocity_params())
    _, ms, _, out = time_steps(
        lambda s: step_column_1m_triton(s, mp, tps, tv, 1.0, 100.0),
        (state,), 20)
    assert np.isfinite(float(jnp.sum(out.q_rai)))
    print(_line("fused 1M bulk-tendency + sedimentation throughput",
                ncol * nlev, ms, label), flush=True)


def _bench_p3_gl16(label):
    import jax.numpy as jnp

    from cloudmicrophysics_tpu.models.tendencies import bulk_tendencies_2m
    from cloudmicrophysics_tpu.ops import p3 as P3
    from cloudmicrophysics_tpu.parameters import (
        ThermodynamicsParameters, microphysics_2m_params)
    from cloudmicrophysics_tpu.perf import chunked_cells, time_steps

    tps = ThermodynamicsParameters()
    mp3 = microphysics_2m_params(with_ice=True, quadrature_order=16)
    n3 = 2 * 1024 * 1024
    f3 = lambda v: jnp.full((n3,), v, jnp.float32)

    ps0 = P3.state_from_prognostic(
        mp3.ice.scheme, f3(1e-4 * 1.1), f3(9e4 * 1.1), f3(3e-5 * 1.1),
        f3(3e-5 / 400 * 1.1))
    ll3 = P3.get_distribution_loglambda(ps0)
    a3 = (f3(1.1), f3(263.0), f3(4e-3), f3(5e-4), f3(9e7), f3(2e-4),
          f3(9e5), f3(1e-4), f3(9e4), f3(3e-5), f3(3e-5 / 400), ll3)
    chunks = n3 // 16384
    tend = chunked_cells(
        lambda *a: bulk_tendencies_2m(mp3, tps, *a), chunks)
    _, ms, _, out = time_steps(tend, a3, 10)
    assert np.isfinite(float(jnp.sum(out.dq_ice_dt)))
    return _line("fused 2M+P3 bulk tendencies (GL-16)", n3, ms, label,
                 chunks=chunks)


if __name__ == "__main__":
    main()
