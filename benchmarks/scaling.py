"""Multi-device scaling harness: fused-step throughput vs device count.

Microphysics is vertical-column-local, so the protocol is WEAK scaling
over the ``columns`` mesh axis: constant columns per device, throughput
should scale linearly with device count (zero cross-device communication
in the step). The reference ecosystem carries its distributed story in
downstream CI (/root/reference/.buildkite/pipeline.yml:47-56); this file
is the equivalent.

One-command entry points
------------------------
All GPUs of one host:

    python benchmarks/scaling.py --out scaling.json

8-device virtual CPU smoke (validates the measurement logic only — the
recorded numbers are NOT performance; virtual devices share host cores):

    python benchmarks/scaling.py --smoke

Each device-count rung prints one JSON line
    {"devices": d, "ncol": ..., "grid_points_per_s": ...,
     "per_device": ..., "efficiency_vs_1dev": ...}
and ``--out`` writes the full ladder plus metadata as one artifact.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def measure_rung(n_devices, per_dev_cols, nlev, n_iter, reps=3,
                 kernel="1m"):
    """Throughput of a fused column step on the first ``n_devices``
    devices with ``per_dev_cols`` columns each (weak scaling).

    ``kernel``: ``"1m"`` (flagship fused 1M step) or ``"p3"`` (the full
    2M+P3 column step at the ladder-verified GL-8 setting, shape solve
    included, warm-started self-map). Both are column-local, so the
    scaling contract is identical: zero cross-device communication.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from __graft_entry__ import _build
    from cloudmicrophysics_tpu.parallel import column_mesh, shard_columns
    from cloudmicrophysics_tpu.perf import time_steps

    mesh = column_mesh(jax.devices()[:n_devices])
    put = lambda tree: shard_columns(tree, mesh)

    ncol = per_dev_cols * n_devices
    if kernel == "p3":
        import cloudmicrophysics_tpu as cm
        from cloudmicrophysics_tpu.models.column import (
            ColumnStateP3,
            step_column_p3,
        )
        from cloudmicrophysics_tpu.parameters import (
            ThermodynamicsParameters,
        )

        tps = ThermodynamicsParameters()
        mp3 = cm.parameters.microphysics_2m_params(with_ice=True,
                                                   quadrature_order=8)
        fc = lambda v: jnp.full((ncol, nlev), v, jnp.float32)
        st = ColumnStateP3(rho=fc(1.1), T=fc(263.0), q_tot=fc(6e-3),
                           q_lcl=fc(1e-3), n_lcl=fc(9e7), q_rai=fc(5e-4),
                           n_rai=fc(9e5), q_ice=fc(5e-4), n_ice=fc(1e5),
                           q_rim=fc(1e-4), b_rim=fc(2e-7))
        # ~16k grid points per chunk (see perf.chunked_cells). Chunking
        # must happen PER SHARD: chunking the global column axis under
        # one jit would make the sequential lax.map walk device slabs one
        # at a time (all other devices idle per step). shard_map splits columns across the
        # mesh first; each shard then chunks its local slab.
        local_cols = per_dev_cols
        chunks = max(local_cols * nlev // 16384, 1)
        while local_cols % chunks:
            chunks -= 1
        base = jax.jit(lambda x: step_column_p3(
            x[0], mp3, tps, 1.0, 100.0, x[1]))
        st0, ll0 = base((put(st), None))
        state = (st0, ll0)
        step_j = jax.shard_map(
            lambda x: step_column_p3(x[0], mp3, tps, 1.0, 100.0, x[1],
                                     col_chunks=chunks),
            mesh=mesh, in_specs=P("columns"), out_specs=P("columns"),
            check_vma=False)
        spec_of = lambda x: x[0].q_rai.sharding.spec
    else:
        step_j, state = _build(ncol=ncol, nlev=nlev, dtype=jnp.float32)
        state = put(state)
        spec_of = lambda x: x.q_rai.sharding.spec

    _, ms, _, out = time_steps(step_j, (state,), n_iter * reps)
    assert spec_of(out) == P("columns"), spec_of(out)
    best = min(ms) / 1e3
    return {
        "kernel": kernel,
        "devices": n_devices,
        "ncol": ncol,
        "nlev": nlev,
        "calls": n_iter * reps,
        "grid_points_per_s": ncol * nlev / best,
        "seconds_per_step": best,
        "stat": "best",
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-dev-cols", type=int, default=None,
                    help="columns per device (default: 65536 on GPU, "
                    "512 on CPU smoke)")
    ap.add_argument("--nlev", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--devices", type=str, default=None,
                    help="comma-separated rungs, e.g. 1,2,4,8 "
                    "(default: powers of 2 up to the device count)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes + explicit not-a-perf-number label "
                    "(virtual CPU mesh)")
    ap.add_argument("--kernel", choices=["1m", "p3"], default="1m",
                    help="which fused column step to ladder (p3 = full "
                    "2M+P3 at GL-8, shape solve included)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()

    import os

    if args.smoke:
        # must happen before jax import
        os.environ["JAX_PLATFORMS"] = "cpu"
        _flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in _flags:
            os.environ["XLA_FLAGS"] = (
                _flags + " --xla_force_host_platform_device_count=8"
            ).strip()

    import jax

    from __graft_entry__ import _enable_compile_cache
    from cloudmicrophysics_tpu.perf import gpu_label

    _enable_compile_cache()

    n_avail = len(jax.devices())
    platform = jax.devices()[0].platform
    label = None if args.smoke else gpu_label()
    if args.devices:
        rungs = [int(d) for d in args.devices.split(",")]
    else:
        rungs, d = [], 1
        while d <= n_avail:
            rungs.append(d)
            d *= 2
    if args.per_dev_cols is None:
        args.per_dev_cols = 512 if args.smoke else 65536
    if args.smoke:
        args.nlev = min(args.nlev, 32)
        args.iters = min(args.iters, 5)

    rows = []
    base = None
    for d in rungs:
        if d > n_avail:
            print(json.dumps({"devices": d,
                              "skipped": f"only {n_avail} available"}))
            continue
        row = measure_rung(d, args.per_dev_cols, args.nlev, args.iters,
                           kernel=args.kernel)
        if base is None:
            base = row["grid_points_per_s"] / row["devices"]
        row["per_device"] = float(
            f"{row['grid_points_per_s'] / row['devices']:.4g}")
        row["efficiency_vs_1dev"] = float(
            f"{row['per_device'] / base:.4g}")
        rows.append(row)
        print(json.dumps(row), flush=True)

    artifact = {
        "metric": f"{args.kernel} fused column step weak-scaling ladder",
        "unit": "grid-points/s",
        "platform": platform,
        "device": label,
        "n_devices_available": n_avail,
        # Virtual CPU devices time-share the host cores: a virtual ladder
        # validates ONLY the measurement/sharding logic, never speed.
        "is_perf_number": not args.smoke,
        "note": ("smoke run on a virtual mesh — NOT a performance number"
                 if args.smoke else
                 "weak scaling: constant columns per device"),
        "rungs": rows,
    }
    if args.out:
        Path(args.out).write_text(json.dumps(artifact, indent=1) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
