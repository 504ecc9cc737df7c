"""Performance-regression harness and timing helpers.

JAX analog of the reference's ``bench_press``
(``/root/reference/test/performance_tests.jl:26-76``), which enforces a
per-call latency budget, zero allocations, JET type-stability, and a
return-type check on every hot function. The XLA equivalents enforced
here:

* **latency budget** — best-of-N wall time of the *compiled* call;
* **zero retrace** — calling again with same-shape/dtype arguments must
  not re-trace (the XLA analog of zero allocations: a retrace means the
  function's cache key depends on values it shouldn't);
* **dtype preservation** — float32 in → float32 out (the analog of the
  reference's ``FT`` return-type check / type-stability gate).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["bench_press", "BenchReport", "profile_trace", "chunked_cells",
           "enable_compile_cache", "gpu_label", "time_steps"]


def enable_compile_cache(default_dir: str) -> str:
    """Keep JAX's persistent compile cache in ``$JAX_COMPILATION_CACHE_DIR``
    when that is set, else in ``default_dir`` (a fixed path, because the
    path is part of the cache key). Returns the directory used."""
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or default_dir
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache


def gpu_label() -> dict:
    """The device every timing is taken on: JAX's view of it plus the
    card's name and power limit from ``nvidia-smi`` (a card set below its
    maximum power runs slower under load). Raises unless JAX's first
    device is a GPU: a timing from any other device is not a measurement
    of this program."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"timings need a GPU; JAX's first device is {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": smi.strip().splitlines()[0]}


def time_steps(fn: Callable, args: tuple, n: int = 5):
    """Compile ``jax.jit(fn)`` for ``args``, run it once to warm up, then
    time ``n`` calls, each fenced by ``jax.block_until_ready``.

    Returns ``(compile_seconds, milliseconds_per_call, compiled, out)``.
    """
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ms.append((time.perf_counter() - t0) * 1e3)
    return compile_s, ms, compiled, out


def chunked_cells(fn: Callable, n_chunks: int) -> Callable:
    """Evaluate ``fn`` over ``n_chunks`` equal slices of the leading
    (cell) axis with ``lax.map``.

    For the very large fused quadrature kernels (2M+P3 at millions of
    cells) one flat fusion streams every shared node table across the
    whole batch at once; mapping over cell chunks bounds the working
    set. The callers use ~16k cells per chunk, where a (64, 16384) f32
    node table is ~4 MB; whether that size suits the GPU is not yet
    measured (a chunk that small may not fill every SM). Identical
    math and output; the leading axis of every input/output array leaf
    must be divisible by ``n_chunks``.

    MULTI-DEVICE NOTE: apply this PER SHARD (inside ``jax.shard_map``
    over the columns mesh axis), not around a globally-sharded array —
    the sequential ``lax.map`` would otherwise walk one device slab at
    a time while the rest of the mesh idles (see benchmarks/scaling.py
    for the pattern). Single-device jits can wrap directly.
    """
    from jax import lax

    def wrapped(*args):
        split = lambda x: x.reshape((n_chunks, -1) + x.shape[1:])
        args_c = jax.tree_util.tree_map(split, args)
        out = lax.map(lambda a: fn(*a), args_c)
        return jax.tree_util.tree_map(
            lambda x: x.reshape((-1,) + x.shape[2:]), out)

    return wrapped


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a ``jax.profiler`` device trace (XProf/TensorBoard format)
    for everything run inside the context — the replacement for the
    reference's allocation-profile dump on budget breach
    (``test/performance_tests.jl:52-67``; SURVEY.md §5)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class BenchReport(NamedTuple):
    name: str
    best_ns: float
    budget_ns: float
    n_traces: int
    ok: bool


def _leaf_dtypes(tree: Any) -> set:
    return {
        l.dtype for l in jax.tree_util.tree_leaves(tree)
        if hasattr(l, "dtype") and jnp.issubdtype(l.dtype, jnp.floating)
    }


def bench_press(
    fn: Callable,
    args: tuple,
    max_time_ns: float,
    name: str | None = None,
    n_calls: int = 10,
    check_dtype: bool = True,
    static_argnums: tuple = (),
) -> BenchReport:
    """Jit ``fn``, enforce the three invariants, return a report.

    Raises ``AssertionError`` on budget breach, retrace, or dtype
    promotion — mirroring the reference's test-failure-on-budget-breach
    contract (test/performance_tests.jl:52-67)."""
    name = name or getattr(fn, "__name__", "<fn>")
    n_traces = 0

    def counted(*a):
        nonlocal n_traces
        n_traces += 1
        return fn(*a)

    jitted = jax.jit(counted, static_argnums=static_argnums)

    out = jitted(*args)
    jax.block_until_ready(out)
    out2 = jitted(*args)  # same shapes/dtypes: must hit the cache
    jax.block_until_ready(out2)
    assert n_traces == 1, (
        f"bench_press[{name}]: retraced on identical call "
        f"({n_traces} traces) — cache key depends on argument values")

    if check_dtype:
        in_dt = _leaf_dtypes(args)
        out_dt = _leaf_dtypes(out)
        if in_dt and out_dt:
            widest_in = max(in_dt, key=lambda d: jnp.finfo(d).bits)
            bad = {d for d in out_dt
                   if jnp.finfo(d).bits > jnp.finfo(widest_in).bits}
            assert not bad, (
                f"bench_press[{name}]: output promoted to {bad} from "
                f"{in_dt} inputs")

    best = float("inf")
    for _ in range(n_calls):
        t0 = time.perf_counter_ns()
        r = jitted(*args)
        jax.block_until_ready(r)
        best = min(best, time.perf_counter_ns() - t0)

    ok = best <= max_time_ns
    report = BenchReport(name=name, best_ns=best, budget_ns=max_time_ns,
                         n_traces=n_traces, ok=ok)
    assert ok, (
        f"bench_press[{name}]: best {best / 1e6:.3f} ms over budget "
        f"{max_time_ns / 1e6:.3f} ms")
    return report
