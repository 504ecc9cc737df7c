"""Drive the column-microphysics main path once on one GPU and check it.

    python chip_smoke.py            # every phase below, on one GPU
    python chip_smoke.py --four     # only the four-GPU column-mesh phase
    python chip_smoke.py --tiny     # the same phases at toy sizes (rehearsal)

Phases, in order, all in float32 through the public API, with the states
made from ``--seed``:

1. device: JAX's first device must be a GPU; prints its kind, the device
   count and the card's name and power limit from ``nvidia-smi``;
2. ``step_column_1m`` and ``step_column_2m`` at 524,288 x 128 cells,
   ``step_column_p3`` at GL-8 on 16,384 x 128 (a cold step, then a
   warm-started step timed flat and chunked), the fused 2M+P3
   ``bulk_tendencies_2m`` at GL-16 on 2,097,152 cells, and a 1,000-step
   ``run_parcel`` trajectory. Each prints its compile time, ms per step,
   the device's peak memory, the compiled program's memory analysis and
   the largest error of every output field against the same function run
   in float64 on the CPU on a slice of the input;
3. the 1M and 2M column steps' Triton kernels against XLA's plain steps,
   at full width.

Any failure raises. The last line of a passing run is one JSON object,
``{"ok": true, "device": {...}}``. With ``--tiny`` the phases run at toy
sizes on whatever device JAX has, and the device check runs last, so a
CPU rehearsal exercises every phase and still refuses to report ok.
"""

import argparse
import json
from typing import NamedTuple

import jax

# float64 is for the CPU reference only; every input on the GPU is made
# float32 explicitly
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import __graft_entry__ as GE  # noqa: E402
from cloudmicrophysics_tpu.models import parcel as PM  # noqa: E402
from cloudmicrophysics_tpu.kernels import (  # noqa: E402
    step_column_1m_triton,
    step_column_2m_triton,
)
from cloudmicrophysics_tpu.models.column import (  # noqa: E402
    ColumnState2M,
    ColumnStateP3,
    step_column_1m,
    step_column_2m,
    step_column_p3,
)
from cloudmicrophysics_tpu.models.tendencies import (  # noqa: E402
    bulk_tendencies_2m,
)
from cloudmicrophysics_tpu.ops import p3 as P3  # noqa: E402
from cloudmicrophysics_tpu.parallel import (  # noqa: E402
    column_mesh,
    shard_columns,
)
from cloudmicrophysics_tpu.parameters import (  # noqa: E402
    ThermodynamicsParameters,
    microphysics_1m_params,
    microphysics_2m_params,
    terminal_velocity_params,
)
from cloudmicrophysics_tpu.perf import (  # noqa: E402
    chunked_cells,
    gpu_label,
    time_steps,
)


class Sizes(NamedTuple):
    ncol: int          # columns of the 1M and 2M steps
    nlev: int          # levels of every column step
    p3_ncol: int       # columns of the P3 step
    p3_order: int      # quadrature order of the P3 step
    cells: int         # cells of the flat fused tendency
    tend_order: int    # quadrature order of the fused tendency
    parcel_steps: int  # parcel trajectory length
    ref_cols: int      # columns compared with the f64 reference
    ref_cells: int     # flat cells compared with the f64 reference
    chunk_cells: int   # cells per lax.map chunk of the chunked P3 paths


FULL = Sizes(524288, 128, 16384, 8, 2097152, 16, 1000, 64, 8192, 16384)
TINY = Sizes(64, 16, 16, 4, 4096, 4, 50, 8, 512, 64)

# Largest allowed error of each output against the float64 CPU reference,
# as max|gpu - ref| / max|ref| over the compared slice (relative to the
# field's own scale, so cells near a clamp or a `where` threshold that
# take the other branch in float32 show as a local error of the size of
# that cell's increment, not as an infinite pointwise ratio).
TOL = {
    # a float32 step of float32-rounded inputs: each state changes by a
    # small increment, so the state error stays near float32 rounding
    # (1.2e-7); 1e-5 leaves room for increments computed through
    # exp/log/pow chains and for a few cells switching branch
    "1m_step": 1e-5,
    "2m_step": 1e-5,
    # the P3 step adds the fixed-iteration shape solve (f32 warm-start
    # gate rtol 1e-3, BASELINE.md) and float32 quadrature node tables,
    # which move the process rates at the 1e-4 level
    "p3_step": 1e-3,
    # raw tendencies carry the solver and quadrature error undiluted
    "p3_tendency": 2e-3,
    # 1,000 explicit steps accumulate float32 rounding of each step
    "parcel": 1e-4,
}
# Share of cells that may take another branch on the GPU than in the CPU's
# float32 run (a where-threshold, a clamp or a fixed-iteration solve that
# lands on the other side under another rounding order).
FLIP_SHARE = 0.01
# The P3 shape solve is a fixed-iteration Brent search; in float32 it does
# not land on the float64 root in a sizeable share of randomly perturbed
# cells, and two float32 runs with another rounding order land apart in a
# few percent of them (4.4% of 8,192 cells, H100 vs CPU, both float32).
# Solves agree when log(lambda) agrees to the reference's float64
# warm-start gate (BASELINE.md).
SOLVE_RTOL = 1e-4
SOLVE_FLIP_SHARE = 0.1


def check_device():
    """Exit unless JAX's first device is a GPU: no CPU fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX's first device is {dev.platform}")
    label = gpu_label()
    print(f"device: {label['kind']} x{label['count']}", flush=True)
    print(f"nvidia-smi: {label['nvidia_smi']}", flush=True)
    return label


def max_rel_err(got, want) -> float:
    """``max|got - want| / max|want|``; infinite if ``got`` is not finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise ValueError(f"shape {got.shape} != reference {want.shape}")
    if not np.all(np.isfinite(got)):
        return float("inf")
    scale = np.max(np.abs(want))
    diff = np.max(np.abs(got - want)) if got.size else 0.0
    return float(diff / scale) if scale > 0 else float(diff)


def compare(got: dict, want: dict, tol: float, base: dict = None) -> dict:
    """Per-field :func:`max_rel_err` of ``got`` against ``want``. Raises if
    one exceeds the same field's error in ``base`` (the CPU's own float32
    result, when given) by more than ``tol``."""
    errs = {k: max_rel_err(got[k], want[k]) for k in want}
    floor = {k: 0.0 if base is None else max_rel_err(base[k], want[k])
             for k in want}
    bad = {k: (e, floor[k]) for k, e in errs.items()
           if not e <= floor[k] + tol}
    if bad:
        raise AssertionError(
            f"fields beyond tolerance {tol} (error, CPU float32 error): {bad}")
    return {k: {"gpu_f32": errs[k], "cpu_f32": floor[k]} for k in want}


def check(fn, args, got, tol, take=lambda x: x, solves=()):
    """Compare ``got`` (``fn(*args)`` on the device, passed through
    ``take``) with ``fn`` on ``take(args)`` in float64 on the CPU.

    Cells where ``got`` and the CPU's own float32 run differ by more than
    ``tol`` of a field's scale took another branch under another rounding
    order; at most ``FLIP_SHARE`` of the cells may. On the other cells
    each field may be at most ``tol`` further from the float64 reference
    than the CPU's float32 run is. The fields named in ``solves`` are
    shape-solve results: a cell whose solve lands elsewhere than the CPU's
    float32 solve, and the two levels below it that its sedimentation
    reaches in two steps, count apart, up to ``SOLVE_FLIP_SHARE``.
    Returns ``(errors, shares, ref)``.
    """
    ref = fields(reference(fn, take(args)))
    cpu32 = fields(reference(fn, take(args), np.float32))
    gpu = {k: np.asarray(v, np.float64) for k, v in fields(take(got)).items()}
    solve_flip = np.zeros(np.shape(next(iter(ref.values()))), bool)
    for k in solves:
        solve_flip |= solver_disagrees(gpu[k], cpu32[k])
    spread = solve_flip.copy()
    for lev in (1, 2):
        spread[..., :-lev] |= solve_flip[..., lev:]
    flip = np.zeros_like(spread)
    for k, r in ref.items():
        scale = np.max(np.abs(np.asarray(r)))
        flip |= ~(np.abs(gpu[k] - np.asarray(cpu32[k], np.float64))
                  <= tol * scale)
    flip &= ~spread
    shares = {"flip": float(np.mean(flip)),
              "solve_flip": float(np.mean(solve_flip))}
    if shares["flip"] > FLIP_SHARE or shares["solve_flip"] > SOLVE_FLIP_SHARE:
        raise AssertionError(
            f"cells differing from the CPU float32 run: {shares} "
            f"(allowed {FLIP_SHARE}, solves {SOLVE_FLIP_SHARE})")
    skip = flip | spread
    keep = lambda d: {k: np.where(skip, np.asarray(ref[k]), np.asarray(v))
                      for k, v in d.items()}
    return compare(keep(gpu), ref, tol, keep(cpu32)), shares, ref


def fields(x) -> dict:
    """Named float leaves of a NamedTuple or a dict."""
    d = x._asdict() if hasattr(x, "_asdict") else dict(x)
    return {k: v for k, v in d.items() if v is not None
            and jnp.issubdtype(jnp.result_type(v), jnp.floating)}


def reference(fn, args, dtype=np.float64):
    """``fn`` jitted on the CPU (in float64 unless ``dtype`` says
    otherwise) on host copies of ``args``."""
    cpu = jax.devices("cpu")[0]
    put = lambda x: jax.device_put(np.asarray(x, dtype), cpu)
    with jax.default_device(cpu):
        return jax.jit(fn)(*jax.tree_util.tree_map(put, args))


def head(tree, n):
    """The first ``n`` entries of the leading axis of every leaf."""
    return jax.tree_util.tree_map(lambda x: x[:n], tree)


def report(name, cells, compile_s, ms, compiled, errs, tol, **extra):
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    line = {
        "phase": name,
        "cells": cells,
        "compile_s": round(compile_s, 3),
        "ms_per_step": float(np.median(ms)),
        "ms_each": [round(m, 4) for m in ms],
        "grid_points_per_s": cells / (float(np.median(ms)) / 1e3),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "memory_analysis": None if mem is None else {
            k: getattr(mem, k) for k in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")},
        "max_rel_err": errs,
        "tol": tol,
        **extra,
    }
    print(json.dumps(line), flush=True)
    return line


# --- states ---------------------------------------------------------------

def _levels(top, bottom, ncol, nlev):
    return np.broadcast_to(np.linspace(top, bottom, nlev), (ncol, nlev))


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32), tree)


def state_2m(ncol, nlev, seed) -> ColumnState2M:
    """Warm-rain columns: level profiles of rho and T, per-cell random
    cloud and rain mass and number."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nlev)
    lognormal = lambda s: np.exp(s * rng.standard_normal(shape))
    q_lcl = 1e-3 * rng.random(shape)
    q_rai = 5e-4 * rng.random(shape)
    return _f32(ColumnState2M(
        rho=_levels(1.2, 0.5, ncol, nlev), T=_levels(300.0, 260.0, ncol, nlev),
        q_tot=6e-3 + q_lcl + q_rai, q_lcl=q_lcl, n_lcl=9e7 * lognormal(0.5),
        q_rai=q_rai, n_rai=9e5 * lognormal(0.5)))


def state_p3(shape, seed) -> ColumnStateP3:
    """Random perturbations around the ice-laden reference state (ice mass,
    number, rime fraction and rime density vary per cell, so the shape
    solve lands in different regimes from cell to cell)."""
    rng = np.random.default_rng(seed)
    lognormal = lambda s: np.exp(s * rng.standard_normal(shape))
    q_lcl = 1e-3 * lognormal(0.5)
    q_rai = 5e-4 * lognormal(0.5)
    q_ice = 5e-4 * lognormal(0.5)
    q_rim = 0.9 * rng.random(shape) * q_ice
    rho_rim = 100.0 + 800.0 * rng.random(shape)
    if len(shape) == 2:
        rho = _levels(1.2, 0.5, *shape)
    else:
        rho = 0.5 + 0.7 * rng.random(shape)
    return _f32(ColumnStateP3(
        rho=rho, T=255.0 + 16.0 * rng.random(shape),
        q_tot=4e-3 * lognormal(0.2) + q_lcl + q_rai + q_ice,
        q_lcl=q_lcl, n_lcl=9e7 * lognormal(0.5),
        q_rai=q_rai, n_rai=9e5 * lognormal(0.5),
        q_ice=q_ice, n_ice=1e5 * lognormal(0.5),
        q_rim=q_rim, b_rim=q_rim / rho_rim))


def parcel_ic(seed) -> PM.ParcelState:
    rng = np.random.default_rng(seed)
    u = rng.random(3)
    return _f32(PM.ParcelState(
        S_l=1.0 + 0.04 * u[0], p_air=8e4, T=274.0 + 8.0 * u[1],
        q_vap=6e-3, q_liq=1e-3 * (0.5 + u[2]), q_ice=0.0, N_aer=1e8,
        N_liq=1e8, N_ice=0.0, ln_inpc=0.0))


# --- phases ---------------------------------------------------------------

TPS = ThermodynamicsParameters()


def phase_1m(sz, seed, n=10):
    mp, tv = microphysics_1m_params(), terminal_velocity_params()
    _, state = GE._build(sz.ncol, sz.nlev, jnp.float32, seed)
    fn = lambda s: step_column_1m(s, mp, TPS, tv, 1.0, 100.0)
    c, ms, compiled, out = time_steps(fn, (state,), n)
    errs, flips, _ = check(fn, (state,), out, TOL["1m_step"],
                           lambda t: head(t, sz.ref_cols))
    return report("1m_step", sz.ncol * sz.nlev, c, ms, compiled, errs,
                  TOL["1m_step"], shares=flips)


def phase_2m(sz, seed, n=10):
    mp = microphysics_2m_params()
    state = state_2m(sz.ncol, sz.nlev, seed + 1)
    fn = lambda s: step_column_2m(s, mp, TPS, 1.0, 100.0)
    c, ms, compiled, out = time_steps(fn, (state,), n)
    errs, flips, _ = check(fn, (state,), out, TOL["2m_step"],
                           lambda t: head(t, sz.ref_cols))
    return report("2m_step", sz.ncol * sz.nlev, c, ms, compiled, errs,
                  TOL["2m_step"], shares=flips)


def _col_chunks(ncol, nlev, chunk_cells):
    chunks = max(ncol * nlev // chunk_cells, 1)
    while ncol % chunks:
        chunks -= 1
    return chunks


def phase_p3(sz, seed, n=5):
    """A cold step, then the warm-started step timed flat and chunked;
    both steps are compared with the reference's two steps."""
    mp = microphysics_2m_params(with_ice=True, quadrature_order=sz.p3_order)
    shape = (sz.p3_ncol, sz.nlev)
    state = state_p3(shape, seed + 2)
    chunks = _col_chunks(sz.p3_ncol, sz.nlev, sz.chunk_cells)
    flat = lambda s, g: step_column_p3(s, mp, TPS, 1.0, 100.0, g)
    chunked = lambda s, g: step_column_p3(s, mp, TPS, 1.0, 100.0, g,
                                          col_chunks=chunks)
    # the cold step through the warm-start program: a non-finite guess
    # leaves the solver's bracket whole, so no third program is compiled
    s1, ll1 = jax.jit(flat)(state, jnp.full(shape, jnp.nan, jnp.float32))

    def two_steps(s):
        s1, ll1 = step_column_p3(s, mp, TPS, 1.0, 100.0)
        s2, ll2 = flat(s1, ll1)
        return {**s2._asdict(), "loglambda_1": ll1, "loglambda_2": ll2}

    lines = []
    for name, fn in (("p3_step_flat", flat), ("p3_step_chunked", chunked)):
        c, ms, compiled, (out, ll2) = time_steps(fn, (s1, ll1), n)
        got = {**out._asdict(), "loglambda_1": ll1, "loglambda_2": ll2}
        errs, flips, ref = check(two_steps, (state,), got, TOL["p3_step"],
                                 lambda t: head(t, sz.ref_cols),
                                 solves=("loglambda_1", "loglambda_2"))
        lines.append(report(
            name, sz.p3_ncol * sz.nlev, c, ms, compiled, errs,
            TOL["p3_step"], shares=flips, quadrature_order=sz.p3_order,
            col_chunks=chunks if fn is chunked else None,
            solve_vs_f64_share=float(np.mean(solver_disagrees(
                head(ll1, sz.ref_cols), ref["loglambda_1"])))))
    return lines


def solver_disagrees(got, want):
    """Cells whose shape solves differ beyond ``SOLVE_RTOL``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return ~((got == want) | (np.abs(got - want) <= SOLVE_RTOL * np.abs(want)))


def phase_tendency(sz, seed, n=5):
    """Fused 2M+P3 tendencies on a flat batch, chunked as in bench.py."""
    mp = microphysics_2m_params(with_ice=True,
                                quadrature_order=sz.tend_order)
    st = state_p3((sz.cells,), seed + 3)
    ll = jax.jit(lambda s: P3.get_distribution_loglambda(
        P3.state_from_prognostic(mp.ice.scheme, s.q_ice * s.rho,
                                 s.n_ice * s.rho, s.q_rim * s.rho,
                                 s.b_rim * s.rho)))(st)
    args = tuple(st) + (ll,)
    tend = lambda *a: bulk_tendencies_2m(mp, TPS, *a)
    chunks = max(sz.cells // sz.chunk_cells, 1)
    c, ms, compiled, out = time_steps(chunked_cells(tend, chunks), args, n)
    errs, flips, _ = check(tend, args, out, TOL["p3_tendency"],
                           lambda t: head(t, sz.ref_cells))
    return report("p3_tendency", sz.cells, c, ms, compiled, errs,
                  TOL["p3_tendency"], shares=flips,
                  quadrature_order=sz.tend_order, chunks=chunks)


def phase_parcel(sz, seed, n=10):
    params = PM.parcel_params(condensation_growth="Condensation",
                              const_dt=0.1, w=1.0)
    ic = parcel_ic(seed + 4)
    fn = lambda ic: PM.run_parcel(ic, 0.0, sz.parcel_steps * 0.1, params)
    c, ms, compiled, out = time_steps(fn, (ic,), n)
    errs, flips, _ = check(fn, (ic,), out, TOL["parcel"])
    return report("parcel", sz.parcel_steps, c, ms, compiled, errs,
                  TOL["parcel"], shares=flips, unit="parcel steps")


# The Triton kernel runs the same float32 arithmetic as XLA's fusion of
# the plain step; only the compilers' rounding of the transcendentals and
# their operation order differ.
TOL_KERNEL = 1e-5


def phase_kernels(sz, seed, interpret=False, n=10):
    """Each Triton kernel against XLA's plain step, at full width."""
    mp1, tv = microphysics_1m_params(), terminal_velocity_params()
    mp2 = microphysics_2m_params()
    _, st1 = GE._build(sz.ncol, sz.nlev, jnp.float32, seed)
    st2 = state_2m(sz.ncol, sz.nlev, seed + 1)
    cases = (
        ("1m_step_triton", st1,
         lambda s: step_column_1m(s, mp1, TPS, tv, 1.0, 100.0),
         lambda s: step_column_1m_triton(s, mp1, TPS, tv, 1.0, 100.0,
                                         interpret=interpret)),
        ("2m_step_triton", st2,
         lambda s: step_column_2m(s, mp2, TPS, 1.0, 100.0),
         lambda s: step_column_2m_triton(s, mp2, TPS, 1.0, 100.0,
                                         interpret=interpret)),
    )
    lines = []
    for name, state, xla, kernel in cases:
        _, ms_xla, _, want = time_steps(xla, (state,), n)
        c, ms, compiled, got = time_steps(kernel, (state,), n)
        errs = {}
        for k in want._fields:
            g, w = getattr(got, k), getattr(want, k)
            scale = jnp.maximum(jnp.max(jnp.abs(w)), jnp.finfo(w.dtype).tiny)
            errs[k] = float(jnp.where(jnp.all(jnp.isfinite(g)),
                                      jnp.max(jnp.abs(g - w)) / scale,
                                      jnp.inf))
        bad = {k: e for k, e in errs.items() if not e <= TOL_KERNEL}
        if bad:
            raise AssertionError(f"{name} vs XLA beyond {TOL_KERNEL}: {bad}")
        lines.append(report(
            name, sz.ncol * sz.nlev, c, ms, compiled, errs, TOL_KERNEL,
            compared_with="XLA's plain step",
            xla_ms_per_step=float(np.median(ms_xla))))
        del state, want, got
    return lines


# --- four GPUs ------------------------------------------------------------

# One column step on a shard and on one card run the same arithmetic on
# the same columns, compiled as two programs. The 1M step came out
# bit-identical on four H100s; the P3 step differed by up to 9.4e-5 of a
# field's scale (log lambda): the float32 shape solve moves with the
# rounding order, as between the GPU and the CPU (phase_p3).
TOL_SHARD = {"four_1m_step": 1e-6, "four_p3_step_chunked": TOL["p3_step"]}


def phase_four(sz, seed, n=5):
    """The 1M step and the per-shard chunked P3 step over a four-device
    ``columns`` mesh (weak scaling: one card's columns per card), each
    compared with the same step on one card on the first shard's
    columns."""
    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four needs 4 devices, JAX has {len(devices)}")
    mesh = column_mesh(devices[:4])

    def per_card(name, fn4, fn1, state4, ncells_card):
        c4, ms4, compiled4, out4 = time_steps(fn4, state4, n)
        for leaf in jax.tree_util.tree_leaves(out4):
            if leaf.ndim and leaf.sharding.spec != P("columns"):
                raise AssertionError(f"{name}: output {leaf.sharding}")
        quarter = lambda t: jax.tree_util.tree_map(
            lambda x: x[: x.shape[0] // 4], t)
        one = jax.device_put(quarter(state4), devices[0])
        c1, ms1, _, out1 = time_steps(fn1, one, n)
        named = lambda o: (fields(o) if hasattr(o, "_asdict")
                           else {**fields(o[0]), "loglambda": o[1]})
        got, want = named(quarter(out4)), named(out1)
        errs = {k: max_rel_err(got[k], want[k]) for k in want}
        line = {
            "phase": name, "cells_per_card": ncells_card,
            "compile_s": {"1": round(c1, 3), "4": round(c4, 3)},
            "ms_per_step": {"1": float(np.median(ms1)),
                            "4": float(np.median(ms4))},
            "grid_points_per_s_per_card": {
                "1": ncells_card / (float(np.median(ms1)) / 1e3),
                "4": ncells_card / (float(np.median(ms4)) / 1e3)},
            "max_rel_err_vs_one_card": errs, "tol": TOL_SHARD[name],
        }
        print(json.dumps(line), flush=True)
        compare(got, want, TOL_SHARD[name])
        return line

    mp1, tv = microphysics_1m_params(), terminal_velocity_params()
    step1 = lambda s: step_column_1m(s, mp1, TPS, tv, 1.0, 100.0)
    _, st1 = GE._build(4 * sz.ncol, sz.nlev, jnp.float32, seed)
    per_card("four_1m_step", step1, step1, (shard_columns(st1, mesh),),
             sz.ncol * sz.nlev)
    del st1

    mp3 = microphysics_2m_params(with_ice=True, quadrature_order=sz.p3_order)
    chunks = _col_chunks(sz.p3_ncol, sz.nlev, sz.chunk_cells)
    shape4 = (4 * sz.p3_ncol, sz.nlev)
    st3 = shard_columns(state_p3(shape4, seed + 2), mesh)
    chunked = lambda s, g: step_column_p3(s, mp3, TPS, 1.0, 100.0, g,
                                          col_chunks=chunks)
    sharded = jax.shard_map(chunked, mesh=mesh, in_specs=P("columns"),
                            out_specs=P("columns"), check_vma=False)
    # the cold step through the same program (see phase_p3)
    nan = shard_columns(jnp.full(shape4, jnp.nan, jnp.float32), mesh)
    s1, ll1 = jax.jit(sharded)(st3, nan)
    per_card("four_p3_step_chunked", sharded, chunked, (s1, ll1),
             sz.p3_ncol * sz.nlev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true",
                    help="toy sizes, the kernel in interpret mode; the "
                    "device check runs last")
    ap.add_argument("--four", action="store_true",
                    help="only the four-GPU column-mesh phase")
    args = ap.parse_args(argv)
    sz = TINY if args.tiny else FULL
    GE._enable_compile_cache()

    label = None if args.tiny else check_device()
    if args.four:
        phase_four(sz, args.seed)
    else:
        phase_1m(sz, args.seed)
        phase_2m(sz, args.seed)
        phase_p3(sz, args.seed)
        phase_tendency(sz, args.seed)
        phase_parcel(sz, args.seed)
        phase_kernels(sz, args.seed, interpret=args.tiny)
    if label is None:
        label = check_device()
    print(json.dumps({"ok": True, "device": {
        "platform": label["platform"], "kind": label["kind"],
        "count": label["count"]}}))


if __name__ == "__main__":
    main()
