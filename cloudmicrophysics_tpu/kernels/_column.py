"""Shared launcher of the column-step kernels on the Triton route."""

from __future__ import annotations

import jax
import jax.extend.core as jex_core
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _folded(fn):
    """``fn`` traced with its constant-only scalar operations evaluated at
    trace time and its inner calls (``jit``, ``custom_jvp``) inlined, forward
    only. The Triton lowering accepts a constant only as an operand of an
    operation that also takes a traced value."""

    def run(jaxpr, consts, *args):
        env = {}
        read = lambda v: v.val if isinstance(v, jex_core.Literal) else env[v]
        for v, x in zip(jaxpr.constvars, consts):
            env[v] = x
        for v, x in zip(jaxpr.invars, args):
            env[v] = x
        for eqn in jaxpr.eqns:
            ins = [read(v) for v in eqn.invars]
            sub = eqn.params.get("call_jaxpr", eqn.params.get("jaxpr"))
            if isinstance(sub, jex_core.ClosedJaxpr):
                outs = run(sub.jaxpr, sub.consts, *ins)
            elif not (any(isinstance(x, jax.core.Tracer) for x in ins)
                      or any(v.aval.shape for v in eqn.outvars)):
                with jax.ensure_compile_time_eval():
                    outs = eqn.primitive.bind(*ins, **eqn.params)
                # numpy scalars trace as literals, not captured constants
                outs = jax.tree_util.tree_map(lambda x: np.asarray(x)[()],
                                              outs)
            else:
                outs = eqn.primitive.bind(*ins, **eqn.params)
            if not eqn.primitive.multiple_results:
                outs = [outs]
            for v, x in zip(eqn.outvars, outs):
                env[v] = x
        return [read(v) for v in jaxpr.outvars]

    def wrapped(*args):
        closed, shape = jax.make_jaxpr(fn, return_shape=True)(*args)
        flat = run(closed.jaxpr, closed.consts,
                   *jax.tree_util.tree_leaves(args))
        return jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(shape), flat)

    return wrapped


# Elements per tile and per thread. Measured on an H100 at 524,288 x 128:
# two elements per thread ran fastest for both column steps; at eight the
# kernels spill and run 5-6x slower.
TILE = 512
PER_THREAD = 2


def tile_columns(ncol: int, nlev: int) -> int:
    """Columns per tile: the largest power of two up to ``TILE // nlev``
    that divides ``ncol``. ``nlev`` must be a power of two (Triton tiles
    are)."""
    if nlev & (nlev - 1):
        raise ValueError(f"nlev={nlev} is not a power of two")
    block = max(TILE // nlev, 1)
    while ncol % block:
        block //= 2
    return block


def column_step_call(state, step, fluxes, *, interpret: bool):
    """Apply ``step(tile, inflow)`` to tiles of whole columns.

    ``state`` is a NamedTuple of ``(ncol, nlev)`` fields. ``fluxes(tile)``
    gives the tile's downward sedimentation fluxes; the ``inflow`` handed
    to ``step`` returns those fluxes evaluated on the tile loaded one level
    higher, with zero at the top level. ``interpret=True`` runs the kernel
    in the Pallas interpreter (CPU tests); otherwise it compiles for the
    GPU and raises on any other backend.
    """
    ncol, nlev = state[0].shape
    block_cols = tile_columns(ncol, nlev)
    size = block_cols * nlev
    num_warps = max(size // (32 * PER_THREAD), 1)
    cls, n = type(state), len(state)
    # flat tiles: a tile is block_cols whole columns, contiguous in memory
    whole = pl.BlockSpec((ncol * nlev,), lambda i: (0,))
    tile = pl.BlockSpec((size,), lambda i: (i,))

    def tile_step(cur, up):
        top = lax.broadcasted_iota(jnp.int32, (size,), 0) % nlev == nlev - 1

        def inflow(_):
            return tuple(jnp.where(top, jnp.zeros_like(f), f)
                         for f in fluxes(up))

        return step(cur, inflow)

    def kernel(*refs):
        ins, outs = refs[:n], refs[n:]
        start = pl.program_id(0) * size
        cur = cls(*(plgpu.load(r.at[pl.ds(start, size)]) for r in ins))
        # the level above; past the top level the load is masked off (the
        # filler is never used)
        top = lax.broadcasted_iota(jnp.int32, (size,), 0) % nlev == nlev - 1
        up = cls(*(plgpu.load(r.at[pl.ds(start + 1, size)], mask=~top,
                              other=1.0) for r in ins))
        for ref, val in zip(outs, _folded(tile_step)(cur, up)):
            ref[...] = val

    out = pl.pallas_call(
        kernel,
        grid=(ncol // block_cols,),
        in_specs=[whole] * n,
        out_specs=[tile] * n,
        out_shape=[jax.ShapeDtypeStruct((ncol * nlev,), f.dtype)
                   for f in state],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
    )(*(f.reshape(-1) for f in state))
    return cls(*(f.reshape(ncol, nlev) for f in out))
