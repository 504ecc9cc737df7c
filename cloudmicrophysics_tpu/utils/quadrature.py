"""Quadrature rules for the P3 size-distribution integrals.

JAX port of the reference ``src/Quadrature.jl``:

* :class:`ChebyshevGauss` — closed-form nodes/weights (reference
  ``src/Quadrature.jl:166-173``).
* :class:`GaussLegendre` — nodes/weights computed **host-side once** in
  float64 (``numpy.polynomial.legendre.leggauss``) and stored on the rule
  as static tuples, mirroring the reference's FastGaussQuadrature
  construction + isbits SVector storage (``src/Quadrature.jl:227-255``).

The rule objects are hashable frozen dataclasses used as *static* trace-time
data: inside a jitted kernel the node/weight tables become XLA constants,
and :func:`integrate` evaluates the integrand over a new leading node axis
then contracts with a single fused dot — the natural array shape for the
"quadrature = dot over node axis" pattern identified in SURVEY.md §2.1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ChebyshevGauss",
    "GaussLegendre",
    "Tabulated",
    "build_quadrature",
    "integrate",
    "integrate_segments",
    "default_quadrature",
    "nodes",
    "segment_nodes",
    "tabulate",
]


@dataclasses.dataclass(frozen=True)
class QuadratureRule:
    n: int


@dataclasses.dataclass(frozen=True)
class ChebyshevGauss(QuadratureRule):
    """Chebyshev-Gauss (first kind): ``y_i = cos(pi (2i-1)/(2n))``,
    ``w_i = pi/n``, ``1/w(y) = sqrt(1 - y^2)``."""

    def nodes_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        i = np.arange(1, self.n + 1, dtype=np.float64)
        y = np.cos(np.pi * (2 * i - 1) / (2 * self.n))
        w = (np.pi / self.n) * np.sqrt(np.maximum(1.0 - y * y, 0.0))
        return y, w


@dataclasses.dataclass(frozen=True)
class GaussLegendre(QuadratureRule):
    """Gauss-Legendre; nodes/weights built host-side in float64."""

    def nodes_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        y, w = np.polynomial.legendre.leggauss(self.n)
        return y.astype(np.float64), w.astype(np.float64)


@jax.tree_util.register_pytree_node_class
class Tabulated:
    """A quadrature rule whose node/weight tables are pytree *leaves*.

    The host-side rules above are static trace-time data, so their tables
    compile to XLA constants — perfect for the jit path, but Pallas
    requires array constants to be explicit kernel operands. ``Tabulated``
    stores the tables as pytree children: embedded in a parameter container
    it flows through ``jit`` as an input and ``nodes_weights()`` returns
    the runtime tables.
    """

    def __init__(self, n, y, w):
        self.n = n
        self.y = y
        self.w = w

    def nodes_weights(self):
        return self.y, self.w

    def tree_flatten(self):
        return (self.y, self.w), self.n

    @classmethod
    def tree_unflatten(cls, n, children):
        return cls(n, *children)


def tabulate(rule: QuadratureRule) -> Tabulated:
    """Materialize a rule's float64 tables host-side once.

    Tables are stored node-leading with two trailing unit axes
    ``(n, 1, 1)`` so they broadcast directly against ``(ncol, nlev)``
    tiles; the unit axes are baked in host-side so no traced reshape is
    needed.
    """
    y, w = rule.nodes_weights()
    return Tabulated(rule.n, y.reshape(-1, 1, 1), w.reshape(-1, 1, 1))


def build_quadrature(order: int) -> QuadratureRule:
    """Select the quadrature rule from the single ``quadrature_order`` knob.

    Gauss-Legendre for the preferred orders {4, 8, 16, 32, 40, 64} (incl.
    the ClimaAtmos production order 40), Chebyshev-Gauss otherwise
    (reference ``src/Quadrature.jl:272-278``; {4, 8} extend the
    reference's GL set downward — at the low node counts that make the
    P3 collision kernel fast, GL's per-segment spectral
    convergence is what keeps the quadrature-ladder gates green, see
    tests/test_quadrature_ladder.py).
    """
    if order in (4, 8, 16, 32, 40, 64):
        return GaussLegendre(order)
    return ChebyshevGauss(order)


def default_quadrature() -> QuadratureRule:
    """Reference default: ``ChebyshevGauss(100)`` (src/Quadrature.jl:62)."""
    return ChebyshevGauss(100)


def _expand(arr, target):
    """Reshape a node table to broadcast over ``target``'s shape with a
    new leading axis. Pre-shaped ``(n, 1, ..., 1)`` tables pass through
    untouched when they already match (the Pallas-kernel hot path — no
    in-kernel reshape at all)."""
    nd = jnp.ndim(target)
    if arr.ndim == nd + 1 and arr.shape[1:] == (1,) * nd:
        return arr
    return arr.reshape((-1,) + (1,) * nd)


def integrate(f: Callable, a, b, quad: QuadratureRule | None = None):
    """Approximate ``\\int_a^b f(x) dx`` with the given rule.

    ``a`` and ``b`` may be arrays (per-cell bounds); ``f`` must accept an
    array with one extra leading node axis. Returns 0 where ``a >= b`` or
    bounds are NaN (reference ``src/Quadrature.jl:62-87``).
    """
    if quad is None:
        quad = default_quadrature()
    y_np, w_np = quad.nodes_weights()

    a = jnp.asarray(a)
    b = jnp.asarray(b)
    dt = jnp.result_type(a, b)
    if not jnp.issubdtype(dt, jnp.floating):
        dt = jnp.result_type(float)
    a = a.astype(dt)
    b = b.astype(dt)

    valid = a < b
    # Dead-branch sanitization: invalid/NaN bounds evaluate f on [1, 2].
    a_s = jnp.where(valid, a, jnp.ones_like(a))
    b_s = jnp.where(valid, b, 2 * jnp.ones_like(b))

    y = _expand(jnp.asarray(y_np, dt), a)
    w = _expand(jnp.asarray(w_np, dt), a)

    scale = (b_s - a_s) / 2
    shift = (a_s + b_s) / 2
    x = scale * y + shift
    fx = f(x)
    res = jnp.sum(fx * w, axis=0) * scale
    return jnp.where(valid, res, jnp.zeros_like(res))


def nodes(quad: QuadratureRule, a, b):
    """Quadrature nodes/weights mapped to ``[a, b]`` with a new LEADING
    axis: summing ``f(x) * w_scaled`` over axis 0 approximates the
    integral. Invalid (``a >= b``) windows get zero weights (and the
    dead-branch nodes are sanitized onto ``[1, 2]``)."""
    dt = jnp.result_type(a, b)
    if not jnp.issubdtype(dt, jnp.floating):
        dt = jnp.result_type(float)
    y_np, w_np = quad.nodes_weights()
    a = jnp.asarray(a, dt)
    b = jnp.asarray(b, dt)
    valid = a < b
    a_s = jnp.where(valid, a, jnp.ones_like(a))
    b_s = jnp.where(valid, b, 2 * jnp.ones_like(b))
    y = _expand(jnp.asarray(y_np, dt), a)
    w = _expand(jnp.asarray(w_np, dt), a)
    scale = (b_s - a_s) / 2
    x = scale * y + (a_s + b_s) / 2
    w_scaled = jnp.where(valid, w * scale, jnp.zeros_like(w * scale))
    return x, w_scaled


def segment_nodes(quad: QuadratureRule, bnds):
    """Concatenate :func:`nodes` tables over consecutive segments of a
    bounds tuple along the leading axis — the shared-node form of
    :func:`integrate_segments` (evaluate integrands once at ``(x, w)``,
    contract many different moments against the same table)."""
    xs, ws = [], []
    for lo, hi in zip(bnds[:-1], bnds[1:]):
        x, w = nodes(quad, lo, hi)
        xs.append(x)
        ws.append(w)
    return jnp.concatenate(xs, axis=0), jnp.concatenate(ws, axis=0)


def integrate_segments(f: Callable, bnds, quad: QuadratureRule | None = None):
    """Integrate ``f`` over consecutive subintervals of a bounds tuple.

    ``integrate_segments(f, (a, b, c)) = \\int_a^b f + \\int_b^c f``
    (reference ``src/Quadrature.jl:101-125``). Each segment with
    ``lo >= hi`` (e.g. collapsed or NaN bounds) contributes zero.
    """
    total = None
    for lo, hi in zip(bnds[:-1], bnds[1:]):
        part = integrate(f, lo, hi, quad)
        total = part if total is None else total + part
    return total
