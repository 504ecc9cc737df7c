"""Parameter-struct machinery for the JAX cloud microphysics library.

The reference library (CloudMicrophysics.jl) builds ``isbits`` parameter
structs host-side once, precomputing expensive transcendentals (gamma
functions, Gauss-Legendre nodes) at construction, then ships them to the
device by value (see ``/root/reference/src/parameters/Parameters.jl:62-74``
and ``src/parameters/TerminalVelocity.jl:58-62``).

The JAX equivalent is a frozen dataclass registered as a JAX pytree:

* numeric fields are pytree *leaves* (plain Python floats) so parameter
  structs can be passed through ``jit`` / ``vmap`` / ``grad`` boundaries and
  calibrated (EKI over parameter ensembles);
* fields declared with :func:`static_field` are pytree *aux data* (e.g.
  integer orders, option enums, nested tuples of precomputed node tables)
  so XLA specializes on them — mirroring Julia's type-level dispatch on
  singleton option types;
* when a model closes over a parameter struct at trace time (the hot-path
  pattern), every float field is embedded as a compile-time constant, giving
  XLA the same constant-folding opportunities Julia gets from struct
  specialization.
"""

from __future__ import annotations

import dataclasses
from dataclasses import MISSING, field
from typing import Any, TypeVar

import jax

_T = TypeVar("_T")

_STATIC_KEY = "cmt_static"


def static_field(default: Any = MISSING, **kwargs: Any):
    """A dataclass field stored as pytree aux data (compile-time static)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata[_STATIC_KEY] = True
    if default is MISSING:
        return field(metadata=metadata, **kwargs)
    return field(default=default, metadata=metadata, **kwargs)


def _is_static(f: dataclasses.Field) -> bool:
    return bool(f.metadata.get(_STATIC_KEY, False))


def paramclass(cls: type[_T]) -> type[_T]:
    """Decorator: frozen dataclass + JAX pytree registration.

    Non-static fields are pytree children; static fields are aux data.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    child_names = tuple(f.name for f in fields if not _is_static(f))
    static_names = tuple(f.name for f in fields if _is_static(f))

    def flatten_with_keys(obj):
        children = tuple(
            (jax.tree_util.GetAttrKey(name), getattr(obj, name))
            for name in child_names
        )
        aux = tuple(getattr(obj, name) for name in static_names)
        return children, aux

    def flatten(obj):
        children = tuple(getattr(obj, name) for name in child_names)
        aux = tuple(getattr(obj, name) for name in static_names)
        return children, aux

    def unflatten(aux, children):
        kwargs = dict(zip(child_names, children))
        kwargs.update(zip(static_names, aux))
        # object.__new__ + setattr path avoids re-running __post_init__
        # validation on symbolic (tracer) leaves during unflattening.
        obj = object.__new__(cls)
        for k, v in kwargs.items():
            object.__setattr__(obj, k, v)
        return obj

    jax.tree_util.register_pytree_with_keys(
        cls, flatten_with_keys, unflatten, flatten_func=flatten
    )
    return cls


def replace(obj: _T, **changes: Any) -> _T:
    """``dataclasses.replace`` for paramclasses."""
    return dataclasses.replace(obj, **changes)
