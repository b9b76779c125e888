"""Frozen dataclasses registered as JAX pytrees.

Every state object of the train path (parameters, camera, projection, Adam
moments, density statistics, train state) is one of these: array fields are
pytree leaves, fields made with ``static_field`` are static metadata (they
become part of a jitted function's cache key, e.g. the camera's render
resolution), and ``.replace(**changes)`` returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept as static pytree metadata instead of a leaf."""
    metadata = dict(kwargs.pop("metadata", {}), static=True)
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Make ``cls`` a frozen dataclass, register it with
    ``jax.tree_util.register_dataclass`` and give it a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if not f.metadata.get("static", False)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
