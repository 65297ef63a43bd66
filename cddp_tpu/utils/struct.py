"""Frozen dataclasses that are JAX pytrees.

``class Foo(PyTreeNode)`` makes ``Foo`` (and every subclass) a frozen
dataclass registered with :func:`jax.tree_util.register_dataclass`. Fields
are pytree leaves unless declared ``field(pytree_node=False)``, which makes
them static metadata: part of the tree structure, and so of every jit cache
key. ``obj.replace(**updates)`` returns a modified copy.
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar, dataclass_transform

import jax

_T = TypeVar("_T", bound="PyTreeNode")


def field(pytree_node: bool = True, *, metadata=None, **kwargs):
    """``dataclasses.field`` with a ``pytree_node`` flag (False = static)."""
    return dataclasses.field(
        metadata=(metadata or {}) | {"pytree_node": pytree_node}, **kwargs
    )


def _register(cls, **kwargs):
    if "_pytree_dataclass" in cls.__dict__:
        return cls
    kwargs.setdefault("frozen", True)
    cls = dataclasses.dataclass(**kwargs)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data, meta)
    cls._pytree_dataclass = True
    return cls


@dataclass_transform(field_specifiers=(field,))
class PyTreeNode:
    """Base class: subclasses become frozen, pytree-registered dataclasses."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__()
        _register(cls, **kwargs)

    def replace(self: _T, **updates) -> _T:
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **updates)
