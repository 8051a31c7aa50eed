"""Immutable pytree dataclasses: the base of the filter and tracker states.

`pytree_dataclass` makes a class a frozen dataclass registered with
`jax.tree_util.register_dataclass`.  Every field is a pytree leaf unless it
is declared with `static_field()`, which puts it in the treedef instead: it
must be hashable, and `jit` sees it as static (a change recompiles).
`.replace(**changes)` returns a copy with the given fields swapped.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field kept out of the pytree's leaves (static under jit)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    """Decorator: frozen dataclass + pytree registration + `.replace`."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
