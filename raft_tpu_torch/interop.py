"""Carry state across from the JAX package, through numpy.

`to_numpy_leaves(obj)` flattens a state, fabric, metrics or LocalOps object
into its leaves in field order, as numpy arrays; `from_numpy_tree(cls,
leaves, device)` builds the object back from such a list. The leaf order is
the one `jax.tree.leaves` gives the JAX package's registered dataclasses, so
the leaves of a `raft_tpu` carry build the matching `raft_tpu_torch`
object, and one sha256 over the leaves (`digest`) compares the two. `None`
fields hold no leaf, exactly as `jax.tree.leaves` skips them.

Leaves keep their dtypes both ways, so a diet-v2 packed carry (uint16,
int16 and int8 columns, uint8/16/32 bitset words) comes across packed.
A dataclass field marked `metadata={"static": True}` holds no leaf, as a
meta field of a JAX registered dataclass holds none (the paged log's `w`
and `w_res`: ops/paged.py PagedLog); `from_numpy_tree` takes it as a
keyword. This module imports no JAX: the caller turns JAX arrays into
numpy.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import typing

import numpy as np
import torch


@functools.cache
def _children(cls):
    """(name, nested class or None) for each field of a dataclass or
    NamedTuple, in order."""
    hints = typing.get_type_hints(cls)
    names = (
        [f.name for f in dataclasses.fields(cls) if not f.metadata.get("static")]
        if dataclasses.is_dataclass(cls)
        else list(cls._fields)
    )
    out = []
    for name in names:
        h = hints.get(name)
        nested = h if isinstance(h, type) and _is_tree(h) else None
        out.append((name, nested))
    return tuple(out)


def _is_tree(cls) -> bool:
    return dataclasses.is_dataclass(cls) or hasattr(cls, "_fields")


def to_numpy_leaves(obj) -> list[np.ndarray]:
    """The leaves of `obj` in field order, as numpy arrays; None is skipped."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [obj.detach().cpu().numpy()]
    if _is_tree(type(obj)):
        out = []
        for name, _ in _children(type(obj)):
            out.extend(to_numpy_leaves(getattr(obj, name)))
        return out
    return [np.asarray(obj)]


def from_numpy_tree(cls, leaves, device, **static):
    """Build a `cls` object from `leaves` in field order, its static fields
    from `static`. Trailing fields that have a default take it when the
    leaves run out (the optional planes of the JAX state are None and hold
    no leaf)."""
    it = list(leaves)
    obj, rest = _build(cls, it, torch.device(device), static)
    if rest:
        raise ValueError(f"{len(rest)} leaves left over building {cls.__name__}")
    return obj


def _build(cls, leaves, device, static=None):
    kw = dict(static or {})
    defaults = _defaults(cls)
    for name, nested in _children(cls):
        if nested is not None:
            kw[name], leaves = _build(nested, leaves, device)
        elif leaves:
            kw[name] = torch.from_numpy(np.array(leaves[0])).to(device)
            leaves = leaves[1:]
        elif name in defaults:
            kw[name] = defaults[name]
        else:
            raise ValueError(f"ran out of leaves at {cls.__name__}.{name}")
    return cls(**kw), leaves


def _defaults(cls) -> dict:
    if dataclasses.is_dataclass(cls):
        return {
            f.name: f.default
            for f in dataclasses.fields(cls)
            if f.default is not dataclasses.MISSING
        }
    return dict(getattr(cls, "_field_defaults", {}))


def digest(*leaf_lists) -> str:
    """sha256 over every leaf in order: its dtype and shape, then its bytes
    (so a packed uint16 column never digests like the int16 bytes it
    shares), applied to lists of numpy leaves."""
    h = hashlib.sha256()
    for leaves in leaf_lists:
        for leaf in leaves:
            x = np.ascontiguousarray(leaf)
            h.update(f"{x.dtype.str}{x.shape}".encode())
            h.update(x.tobytes())
    return h.hexdigest()
