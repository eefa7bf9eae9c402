"""Flatten a chain state the way ``jax.tree_util`` orders it.

A streaming state is a small tree of tuples, lists, NamedTuples and dicts
with tensors (or arrays, or scalars) at the leaves. ``checkpoint`` stores the
leaves as ``leaf_0..leaf_{n-1}`` and ``debug`` names a bad leaf by its path,
so both need the order in which the JAX package visits them:

- tuples, lists and NamedTuples in order (a NamedTuple field is ``.name``,
  a position ``[i]``);
- dicts by sorted key (``['key']``);
- ``None`` as no leaf;
- anything else (tensors, ndarrays, scalars) as a leaf.

A JAX state and its port counterpart of the same fields therefore give the
same leaves in the same order. The helpers are written here rather than
taken from torch's private pytree module.
"""

from __future__ import annotations

from typing import Any, NamedTuple


class TreeDef(NamedTuple):
    """The structure of a tree with its leaves taken out: `kind` is one of
    "leaf", "none", "tuple", "list", "namedtuple", "dict"; `meta` the
    NamedTuple class or the sorted dict keys; `children` the sub-structures."""
    kind: str
    meta: Any
    children: tuple

    def __str__(self) -> str:
        return f"PyTreeDef({_fmt(self)})"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _node(x):
    """(kind, meta, [(key string, child)]) of an inner node, or None for a leaf."""
    if x is None:
        return "none", None, []
    if _is_namedtuple(x):
        return "namedtuple", type(x), [(f".{f}", getattr(x, f)) for f in x._fields]
    if isinstance(x, (tuple, list)):
        return type(x).__name__, None, [(f"[{i}]", c) for i, c in enumerate(x)]
    if isinstance(x, dict):
        keys = sorted(x)
        return "dict", tuple(keys), [(f"[{k!r}]", x[k]) for k in keys]
    return None


def flatten_with_path(tree) -> tuple[list[tuple[str, Any]], TreeDef]:
    """([(path, leaf), ...], treedef); a path is the reference's
    ``jax.tree_util.keystr`` of the leaf's key path, e.g. ``.fir.tail``,
    ``[0]`` or ``['y']``."""
    out: list[tuple[str, Any]] = []

    def walk(x, path: str) -> TreeDef:
        node = _node(x)
        if node is None:
            out.append((path, x))
            return TreeDef("leaf", None, ())
        kind, meta, kids = node
        return TreeDef(kind, meta, tuple(walk(c, path + k) for k, c in kids))

    treedef = walk(tree, "")
    return out, treedef


def flatten(tree) -> tuple[list, TreeDef]:
    """(leaves, treedef) in the reference's leaf order."""
    pairs, treedef = flatten_with_path(tree)
    return [leaf for _, leaf in pairs], treedef


def unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of `treedef` with `leaves` put back in order."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "namedtuple":
            return td.meta(*kids)
        if td.kind == "dict":
            return dict(zip(td.meta, kids))
        return tuple(kids) if td.kind == "tuple" else kids

    tree = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return tree


def _fmt(td: TreeDef) -> str:
    if td.kind == "leaf":
        return "*"
    if td.kind == "none":
        return "None"
    kids = [_fmt(c) for c in td.children]
    if td.kind == "namedtuple":
        return f"{td.meta.__name__}(" + ", ".join(
            f"{f}={k}" for f, k in zip(td.meta._fields, kids)) + ")"
    if td.kind == "dict":
        return "{" + ", ".join(f"{k!r}: {v}" for k, v in zip(td.meta, kids)) + "}"
    if td.kind == "list":
        return "[" + ", ".join(kids) + "]"
    return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
