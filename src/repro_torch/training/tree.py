"""Nested containers of tensors (the port's pytrees), walked in jax's order.

A tree is a leaf or a ``dict`` / ``list`` / ``tuple`` / ``NamedTuple``
of trees; ``None`` holds no leaf.  Leaves are visited as
``jax.tree_util`` visits them: a dict's keys sorted, a sequence's items
in order, a NamedTuple's fields in order.  ``names`` spells each leaf's
path as jax's key paths print, joined by ``/`` as the reference's
checkpoint joins them: ``[0]/['blocks']/['wq']``, ``[1]/.m/['embed']``,
``[1]/.step``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> List[Tuple[str, Any, Any]]:
    """``(path entry, key, child)`` of a container, in jax's order."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", i, c) for i, c in enumerate(node)]
    raise TypeError(f"not a container: {type(node)}")


def _is_container(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def _flatten(node, path: List[str], names: List[str], leaves: List[Any]) -> None:
    if node is None:
        return
    if _is_container(node):
        for entry, _, child in _children(node):
            _flatten(child, path + [entry], names, leaves)
        return
    names.append("/".join(path))
    leaves.append(node)


def flatten_with_names(tree: PyTree) -> Tuple[List[str], List[Any]]:
    """``(names, leaves)`` in jax's leaf order."""
    # module-level recursion: a nested recursive function would hold its
    # own cell and the leaf list in a reference cycle, keeping the leaves
    # (device memory) alive until the cyclic collector runs
    names: List[str] = []
    leaves: List[Any] = []
    _flatten(tree, [], names, leaves)
    return names, leaves


def leaves(tree: PyTree) -> List[Any]:
    return flatten_with_names(tree)[1]


def _rebuild(node, values):
    if isinstance(node, dict):
        return dict(values)
    if _is_namedtuple(node):
        return type(node)(*[v for _, v in values])
    return type(node)(v for _, v in values)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in a tree of ``tree``'s structure."""
    if tree is None:
        return None
    if _is_container(tree):
        if isinstance(tree, dict):
            keys = list(tree)
            return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in keys}
        kids = [tree_map(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)]
        return type(tree)(*kids) if _is_namedtuple(tree) else type(tree)(kids)
    return fn(tree, *rest)


def _unflatten(node, it):
    if node is None:
        return None
    if not _is_container(node):
        return next(it)
    return _rebuild(node, [(k, _unflatten(c, it)) for _, k, c in _children(node)])


def unflatten(like: PyTree, new_leaves: List[Any]) -> PyTree:
    """A tree of ``like``'s structure holding ``new_leaves`` in jax's leaf
    order (the order of ``flatten_with_names(like)``)."""
    it = iter(new_leaves)
    out = _unflatten(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
