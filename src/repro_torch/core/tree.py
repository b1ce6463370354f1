"""Trees of tensors in JAX's order.

A tree is nested dicts, ``NamedTuple``s, tuples and lists; ``None`` is an
empty subtree; anything else is a leaf. The walk is ``jax.tree``'s: dict
keys sorted, ``NamedTuple`` fields in order, tuple and list items by index.
So the leaves come in the reference's order (its global norm sums them in
it, its checkpoints number them by it), and each leaf's path name is the
one the reference's checkpoint writes: the keys, indices and field names
joined by ``/`` (``0/bias``, ``1/mu/tables``, ``1/step``).

Rebuilt dicts keep the key order of the tree they were rebuilt from; only
the walk sorts.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> list[tuple[str, Any]] | None:
    """(name, child) pairs of a container in walk order; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _walk(node, path: str) -> Iterator[tuple[str, Any]]:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        yield path or "root", node
        return
    for name, child in kids:
        yield from _walk(child, f"{path}/{name}" if path else name)


def flatten_with_paths(tree: Tree) -> list[tuple[str, Any]]:
    """(path name, leaf) of every leaf, in JAX's order."""
    return list(_walk(tree, ""))


def leaves(tree: Tree) -> list:
    """The leaves in JAX's order (``jax.tree.leaves``)."""
    return [leaf for _, leaf in _walk(tree, "")]


def unflatten(like: Tree, new_leaves) -> Tree:
    """``like``'s structure with its leaves replaced, in JAX's order, by
    ``new_leaves`` (``jax.tree_util.tree_unflatten``). Raises
    ``ValueError`` if the counts differ."""
    new_leaves = list(new_leaves)
    n = len(leaves(like))
    if len(new_leaves) != n:
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {n}")
    return _build(like, iter(new_leaves))


def _build(node, it):
    # a module-level function: a recursive closure would form a reference
    # cycle with the leaves, which then live until the garbage collector
    # runs (a dlrm-rm2 gradient is 6.66 GB)
    if node is None:
        return None
    if isinstance(node, dict):
        got = {k: _build(node[k], it) for k in sorted(node)}
        return {k: got[k] for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_build(c, it) for c in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_build(c, it) for c in node)
    return next(it)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure), in ``tree``'s structure."""
    flat = leaves(tree)
    others = [leaves(r) for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError(f"trees of {[len(flat), *map(len, others)]} leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(flat, *others)])
