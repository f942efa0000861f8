"""Nested trees of tensors: the port's parameters, optimizer states and
checkpoints (the reference's pytrees).

A tree is a dict, list or tuple of trees, a leaf (a tensor, or any other
value), or None, which holds no leaf.  Flattening walks a dict's keys in
sorted order and a list's items in order, as ``jax.tree_util`` does, so
a leaf's path and position are the same however the dict was built.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator


def flatten_with_paths(tree: Any, prefix: tuple = ()) -> list[tuple]:
    """``[(path, leaf), ...]`` in flattening order; a path is the tuple of
    dict keys and list indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, t in enumerate(tree):
            out += flatten_with_paths(t, prefix + (i,))
        return out
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def path_str(path: tuple) -> str:
    """``("layers", 0, "attn", "wq")`` -> ``"layers/0/attn/wq"`` (the
    reference checkpoint's leaf names)."""
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten_like(template: Any, values) -> Any:
    """A tree of ``template``'s structure whose leaves are ``values``, in
    flattening order."""
    it = iter(values)
    out = _rebuild(template, it)
    if next(it, _END) is not _END:
        raise ValueError("more values than the template has leaves")
    return out


_END = object()


def _rebuild(tree: Any, it: Iterator) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        built = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: built[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    v = next(it, _END)
    if v is _END:
        raise ValueError("fewer values than the template has leaves")
    return v
