"""Nested containers of tensors walked in the reference's pytree order.

The reference flattens its parameter and optimizer trees with
``jax.tree_util``; the port's trees are the same plain containers of
tensors, walked here in the same order: a dict's items by sorted key, a
list's or tuple's items in order, a ``NamedTuple``'s fields in order.
Anything else is a leaf, and ``None`` holds no leaf. A leaf's path is
its keys from the root as strings, a field's name written ``.name`` (the
reference's ``GetAttrKey``), so ``(params, OptState)`` has the paths
``0/table0``, ``1/.step`` and ``1/.m/bot_w0``: the keys of the
reference's checkpoints.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, is_leaf: Optional[Callable] = None,
                      prefix: Tuple[str, ...] = ()
                      ) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] in the reference's order (module docstring)."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out.extend(flatten_with_path(sub, is_leaf, prefix + (key,)))
    return out


def leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    return [leaf for _, leaf in flatten_with_path(tree, is_leaf)]


def path_key(path: Tuple[str, ...]) -> str:
    """A leaf's checkpoint key: its path joined with '/'."""
    return "/".join(path)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """``fn`` of each leaf of ``tree`` and the leaves at the same place in
    ``rest`` (trees of the same structure), in a tree of ``tree``'s
    structure."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest),
                                     is_leaf=is_leaf)
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree, prefix: Tuple[str, ...] = (),
                       is_leaf: Optional[Callable] = None):
    """``fn(path, leaf)`` of each leaf of ``tree``, in a tree of its
    structure (paths as in :func:`flatten_with_path`)."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(prefix, tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (str(k),), is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, f),
                                               prefix + (f".{f}",), is_leaf)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (str(i),),
                                             is_leaf)
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
