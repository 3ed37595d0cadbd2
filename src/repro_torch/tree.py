"""Nested containers of tensors ("trees"), walked as the JAX package's
pytrees are: dicts by sorted key, NamedTuples by field, tuples and lists by
index, ``None`` as an empty node; anything else is a leaf.

A leaf's path is spelled as ``jax.tree_util.keystr`` pieces joined by "/"
— ``['params']/['encode']/['w']`` for dict keys, ``.m`` for a NamedTuple
field, ``[0]`` for a sequence index — so a checkpoint the port writes names
its leaves as one the JAX package writes does.
"""
from __future__ import annotations

from typing import Any, Callable, Optional


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(node) -> Optional[list]:
    """[(key, child), ...] of a container node (the dict key, field name or
    index); None for a leaf."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def _keystr(node, key) -> str:
    if isinstance(node, dict):
        return f"[{key!r}]"
    return f".{key}" if _is_namedtuple(node) else f"[{key}]"


def _rebuild(node, children: list):
    if isinstance(node, dict):
        return dict(zip(sorted(node), children))
    if _is_namedtuple(node):
        return type(node)(*children)
    return type(node)(children)


def map_with_keys(fn: Callable[[tuple, Any], Any], tree: Any, *,
                  is_leaf: Optional[Callable[[Any], bool]] = None, _keys: tuple = ()):
    """The tree with every leaf replaced by ``fn(keys, leaf)``, ``keys`` the
    tuple of (container, key) pairs from the root; containers are rebuilt
    as their own type (dicts with sorted keys)."""
    if tree is None:
        return None
    kids = None if (is_leaf is not None and is_leaf(tree)) else _children(tree)
    if kids is None:
        return fn(_keys, tree)
    return _rebuild(tree, [
        map_with_keys(fn, c, is_leaf=is_leaf, _keys=_keys + ((tree, k),)) for k, c in kids
    ])


def keystr(keys: tuple) -> str:
    """The JAX package's leaf path: ``['params']/['encode']/['w']``."""
    return "/".join(_keystr(node, k) for node, k in keys)


def flatten_with_paths(tree: Any, *, is_leaf=None) -> tuple[list, list]:
    """(paths, leaves) in the order ``jax.tree_util.tree_flatten_with_path``
    gives them, each path as :func:`keystr` spells it."""
    paths, leaves = [], []

    def visit(keys, leaf):
        paths.append(keystr(keys))
        leaves.append(leaf)
        return leaf

    map_with_keys(visit, tree, is_leaf=is_leaf)
    return paths, leaves


def flatten_with_keys(tree: Any, *, is_leaf=None) -> list:
    """[(keys, leaf), ...] in flatten order, ``keys`` the tuple of dict keys,
    field names and indices from the root."""
    out = []
    map_with_keys(lambda keys, leaf: out.append((tuple(k for _, k in keys), leaf)), tree,
                  is_leaf=is_leaf)
    return out


def leaves(tree: Any, *, is_leaf=None) -> list:
    return flatten_with_paths(tree, is_leaf=is_leaf)[1]


def tree_map(fn: Callable, tree: Any, *rest: Any, is_leaf=None):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (which share ``tree``'s structure)."""
    others = [iter(leaves(r, is_leaf=is_leaf)) for r in rest]
    return map_with_keys(lambda _, x: fn(x, *(next(o) for o in others)), tree,
                         is_leaf=is_leaf)


def unflatten_like(tree: Any, new_leaves, *, is_leaf=None):
    """``tree``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)
    return tree_map(lambda _: next(it), tree, is_leaf=is_leaf)
