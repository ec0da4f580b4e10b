"""Nested dicts of tensors (the port's params "pytrees"): leaves with
their key paths, the leaf at a path, rebuilt trees, and a map. ``None`` subtrees (an empty
buffer stack) are kept by :func:`tree_map` and skipped by
:func:`leaves_with_paths`."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[str, ...]


def leaves_with_paths(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """Every non-``None`` leaf with its key path, in dict order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in leaves_with_paths(v, prefix + (k,))]
    return [(prefix, tree)]


def leaf_at(tree, path: Path):
    """The subtree at key path ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def unflatten(pairs) -> Dict[str, Any]:
    """The tree of (path, leaf) pairs (inverse of
    :func:`leaves_with_paths`, without the ``None`` subtrees)."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_map(fn: Callable, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
