"""Nested-dict trees of tensors, the port's param and state trees: leaves
in ``jax.tree``'s flattening order of a dict (sorted keys) under their
"/"-joined keys, the leaf keys of a checkpoint."""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

Tree = Dict[str, Any]


def leaves(tree: Tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of a nested dict in sorted key order, keys joined by
    "/" (``jax.tree``'s flattening order of a dict)."""
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from leaves(v, key + "/")
        else:
            yield key, v


def unflatten(like: Tree, flat: Dict[str, Any], prefix: str = "") -> Tree:
    """``like``'s nested structure with each leaf taken from ``flat`` by
    its "/"-joined key."""
    return {k: unflatten(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
            else flat[f"{prefix}{k}"] for k, v in like.items()}


def tree_map(fn, tree: Tree) -> Tree:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
