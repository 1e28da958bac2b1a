"""Parameter trees: nested dicts and lists with tensors (or arrays) at the
leaves, the layout both packages use."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply fn to every leaf; dicts stay dicts, lists and tuples become
    lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)
