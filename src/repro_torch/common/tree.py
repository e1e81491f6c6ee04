"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

A tree is a dict whose values are trees or leaves; anything that is not a
dict is a leaf (a tensor, a `ParamDef`, a `QTensor`)."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply `fn` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)

