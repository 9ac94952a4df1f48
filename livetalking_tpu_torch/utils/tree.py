"""Nested parameter trees: dictionaries, lists and tuples of tensors (or
numpy arrays), with ``None`` where the reference leaves a slot empty.

The port's counterpart of ``jax.tree_util`` for the few things training
needs: visit the leaves in a fixed order, rebuild a tree of the same
shape, and move a whole tree between numpy and a device.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every leaf; containers and ``None`` kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, v) for v in tree)) if hasattr(tree, "_fields") \
            else tuple(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in the order ``tree_map`` visits them (``None`` skipped)."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def to_numpy_tree(tree: Any) -> Any:
    """Every tensor leaf as a numpy array (bf16 as f32: numpy has no bf16);
    numbers and arrays as they are."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return v
    return tree_map(leaf, tree)


def to_torch_tree(tree: Any, device="cpu", dtype=None) -> Any:
    """Every array leaf as a tensor on ``device`` (floating leaves cast to
    ``dtype`` when given); plain numbers stay as they are."""
    def leaf(v):
        if isinstance(v, (np.ndarray, np.generic, torch.Tensor)):
            t = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            return t.to(device)
        return v
    return tree_map(leaf, tree)
