"""Parameter-tree checkpoints (ports livetalking_tpu/utils/checkpoint.py).

The format is the reference's: a pickle of the tree with every leaf a
numpy array, readable without PyTorch or JAX. The port writes its own
parameter layouts (conv weights (O, I, kh, kw), linears (out, in)) inside
a marked dictionary, ``{"format": PORT_FORMAT, "params": tree}``, so a
reader can tell them from a tree the JAX package wrote (HWIO convs,
(in, out) linears), which ``load_params`` returns unmarked for the
family's ``params_from_jax``.
"""

from __future__ import annotations

import pickle
from typing import Any, Tuple

import torch

from livetalking_tpu_torch.utils.tree import to_numpy_tree

PORT_FORMAT = "livetalking_tpu_torch/params-v1"


def save_pytree(path: str, tree: Any) -> None:
    """Pickle ``tree`` with numpy leaves."""
    with open(path, "wb") as f:
        pickle.dump(to_numpy_tree(tree), f, protocol=pickle.HIGHEST_PROTOCOL)


def load_pytree(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_params(path: str, tree: Any) -> None:
    """Write a parameter tree (a module: its state dict) in the port's
    layout, marked as such."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    save_pytree(path, {"format": PORT_FORMAT, "params": tree})


def load_params(path: str) -> Tuple[Any, bool]:
    """(tree with numpy leaves, True if the port wrote it in its own layout;
    False for a tree in the JAX package's layout)."""
    tree = load_pytree(path)
    if isinstance(tree, dict) and tree.get("format") == PORT_FORMAT:
        return tree["params"], True
    return tree, False
