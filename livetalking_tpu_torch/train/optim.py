"""The reference's optax optimizers and schedules on ``torch.optim``.

optax takes the schedule's value at the update count *before* its
increment, so the first update of a schedule that starts at 0 moves only
the moments. ``Optimizer.step`` does the same: it sets the learning rate
to ``schedule(count)``, steps, then counts. ``adam`` is ``optax.adam``
(``torch.optim.Adam``); ``adamw`` is ``optax.adamw`` with decoupled
weight decay (``torch.optim.AdamW``: both decay by ``lr * wd * p`` with
the parameters before the update, and both put ``eps`` outside the square
root). The schedules are optax's formulas in plain Python.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from livetalking_tpu_torch.utils.tree import to_torch_tree, tree_leaves

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warm-up, then cosine
    decay over ``decay_steps - warmup_steps`` to ``end_value``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        c = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)
    return schedule


class Optimizer:
    """A torch optimizer over a tree's leaves (or a module's parameters),
    stepped the way optax steps."""

    def __init__(self, tree: Any, schedule: Union[float, Schedule],
                 weight_decay: float = 0.0, decoupled: bool = False):
        self.params = (list(tree.parameters()) if isinstance(tree, torch.nn.Module)
                       else tree_leaves(tree))
        for p in self.params:
            p.requires_grad_(True)
        cls = torch.optim.AdamW if decoupled else torch.optim.Adam
        self.opt = cls(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                       weight_decay=weight_decay)
        self.schedule = schedule if callable(schedule) else (lambda count: schedule)
        self.count = 0
        # called with the leaves' gradients before each update (the
        # training CLI's --mesh sets their mean over dp here)
        self.reduce_grads: Optional[Callable[[List[torch.Tensor]], None]] = None

    def step(self) -> None:
        """Apply the gradients in the leaves' ``.grad`` (through
        ``reduce_grads`` first, when set), then clear them."""
        if self.reduce_grads is not None:
            self.reduce_grads([p.grad for p in self.params if p.grad is not None])
        for group in self.opt.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "opt": self.opt.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        self.opt.load_state_dict(to_torch_tree(state["opt"]))


class Tx:
    """optax's ``GradientTransformation`` shape: ``init(tree)`` gives the
    tree's optimizer (and marks its leaves as trainable)."""

    def __init__(self, schedule: Union[float, Schedule], weight_decay: float = 0.0,
                 decoupled: bool = False):
        self.schedule, self.weight_decay, self.decoupled = schedule, weight_decay, decoupled

    def init(self, tree: Any) -> Optimizer:
        return Optimizer(tree, self.schedule, self.weight_decay, self.decoupled)


def adam(learning_rate: Union[float, Schedule]) -> Tx:
    return Tx(learning_rate)


def adamw(learning_rate: Union[float, Schedule], weight_decay: float = 1e-4) -> Tx:
    return Tx(learning_rate, weight_decay, decoupled=True)
