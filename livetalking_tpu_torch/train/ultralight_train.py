"""Ultralight per-avatar U-Net training (ports
livetalking_tpu/train/ultralight_train.py): L1 reconstruction of the
160 px mouth crop (upstream stage 1), and L1 plus a frozen 5-frame sync
expert trained at 160 px (stage 2). Parameters train in f32 whatever the
serving tree's dtype.

Batch (tensors on the device): face (B, 160, 160, 6) real || interior-
masked in [0, 1]; audio (B, 32, 32, 16) HuBERT window planes; target
(B, 160, 160, 3); the full recipe adds sync_mel (B // 5, 80, 16, 1).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from livetalking_tpu_torch.models import syncnet, ultralight
from livetalking_tpu_torch.train import optim
from livetalking_tpu_torch.train.musetalk_train import _clip_windows, _detached


def l1_loss(params: Any, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    pred = ultralight.apply(params, batch["face"], batch["audio"])
    return (pred - batch["target"]).abs().mean()


def make_train_step(learning_rate: float = 1e-4):
    """-> (tx, step): ``step(params, opt_state, batch) -> (params, opt_state,
    loss)``, Adam on the L1 loss."""
    tx = optim.adam(learning_rate)

    def train_step(params, opt_state, batch):
        loss = l1_loss(params, batch)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return tx, train_step


def make_full_train_step(lr: float = 1e-4, sync_wt: float = 0.3, T: int = 5):
    """L1 + the frozen sync expert: ``step(params, sync_params, opt_state,
    batch) -> (params, opt_state, metrics)``; B a multiple of T."""
    tx = optim.adam(lr)

    def step(params, sync_params, opt_state, batch):
        pred = ultralight.apply(params, batch["face"], batch["audio"])
        l1 = (pred - batch["target"]).abs().mean()
        v, a = _detached(sync_params)(_clip_windows(pred, T), batch["sync_mel"])
        sync = syncnet.cosine_bce_loss(v, a, torch.ones(v.shape[0], device=v.device))
        loss = (1.0 - sync_wt) * l1 + sync_wt * sync
        loss.backward()
        opt_state.step()
        return params, opt_state, {"loss": loss.detach(), "l1": l1.detach(),
                                   "sync": sync.detach()}

    return tx, step
