"""SyncNet training step (ports livetalking_tpu/train/syncnet_train.py):
the expert is trained on its own before it judges a generator.

Batch: faces (B, img//2, img, 15) 5-frame lower-half windows in [0, 1];
mels (B, 80, 16, 1) matching or offset mel windows; labels (B,) 1.0 in
sync, 0.0 off.
"""

from __future__ import annotations

from livetalking_tpu_torch.models import syncnet
from livetalking_tpu_torch.train import optim


def make_train_step(learning_rate: float = 1e-4):
    """-> (tx, step): ``step(params, opt_state, faces, mels, labels) ->
    (params, opt_state, loss)``, Adam on the cosine BCE; ``params`` is a
    ``syncnet.SyncNet``."""
    tx = optim.adam(learning_rate)

    def train_step(params, opt_state, faces, mels, labels):
        v, a = params(faces, mels)
        loss = syncnet.cosine_bce_loss(v, a, labels)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return tx, train_step
