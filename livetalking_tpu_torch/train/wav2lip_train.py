"""Wav2Lip training (ports livetalking_tpu/train/wav2lip_train.py): the L1
reconstruction step and the full GAN recipe.

Batch (tensors on the device): mel (B, 80, 16, 1) mel windows; face
(B, 256, 256, 6) masked || reference in [0, 1]; target (B, 256, 256, 3)
in [0, 1]; the GAN recipe adds sync_mel (B // T, 80, 16, 1), one window
per T-frame clip. The generator is the ``models/wav2lip.py`` module, or
any parameters ``gen_apply(params, mel, face)`` runs.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from livetalking_tpu_torch.models import syncnet, wav2lip_disc
from livetalking_tpu_torch.train import optim
from livetalking_tpu_torch.train.musetalk_train import _clip_windows, _detached


def _module_apply(model, mel, face):
    return model(mel, face)


def l1_loss(params: Any, batch: Dict[str, torch.Tensor], gen_apply=_module_apply) -> torch.Tensor:
    pred = gen_apply(params, batch["mel"], batch["face"])
    return (pred - batch["target"]).abs().mean()


def make_train_step(learning_rate: float = 1e-4):
    """-> (tx, step): ``step(params, opt_state, batch) -> (params, opt_state,
    loss)``, Adam on the L1 loss; ``opt_state`` is ``tx.init(params)``."""
    tx = optim.adam(learning_rate)

    def train_step(params, opt_state, batch):
        loss = l1_loss(params, batch)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return tx, train_step


def make_full_train_step(gen_lr: float = 1e-4, disc_lr: float = 1e-4, sync_wt: float = 0.03,
                         disc_wt: float = 0.07, T: int = 5, gen_apply=None):
    """The full GAN recipe: L1 + the frozen sync expert + the quality
    discriminator, with the published weights.

    -> (tx_gen, tx_disc, step) with ``step(gen_p, disc_p, sync_p, gen_opt,
    disc_opt, batch) -> (gen_p, disc_p, gen_opt, disc_opt, metrics)``; the
    generator's loss judges with the discriminator's parameters from before
    the step and takes no gradient into them; ``sync_p`` stays frozen."""
    tx_gen, tx_disc = optim.adam(gen_lr), optim.adam(disc_lr)
    apply_fn = gen_apply or _module_apply

    def gen_loss_fn(gen_p, disc_p, sync_p, batch):
        pred = apply_fn(gen_p, batch["mel"], batch["face"])
        l1 = (pred - batch["target"]).abs().mean()
        v, a = _detached(sync_p)(_clip_windows(pred, T), batch["sync_mel"])
        sync = syncnet.cosine_bce_loss(v, a, torch.ones(v.shape[0], device=v.device,
                                                        dtype=pred.dtype))
        percep = wav2lip_disc.bce_logits(_detached(disc_p)(pred), 1.0)
        loss = (1.0 - sync_wt - disc_wt) * l1 + sync_wt * sync + disc_wt * percep
        return loss, (l1, sync, percep, pred)

    def disc_loss_fn(disc_p, pred, target):
        real = wav2lip_disc.bce_logits(disc_p(target), 1.0)
        fake = wav2lip_disc.bce_logits(disc_p(pred), 0.0)
        return real + fake

    def step(gen_p, disc_p, sync_p, gen_opt, disc_opt, batch):
        g_loss, (l1, sync, percep, pred) = gen_loss_fn(gen_p, disc_p, sync_p, batch)
        g_loss.backward()
        gen_opt.step()
        d_loss = disc_loss_fn(disc_p, pred.detach(), batch["target"])
        d_loss.backward()
        disc_opt.step()
        metrics = {"gen": g_loss, "l1": l1, "sync": sync, "percep": percep, "disc": d_loss}
        return gen_p, disc_p, gen_opt, disc_opt, {k: v.detach() for k, v in metrics.items()}

    return tx_gen, tx_disc, step
