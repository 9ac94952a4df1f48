"""MuseTalk U-Net fine-tuning: the reference's training recipe (ports
livetalking_tpu/train/musetalk_train.py).

The latent U-Net is the only net that trains; the VAE and the Whisper
front-end are frozen. Per step the target frame is lower-half masked, the
masked and a reference frame are VAE-encoded (no gradient), their latents
concatenated into the 8-channel U-Net input, the U-Net predicts the
target's latents in one step at t=0 conditioned on the audio window, and
the prediction is VAE-decoded for the pixel-space losses: the gradient
flows back through the frozen decoder into the prediction. Loss terms:
latent and pixel L1, an image-pyramid L1 (``pyramid_l1``, with an
injectable feature extractor), a frozen sync expert (the generic 5-frame
``models/syncnet.py`` or MuseTalk's 16-frame ``models/musetalk_syncnet.py``)
and two multi-scale GAN discriminators, full face and mouth, each with
its own AdamW and cosine schedule.

Every self-attention of the step (16 in the U-Net, one in each of the
three encodes and the decode, two in the MuseTalk expert) runs kernel 3
(``ops/attention.py``) on the card, and the U-Net's, the decode's and the
expert's also its backward.

Order inside a step, as the reference's: the generator loss judges with
the discriminators' parameters from before the step (a detached copy, so
no gradient reaches them); the U-Net steps; then each discriminator
steps on the prediction of the old U-Net, detached.

Batch (tensors on the device): gt, ref (B, S, S, 3) RGB in [-1, 1];
audio (B, 50, 384) Whisper windows; sync_mel (B // 5, 80, 16, 1) or
sync_mel16 (B // 16, 80, 52, 1) when the sync term is on.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from livetalking_tpu_torch.models import multiscale_disc, sd_unet, sd_vae, syncnet
from livetalking_tpu_torch.models.musetalk import positional_encoding_table
from livetalking_tpu_torch.train import optim
from livetalking_tpu_torch.utils.tree import tree_map


class LossWeights(NamedTuple):
    """The reference's loss_params defaults (stage-2 style recipe)."""

    pixel: float = 1.0
    latent: float = 1.0
    perceptual: float = 0.01
    sync: float = 0.0
    gan: float = 0.0
    mouth_gan: float = 0.0


def make_schedule(lr: float = 1e-5, warmup: int = 500, max_steps: int = 100_000):
    """The reference's cosine schedule with linear warm-up from 0."""
    return optim.warmup_cosine_decay_schedule(0.0, lr, max(warmup, 1),
                                              max(max_steps, warmup + 1), lr * 1e-2)


def mask_lower_half(gt: torch.Tensor) -> torch.Tensor:
    """Rows from S // 2 down set to -1."""
    out = gt.clone()
    out[:, gt.shape[1] // 2:] = -1.0
    return out


def mouth_crop(img01: torch.Tensor) -> torch.Tensor:
    """Rows [S/2, S), columns [S/4, 3S/4): the mouth discriminator's region."""
    S = img01.shape[1]
    return img01[:, S // 2:, S // 4: 3 * S // 4, :]


def pyramid_l1(pred01: torch.Tensor, gt01: torch.Tensor, scales=(1.0, 0.5, 0.25),
               feature_fn: Optional[Callable] = None) -> torch.Tensor:
    """Image-pyramid perceptual term: mean |p - g| per scale (of
    ``feature_fn`` of each, when given), averaged over the scales."""
    total = torch.zeros((), dtype=torch.float32, device=pred01.device)
    for s in scales:
        f = int(round(1.0 / s))
        p = multiscale_disc._downsample(pred01, f)
        g = multiscale_disc._downsample(gt01, f)
        if feature_fn is not None:
            p, g = feature_fn(p), feature_fn(g)
        total = total + (p - g).abs().mean()
    return total / len(scales)


def _clip_windows(pred01: torch.Tensor, T: int) -> torch.Tensor:
    """(n*T, S, S, 3) -> (n, S/2, S, 3T): each clip's lower halves
    channel-stacked in frame order."""
    n = pred01.shape[0] // T
    S = pred01.shape[1]
    clips = pred01[: n * T].reshape(n, T, S, S, 3)[:, :, S // 2:]
    return torch.cat([clips[:, i] for i in range(T)], dim=-1)


def sync_loss(sync_net, pred01: torch.Tensor, sync_mel: torch.Tensor) -> torch.Tensor:
    """The frozen 5-frame expert's BCE on the clips' lower halves."""
    v, a = sync_net(_clip_windows(pred01, syncnet.FRAMES), sync_mel)
    return syncnet.cosine_bce_loss(v, a, torch.ones(v.shape[0], device=v.device))


def sync_loss_musetalk(sync_params, pred01: torch.Tensor, sync_mel16: torch.Tensor,
                       sync_cfg) -> torch.Tensor:
    """MuseTalk's 16-frame expert against the clip's 52-column mel."""
    from livetalking_tpu_torch.models import musetalk_syncnet as msn

    v, a = msn.apply(sync_params, _clip_windows(pred01, msn.FRAMES), sync_mel16, sync_cfg)
    return msn.cosine_bce_loss(v, a, torch.ones(v.shape[0], device=v.device))


def forward(unet_params, vae_params, cfg: sd_unet.UNetConfig, pe: torch.Tensor,
            gt: torch.Tensor, ref: torch.Tensor, audio: torch.Tensor,
            dtype: torch.dtype = torch.float32):
    """The differentiable forward: (pred_latents, pred01, gt_latents).

    The three encodes run without a gradient; the decode carries it from
    the RGB prediction back into the predicted latents (the VAE's own
    parameters take none)."""
    with torch.no_grad():
        m_lat = sd_vae.encode(vae_params, mask_lower_half(gt).to(dtype))
        r_lat = sd_vae.encode(vae_params, ref.to(dtype))
        gt_lat = sd_vae.encode(vae_params, gt.to(dtype))
    x = torch.cat([m_lat, r_lat], dim=-1).to(dtype)
    ctx = (audio + pe).to(dtype)
    t = torch.zeros((gt.shape[0],), dtype=torch.float32, device=gt.device)
    pred_lat = sd_unet.apply(unet_params, cfg, x, t, ctx)
    pred01 = sd_vae.decode(vae_params, pred_lat.to(dtype), dtype=dtype)
    return pred_lat, pred01.float(), gt_lat


class TrainState(NamedTuple):
    unet: Any
    unet_opt: Any
    face_disc: Any
    face_disc_opt: Any
    mouth_disc: Any
    mouth_disc_opt: Any


def init_train_state(seed: int, cfg: sd_unet.UNetConfig, txs, weights: LossWeights,
                     unet_params=None, dtype=torch.float32, device="cpu") -> TrainState:
    """Parameters and optimizers; ``txs`` from ``make_train_step``. The
    U-Net is random from ``seed`` unless given; the discriminators from
    ``seed + 1`` and ``seed + 2``."""
    tx_g, tx_d = txs
    unet_p = unet_params if unet_params is not None else sd_unet.init_params(
        seed, cfg, dtype, device)
    fd = multiscale_disc.init_params(seed + 1, device=device) if weights.gan > 0 else None
    md = multiscale_disc.init_params(seed + 2, device=device) if weights.mouth_gan > 0 else None
    return TrainState(unet=unet_p, unet_opt=tx_g.init(unet_p),
                      face_disc=fd, face_disc_opt=tx_d.init(fd) if fd is not None else None,
                      mouth_disc=md, mouth_disc_opt=tx_d.init(md) if md is not None else None)


def _detached(params):
    """``params`` cut from autograd, so a loss through them takes no gradient
    into them: a tree of tensors, or for a module, the module to call."""
    if isinstance(params, torch.nn.Module):
        frozen = {n: p.detach() for n, p in params.named_parameters()}
        return lambda *args: torch.func.functional_call(params, frozen, args)
    return tree_map(torch.Tensor.detach, params)


def make_train_step(cfg: sd_unet.UNetConfig, weights: LossWeights = LossWeights(),
                    lr: float = 1e-5, disc_lr: float = 2e-5, warmup: int = 500,
                    max_steps: int = 100_000, weight_decay: float = 1e-2, ctx_len: int = 50,
                    dtype: torch.dtype = torch.float32, feature_fn: Optional[Callable] = None,
                    sync_backend: str = "generic", sync_cfg=None):
    """-> ((tx_gen, tx_disc), step).

    ``step(state, vae_params, sync_params, batch) -> (state, metrics)``
    updates ``state``'s parameters in place; ``sync_params`` may be None
    when ``weights.sync == 0``. ``step.gen_loss_fn(unet_p, state,
    vae_params, sync_params, batch) -> (loss, (metrics, pred01))`` is the
    generator's loss alone. The reference's ``remat`` option (recompute the
    forward in the backward) is left out: no caller of the port sets it."""
    if sync_cfg is None and sync_backend == "musetalk":
        from livetalking_tpu_torch.models import musetalk_syncnet as msn

        sync_cfg = msn.MUSETALK
    pe_np = positional_encoding_table(ctx_len, cfg.cross_dim)
    tx_g = optim.adamw(make_schedule(lr, warmup, max_steps), weight_decay=weight_decay)
    tx_d = optim.adamw(optim.cosine_decay_schedule(disc_lr, max_steps, 1e-2),
                       weight_decay=weight_decay)

    def gen_loss_fn(unet_p, state: TrainState, vae_params, sync_params, batch):
        gt = batch["gt"]
        pe = torch.as_tensor(pe_np, device=gt.device)
        pred_lat, pred01, gt_lat = forward(unet_p, vae_params, cfg, pe, gt, batch["ref"],
                                           batch["audio"], dtype)
        gt01 = gt.float() / 2.0 + 0.5
        m = {"latent_l1": (pred_lat - gt_lat).abs().mean(),
             "pixel_l1": (pred01 - gt01).abs().mean()}
        loss = weights.latent * m["latent_l1"] + weights.pixel * m["pixel_l1"]
        if weights.perceptual > 0:
            m["perceptual"] = pyramid_l1(pred01, gt01, feature_fn=feature_fn)
            loss = loss + weights.perceptual * m["perceptual"]
        if weights.sync > 0:
            if sync_backend == "musetalk":
                m["sync"] = sync_loss_musetalk(_detached(sync_params), pred01,
                                               batch["sync_mel16"], sync_cfg)
            else:
                m["sync"] = sync_loss(_detached(sync_params), pred01, batch["sync_mel"])
            loss = loss + weights.sync * m["sync"]
        if weights.gan > 0:
            m["gan"] = multiscale_disc.gen_loss(_detached(state.face_disc), pred01)
            loss = loss + weights.gan * m["gan"]
        if weights.mouth_gan > 0:
            m["mouth_gan"] = multiscale_disc.gen_loss(_detached(state.mouth_disc),
                                                      mouth_crop(pred01))
            loss = loss + weights.mouth_gan * m["mouth_gan"]
        m["loss"] = loss
        return loss, (m, pred01)

    def disc_step(params, opt, real, fake):
        d_loss = multiscale_disc.disc_loss(params, real, fake)
        d_loss.backward()
        opt.step()
        return d_loss.detach()

    def step(state: TrainState, vae_params, sync_params, batch):
        loss, (metrics, pred01) = gen_loss_fn(state.unet, state, vae_params, sync_params, batch)
        loss.backward()
        state.unet_opt.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        gt01 = batch["gt"].float() / 2.0 + 0.5
        fake = pred01.detach()
        if weights.gan > 0:
            metrics["face_disc"] = disc_step(state.face_disc, state.face_disc_opt, gt01, fake)
        if weights.mouth_gan > 0:
            metrics["mouth_disc"] = disc_step(state.mouth_disc, state.mouth_disc_opt,
                                              mouth_crop(gt01), mouth_crop(fake))
        return state, metrics

    step.gen_loss_fn = gen_loss_fn
    return (tx_g, tx_d), step
