"""One full-recipe MuseTalk training step of the port against the JAX
package's recipe on the CPU, in f32: TINY U-Net, the full-width VAE, 64 px
frames, one 16-frame clip judged by the MuseTalk sync expert (a small
config with one self-attention block, so kernel 3's forward and backward
run inside the expert too) and the face and mouth discriminators.

The weights are the port's seeded inits carried to the JAX layouts. A
step's metrics are functions of the parameters before it (the generator's
terms, and the discriminators' losses on the old U-Net's prediction), so
the JAX side evaluates them with its module's own functions in one
compiled forward, and the discriminators' updates with ``optax.adamw``
on its own gradients of their losses on the port's prediction (their
leaky ReLUs make those gradients move by 3e-4 under a 1e-6 change of the
prediction). Bars: every metric within 1e-4 relative; each
discriminator's gradient (its first moment / 0.1) and its new parameters,
each leaf on its own, within 1e-4 relative L2 (Adam's first update is
lr x sign(g) wherever |g| >> eps, so an element whose gradient is
rounding noise may step the other way in one package); the U-Net
unchanged by the first update (the schedule's learning rate 0; that it
moves after is held by test_torch_train_optim.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from livetalking_tpu.models import multiscale_disc as jmd
from livetalking_tpu.models import musetalk_syncnet as jms
from livetalking_tpu.train import musetalk_train as jmt
from livetalking_tpu_torch.models import multiscale_disc as tmd
from livetalking_tpu_torch.models import musetalk_syncnet as tms
from livetalking_tpu_torch.models.musetalk import positional_encoding_table
from livetalking_tpu_torch.train import musetalk_train as tmt
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401
from test_torch_musetalk_train import JTINY, TTINY, paths, port_weights, rel, tree_to_jax

S, B = 64, 16
WEIGHTS = dict(pixel=1.0, latent=1.0, perceptual=0.01, sync=0.1, gan=0.05, mouth_gan=0.05)
STEP_KW = dict(lr=1e-4, disc_lr=2e-5, warmup=2, max_steps=10, sync_backend="musetalk")
# lower halves (32, 64, 48) and the 52-column mel both end at 4x4x32
_SYNC = dict(audio=(1, (32, 32, 32), (2, 2, (5, 3)), (0, 0, 0)),
             visual=(48, (32, 32, 32), (2, 2, (2, 4)), (0, 1, 0)))
JSYNC = jms.SyncNetConfig(**{k: jms.EncoderConfig(*v) for k, v in _SYNC.items()})
TSYNC = tms.SyncNetConfig(**{k: tms.EncoderConfig(*v) for k, v in _SYNC.items()})


@pytest.fixture(scope="module")
def run():
    r = np.random.RandomState(7)
    batch = {"gt": r.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
             "ref": r.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
             "audio": r.normal(0, 0.3, (B, 50, 384)).astype(np.float32),
             "sync_mel16": r.normal(0, 1, (1, 80, 52, 1)).astype(np.float32)}
    tw = port_weights(3)
    sync = tms.init_params(4, TSYNC)
    jw = {k: tree_to_jax(v) for k, v in tw.items()}
    jsync = tree_to_jax(sync)
    w = jmt.LossWeights(**WEIGHTS)
    pe = jnp.asarray(positional_encoding_table(50, JTINY.cross_dim))

    @jax.jit
    def jmetrics(b, port_pred01):
        pred_lat, pred01, gt_lat = jmt.forward(jw["unet"], jw["vae"], JTINY, pe, b["gt"],
                                               b["ref"], b["audio"])
        gt01 = b["gt"] / 2.0 + 0.5
        m = {"latent_l1": jnp.mean(jnp.abs(pred_lat - gt_lat)),
             "pixel_l1": jnp.mean(jnp.abs(pred01 - gt01)),
             "perceptual": jmt.pyramid_l1(pred01, gt01),
             "sync": jmt._sync_loss_musetalk(jsync, pred01, b["sync_mel16"], JSYNC),
             "gan": jmd.gen_loss(jw["face"], pred01),
             "mouth_gan": jmd.gen_loss(jw["mouth"], jmt._mouth_crop(pred01))}
        m["loss"] = (w.latent * m["latent_l1"] + w.pixel * m["pixel_l1"]
                     + w.perceptual * m["perceptual"] + w.sync * m["sync"]
                     + w.gan * m["gan"] + w.mouth_gan * m["mouth_gan"])
        # the discriminators' step: AdamW on the cosine schedule, count 0
        tx_d = optax.adamw(optax.cosine_decay_schedule(STEP_KW["disc_lr"],
                                                       STEP_KW["max_steps"], 1e-2),
                           b1=0.9, b2=0.999, weight_decay=1e-2)
        new = {}
        for name, real, fake in (("face", gt01, port_pred01),
                                 ("mouth", jmt._mouth_crop(gt01),
                                  jmt._mouth_crop(port_pred01))):
            loss, g = jax.value_and_grad(jmd.disc_loss)(jw[name], real, fake)
            m[f"{name}_disc"] = loss
            upd, _ = tx_d.update(g, tx_d.init(jw[name]), jw[name])
            new[name] = (optax.apply_updates(jw[name], upd), g)
        return m, new

    txs, step = tmt.make_train_step(TTINY, tmt.LossWeights(**WEIGHTS), sync_cfg=TSYNC,
                                    **STEP_KW)
    tx_g, tx_d = txs
    state = tmt.TrainState(tw["unet"], tx_g.init(tw["unet"]), tw["face"], tx_d.init(tw["face"]),
                           tw["mouth"], tx_d.init(tw["mouth"]))
    unet0 = [t.detach().clone() for _, t in paths(tw["unet"])]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    fakes = []  # the prediction the step hands its face discriminator
    disc_loss = tmd.disc_loss
    tmd.disc_loss = lambda net, real, fake: fakes.append(fake) or disc_loss(net, real, fake)
    try:
        state, tm = step(state, tw["vae"], sync, tb)
    finally:
        tmd.disc_loss = disc_loss
    jm, jnew = jmetrics({k: jnp.asarray(v) for k, v in batch.items()},
                        jnp.asarray(fakes[0].numpy()))
    want = ({k: float(v) for k, v in jm.items()}, jax.tree.map(np.asarray, jnew))
    unet1 = [t.detach() for _, t in paths(state.unet)]
    discs = {}
    for k in ("face", "mouth"):
        opt = getattr(state, f"{k}_disc_opt")
        grads = [opt.opt.state[t]["exp_avg"] / 0.1 for t in opt.params]
        discs[k] = ({p: t.detach().numpy().copy() for p, t in paths(getattr(state, f"{k}_disc"))},
                    dict(zip([p for p, _ in paths(getattr(state, f"{k}_disc"))], grads)))
    got = ({k: float(v) for k, v in tm.items()}, discs, (unet0, unet1))
    return got, want


def test_full_recipe_metrics_within_1e4(run):
    (gm, _, _), (wm, _) = run
    assert gm.keys() == wm.keys()
    for k, w in wm.items():
        assert abs(gm[k] - w) <= 1e-4 * abs(w), (k, gm[k], w)


def test_discriminators_step_like_optax_adamw(run):
    (_, discs, _), (_, wnew) = run
    for name in ("face", "mouth"):
        params, grads = discs[name]
        wp, wg = (dict(paths(tmd.params_from_jax(t))) for t in wnew[name])
        keys = sorted(params)
        assert keys == sorted(wp)
        for k in keys:  # each leaf on its own
            assert rel(grads[k].numpy(), wg[k].detach().numpy()) <= 1e-4, (name, k)
            assert rel(params[k], wp[k].detach().numpy()) <= 1e-4, (name, k)


def test_the_zero_learning_rate_update_leaves_the_unet(run):
    (_, _, (u0, u1)), _ = run
    assert all(torch.equal(a, b) for a, b in zip(u0, u1))

