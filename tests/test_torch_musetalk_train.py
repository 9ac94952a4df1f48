"""The port's MuseTalk generator loss and its U-Net gradients against the
JAX package's on the CPU, in f32, at the JAX test's TINY U-Net and the
full-width VAE, on 128 px frames (16x16 latents). At 64 px the U-Net's
deepest level is 1x1 and its GroupNorms' E[x^2] - E[x]^2 cancels so badly
that a 1e-6 relative change of the input moves the gradient by 1e-3 in
either package; at 128 px the same change moves it by 3e-5.

The weights are the port's seeded inits, carried to the JAX package's
layouts (``tree_to_jax``, the inverse of ``tree_from_jax``). The JAX side
composes the recipe's generator loss from its module's own functions
(``forward``, ``pyramid_l1``, ``_mouth_crop``, the
discriminators' ``gen_loss``) with the full recipe's weights but the
sync term (its expert's backward into the prediction is held by
test_torch_train_ultralight.py's full recipe, the MuseTalk expert's
forward by test_torch_musetalk_recipe.py), and takes one
``jax.value_and_grad`` of it,
compiled once. Bars: the loss within 1e-5 relative; the whole U-Net
gradient (every leaf, concatenated) within 1e-4 relative L2; each leaf
within 5e-4 relative L2, or, for a leaf whose gradient is nearly or
exactly cancelled, within 1e-6 of the largest leaf's norm in absolute L2.
The per-leaf bar is not 1e-4 because this f32 problem does not hold a
leaf to 1e-4: changing the port's own inputs by 1e-6 relative moves its
deep conv leaves by 1.1e-4 relative L2. A GroupNorm removes most of a
per-channel shift (all of it with one channel per group), so the biases
and time projections in front of one hold small differences of large
sums: ~3e-3 of the largest leaf at the 2x2 levels, and zero in exact
arithmetic, rounding noise (~1e-9) in both packages, at one channel per
group. The L1 terms' gradients are signs, so a target pixel within
rounding of the prediction would flip between the packages; the target
frames are therefore +-1 in 4x4 blocks (0 or 1 after the pyramid's
pooling too), and the decoder's output conv is scaled by 0.1 so the
prediction stays inside (0.4, 0.6), away from both the targets and the
clamp at 0 and 1, whose gradient is a step too. The gradient reaches the
U-Net through the decode's self-attention, kernel 3's backward; the
U-Net's own 16 self-attention sites run it too. ``test_torch_musetalk_recipe.py`` holds a
whole step (the MuseTalk expert, the discriminators' updates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.models import multiscale_disc as jmd
from livetalking_tpu.models import sd_unet as jun
from livetalking_tpu.train import musetalk_train as jmt
from livetalking_tpu_torch.models import multiscale_disc as tmd
from livetalking_tpu_torch.models import sd_unet as tun
from livetalking_tpu_torch.models import sd_vae as tvae
from livetalking_tpu_torch.models.diffusion_blocks import tree_from_jax
from livetalking_tpu_torch.models.musetalk import positional_encoding_table
from livetalking_tpu_torch.train import musetalk_train as tmt
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

S, B = 128, 2
JTINY = jun.UNetConfig(block_out=(32, 64, 96, 96), heads=2)
TTINY = tun.UNetConfig(block_out=(32, 64, 96, 96), heads=2)
WEIGHTS = dict(pixel=1.0, latent=1.0, perceptual=0.01, gan=0.05, mouth_gan=0.05)


def tree_to_jax(tree):
    """The port's tree -> the JAX package's layout, numpy leaves (copies: the
    port's steps update its tensors in place): conv (O, I, kh, kw) -> HWIO,
    linear (out, in) -> (in, out)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "w" and v is not None:
                w = v.detach().float().numpy()
                out[k] = np.ascontiguousarray(w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T)
            else:
                out[k] = tree_to_jax(v)
        return out
    if isinstance(tree, (list, tuple)):
        return [tree_to_jax(v) for v in tree]
    if isinstance(tree, tmd.MultiScaleDisc):  # per scale, its layers' {"w", "b"}
        return [[tree_to_jax({"w": layer.conv.weight, "b": layer.conv.bias}) for layer in stack]
                for stack in tree.stacks]
    return None if tree is None else tree.detach().float().numpy().copy()


def paths(tree, path=""):
    """(path, leaf) pairs of a nested tree (a module: its parameters),
    ``None`` skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from paths(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from paths(v, f"{path}/{i}")
    elif isinstance(tree, torch.nn.Module):
        for k, v in tree.named_parameters():
            yield f"{path}/{k}", v
    elif tree is not None:
        yield path, tree


def rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def port_weights(seed: int = 0):
    """The port's seeded f32 U-Net, VAE (its output conv scaled by 0.1) and
    both discriminators."""
    vae = tvae.init_params(seed + 1, torch.float32)
    with torch.no_grad():
        vae["dec_conv_out"]["w"].mul_(0.1)
    return {"unet": tun.init_params(seed, TTINY, torch.float32), "vae": vae,
            "face": tmd.init_params(seed + 2), "mouth": tmd.init_params(seed + 3)}


@pytest.fixture(scope="module")
def grads():
    r = np.random.RandomState(5)
    blocks = np.sign(r.uniform(-1, 1, (B, S // 4, S // 4, 3))).astype(np.float32)
    batch = {"gt": np.ascontiguousarray(blocks.repeat(4, axis=1).repeat(4, axis=2)),
             "ref": r.uniform(-1, 1, (B, S, S, 3)).astype(np.float32),
             "audio": r.normal(0, 0.3, (B, 50, 384)).astype(np.float32)}
    tw = port_weights()
    jw = {k: tree_to_jax(v) for k, v in tw.items()}
    w = jmt.LossWeights(**WEIGHTS)
    pe = jnp.asarray(positional_encoding_table(50, JTINY.cross_dim))

    def jloss(unet, b):
        pred_lat, pred01, gt_lat = jmt.forward(unet, jw["vae"], JTINY, pe, b["gt"], b["ref"],
                                               b["audio"])
        gt01 = b["gt"] / 2.0 + 0.5
        return (w.latent * jnp.mean(jnp.abs(pred_lat - gt_lat))
                + w.pixel * jnp.mean(jnp.abs(pred01 - gt01))
                + w.perceptual * jmt.pyramid_l1(pred01, gt01)
                + w.gan * jmd.gen_loss(jw["face"], pred01)
                + w.mouth_gan * jmd.gen_loss(jw["mouth"], jmt._mouth_crop(pred01)))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jw["unet"],
                                                {k: jnp.asarray(v) for k, v in batch.items()})
    want = (float(jl), dict(paths(tree_from_jax(jax.tree.map(np.asarray, jg)))))

    _, step = tmt.make_train_step(TTINY, tmt.LossWeights(**WEIGHTS))
    state = tmt.TrainState(tw["unet"], None, tw["face"], None, tw["mouth"], None)
    leaves = [(p, t.requires_grad_(True)) for p, t in paths(tw["unet"])]
    loss, (metrics, _) = step.gen_loss_fn(tw["unet"], state, tw["vae"], None,
                                          {k: torch.from_numpy(v) for k, v in batch.items()})
    got_g = torch.autograd.grad(loss, [t for _, t in leaves])
    got = (float(loss), {p: g for (p, _), g in zip(leaves, got_g)}, metrics)
    return got, want


def test_generator_loss_within_1e5(grads):
    (gl, _, metrics), (wl, _) = grads
    assert {"gan", "mouth_gan", "perceptual"} <= set(metrics)
    assert abs(gl - wl) <= 1e-5 * abs(wl), (gl, wl)


def test_every_unet_gradient_leaf_within_1e4(grads):
    (_, gg, _), (_, wg) = grads
    assert gg.keys() == wg.keys() and len(gg) > 100
    norms = {p: float(np.linalg.norm(w.numpy())) for p, w in wg.items()}
    floor = 1e-6 * max(norms.values())
    errs = {p: float(np.linalg.norm(gg[p].numpy() - wg[p].numpy())) for p in gg}
    total = float(np.sqrt(sum(e * e for e in errs.values())
                          / sum(n * n for n in norms.values())))
    assert total <= 1e-4, total
    for p, err in errs.items():
        assert err <= max(5e-4 * norms[p], floor), (p, err, norms[p])


