"""The Wav2Lip and SyncNet training steps of the port against the JAX
package's on the CPU, in f32, from the same weights and batches: the
Wav2Lip L1 step on the full network (one 256 px face), the full GAN
recipe with the generator injected as a tiny conv net at 64 px (as the
JAX package's own test injects it; the real generator is covered by the
L1 step), and the SyncNet step.

Bars: the first step's loss (every metric of the GAN step) within 1e-5
relative and the second's within 1e-4 (it follows updates that may
differ, below); the parameters' change after 2 steps within 1e-3
relative L2 for each leaf on its own. Leaves whose reference is zero to
rounding (norm at most 1e-6 of the largest leaf's) are left out. Adam's
first update is lr x sign(g) wherever |g| >> eps, so an element whose
gradient lies within the two packages' rounding of it steps the other way
in one of them. On the full 256 px Wav2Lip, whose ReLUs leave its f32
gradient ~3e-3 apart between the packages, that moves the change by 1e-1,
so there both steps' losses (within 1e-5) and each leaf of the first
step's gradient (the first moment / 0.1, within 1e-2 relative L2) are
held instead, beside a witness: a 1e-6 change of the input moves the
port's own gradient by at least half the packages' worst difference. The
tiny injected generator's first gradient is held within 1e-4 for each
leaf, and its change, where the two steps' gradients partly cancel in a
few elements, within 5e-3 for each leaf. The quality discriminator's
first gradient is held within 5e-3 for each leaf, beside the same
witness (its leaky ReLUs move its first layers' gradient by ~1.5e-3
under a 1e-6 change of the target), and its change within 1e-2 over all
its leaves together (its first layer's own change is ~3e-2 apart, from
the sign steps above).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu.models import syncnet as jsn
from livetalking_tpu.models import wav2lip as jw2l
from livetalking_tpu.models import wav2lip_disc as jwd
from livetalking_tpu.train import syncnet_train as jst
from livetalking_tpu.train import wav2lip_train as jwt
from livetalking_tpu_torch.models import syncnet as tsn
from livetalking_tpu_torch.models import wav2lip as tw2l
from livetalking_tpu_torch.models import wav2lip_disc as twd
from livetalking_tpu_torch.train import syncnet_train as tst
from livetalking_tpu_torch.train import wav2lip_train as twt
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

S, T = 64, 5


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat_jax(tree):
    return np.concatenate([np.ravel(a) for a in jax.tree.leaves(tree)])


def _delta_rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _assert_loss(got, want, rtol=1e-5):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (float(got), float(want))


def _flat(tree):
    """The leaves of a tree, or a module's parameters, as numpy arrays."""
    from livetalking_tpu_torch.utils.tree import tree_leaves

    leaves = tree.parameters() if isinstance(tree, torch.nn.Module) else tree_leaves(tree)
    return [t.detach().numpy().copy() for t in leaves]


def _assert_leaves(got, want, bar: float) -> dict:
    """Each leaf's relative L2 within ``bar``, leaves whose reference is zero
    to rounding (norm <= 1e-6 of the largest leaf's) left out; -> {index: error}."""
    top = max(np.linalg.norm(w) for w in want)
    errs = {i: _delta_rel(g, w) for i, (g, w) in enumerate(zip(got, want, strict=True))
            if np.linalg.norm(w) > 1e-6 * top}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= bar, (worst, got[worst].shape, errs[worst], bar)
    return errs


def _first_grads(opt) -> list:
    """The port's first gradients: Adam's first moments after one step / 0.1."""
    return [(opt.opt.state[q]["exp_avg"] / 0.1).numpy() for q in opt.params]


def _jax_first_grads(opt_state, to_port) -> list:
    """The JAX package's first gradients in the port's leaf order."""
    mu = next(x.mu for x in opt_state if hasattr(x, "mu"))
    return _flat(to_port(_np(jax.tree.map(lambda m: m / 0.1, mu))))


def _assert_witness(errs: dict, grads: list, perturbed: list) -> None:
    """The packages' gradients differ by at most twice what a 1e-6 change of
    the input does to the port's own: the bar sits at the function's
    conditioning, not above a fault."""
    moved = max(_delta_rel(p, g) for g, p in zip(grads, perturbed, strict=True))
    assert max(errs.values()) <= 2 * moved, (max(errs.values()), moved)


def _tensors(tree: dict) -> dict:
    return {k: torch.tensor(v) for k, v in tree.items()}


def _perturbed(batch: dict, key: str, seed: int = 9) -> dict:
    r = np.random.default_rng(seed)
    x = batch[key]
    return {**batch, key: (x + 1e-6 * r.standard_normal(x.shape)).astype(np.float32)}


def test_wav2lip_l1_step_on_the_full_network():
    r = np.random.default_rng(0)
    jp = jax.jit(lambda k: jw2l.init_params(k, jnp.float32))(jax.random.PRNGKey(0))
    batch = {"mel": r.standard_normal((1, 80, 16, 1)).astype(np.float32),
             "face": r.random((1, 256, 256, 6)).astype(np.float32),
             "target": r.random((1, 256, 256, 3)).astype(np.float32)}
    tx, jstep = jwt.make_train_step(1e-4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p, s = jp, tx.init(jp)
    ttx, tstep = twt.make_train_step(1e-4)

    def port(b):
        model = tw2l.params_from_jax(_np(jp)).train()
        return model, ttx.init(model), {k: torch.from_numpy(v) for k, v in b.items()}

    model, opt, tb = port(batch)
    for i in range(2):
        p, s, jl = jstep(p, s, jb)
        _, _, tl = tstep(model, opt, tb)
        _assert_loss(tl, jl)
        if i == 0:
            got = _first_grads(opt)
            errs = _assert_leaves(got, _jax_first_grads(s, tw2l.params_from_jax), 1e-2)
    model, opt, tb = port(_perturbed(batch, "face"))
    tstep(model, opt, tb)
    _assert_witness(errs, got, _first_grads(opt))


def _tiny_gen():
    r = np.random.default_rng(1)
    return {"w1": (0.1 * r.standard_normal((3, 3, 6, 8))).astype(np.float32),
            "w2": (0.1 * r.standard_normal((3, 3, 8, 3))).astype(np.float32)}


def _jax_gen(params, mel, face):
    x = jax.lax.conv_general_dilated(face, params["w1"], (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    x = jax.nn.relu(x + jnp.mean(mel))
    x = jax.lax.conv_general_dilated(x, params["w2"], (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return jax.nn.sigmoid(x)


def _torch_gen(params, mel, face):
    def conv(x, w):  # HWIO weights, NHWC activations
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(
            0, 2, 3, 1)
    x = torch.relu(conv(face, params["w1"]) + mel.mean())
    return torch.sigmoid(conv(x, params["w2"]))


def test_wav2lip_gan_recipe_with_an_injected_generator():
    r = np.random.default_rng(2)
    gen = _tiny_gen()
    jd = jax.jit(lambda k: jwd.init_params(k, img_size=S))(jax.random.PRNGKey(1))
    js = jax.jit(lambda k: jsn.init_params(k, img_size=S))(jax.random.PRNGKey(2))
    batch = {"mel": r.standard_normal((T, 80, 16, 1)).astype(np.float32),
             "face": r.random((T, S, S, 6)).astype(np.float32),
             "target": r.random((T, S, S, 3)).astype(np.float32),
             "sync_mel": r.standard_normal((1, 80, 16, 1)).astype(np.float32)}
    tx_g, tx_d, jstep = jwt.make_full_train_step(gen_lr=3e-4, disc_lr=1e-4, T=T,
                                                 gen_apply=_jax_gen)
    gp, dp = {k: jnp.asarray(v) for k, v in gen.items()}, jd
    go, do = tx_g.init(gp), tx_d.init(dp)
    tgen = {k: torch.from_numpy(v.copy()) for k, v in gen.items()}
    tdisc, tsync = twd.params_from_jax(_np(jd)), tsn.params_from_jax(_np(js))
    ttx_g, ttx_d, tstep = twt.make_full_train_step(gen_lr=3e-4, disc_lr=1e-4, T=T,
                                                   gen_apply=_torch_gen)
    tgo, tdo = ttx_g.init(tgen), ttx_d.init(tdisc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(2):
        gp, dp, go, do, jm = jstep(gp, dp, js, go, do, jb)
        _, _, _, _, tm = tstep(tgen, tdisc, tsync, tgo, tdo, tb)
        assert tm.keys() == jm.keys()
        for k in jm:
            _assert_loss(tm[k], jm[k], 1e-5 if i == 0 else 1e-4)
        if i == 0:
            _assert_leaves(_first_grads(tgo), _jax_first_grads(go, _tensors), 1e-4)
            d_got = _first_grads(tdo)
            d_errs = _assert_leaves(d_got, _jax_first_grads(do, twd.params_from_jax), 5e-3)
    _assert_leaves([tgen[k].detach().numpy() - gen[k] for k in gen],
                   [np.asarray(gp[k]) - gen[k] for k in gen], 5e-3)
    d0 = np.concatenate([a.ravel() for a in _flat(twd.params_from_jax(_np(jd)))])
    assert _delta_rel(np.concatenate([a.ravel() for a in _flat(tdisc)]) - d0,
                      np.concatenate([a.ravel() for a in _flat(twd.params_from_jax(_np(dp)))])
                      - d0) <= 1e-2
    # the witness of the discriminator's bar: the same first step on a
    # target moved by 1e-6
    tgen = {k: torch.from_numpy(v.copy()) for k, v in gen.items()}
    tdisc = twd.params_from_jax(_np(jd))
    tdo = ttx_d.init(tdisc)
    tstep(tgen, tdisc, tsync, ttx_g.init(tgen), tdo,
          {k: torch.from_numpy(v) for k, v in _perturbed(batch, "target").items()})
    _assert_witness(d_errs, d_got, _first_grads(tdo))


def test_syncnet_step():
    r = np.random.default_rng(3)
    jp = jax.jit(lambda k: jsn.init_params(k, img_size=S))(jax.random.PRNGKey(3))
    tp = tsn.params_from_jax(_np(jp))
    faces = r.random((4, S // 2, S, 15)).astype(np.float32)
    mels = r.standard_normal((4, 80, 16, 1)).astype(np.float32)
    labels = np.array([1, 0, 1, 0], np.float32)
    tx, jstep = jst.make_train_step(1e-4)
    p, s = jp, tx.init(jp)
    ttx, tstep = tst.make_train_step(1e-4)
    opt = ttx.init(tp)
    start = _flat(tp)
    for i in range(2):
        p, s, jl = jstep(p, s, jnp.asarray(faces), jnp.asarray(mels), jnp.asarray(labels))
        _, _, tl = tstep(tp, opt, *(torch.from_numpy(a) for a in (faces, mels, labels)))
        _assert_loss(tl, jl, 1e-5 if i == 0 else 1e-4)
    _assert_leaves([a - b for a, b in zip(_flat(tp), start)],
                   [a - b for a, b in zip(_flat(tsn.params_from_jax(_np(p))), start)], 1e-3)
