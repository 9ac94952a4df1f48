"""The Ultralight and ER-NeRF training steps of the port against the JAX
package's on the CPU, in f32, from the same weights and batches: the
Ultralight full recipe (L1 + the frozen 5-frame sync expert at 160 px;
its L1 term is the L1 recipe's loss, and the L1 step runs in
test_torch_train_cli.py) on the real network (params trained in f32),
and the ER-NeRF photometric step (Adam, MSE of the composited render).

Bars: the first step's loss (every metric) within 1e-5 relative. ER-NeRF:
the second step's loss within 1e-4 and the parameters' change after 2
steps within 1e-3 relative L2 for each leaf on its own. Ultralight: Adam's
first update is lr x sign(g) wherever |g| >> eps, so an element whose
gradient lies within the two packages' rounding of it steps the other way
in one of them, and the 160 px ReLU network's f32 gradients, behind the
sync expert's ReLU tower, are ~2e-2 apart between the packages for each
leaf. There the first step's gradient (the first moment / 0.1) is held
within 5e-2 relative L2 for each leaf, beside the witness that a 1e-6
change of the input moves the port's own gradient by at least half the
packages' worst difference (2.4e-2 apart, 2.8e-2 moved, measured), and
the second step's metrics within 1e-2 relative, instead of the change.
Leaves whose reference is zero to rounding (norm at most 1e-6 of the
largest leaf's) are left out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from livetalking_tpu.models import ernerf as jne
from livetalking_tpu.models import syncnet as jsn
from livetalking_tpu.models import ultralight as jul
from livetalking_tpu.train import ultralight_train as jut
from livetalking_tpu_torch.models import ernerf as tne
from livetalking_tpu_torch.models import syncnet as tsn
from livetalking_tpu_torch.models import ultralight as tul
from livetalking_tpu_torch.train import ultralight_train as tut
from test_torch_train_recipes import (
    _assert_leaves,
    _assert_loss,
    _assert_witness,
    _first_grads,
    _flat,
    _jax_first_grads,
    _np,
    _perturbed,
)
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401


def _batch(r, B):
    return {"face": r.random((B, 160, 160, 6)).astype(np.float32),
            "audio": r.standard_normal((B, 32, 32, 16)).astype(np.float32),
            "target": r.random((B, 160, 160, 3)).astype(np.float32),
            "sync_mel": r.standard_normal((B // 5, 80, 16, 1)).astype(np.float32)}


def test_ultralight_full_recipe_step():
    r = np.random.default_rng(4)
    jp = jax.jit(lambda k: jul.init_params(k, jnp.float32))(jax.random.PRNGKey(0))
    batch = _batch(r, 5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    js = jax.jit(lambda k: jsn.init_params(k, 160))(jax.random.PRNGKey(2))
    ts = tsn.params_from_jax(_np(js))
    tx, jstep = jut.make_full_train_step(lr=1e-4, sync_wt=0.3)
    ttx, tstep = tut.make_full_train_step(lr=1e-4, sync_wt=0.3)

    def port(b):
        tp = tul.params_from_jax(_np(jp))
        return tp, ttx.init(tp), {k: torch.from_numpy(v) for k, v in b.items()}

    tp, opt, tb = port(batch)
    start = _flat(tp)
    p, s = jp, tx.init(jp)
    for i in range(2):
        p, s, jm = jstep(p, js, s, jb)
        _, _, tm = tstep(tp, ts, opt, tb)
        assert tm.keys() == jm.keys()
        for k in jm:
            _assert_loss(tm[k], jm[k], 1e-5 if i == 0 else 1e-2)
        if i == 0:
            got = _first_grads(opt)
            errs = _assert_leaves(got, _jax_first_grads(s, tul.params_from_jax), 5e-2)
    assert not all(np.array_equal(a, b) for a, b in zip(_flat(tp), start))
    tp, opt, tb = port(_perturbed(batch, "face"))
    tstep(tp, ts, opt, tb)
    _assert_witness(errs, got, _first_grads(opt))


def test_ernerf_step():
    r = np.random.default_rng(5)
    size, B = 16, 2
    jp = jax.jit(lambda k: jne.init_params(k, plane_res=32, audio_dim=64))(
        jax.random.PRNGKey(0))
    tp = tne.params_from_jax(_np(jp))
    start = _flat(tp)
    feats = r.standard_normal((B, 64)).astype(np.float32)
    bg = np.broadcast_to(r.random((B, 1, 1, 3)).astype(np.float32), (B, size, size, 3)).copy()
    target = r.random((B, size, size, 3)).astype(np.float32)
    tx, jstep = jne.make_train_step(lr=2e-3, size=size, n_samples=8)
    ttx, tstep = tne.make_train_step(lr=2e-3, size=size, n_samples=8)
    p, s = jp, tx.init(jp)
    opt = ttx.init(tp)
    for i in range(2):
        p, s, jl = jstep(p, s, *(jnp.asarray(a) for a in (feats, bg, target)))
        _, _, tl = tstep(tp, opt, *(torch.from_numpy(a) for a in (feats, bg, target)))
        _assert_loss(tl, jl, 1e-5 if i == 0 else 1e-4)
    _assert_leaves([a - b for a, b in zip(_flat(tp), start)],
                   [a - b for a, b in zip(_flat(tne.params_from_jax(_np(p))), start)], 1e-3)


def test_training_after_a_serving_step():
    """A serving step under ``inference_mode`` first (as a server that also
    trains runs them) leaves nothing cached that the training step's
    autograd cannot save: the upsampler's interpolation matrices."""
    from livetalking_tpu_torch.models.layers import _interp_matrix

    _interp_matrix.cache_clear()
    params = tul.init_params(0, torch.float32)
    g = torch.Generator().manual_seed(0)
    face, audio = torch.rand((1, 160, 160, 6), generator=g), torch.randn((1, 32, 32, 16))
    with torch.inference_mode():
        tul.apply(params, face, audio)
    tx, step = tut.make_train_step(1e-4)
    batch = {"face": face, "audio": audio, "target": torch.rand((1, 160, 160, 3), generator=g)}
    assert np.isfinite(float(step(params, tx.init(params), batch)[2]))
