"""The Ultralight U-Net of the PyTorch port against the JAX package's.

Weights are random state dicts in the reference checkpoint's layout (the
``TorchUltralight`` oracle of tests/test_ultralight.py, BatchNorm running
stats randomized so folding is exercised); each package converts them with
its own ``convert_torch_state_dict``. Everything runs in f32 on the CPU.
Bars are the JAX package's own (tests/test_ultralight.py): atol 5e-4 for
the forward pass, 1 LSB for the uint8 steps, per avatar, grouped and
composed with the paste-back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from livetalking_tpu.avatars import ultralight_avatar as jua
from livetalking_tpu.models import ultralight as jul
from livetalking_tpu_torch.avatars import ultralight_avatar as tua
from livetalking_tpu_torch.models import ultralight as tul
from livetalking_tpu_torch.utils import synthetic
from test_ultralight import TorchUltralight

FWD_ATOL = 5e-4
B = 2


def _state_dict(seed: int) -> dict:
    torch.manual_seed(seed)
    m = TorchUltralight()
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.3)
                mod.running_var.uniform_(0.5, 2.0)
                mod.weight.uniform_(0.5, 1.5)
                mod.bias.normal_(0, 0.2)
    return m.eval().state_dict()


@pytest.fixture(scope="module")
def weights():
    """Two avatars' weights: (JAX tree, port tree) per avatar."""
    out = []
    for seed in (3, 4):
        sd = _state_dict(seed)
        out.append((jul.convert_torch_state_dict(sd, dtype=jnp.float32),
                    tul.convert_torch_state_dict(sd, dtype=torch.float32)))
    return out


def test_converter_matches_jax_and_counts(weights):
    jp, tp = weights[0]
    want = tul.params_from_jax(jax.tree.map(np.asarray, jp))
    assert jax.tree.structure(want) == jax.tree.structure(tp)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(tp)):
        assert a.shape == b.shape and torch.equal(a, b)
    n = tul.count_params(tp)
    assert n == jul.count_params(jp) == tul.count_params(tul.init_params(0, torch.float32))
    assert 1e6 < n < 20e6


def test_forward_matches_jax(weights):
    jp, tp = weights[0]
    rng = np.random.default_rng(4)
    face = rng.random((B, 160, 160, 6)).astype(np.float32)
    audio = (rng.standard_normal((B, 32, 32, 16)) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(jul.apply)(jp, jnp.asarray(face), jnp.asarray(audio)))
    got = tul.apply(tp, torch.from_numpy(face), torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (B, 160, 160, 3)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


def test_upsample_matches_jax():
    """The align-corners upsampler alone: in bf16 the same bytes (its two
    roundings), in f32 within an ulp (sum order)."""
    from livetalking_tpu.models.layers import upsample2x_align_corners as jup
    from livetalking_tpu_torch.models.layers import upsample2x_align_corners as tup

    x = np.random.default_rng(0).standard_normal((2, 10, 20, 8)).astype(np.float32)
    for jd, td in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jup(jnp.asarray(x, jd)).astype(jnp.float32))
        got = tup(torch.from_numpy(x).to(td).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert got.dtype == td and got.shape == (2, 20, 40, 8)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=0 if td == torch.bfloat16 else 1e-6, rtol=0)


def _inputs(seed: int, n: int, frames: int = 3):
    rng = np.random.default_rng(seed)
    cycle = rng.integers(0, 256, (n * frames, 168, 168, 3), dtype=np.uint8)
    idxs = np.concatenate([s * frames + (np.arange(B) * 2) % frames
                           for s in range(n)]).astype(np.int32)
    audio = (rng.standard_normal((n * B, 16, 32, 32)) * 0.5).astype(np.float32)
    return cycle, idxs, audio


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


def test_step_matches_jax(weights):
    jp, tp = weights[0]
    cycle, idxs, audio = _inputs(5, 1)
    want = np.asarray(jul.make_infer_fn(B, jnp.float32)(jp, jnp.asarray(cycle),
                                                        jnp.asarray(idxs), jnp.asarray(audio)))
    got = tul.make_infer_fn(B, torch.float32)(tp, torch.from_numpy(cycle),
                                              torch.from_numpy(idxs), torch.from_numpy(audio))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (B, 160, 160, 3)
    assert _lsb(got, want) <= 1


def test_grouped_step_matches_per_avatar_steps(weights):
    """Two avatars' distinct weights, stacked, selected by slot (in the
    order 1, 0, so the slots are not the identity) and run as one grouped
    forward: each session block within 1 LSB of that avatar's own step
    (the composed step below holds the grouped step to the JAX package's)."""
    cycle, idxs, audio = _inputs(6, 2)
    stacked = tul.append_stacked(tul.stack_params([weights[1][1]]), weights[0][1])
    got = tul.make_grouped_infer_fn(2, B, torch.float32)(
        stacked, torch.from_numpy(cycle), torch.from_numpy(idxs), torch.tensor([1, 0]),
        torch.from_numpy(audio)).numpy()
    for s in range(2):
        sl = slice(s * B, (s + 1) * B)
        solo = tul.make_infer_fn(B, torch.float32)(weights[s][1], torch.from_numpy(cycle),
                                                   torch.from_numpy(idxs[sl]),
                                                   torch.from_numpy(audio[sl]))
        assert _lsb(got[sl], solo) <= 1


def test_superbatch_step_with_paste_matches_jax(weights):
    """The composed step of the shared scheduler (grouped U-Net, the
    prediction written into each gathered 168 px crop, the paste into full
    frames; the plain paste on CPU tensors) against the JAX package's step
    of ``get_shared_scheduler``, two avatars registered in each."""
    avatars = [synthetic.ultralight_avatar_arrays(n_frames=3, seed=10 + k) for k in range(2)]
    x1, y1, x2, y2 = avatars[0]["coords"][0]
    boxes = np.asarray([(y1, y2, x1, x2)] * 3, np.int32)
    spec = {"H": 480, "W": 640, "Ho": 240, "Wo": 256}
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((2 * B, 16, 32, 32)) * 0.5).astype(np.float32)
    idxs = np.asarray([0, 2, 4, 3], np.int32)
    outs = []
    for pkg, params in ((jua, [w[0] for w in weights]), (tua, [w[1] for w in weights])):
        pkg.reset_shared_scheduler()
        try:
            if pkg is jua:
                _, sched = pkg.get_shared_scheduler({"dtype": jnp.float32}, B, buckets=(2,),
                                                    paste_spec=spec)
            else:
                _, sched = pkg.get_shared_scheduler({"dtype": torch.float32, "device": "cpu"},
                                                    B, buckets=(2,), paste_spec=spec)
            for k, a in enumerate(avatars):
                pkg.register_session_avatar(
                    {"avatar_id": f"ul{k}", "crop_cycle_host": a["crops"],
                     "unet_params": params[k]},
                    {"pb_frames": np.stack(a["frames"]), "pb_boxes": boxes})
            store = pkg._shared["store"]
            if pkg is jua:
                out = sched._steps[2](None, store.buffer, jnp.asarray(idxs), jnp.asarray(audio))
            else:
                out = sched._steps[2](None, store.buffer, torch.from_numpy(idxs),
                                      torch.from_numpy(audio))
            outs.append(np.asarray(out))
        finally:
            pkg.reset_shared_scheduler()
    want, got = outs
    assert got.shape == want.shape == (2 * B, 480, 640, 3) and got.dtype == np.uint8
    assert _lsb(got, want) <= 1
    frames = np.concatenate([np.stack(a["frames"]) for a in avatars])[idxs]
    outside = np.ones((480, 640), bool)
    outside[y1:y2, x1:x2] = False
    assert np.array_equal(got[:, outside], frames[:, outside])


def test_avatar_directory_and_checkpoint_load(tmp_path):
    """A directory the port's writer makes loads back (168 px crops,
    (x1, y1, x2, y2) boxes); its ``ultralight.pth``, a reference-layout
    state dict, goes through the converter, and without it the weights are
    random from seed 1. A HuBERT directory without ``pytorch_model.bin``
    raises, naming the file."""
    from livetalking_tpu_torch.config import default_opt

    avatar_dir = tmp_path / "avatars" / "ul"
    synthetic.make_synthetic_ultralight_avatar(str(avatar_dir), n_frames=3, seed=2)
    want = synthetic.ultralight_avatar_arrays(n_frames=3, seed=2)
    got = tua.load_avatar("ul", str(tmp_path), device="cpu")
    np.testing.assert_array_equal(got["crop_cycle_host"], want["crops"])
    np.testing.assert_array_equal(np.stack(got["frame_list_cycle"]), np.stack(want["frames"]))
    assert got["coord_list_cycle"] == want["coords"]
    seed1 = tul.init_params(1, torch.float32)
    for a, b in zip(jax.tree.leaves(got["unet_params"]), jax.tree.leaves(seed1)):
        assert torch.equal(a, b)

    sd = _state_dict(5)
    torch.save({"state_dict": sd}, str(avatar_dir / "ultralight.pth"))
    got = tua.load_avatar("ul", str(tmp_path), device="cpu")
    for a, b in zip(jax.tree.leaves(got["unet_params"]),
                    jax.tree.leaves(tul.convert_torch_state_dict(sd, torch.float32))):
        assert torch.equal(a, b)

    (tmp_path / "models" / "hubert-large-ls960-ft").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        tua.load_model(default_opt(device="cpu", models_dir=str(tmp_path / "models")))
