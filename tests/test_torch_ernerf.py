"""ER-NeRF rendering of the PyTorch port against the JAX package's.

The field's weights come from the JAX package's ``init_params`` (as
numpy); the render runs in f32 on the CPU at 16 px and 4 samples a ray.
The bar is 1 LSB of the uint8 frames. An avatar directory whose
``ernerf.npz`` the JAX package wrote loads in the port unchanged.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.avatars import ernerf_avatar as jea
from livetalking_tpu.models import ernerf as jn
from livetalking_tpu.utils.synthetic import make_synthetic_avatar
from livetalking_tpu_torch.avatars import ernerf_avatar as tea
from livetalking_tpu_torch.models import ernerf as tn

SIZE, NS, B = 16, 4, 2


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())


@pytest.fixture(scope="module")
def field():
    jp = jn.init_params(jax.random.PRNGKey(0), audio_dim=64)
    return jp, tn.params_from_jax(jax.tree.map(np.asarray, jp))


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, 64)).astype(np.float32)
    bg = rng.random((B, SIZE, SIZE, 3)).astype(np.float32)
    return feats, bg


def test_render_matches_jax(field):
    jp, tp = field
    feats, bg = _inputs(1)
    want = np.asarray(jn.render_frame_batch(jp, jnp.asarray(feats), jnp.asarray(bg), size=SIZE,
                                            n_samples=NS))
    got = tn.render_frame_batch(tp, torch.from_numpy(feats), torch.from_numpy(bg), size=SIZE,
                                n_samples=NS)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (B, SIZE, SIZE, 3)
    assert _lsb(got, want) <= 1
    # chunks that split frames unevenly give the same frames
    split = tn.render_frame_batch(tp, torch.from_numpy(feats), torch.from_numpy(bg), size=SIZE,
                                  n_samples=NS, ray_chunk=100)
    assert _lsb(split, got) <= 1


def test_rays_and_sampling_match_jax(field):
    jp, tp = field
    for a, b in zip(jn.make_frame_rays(SIZE), tn.make_frame_rays(SIZE)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rng = np.random.default_rng(2)
    R, C = 8, 4
    plane = rng.standard_normal((R, R, C)).astype(np.float32)
    uv = rng.uniform(-1.2, 1.2, (50, 2)).astype(np.float32)  # some outside: clamped taps
    want = np.asarray(jn._bilinear_plane(jnp.asarray(plane), jnp.asarray(uv)))
    got = tn._bilinear_plane(torch.from_numpy(plane), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_zero_density_passes_background(field):
    _, tp = field
    p = dict(tp, sigma={"w": torch.zeros_like(tp["sigma"]["w"]),
                        "b": torch.full_like(tp["sigma"]["b"], -30.0)})
    feats, bg = _inputs(3)
    out = tn.render_frame_batch(p, torch.from_numpy(feats), torch.from_numpy(bg), size=SIZE,
                                n_samples=NS)
    ref = np.clip(np.rint(bg * 255.0), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_field_written_by_jax_loads(tmp_path, field):
    """``ernerf.npz`` as the JAX package saves it, in an avatar directory
    of its synthetic generator: the port loads the same field and renders
    what the JAX package renders."""
    jp, _ = field
    avatar_dir = os.path.join(str(tmp_path), "avatars", "nf")
    make_synthetic_avatar(avatar_dir, n_frames=3)
    jea.save_avatar_field(jp, avatar_dir)
    got = tea.load_avatar("nf", str(tmp_path), device="cpu")
    want = jea.load_avatar("nf", str(tmp_path))
    assert len(got["frame_list_cycle"]) == 3 and got["coord_list_cycle"] == [
        tuple(c) for c in want["coord_list_cycle"]]
    flat = tea.flatten_params(got["nerf_params"])
    assert sorted(flat) == sorted(jea.flatten_params(jp))
    for k, v in jea.flatten_params(jp).items():
        np.testing.assert_array_equal(flat[k], v)
    feats, bg = _inputs(4)
    a = jn.render_frame_batch(want["nerf_params"], jnp.asarray(feats), jnp.asarray(bg),
                              size=SIZE, n_samples=NS)
    b = tn.render_frame_batch(got["nerf_params"], torch.from_numpy(feats), torch.from_numpy(bg),
                              size=SIZE, n_samples=NS)
    assert _lsb(b, a) <= 1
