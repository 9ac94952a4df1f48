"""The port's MuseTalk models against the JAX package on the CPU, in f32:
the full-width VAE (sd-vae-ft-mse channels), its converter, the composite
step (``make_infer_fn``), the avatar latent encode, and the whole slice
from PCM to pasted full frames.

Weights come from diffusers-layout state dicts (the recomposed
``TorchVAE``/``TorchUNet`` of tests/test_sd_converters.py): the JAX package
converts them and the port takes that tree through ``params_from_jax``; the
Whisper weights come from the JAX package's seeded init. Inputs are numpy
arrays from a seed. Bars: VAE atol 2e-3 as in tests/test_sd_converters.py;
the uint8 step at most 1 LSB apart; the whole slice at most 2 LSB (the
Whisper features already differ by f32 summation order before the step).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livetalking_tpu.audio_features import whisper_features as jwf
from livetalking_tpu.models import musetalk as jm
from livetalking_tpu.models import sd_unet as ju
from livetalking_tpu.models import sd_vae as jv
from livetalking_tpu.models import whisper_encoder as jwe
from livetalking_tpu.ops import pallas_blend as jpb
from livetalking_tpu_torch.audio_features import whisper_features as twf
from livetalking_tpu_torch.avatars import musetalk_avatar as plugin
from livetalking_tpu_torch.models import musetalk as tm
from livetalking_tpu_torch.models import sd_unet as tu
from livetalking_tpu_torch.models import sd_vae as tv
from livetalking_tpu_torch.models import whisper_encoder as twe
from livetalking_tpu_torch.ops import blend as tb
from livetalking_tpu_torch.utils import synthetic
from test_sd_converters import TorchUNet, TorchVAE, _init
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

VAE_ATOL = 2e-3
TINY = dict(block_out=(32, 64, 96, 96), heads=2)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_trees_equal(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k] is None) == (b[k] is None), k
        if a[k] is not None:
            assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def vae():
    """The full sd-vae-ft-mse widths: (JAX tree, port tree, state dict)."""
    sd = dict(_init(TorchVAE(ch=tv.BLOCK_CH), seed=2).state_dict())
    jp = jv.convert_torch_state_dict(sd, dtype=jnp.float32)
    return jp, tv.params_from_jax(_np_tree(jp)), sd


@pytest.fixture(scope="module")
def unet():
    sd = dict(_init(TorchUNet(ju.UNetConfig(**TINY)), seed=0).state_dict())
    jp = ju.convert_torch_state_dict(sd, ju.UNetConfig(**TINY), dtype=jnp.float32)
    return jp, tu.params_from_jax(_np_tree(jp))


@pytest.fixture(scope="module")
def jstep():
    """The JAX package's B=2 step, compiled once for the two tests that run
    it on (3, 32, 32, 8) latent cycles."""
    return jm.make_infer_fn(ju.UNetConfig(**TINY), 2, dtype=jnp.float32)


def test_vae_encode_and_decode_match_jax(vae, rng):
    jp, tp, _ = vae
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32).clip(-1, 1)
    np.testing.assert_allclose(tv.encode(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(jv.encode(jp, jnp.asarray(x))), atol=VAE_ATOL)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32) * tv.SCALING_FACTOR
    got = tv.decode(tp, torch.from_numpy(z), dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jv.decode(jp, jnp.asarray(z),
                                                                 dtype=jnp.float32)),
                               atol=VAE_ATOL)


def test_vae_converter_matches_the_jax_converter(vae):
    """One reference-layout state dict with the legacy mid-attention names
    (query/key/value/proj_attn) through both converters."""
    _, _, sd = vae
    ren = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    legacy = {}
    for k, v in sd.items():
        for new, old in ren.items():
            if f".attentions.0.{new}." in k:
                k = k.replace(f".{new}.", f".{old}.")
                break
        legacy[k] = v
    assert legacy.keys() != sd.keys()
    from_jax = tv.params_from_jax(_np_tree(jv.convert_torch_state_dict(legacy, dtype=jnp.float32)))
    _assert_trees_equal(tv.convert_torch_state_dict(legacy, dtype=torch.float32), from_jax)


def test_positional_encoding_table_matches_jax():
    np.testing.assert_array_equal(tm.positional_encoding_table(50, 384),
                                  jm.positional_encoding_table(50, 384))


def test_step_f32_matches_jax(vae, unet, rng, jstep):
    """``make_infer_fn`` at B=2, tiny U-Net, full VAE: gather, PE, U-Net at
    t=0, decode, uint8 BGR."""
    (jvp, tvp, _), (jup, tup) = vae, unet
    lat = rng.standard_normal((3, 32, 32, 8)).astype(np.float32)
    wh = rng.standard_normal((2, 50, 384)).astype(np.float32)
    idxs = np.asarray([2, 0], np.int32)
    want = np.asarray(jstep(jup, jvp, jnp.asarray(lat), jnp.asarray(idxs), jnp.asarray(wh)))
    got = tm.make_infer_fn(tu.UNetConfig(**TINY), 2, dtype=torch.float32)(
        tup, tvp, torch.from_numpy(lat), torch.from_numpy(idxs), torch.from_numpy(wh))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 256, 256, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    assert 0.1 < float(((want > 0) & (want < 255)).mean())  # not a saturated image


@pytest.fixture(scope="module")
def slice_avatar(vae):
    """A two-frame synthetic avatar encoded by the port's VAE (once: four
    256 px encodes at full width)."""
    a = synthetic.musetalk_avatar_arrays(n_frames=2, seed=5)
    return a, plugin.avatar_from_arrays("lat", a["frames"], a["faces"], a["coords"],
                                        a["mask_coords"], a["masks"], vae[1], device="cpu")


def test_avatar_latents_match_jax(vae, slice_avatar):
    """``avatar_from_arrays`` encodes the faces with the port's VAE as the
    JAX package's ``encode_avatar_latents`` does."""
    jp, tp, _ = vae
    a, avatar = slice_avatar
    want = jm.encode_avatar_latents(jp, a["faces"])
    assert avatar["latent_cycle_host"].shape == want.shape == (2, 32, 32, 8)
    np.testing.assert_allclose(avatar["latent_cycle_host"], want, atol=VAE_ATOL)
    assert torch.equal(avatar["latent_cycle_device"],
                       torch.from_numpy(avatar["latent_cycle_host"]))


def test_whole_slice_matches_jax(vae, unet, rng, jstep, slice_avatar):
    """PCM -> Whisper features (30 s window) -> step at B=2 -> masked
    paste-back onto the avatar's full frames, against the JAX chain."""
    (jvp, tvp, _), (jup, tup) = vae, unet
    jwp = jwe.init_params(jax.random.PRNGKey(0), jwe.TINY, jnp.float32)
    twp = twe.params_from_jax(_np_tree(jwp))
    B, l, r = 2, 10, 10
    a, avatar = slice_avatar
    # three rows, the shape the shared JAX step was compiled for
    lat = np.concatenate([avatar["latent_cycle_host"], avatar["latent_cycle_host"][:1]])
    frames = np.stack(a["frames"])
    Ho, Wo = tb.bucket_shape([(ys, ye, xs, xe) for (xs, ys, xe, ye) in a["mask_coords"]])
    planes = tb.prepare_masked_paste_data(a["coords"], a["mask_coords"], a["masks"], Ho, Wo,
                                          480, 640)
    tf, n = twf.make_batched_encode_factory(twp, twe.TINY, B, l, r, device="cpu")
    jf, _ = jwf.make_batched_encode_factory(jwp, jwe.TINY, B, l, r)
    t = np.arange(n) / 16000
    pcm = (0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
           + 0.02 * rng.standard_normal(n)).astype(np.float32)[None]
    idxs = np.asarray([1, 0], np.int32)

    jfeat = jf(1)(pcm)[0]
    jface = jstep(jup, jvp, jnp.asarray(lat), jnp.asarray(idxs), jfeat)
    want = np.asarray(jpb.make_masked_paste_fn(256, Ho, Wo, 480, 640, use_pallas=False)(
        jface, jnp.asarray(frames), jnp.asarray(idxs), *(jnp.asarray(p) for p in planes)))

    tfeat = tf(1)(pcm)[0]
    tface = tm.make_infer_fn(tu.UNetConfig(**TINY), B, dtype=torch.float32)(
        tup, tvp, torch.from_numpy(lat), torch.from_numpy(idxs), tfeat)
    got = tb.make_masked_paste_fn(256, Ho, Wo, 480, 640)(
        tface, torch.from_numpy(frames), torch.from_numpy(idxs),
        *(torch.from_numpy(p) for p in planes)).numpy()

    assert got.shape == want.shape == (B, 480, 640, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
    x1, y1, x2, y2 = a["coords"][0]
    assert not np.array_equal(got[0, y1:y2, x1:x2], frames[1, y1:y2, x1:x2])  # pasted
