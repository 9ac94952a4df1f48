"""The port's SD-family blocks and latent U-Net (models/diffusion_blocks.py,
models/sd_unet.py) against the JAX package on the CPU, in f32.

Block parameters are drawn with numpy in the JAX package's layouts (conv
HWIO, linear (in, out)) and reach the port through ``tree_from_jax``. The
U-Net's weights come from one diffusers-layout state dict (the recomposed
``TorchUNet`` of tests/test_sd_converters.py): the JAX package converts
it, the port takes that tree through ``params_from_jax`` and, separately,
converts the same state dict itself; the two port trees must be equal.
Bars: blocks atol 1e-4 (f32 GEMM/conv summation orders), the U-Net's max
abs error / max |ref| < 2e-3 as in tests/test_sd_converters.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livetalking_tpu.models import diffusion_blocks as jdb
from livetalking_tpu.models import sd_unet as ju
from livetalking_tpu_torch.models import diffusion_blocks as tdb
from livetalking_tpu_torch.models import sd_unet as tu
from test_sd_converters import TorchUNet, _init
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

BLOCK_ATOL = 1e-4
TINY = dict(block_out=(32, 64, 96, 96), heads=2)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


class _Draw:
    """Random parameter trees in the JAX package's layouts."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def arr(self, *shape, scale=1.0):
        return (self.rng.standard_normal(shape) * scale).astype(np.float32)

    def conv(self, k, ci, co):
        return {"w": self.arr(k, k, ci, co, scale=(k * k * ci) ** -0.5), "b": self.arr(co, scale=0.1)}

    def lin(self, i, o, bias=True):
        return {"w": self.arr(i, o, scale=i ** -0.5), "b": self.arr(o, scale=0.1) if bias else None}

    def norm(self, c):
        return {"g": 1 + self.arr(c, scale=0.1), "b": self.arr(c, scale=0.1)}

    def resnet(self, ci, co, tdim=None):
        p = {"norm1": self.norm(ci), "conv1": self.conv(3, ci, co),
             "norm2": self.norm(co), "conv2": self.conv(3, co, co)}
        if tdim:
            p["time_emb_proj"] = self.lin(tdim, co)
        if ci != co:
            p["conv_shortcut"] = self.conv(1, ci, co)
        return p

    def attn(self, c, kv, bias=False):
        return {"q": self.lin(c, c, bias), "k": self.lin(kv, c, bias), "v": self.lin(kv, c, bias),
                "o": self.lin(c, c)}

    def transformer(self, c, cross):
        return {"norm": self.norm(c), "proj_in": self.conv(1, c, c), "proj_out": self.conv(1, c, c),
                "block": {"norm1": self.norm(c), "attn1": self.attn(c, c),
                          "norm2": self.norm(c), "attn2": self.attn(c, cross),
                          "norm3": self.norm(c),
                          "ff": {"proj": self.lin(c, 8 * c), "out": self.lin(4 * c, c)}}}


def _both(fn_j, fn_t, jtree, *args):
    """Run a JAX block and its port on the same numpy inputs."""
    want = np.asarray(fn_j(jax.tree.map(jnp.asarray, jtree), *(jnp.asarray(a) for a in args)))
    got = fn_t(tdb.tree_from_jax(jtree), *(torch.from_numpy(a) for a in args))
    return got.float().numpy(), want


BLOCKS = {
    "group_norm": lambda d: ((lambda p, x: jdb.group_norm(p, x)),
                             (lambda p, x: tdb.group_norm(p, x)), d.norm(64),
                             (d.arr(2, 8, 8, 64, scale=3) + 5,)),
    "resnet_temb_shortcut": lambda d: ((lambda p, x, t: jdb.resnet_block(p, x, t)),
                                       (lambda p, x, t: tdb.resnet_block(p, x, t)),
                                       d.resnet(32, 64, tdim=48), (d.arr(2, 8, 8, 32), d.arr(2, 48))),
    "resnet": lambda d: (jdb.resnet_block, tdb.resnet_block, d.resnet(64, 64),
                         (d.arr(2, 4, 4, 64),)),
    "spatial_attention": lambda d: (jdb.spatial_attention, tdb.spatial_attention,
                                    {"group_norm": d.norm(64), **d.attn(64, 64, bias=True)},
                                    (d.arr(2, 8, 8, 64),)),
    "transformer_2d": lambda d: ((lambda p, x, c: jdb.transformer_2d(p, x, c, 2)),
                                 (lambda p, x, c: tdb.transformer_2d(p, x, c, 2)),
                                 d.transformer(64, 24), (d.arr(2, 4, 8, 64), d.arr(2, 7, 24))),
    "cross_attention": lambda d: ((lambda p, x, c: jdb.attention(p, x, c, 4)),
                                  (lambda p, x, c: tdb.attention(p, x, c, 4)),
                                  d.attn(32, 24), (d.arr(2, 16, 32), d.arr(2, 5, 24))),
    "layer_norm": lambda d: (jdb.layer_norm, tdb.layer_norm, d.norm(48), (d.arr(3, 5, 48),)),
    "geglu_ff": lambda d: (jdb.geglu_ff, tdb.geglu_ff,
                           {"proj": d.lin(32, 256), "out": d.lin(128, 32)}, (d.arr(2, 6, 32),)),
    "conv_stride2": lambda d: ((lambda p, x: jdb.conv(p, x, stride=2)),
                               (lambda p, x: tdb.conv(p, x, stride=2)), d.conv(3, 16, 24),
                               (d.arr(2, 9, 9, 16),)),
    "conv_asym": lambda d: ((lambda p, x: jdb.conv_asym(p, x, 2, ((0, 1), (0, 1)))),
                            (lambda p, x: tdb.conv_asym(p, x, 2, ((0, 1), (0, 1)))),
                            d.conv(3, 16, 16), (d.arr(2, 8, 8, 16),)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    fn_j, fn_t, tree, args = BLOCKS[name](_Draw(sorted(BLOCKS).index(name)))
    got, want = _both(fn_j, fn_t, tree, *args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BLOCK_ATOL)


def test_elementwise_helpers_match_jax(rng):
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    t = np.asarray([0.0, 3.0, 981.0], np.float32)
    np.testing.assert_allclose(tdb.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(jdb.silu(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(tdb.upsample_nearest2x(torch.from_numpy(x)).numpy(),
                                  np.asarray(jdb.upsample_nearest2x(jnp.asarray(x))))
    np.testing.assert_allclose(tdb.timestep_embedding(torch.from_numpy(t), 320).numpy(),
                               np.asarray(jdb.timestep_embedding(jnp.asarray(t), 320)),
                               atol=2e-4)  # sin/cos of arguments up to 981 in f32


def test_group_norm_keeps_the_clamped_channel_moment_arithmetic():
    """A constant channel group (mean >> std): E[x^2] - E[x]^2 cancels to
    zero or below and is clamped, as in the reference, so the output is the
    shift exactly."""
    x = torch.full((1, 2, 2, 32), 300.0)
    p = {"g": torch.ones(32), "b": torch.arange(32.0)}
    np.testing.assert_allclose(tdb.group_norm(p, x).numpy()[0, 0, 0], np.arange(32.0),
                               atol=1e-2)


@pytest.fixture(scope="module")
def unet_pair():
    torch_unet = _init(TorchUNet(ju.UNetConfig(**TINY)), seed=0).eval()
    sd = dict(torch_unet.state_dict())
    jp = ju.convert_torch_state_dict(sd, ju.UNetConfig(**TINY), dtype=jnp.float32)
    return sd, jp, tu.params_from_jax(_np_tree(jp))


def test_unet_matches_jax(unet_pair, rng):
    _, jp, tp = unet_pair
    x = rng.standard_normal((2, 32, 32, 8)).astype(np.float32)
    t = np.asarray([0.0, 7.0], np.float32)
    ctx = rng.standard_normal((2, 50, 384)).astype(np.float32)
    want = np.asarray(ju.apply(jp, ju.UNetConfig(**TINY), *(jnp.asarray(a) for a in (x, t, ctx))))
    got = tu.apply(tp, tu.UNetConfig(**TINY), *(torch.from_numpy(a) for a in (x, t, ctx)))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 32, 4)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 2e-3


def test_unet_converter_matches_the_jax_converter(unet_pair):
    sd, _, from_jax = unet_pair
    converted = tu.convert_torch_state_dict(sd, tu.UNetConfig(**TINY), dtype=torch.float32)

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{path}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{path}/{i}")
        else:
            yield path, tree

    a, b = dict(leaves(converted)), dict(leaves(from_jax))
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k] is None) == (b[k] is None), k
        if a[k] is not None:
            assert torch.equal(a[k], b[k]), k
    assert tu.count_params(converted) == sum(v.numel() for v in sd.values())


def test_unet_channel_plans_match_jax():
    for kw in (TINY, {}):
        jc, tc = ju.UNetConfig(**kw), tu.UNetConfig(**kw)
        assert tu._down_plan(tc) == ju._down_plan(jc)
        assert tu._up_plan(tc) == ju._up_plan(jc)
        assert tu._skip_channels(tc) == ju._skip_channels(jc)


def test_random_init_has_the_reference_tree():
    """``init_params`` (a seeded torch.Generator) builds the same tree, leaf
    shapes included, as the JAX package's init at the tiny widths."""
    tp = tu.init_params(2, tu.UNetConfig(**TINY), dtype=torch.float32)
    jshapes = jax.eval_shape(lambda: ju.init_params(jax.random.PRNGKey(2), ju.UNetConfig(**TINY),
                                                    jnp.float32))
    want = tdb.tree_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), jshapes))
    got_shapes = jax.tree.map(lambda t: tuple(t.shape), tp)
    want_shapes = jax.tree.map(lambda t: tuple(t.shape), want)
    assert got_shapes == want_shapes
