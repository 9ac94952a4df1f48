"""The port's W8A8 int8 MuseTalk path against the JAX package on the CPU:
quantize/calibrate trees, the int8 blocks, ``apply_int8``, ``decode_int8``
through both routes, and the int8 step from PCM to pasted frames.

Weights come from diffusers-layout state dicts (the recomposed
``TorchUNet``/``TorchVAE`` of tests/test_sd_converters.py) in f32: a two-level
U-Net (32, 64), one resnet per block, which keeps every kind of int8 site
(conv_in's 8 channels, 3x3 convs at stride 1 and 2, 1x1 shortcuts, the
upsampler, the int8 transformer) at a third of the four-level test
config's cost on the JAX side, and a narrow VAE (32, 32, 64, 64). The JAX package
quantizes and calibrates its tree; ``quantized_from_jax`` carries that tree
over, and the port's own quantize/calibrate must give the same tree (int8
weights bit-equal, scales rtol 1e-5: the calibration walks sum in another
order). Inputs are numpy arrays from seeds. The JAX decoder runs with
``LT_DILATED_UP=0``, the upsampler route the port takes (ROADMAP section 3).

Bars: an int8 site on equal inputs bit-equal up to f32 rounding (rtol
1e-5); the U-Net's latents max error <= 1e-2 max|ref|; the fused decode
chain PSNR >= 40 dB; other images by ``_assert_int8_quality``. Outside
the fused chain both sides quantize bf16 activations whose f32 sums ran
in another order, so a value next to a .5 step can round to the
neighbouring int8 level on one side only. In a whole unfused decode or
step such flips carry on through the later layers: those images cannot
reach 40 dB against each other (measured 23.6 to 30.2 dB), so they are held
to the reference's own distance from full precision instead.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livetalking_tpu.audio_features import whisper_features as jwf
from livetalking_tpu.models import diffusion_blocks as jdb
from livetalking_tpu.models import musetalk as jm
from livetalking_tpu.models import sd_unet as ju
from livetalking_tpu.models import sd_vae as jv
from livetalking_tpu.models import whisper_encoder as jwe
from livetalking_tpu.ops import pallas_blend as jpb
from livetalking_tpu_torch.audio_features import whisper_features as twf
from livetalking_tpu_torch.avatars import musetalk_avatar as plugin
from livetalking_tpu_torch.models import diffusion_blocks as tdb
from livetalking_tpu_torch.models import musetalk as tm
from livetalking_tpu_torch.models import sd_unet as tu
from livetalking_tpu_torch.models import sd_vae as tv
from livetalking_tpu_torch.models import whisper_encoder as twe
from livetalking_tpu_torch.ops import blend as tb
from livetalking_tpu_torch.utils import synthetic
from test_sd_converters import TorchUNet, TorchVAE, _init
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

TINY = dict(block_out=(32, 64), layers_per_block=1, heads=2)
VAE_CH = (32, 32, 64, 64)
PSNR_DB = 40.0
LATENT_REL = 1e-2


# the JAX side runs jitted: one compile per function instead of one per op
_quantize_unet = jax.jit(ju.quantize_unet, static_argnums=1)
_quantize_decoder = jax.jit(jv.quantize_decoder, static_argnums=(1, 2))
_apply_int8 = jax.jit(ju.apply_int8, static_argnums=1)
_decode_int8 = jax.jit(jv.decode_int8)
_decode_f32 = jax.jit(functools.partial(jv.decode, dtype=jnp.float32))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def _assert_int8_quality(got, want, full, what):
    """The bar of every int8 image here: ``got`` (the port's int8 output)
    is as close to the reference's full-precision output ``full`` as the
    reference's int8 output ``want`` is (within 1 dB), and at most 3 dB
    further from ``want`` than ``want`` is from ``full``: two int8 runs
    whose inputs differ only by f32 rounding quantize alike except for a
    few values next to a .5 step, and each such flip carries on through
    the later layers, so on random weights they end as two draws of the
    same quantization noise, whose distance is 3 dB above either's."""
    q_got, q_want, apart = _psnr(got, full), _psnr(want, full), _psnr(got, want)
    print(f"{what}: port vs reference {apart:.2f} dB; against full precision port "
          f"{q_got:.2f} dB, reference {q_want:.2f} dB")
    assert abs(q_got - q_want) <= 1.0
    assert apart >= q_want - 3.0


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_quantized_trees_match(got, want):
    """The port's quantized tree against the one carried over from JAX:
    same sites, int8 weights and biases bit-equal, scales rtol 1e-5."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k] is None) == (want[k] is None), k
        if got[k] is None:
            continue
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k.endswith(("/as", "/ws")):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, err_msg=k)
        else:
            assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope="module")
def unet():
    """Tiny U-Net: (cfg, JAX tree, port tree, calibration inputs as numpy)."""
    cfg = ju.UNetConfig(**TINY)
    sd = dict(_init(TorchUNet(cfg), seed=0).state_dict())
    jp = ju.convert_torch_state_dict(sd, cfg, dtype=jnp.float32)
    rng = np.random.default_rng(11)
    cal = (rng.standard_normal((2, 8, 8, 8)).astype(np.float32), np.zeros(2, np.float32),
           rng.standard_normal((2, 50, 384)).astype(np.float32))
    return cfg, jp, tu.params_from_jax(_np(jp)), cal


@pytest.fixture(scope="module")
def vae():
    """Narrow VAE: (JAX tree, port tree, calibration latents)."""
    sd = dict(_init(TorchVAE(ch=VAE_CH), seed=1).state_dict())
    jp = jv.convert_torch_state_dict(sd, dtype=jnp.float32)
    z = (np.random.default_rng(12).standard_normal((2, 8, 8, 4)) * jv.SCALING_FACTOR
         ).astype(np.float32)
    return jp, tv.params_from_jax(_np(jp)), z


@pytest.fixture(scope="module")
def vae_bf16():
    """The narrow VAE in bf16, the serving dtype (a bf16 conv adds a bf16
    bias on both sides): (JAX tree, JAX int8 tree calibrated, the int8
    tree carried over)."""
    sd = dict(_init(TorchVAE(ch=VAE_CH), seed=1).state_dict())
    jp = jv.convert_torch_state_dict(sd, dtype=jnp.bfloat16)
    z = (np.random.default_rng(12).standard_normal((2, 8, 8, 4)) * jv.SCALING_FACTOR
         ).astype(np.float32)
    jq = jv.calibrate_decoder(jp, _quantize_decoder(jp, True, None), jnp.asarray(z))
    return jp, jq, tdb.quantized_from_jax(_np(jq), dtype=torch.bfloat16)


@pytest.fixture(scope="module")
def unet_q(unet):
    """The calibrated int8 U-Net: (JAX tree, the port's own, carried over)."""
    cfg, jp, tp, (x, t, ctx) = unet
    jq = ju.calibrate_unet(jp, _quantize_unet(jp, True), cfg,
                           *(jnp.asarray(a) for a in (x, t, ctx)))
    tq = tu.calibrate_unet(tp, tu.quantize_unet(tp), tu.UNetConfig(**TINY),
                           *(torch.from_numpy(a) for a in (x, t, ctx)))
    return jq, tq, tdb.quantized_from_jax(_np(jq))


@pytest.fixture(scope="module")
def vae_q(vae):
    jp, tp, z = vae
    jq = jv.calibrate_decoder(jp, _quantize_decoder(jp, True, None), jnp.asarray(z))
    tq = tv.calibrate_decoder(tp, tv.quantize_decoder(tp), torch.from_numpy(z))
    return jq, tq, tdb.quantized_from_jax(_np(jq))


def _dim(tree, path):
    node = tree
    for part in path.strip("/").split("/"):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node.dim()


def test_quantize_and_calibrate_unet_match_jax(unet_q):
    _, tq, from_jax = unet_q
    _assert_quantized_trees_match(tq, from_jax)
    # every conv site calibrated, the transformer's linears dynamic
    sites = [k for k, _ in _leaves(tq) if k.endswith("/wq")]
    scaled = {k[:-3] for k, _ in _leaves(tq) if k.endswith("/as")}
    assert {k[:-3] for k in sites if _dim(tq, k) == 4} == scaled
    assert any(_dim(tq, k) == 2 for k in sites)


def test_quantize_and_calibrate_decoder_match_jax(vae_q):
    """The bf16-epilogue default: shortcuts and the final conv keep no int8
    weights; the upsamplers carry the port's conv3x3(nearest2x) weights
    only (the reference's folded wq4/ws4 are not carried over)."""
    jq, tq, from_jax = vae_q
    _assert_quantized_trees_match(tq, from_jax)
    assert "wq4" in jq["dec_up"][0]["up"] and "wq4" not in tq["dec_up"][0]["up"]
    assert "wq" not in tq["dec_conv_out"]
    assert all("wq" not in rp.get("conv_shortcut", {}) for blk in tq["dec_up"]
               for rp in blk["resnets"])


def test_int8_blocks_match_jax(rng):
    """conv_q at each kind of site (3x3 static scale, C=8 padded to the
    kernel's channel step, 1x1 and 3x3 stride 2 dynamic), linear_q with and
    without bias, and transformer_2d on a quantize_transformer tree."""
    def arr(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def check(fn_j, fn_t, jtree, ttree, *xs, rel):
        want = np.asarray(jax.jit(fn_j)(jtree, *(jnp.asarray(x) for x in xs)))
        got = fn_t(ttree, *(torch.from_numpy(x) for x in xs)).float().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())

    for (k, ci, co, stride, pad, static) in [(3, 64, 96, 1, 1, True), (3, 8, 64, 1, 1, True),
                                             (1, 96, 64, 1, 0, False), (3, 32, 32, 2, 1, False)]:
        x = arr(2, 8, 8, ci)
        p = {"w": arr(k, k, ci, co, scale=(k * k * ci) ** -0.5), "b": arr(co, scale=0.1)}
        jq = jdb.quantize_conv(jax.tree.map(jnp.asarray, p))
        if static:
            jq["as"] = jnp.asarray(np.abs(x).max() * 1.25 / 127.0, jnp.float32)
        tq = tdb.quantized_from_jax(_np(jq))
        own = tdb.quantize_conv(tdb.tree_from_jax(p))
        assert torch.equal(own["wq"], tq["wq"]) and torch.equal(own["b"], tq["b"])
        np.testing.assert_allclose(own["ws"].numpy(), tq["ws"].numpy(), rtol=1e-6)
        check(lambda p, x: jdb.conv_q(p, x, stride=stride, padding=pad),
              lambda p, x: tdb.conv_q(p, x, stride=stride, padding=pad), jq, tq, x, rel=1e-5)

    for bias in (True, False):
        p = {"w": arr(96, 160, scale=96 ** -0.5), "b": arr(160, scale=0.1) if bias else None}
        jq = jdb.quantize_linear({"w": jnp.asarray(p["w"]),
                                  "b": None if p["b"] is None else jnp.asarray(p["b"])})
        tq = tdb.quantize_linear(tdb.tree_from_jax(p))
        assert torch.equal(tq["wq"], tdb.quantized_from_jax(_np(jq))["wq"])
        check(jdb.linear_q, tdb.linear_q, jq, tq, arr(2, 10, 96), rel=1e-5)

    c, cross = 64, 48

    def lin(i, o, b=True):
        return {"w": arr(i, o, scale=i ** -0.5), "b": arr(o, scale=0.1) if b else None}

    def norm(n):
        return {"g": 1 + arr(n, scale=0.1), "b": arr(n, scale=0.1)}

    def attn(kv):
        return {"q": lin(c, c, False), "k": lin(kv, c, False), "v": lin(kv, c, False),
                "o": lin(c, c)}

    p = {"norm": norm(c), "proj_in": {"w": arr(1, 1, c, c, scale=c ** -0.5), "b": arr(c)},
         "proj_out": {"w": arr(1, 1, c, c, scale=c ** -0.5), "b": arr(c)},
         "block": {"norm1": norm(c), "attn1": attn(c), "norm2": norm(c), "attn2": attn(cross),
                   "norm3": norm(c), "ff": {"proj": lin(c, 8 * c), "out": lin(4 * c, c)}}}
    jq = jdb.quantize_transformer(jax.tree.map(jnp.asarray, p))
    tq = tdb.quantize_transformer(tdb.tree_from_jax(p))
    _assert_quantized_trees_match(tq, tdb.quantized_from_jax(_np(jq)))
    # the block's f32 products sum in another order on each side before the
    # dynamic activation scales: a few int8 levels flip
    check(lambda q, x, ctx: jdb.transformer_2d(q, x, ctx, 4),
          lambda q, x, ctx: tdb.transformer_2d(q, x, ctx, 4), jq, tq, arr(2, 4, 4, c),
          arr(2, 6, cross), rel=1e-2)


def test_apply_int8_tiny_unet_matches_jax(unet, unet_q):
    cfg, _, _, _ = unet
    jq, _, from_jax = unet_q
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 8, 8, 8)).astype(np.float32)
    t = np.zeros(2, np.float32)
    ctx = rng.standard_normal((2, 50, 384)).astype(np.float32)
    want = np.asarray(_apply_int8(jq, cfg, *(jnp.asarray(a) for a in (x, t, ctx))))
    got = tu.apply_int8(from_jax, tu.UNetConfig(**TINY), *(torch.from_numpy(a) for a in (x, t, ctx)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 8, 8, 4)
    assert float(np.abs(got.numpy() - want).max()) <= LATENT_REL * float(np.abs(want).max())


def test_decode_int8_unfused_matches_jax(vae_bf16, monkeypatch):
    """``decode_int8`` from the same latents through the unfused route, at
    the bar of ``_assert_int8_quality`` (measured: 30.2 dB apart, 30.5 and
    30.7 dB from full precision)."""
    monkeypatch.setenv("LT_DILATED_UP", "0")
    jp, jq, tq = vae_bf16
    z = (np.random.default_rng(14).standard_normal((1, 4, 4, 4)) * jv.SCALING_FACTOR
         ).astype(np.float32)
    full = np.asarray(_decode_f32(jp, jnp.asarray(z)))
    want = np.asarray(_decode_int8(jq, jnp.asarray(z)))
    got = tv.decode_int8(tq, torch.from_numpy(z))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 32, 32, 3)
    _assert_int8_quality(got.numpy(), want, full, "int8 decode")


def _mid_block(jq, z):
    """The int8 decoder's output before the up-blocks, on the JAX side."""
    h = jv.conv(jq["post_quant_conv"], (jnp.asarray(z) / jv.SCALING_FACTOR).astype(jnp.bfloat16),
                padding=0)
    h = jv.conv(jq["dec_conv_in"], h)
    h = jv._resnet_block_q(jq["dec_mid"]["r0"], h)
    h = jv.spatial_attention(jq["dec_mid"]["attn"], h)
    return jv._resnet_block_q(jq["dec_mid"]["r1"], h)


def test_decode_int8_fused_matches_jax(vae_bf16, monkeypatch):
    """The kernel-5 chain from the same mid-block output on both sides: the
    port's ``_decode_int8_fused`` against the JAX one with its Pallas
    kernel in interpret mode, at the image bar of ``PSNR_DB`` (measured:
    identical images; both quantize the same f32 activations, and the
    moments feed the next GroupNorm the same way). The decoder runs up
    blocks 1 and 2 only (64 -> 32 channels): that keeps every kind of chain
    site (upsamplers, resnets with and without a shortcut, the final
    GroupNorm from moments) in 8 kernel calls instead of 21, as interpret
    mode costs about 2 s a call."""
    for knob in ("LT_FUSED_VAE_FROM", "LT_FUSED_VAE_SKIP_UP", "LT_FUSED_VAE_RESTART"):
        monkeypatch.delenv(knob, raising=False)
    _, jq, tq = vae_bf16
    jq, tq = dict(jq, dec_up=jq["dec_up"][1:3]), dict(tq, dec_up=tq["dec_up"][1:3])
    z = (np.random.default_rng(15).standard_normal((1, 8, 8, 4)) * jv.SCALING_FACTOR
         ).astype(np.float32)
    h = _mid_block(jq, z)
    want = np.asarray(jv._decode_int8_fused(jq, h, interpret=True, min_h=16))
    got = tv._decode_int8_fused(tq, torch.from_numpy(np.asarray(h, np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 32, 32, 3)
    apart = _psnr(got.numpy(), want)
    print(f"fused int8 decode: port vs reference {apart:.2f} dB")
    assert apart >= PSNR_DB


def test_int8_step_pcm_to_pasted_frames_matches_jax(unet, vae, monkeypatch):
    """PCM -> Whisper features -> the int8 step (both flags) at B=2 -> masked
    paste-back onto the avatar's frames, against the JAX chain, with the
    trees calibrated as a first session calibrates them: the decoder on the
    avatar's reference-face latents, the U-Net on its latents and the
    features with the positional encoding. The faces are held to
    ``_assert_int8_quality`` against the full-precision step (measured:
    23.6 dB apart, 22.4 dB each from full precision), taken from the port:
    its f32 step equals the JAX one within 1 LSB
    (tests/test_torch_musetalk.py) and skips a JAX compile; the pasted
    frames equal outside the crop boxes."""
    monkeypatch.setenv("LT_DILATED_UP", "0")
    cfg, jp_u = unet[0], unet[1]
    jp_v = vae[0]
    jwp = jwe.init_params(jax.random.PRNGKey(0), jwe.TINY, jnp.float32)
    twp = twe.params_from_jax(_np(jwp))
    B, l, r = 2, 10, 10
    a = synthetic.musetalk_avatar_arrays(n_frames=3, seed=6)
    avatar = plugin.avatar_from_arrays("int8", a["frames"], a["faces"], a["coords"],
                                       a["mask_coords"], a["masks"], vae[1], device="cpu")
    lat = avatar["latent_cycle_host"]
    frames = np.stack(a["frames"])
    Ho, Wo = tb.bucket_shape([(ys, ye, xs, xe) for (xs, ys, xe, ye) in a["mask_coords"]])
    planes = tb.prepare_masked_paste_data(a["coords"], a["mask_coords"], a["masks"], Ho, Wo,
                                          480, 640)
    tf, n = twf.make_batched_encode_factory(twp, twe.TINY, B, l, r, device="cpu")
    jf, _ = jwf.make_batched_encode_factory(jwp, jwe.TINY, B, l, r)
    rng = np.random.default_rng(16)
    t = np.arange(n) / 16000
    pcm = (0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 3 * t)
           + 0.02 * rng.standard_normal(n)).astype(np.float32)[None]
    idxs = np.asarray([1, 2], np.int32)

    jfeat = jf(1)(pcm)[0]
    ctx = jnp.asarray(np.asarray(jfeat) + jm.positional_encoding_table(50, 384))
    jq_u = ju.calibrate_unet(jp_u, _quantize_unet(jp_u, True), cfg, jnp.asarray(lat[:2]),
                             jnp.zeros(2), ctx)
    jq_v = jv.calibrate_decoder(jp_v, _quantize_decoder(jp_v, True, None),
                                jnp.asarray(lat[:2, ..., 4:]))
    tq_u, tq_v = tdb.quantized_from_jax(_np(jq_u)), tdb.quantized_from_jax(_np(jq_v))
    jargs = (jnp.asarray(lat), jnp.asarray(idxs), jfeat)
    jface = jm.make_infer_fn(cfg, B, dtype=jnp.float32, vae_int8=True, unet_int8=True)(
        jq_u, jq_v, *jargs)
    want = np.asarray(jpb.make_masked_paste_fn(256, Ho, Wo, 480, 640, use_pallas=False)(
        jface, jnp.asarray(frames), jnp.asarray(idxs), *(jnp.asarray(p) for p in planes)))
    targs = (torch.from_numpy(lat), torch.from_numpy(idxs), tf(1)(pcm)[0])
    tface = tm.make_infer_fn(tu.UNetConfig(**TINY), B, dtype=torch.float32, vae_int8=True,
                             unet_int8=True)(tq_u, tq_v, *targs)
    full = tm.make_infer_fn(tu.UNetConfig(**TINY), B, dtype=torch.float32)(
        unet[2], vae[1], *targs).numpy()
    got = tb.make_masked_paste_fn(256, Ho, Wo, 480, 640)(
        tface, torch.from_numpy(frames), torch.from_numpy(idxs),
        *(torch.from_numpy(p) for p in planes)).numpy()

    assert got.shape == want.shape == (B, 480, 640, 3) and got.dtype == np.uint8
    _assert_int8_quality(tface.numpy() / 255.0, np.asarray(jface) / 255.0, full / 255.0,
                         "int8 step faces")
    for b, i in enumerate(idxs):
        xs, ys, xe, ye = a["mask_coords"][i]
        outside = np.ones((480, 640), bool)
        outside[ys:ye, xs:xe] = False
        np.testing.assert_array_equal(got[b][outside], want[b][outside])
    x1, y1, x2, y2 = a["coords"][1]
    assert not np.array_equal(got[0, y1:y2, x1:x2], frames[1, y1:y2, x1:x2])  # pasted
