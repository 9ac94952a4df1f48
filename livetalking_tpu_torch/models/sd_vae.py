"""AutoencoderKL (sd-vae-ft-mse), MuseTalk's image codec (ports
livetalking_tpu/models/sd_vae.py).

diffusers' AutoencoderKL as the reference instantiates it: block channels
(128, 256, 512, 512), 2 resnets per encoder block and 3 per decoder block,
single-head mid attention, 4 latent channels, scaling factor 0.18215.

``encode`` maps RGB in [-1, 1] to the posterior MEAN times 0.18215 (the
variance-free choice for a fixed avatar cache); ``decode`` maps latents
back to RGB in [0, 1]. Both read channel counts from the parameters, so a
narrower checkpoint runs too. The mid-blocks' self-attention runs the
``csrc/attention.cu`` kernel on the card.

``decode_int8`` is the W8A8 decoder (``quantize_decoder`` +
``calibrate_decoder``): its 3x3 convs run kernel 4 of ``csrc/conv.cu``, or,
with ``LT_FUSED_VAE=1``, the up-block chain runs kernel 5 (GroupNorm,
SiLU and quantize in the conv's prologue, the next GroupNorm's moments in
its epilogue).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from livetalking_tpu_torch.models.diffusion_blocks import (
    Params,
    conv,
    conv_asym,
    conv_q,
    fetch_scales,
    group_norm_silu,
    prepare,
    quantize_conv,
    resnet_block,
    spatial_attention,
    t_conv,
    t_norm,
    t_resnet,
    t_spatial_attn,
    tree_from_jax,
    upsample_nearest2x,
)
from livetalking_tpu_torch.ops.conv import conv3x3_gnq, conv3x3_gnq_fits
from livetalking_tpu_torch.ops.norm import affine_from_moments

SCALING_FACTOR = 0.18215
BLOCK_CH: Tuple[int, ...] = (128, 256, 512, 512)
LATENT_CH = 4


def encode(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, 256, 256, 3) in [-1, 1] -> (B, 32, 32, 4) scaled latents (mean),
    in ``x``'s dtype."""
    h = conv(params["enc_conv_in"], x)
    for blk in params["enc_down"]:
        for rp in blk["resnets"]:
            h = resnet_block(rp, h)
        if "down" in blk:
            h = conv_asym(blk["down"], h, 2, ((0, 1), (0, 1)))
    h = resnet_block(params["enc_mid"]["r0"], h)
    h = spatial_attention(params["enc_mid"]["attn"], h)
    h = resnet_block(params["enc_mid"]["r1"], h)
    h = conv(params["enc_conv_out"], group_norm_silu(params["enc_norm_out"], h))
    moments = conv(params["quant_conv"], h, padding=0)  # (B, 32, 32, 8)
    return moments[..., :LATENT_CH] * SCALING_FACTOR


def decode(params: Params, z: torch.Tensor, *, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, 32, 32, 4) scaled latents -> (B, 256, 256, 3) RGB in [0, 1], f32.

    Activations run in ``dtype`` (bf16 by default; float32 for parity)."""
    z = (z / SCALING_FACTOR).to(dtype)
    h = conv(params["post_quant_conv"], z, padding=0)
    h = conv(params["dec_conv_in"], h)
    h = resnet_block(params["dec_mid"]["r0"], h)
    h = spatial_attention(params["dec_mid"]["attn"], h)
    h = resnet_block(params["dec_mid"]["r1"], h)
    for blk in params["dec_up"]:
        for rp in blk["resnets"]:
            h = resnet_block(rp, h)
        if "up" in blk:
            h = conv(blk["up"], upsample_nearest2x(h))
    h = conv(params["dec_conv_out"], group_norm_silu(params["dec_norm_out"], h))
    return (h.float() / 2.0 + 0.5).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# W8A8 int8 decoder
# ---------------------------------------------------------------------------
#
# Every upsampler runs as conv_q(up, upsample_nearest2x(h)), the reference
# under LT_DILATED_UP=0, with the same wq/ws as the fused route's in-kernel
# upsample. The reference's shape-tuned lhs-dilated folded 4x4 route
# (conv_q_up with its own wq4/ws4) is left out (ROADMAP "Leave out").

@torch.inference_mode()
def quantize_decoder(params: Params, mid_int8: bool = True,
                     bf16_epilogue: Optional[bool] = None) -> Params:
    """One-time int8 conversion of the decoder's convs; norms, the mid
    attention and the latent-side convs stay model-dtype. ``mid_int8``
    also quantizes the two mid-block resnets. ``bf16_epilogue`` (default
    ``$LT_BF16_EPILOGUE``, on) keeps the 1x1 resnet shortcuts and the final
    128->3 conv in the model dtype, as the reference does."""
    if bf16_epilogue is None:
        bf16_epilogue = os.environ.get("LT_BF16_EPILOGUE", "1") == "1"

    def q_resnet(rp):
        out = {"norm1": rp["norm1"], "norm2": rp["norm2"],
               "conv1": quantize_conv(rp["conv1"]), "conv2": quantize_conv(rp["conv2"])}
        if "conv_shortcut" in rp:
            out["conv_shortcut"] = (dict(rp["conv_shortcut"]) if bf16_epilogue
                                    else quantize_conv(rp["conv_shortcut"]))
        return out

    mid = params["dec_mid"]
    if mid_int8:
        mid = {"r0": q_resnet(mid["r0"]), "attn": mid["attn"], "r1": q_resnet(mid["r1"])}
    q: Params = {
        "post_quant_conv": params["post_quant_conv"],
        "dec_conv_in": params["dec_conv_in"],
        "dec_mid": mid,
        "dec_norm_out": params["dec_norm_out"],
        "dec_conv_out": (dict(params["dec_conv_out"]) if bf16_epilogue
                         else quantize_conv(params["dec_conv_out"])),
        "dec_up": [],
    }
    for blk in params["dec_up"]:
        qblk: Params = {"resnets": [q_resnet(rp) for rp in blk["resnets"]]}
        if "up" in blk:
            qblk["up"] = quantize_conv(blk["up"])
        q["dec_up"].append(qblk)
    return q


def _decode_scale_walk(params: Params, z: torch.Tensor, headroom: float,
                       mid_int8: bool) -> List[torch.Tensor]:
    """Full-precision decode that records one activation scale
    ``max|a| * headroom / 127 + 1e-8`` (a device scalar) per quantizable
    conv site: the mid resnets first when ``mid_int8``, then per resnet
    conv1, conv2, shortcut, the block's upsampler, and dec_conv_out last."""
    rec: List[torch.Tensor] = []

    def sof(x):
        rec.append(x.float().abs().amax() * headroom / 127.0 + 1e-8)

    def cal_resnet(rp, x, eps=1e-6):
        a1 = group_norm_silu(rp["norm1"], x, eps=eps)
        sof(a1)
        h = conv(rp["conv1"], a1)
        a2 = group_norm_silu(rp["norm2"], h, eps=eps)
        sof(a2)
        h = conv(rp["conv2"], a2)
        if "conv_shortcut" in rp:
            sof(x)
            x = conv(rp["conv_shortcut"], x, padding=0)
        return x + h

    mid_resnet = cal_resnet if mid_int8 else resnet_block
    h = conv(params["post_quant_conv"], z / SCALING_FACTOR, padding=0)
    h = conv(params["dec_conv_in"], h)
    h = mid_resnet(params["dec_mid"]["r0"], h)
    h = spatial_attention(params["dec_mid"]["attn"], h)
    h = mid_resnet(params["dec_mid"]["r1"], h)
    for blk in params["dec_up"]:
        for rp in blk["resnets"]:
            h = cal_resnet(rp, h)
        if "up" in blk:
            up = upsample_nearest2x(h)
            sof(up)
            h = conv(blk["up"], up)
    sof(group_norm_silu(params["dec_norm_out"], h))
    return rec


@torch.inference_mode()
def calibrate_decoder(params: Params, params_q: Params, z: torch.Tensor,
                      headroom: float = 1.25) -> Params:
    """Static activation scales from representative latents ``z``: one
    full-precision walk that keeps every site's scale on the device, one
    host copy, then the assignment in the walk's order (in place on
    ``params_q``, which is returned). Sites left in the model dtype by the
    bf16 epilogue take their slot and store nothing."""
    mid_int8 = "wq" in params_q["dec_mid"]["r0"]["conv1"]
    scales = fetch_scales(_decode_scale_walk(params, z, headroom, mid_int8), z.device)

    def maybe(site):
        s = next(scales)
        if "wq" in site:
            site["as"] = s

    def assign_resnet(rq):
        rq["conv1"]["as"] = next(scales)
        rq["conv2"]["as"] = next(scales)
        if "conv_shortcut" in rq:
            maybe(rq["conv_shortcut"])

    if mid_int8:
        assign_resnet(params_q["dec_mid"]["r0"])
        assign_resnet(params_q["dec_mid"]["r1"])
    for blk in params_q["dec_up"]:
        for rq in blk["resnets"]:
            assign_resnet(rq)
        if "up" in blk:
            blk["up"]["as"] = next(scales)
    maybe(params_q["dec_conv_out"])
    leftover = sum(1 for _ in scales)
    assert leftover == 0, f"scale walk/assign mismatch: {leftover} extra"
    return params_q


def _resnet_block_q(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = conv_q(p["conv1"], group_norm_silu(p["norm1"], x, eps=eps))
    a = group_norm_silu(p["norm2"], h, eps=eps)
    if "conv_shortcut" in p:
        cs = p["conv_shortcut"]
        x = conv_q(cs, x, padding=0) if "wq" in cs else conv(cs, x, padding=0)
    return conv_q(p["conv2"], a, residual=x)


def _gn_scale_shift(gn_p: Params, s1: torch.Tensor, s2: torch.Tensor, hw: int,
                    groups: int = 32, eps: float = 1e-6):
    """GroupNorm's per-(batch, channel) scale and shift from per-channel
    spatial moments s1 = sum x, s2 = sum x^2 ((B, C) f32): ``group_norm``'s
    arithmetic without its statistics pass (kernel 5's epilogue took the
    moments)."""
    scale, shift = affine_from_moments(s1, s2, gn_p["g"], gn_p["b"], hw, groups, eps)
    return scale.contiguous(), shift.contiguous()


def _fused_resnet_q(rp: Params, h: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor):
    """A quantized resnet block as two kernel-5 convs: each takes the
    GroupNorm affine from the previous kernel's moments and returns its
    own. The residual (identity, or the shortcut conv) rides conv2."""
    B, H, W, C = h.shape
    sc1, sh1 = _gn_scale_shift(rp["norm1"], s1, s2, H * W)
    c1 = rp["conv1"]
    h1, t1, t2 = conv3x3_gnq(h, sc1, sh1, c1["as"], c1["wq"], c1["as"] * c1["ws"], c1["b"])
    sc2, sh2 = _gn_scale_shift(rp["norm2"], t1, t2, H * W)
    res = h
    if "conv_shortcut" in rp:
        cs = rp["conv_shortcut"]
        res = conv_q(cs, h, padding=0) if "wq" in cs else conv(cs, h, padding=0)
    c2 = rp["conv2"]
    return conv3x3_gnq(h1, sc2, sh2, c2["as"], c2["wq"], c2["as"] * c2["ws"], c2["b"],
                       residual=res.contiguous())


def _fused_chain_fits(params_q: Params, h_px: int) -> bool:
    """True when every conv from block 0's upsampler to the end of the
    decoder fits kernel 5 (``conv3x3_gnq_fits``) at mid-block resolution
    ``h_px`` and the tree is calibrated: the moment chain cannot switch
    to the unfused route midway without a statistics pass."""
    blocks = params_q["dec_up"]
    if not all("as" in blk["resnets"][0]["conv1"] for blk in blocks):
        return False  # uncalibrated tree
    px = h_px
    cin = blocks[0]["resnets"][-1]["conv2"]["wq"].shape[0]
    for bi, blk in enumerate(blocks):
        if bi > 0:
            for rp in blk["resnets"]:
                cout = rp["conv1"]["wq"].shape[0]
                if not (conv3x3_gnq_fits(px, px, cin, cout)
                        and conv3x3_gnq_fits(px, px, cout, cout)):
                    return False
                cin = cout
        if "up" in blk:
            px *= 2
            if not conv3x3_gnq_fits(px, px, cin, cin, upsample=True):
                return False
        elif bi == 0:
            return False
    return True


def _out_conv(co: Params, a: torch.Tensor) -> torch.Tensor:
    """The final 128->3 conv: model dtype under the bf16 epilogue."""
    return conv_q(co, a) if "wq" in co else conv(co, a)


def _decode_int8_fused(params_q: Params, h: torch.Tensor) -> torch.Tensor:
    """The up-block chain on kernel 5 from block 0's upsampler on; ``h``
    is the mid-block output. Block 0's resnets run the unfused route."""
    s1 = s2 = None
    for blk in params_q["dec_up"]:
        for rp in blk["resnets"]:
            if s1 is None:
                h = _resnet_block_q(rp, h)
            else:
                h, s1, s2 = _fused_resnet_q(rp, h, s1, s2)
        if "up" in blk:
            up = blk["up"]
            # the nearest-2x upsample happens inside the kernel's prologue
            h, s1, s2 = conv3x3_gnq(h.contiguous(), None, None, up["as"], up["wq"],
                                    up["as"] * up["ws"], up["b"], upsample=True)
    sc, sh = _gn_scale_shift(params_q["dec_norm_out"], s1, s2, h.shape[1] * h.shape[2])
    a = h.float() * sc[:, None, None, :] + sh[:, None, None, :]
    a = (a * torch.sigmoid(a)).to(h.dtype)
    h = _out_conv(params_q["dec_conv_out"], a)
    return (h.float() / 2.0 + 0.5).clamp(0.0, 1.0)


def _decode_int8_mid(params_q: Params, z: torch.Tensor) -> torch.Tensor:
    """``decode_int8`` up to the up-blocks: the latent-side convs and the
    mid block, in bf16 (the fused chain's input)."""
    z = (z / SCALING_FACTOR).to(torch.bfloat16)
    h = conv(params_q["post_quant_conv"], z, padding=0)
    h = conv(params_q["dec_conv_in"], h)
    mid = params_q["dec_mid"]
    mid_resnet = _resnet_block_q if "wq" in mid["r0"]["conv1"] else resnet_block
    h = mid_resnet(mid["r0"], h)
    h = spatial_attention(mid["attn"], h)
    return mid_resnet(mid["r1"], h)


def decode_int8(params_q: Params, z: torch.Tensor) -> torch.Tensor:
    """int8 twin of ``decode`` (same contract), params from
    ``quantize_decoder`` (+ ``calibrate_decoder``). Activations run bf16
    whatever the latents' dtype, as in the reference.

    With ``LT_FUSED_VAE=1``, on a CUDA tensor and a calibrated tree whose
    chain fits, the up-blocks from block 0's upsampler on run kernel 5
    (``_decode_int8_fused``): GroupNorm statistics ride the previous
    conv's epilogue. Otherwise every 3x3 conv runs kernel 4."""
    h = _decode_int8_mid(params_q, z)
    if (h.is_cuda and os.environ.get("LT_FUSED_VAE", "0") == "1"
            and _fused_chain_fits(params_q, h.shape[1])):
        return _decode_int8_fused(params_q, h)
    for blk in params_q["dec_up"]:
        for rp in blk["resnets"]:
            h = _resnet_block_q(rp, h)
        if "up" in blk:
            h = conv_q(blk["up"], upsample_nearest2x(h))
    h = _out_conv(params_q["dec_conv_out"], group_norm_silu(params_q["dec_norm_out"], h))
    return (h.float() / 2.0 + 0.5).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# random init (serving and tests without weights)
# ---------------------------------------------------------------------------

def _rand_conv(g, kh, kw, cin, cout):
    std = 0.3 / (kh * kw * cin) ** 0.5
    return {"w": torch.randn((cout, cin, kh, kw), generator=g) * std, "b": torch.zeros(cout)}


def _rand_norm(c):
    return {"g": torch.ones(c), "b": torch.zeros(c)}


def _rand_resnet(g, cin, cout):
    p = {"norm1": _rand_norm(cin), "conv1": _rand_conv(g, 3, 3, cin, cout),
         "norm2": _rand_norm(cout), "conv2": _rand_conv(g, 3, 3, cout, cout)}
    if cin != cout:
        p["conv_shortcut"] = _rand_conv(g, 1, 1, cin, cout)
    return p


def _rand_lin(g, i, o):
    return {"w": torch.randn((o, i), generator=g) * (0.3 / i ** 0.5), "b": torch.zeros(o)}


def _rand_attn(g, c):
    return {"group_norm": _rand_norm(c), "q": _rand_lin(g, c, c), "k": _rand_lin(g, c, c),
            "v": _rand_lin(g, c, c), "o": _rand_lin(g, c, c)}


def init_params(seed: int = 1, dtype=torch.bfloat16, device="cpu") -> Params:
    """Random weights from ``torch.Generator(seed)`` with the reference's
    init: N(0, 0.3/sqrt(fan_in)) weights, zero biases, unit norms."""
    g = torch.Generator().manual_seed(seed)
    C = BLOCK_CH

    enc_down: List[Dict] = []
    cin = C[0]
    for i, cout in enumerate(C):
        blk = {"resnets": [_rand_resnet(g, cin if j == 0 else cout, cout) for j in range(2)]}
        if i < len(C) - 1:
            blk["down"] = _rand_conv(g, 3, 3, cout, cout)
        enc_down.append(blk)
        cin = cout

    dec_up: List[Dict] = []
    rev = list(reversed(C))  # (512, 512, 256, 128)
    cin = rev[0]
    for i, cout in enumerate(rev):
        blk = {"resnets": [_rand_resnet(g, cin if j == 0 else cout, cout) for j in range(3)]}
        if i < len(rev) - 1:
            blk["up"] = _rand_conv(g, 3, 3, cout, cout)
        dec_up.append(blk)
        cin = cout

    mid_c = C[-1]
    tree = {
        "enc_conv_in": _rand_conv(g, 3, 3, 3, C[0]),
        "enc_down": enc_down,
        "enc_mid": {"r0": _rand_resnet(g, mid_c, mid_c), "attn": _rand_attn(g, mid_c),
                    "r1": _rand_resnet(g, mid_c, mid_c)},
        "enc_norm_out": _rand_norm(mid_c),
        "enc_conv_out": _rand_conv(g, 3, 3, mid_c, 2 * LATENT_CH),
        "quant_conv": _rand_conv(g, 1, 1, 2 * LATENT_CH, 2 * LATENT_CH),
        "post_quant_conv": _rand_conv(g, 1, 1, LATENT_CH, LATENT_CH),
        "dec_conv_in": _rand_conv(g, 3, 3, LATENT_CH, mid_c),
        "dec_mid": {"r0": _rand_resnet(g, mid_c, mid_c), "attn": _rand_attn(g, mid_c),
                    "r1": _rand_resnet(g, mid_c, mid_c)},
        "dec_up": dec_up,
        "dec_norm_out": _rand_norm(C[0]),
        "dec_conv_out": _rand_conv(g, 3, 3, C[0], 3),
    }
    return prepare(tree, device, dtype)


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's VAE tree (leaves as numpy arrays) -> the port's."""
    return prepare(tree_from_jax(tree), device, dtype)


# ---------------------------------------------------------------------------
# diffusers checkpoint conversion
# ---------------------------------------------------------------------------

def convert_torch_state_dict(sd: Dict[str, Any], dtype=torch.bfloat16, device="cpu") -> Params:
    """diffusers AutoencoderKL state dict -> the port's tree. Accepts the
    modern and the legacy mid-attention key names."""
    enc_down = []
    for i in range(len(BLOCK_CH)):
        blk = {"resnets": [t_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}") for j in range(2)]}
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            blk["down"] = t_conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv")
        enc_down.append(blk)

    dec_up = []
    for i in range(len(BLOCK_CH)):
        blk = {"resnets": [t_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}") for j in range(3)]}
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            blk["up"] = t_conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv")
        dec_up.append(blk)

    def mid(prefix):
        return {"r0": t_resnet(sd, f"{prefix}.resnets.0"),
                "attn": t_spatial_attn(sd, f"{prefix}.attentions.0"),
                "r1": t_resnet(sd, f"{prefix}.resnets.1")}

    tree = {
        "enc_conv_in": t_conv(sd, "encoder.conv_in"),
        "enc_down": enc_down,
        "enc_mid": mid("encoder.mid_block"),
        "enc_norm_out": t_norm(sd, "encoder.conv_norm_out"),
        "enc_conv_out": t_conv(sd, "encoder.conv_out"),
        "quant_conv": t_conv(sd, "quant_conv"),
        "post_quant_conv": t_conv(sd, "post_quant_conv"),
        "dec_conv_in": t_conv(sd, "decoder.conv_in"),
        "dec_mid": mid("decoder.mid_block"),
        "dec_up": dec_up,
        "dec_norm_out": t_norm(sd, "decoder.conv_norm_out"),
        "dec_conv_out": t_conv(sd, "decoder.conv_out"),
    }
    return prepare(tree, device, dtype)
