"""AutoencoderKL (sd-vae-ft-mse), MuseTalk's image codec (ports the bf16/f32
path of livetalking_tpu/models/sd_vae.py).

diffusers' AutoencoderKL as the reference instantiates it: block channels
(128, 256, 512, 512), 2 resnets per encoder block and 3 per decoder block,
single-head mid attention, 4 latent channels, scaling factor 0.18215.

``encode`` maps RGB in [-1, 1] to the posterior MEAN times 0.18215 (the
variance-free choice for a fixed avatar cache); ``decode`` maps latents
back to RGB in [0, 1]. Both read channel counts from the parameters, so a
narrower checkpoint runs too. The mid-blocks' self-attention runs the
``csrc/attention.cu`` kernel on the card.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from livetalking_tpu_torch.models.diffusion_blocks import (
    Params,
    conv,
    conv_asym,
    group_norm,
    prepare,
    resnet_block,
    silu,
    spatial_attention,
    t_conv,
    t_norm,
    t_resnet,
    t_spatial_attn,
    tree_from_jax,
    upsample_nearest2x,
)

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
    h = conv(params["enc_conv_out"], silu(group_norm(params["enc_norm_out"], h)))
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
    h = conv(params["dec_conv_out"], silu(group_norm(params["dec_norm_out"], h)))
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
