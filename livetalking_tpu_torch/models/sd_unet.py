"""UNet2DConditionModel (SD1.x layout), MuseTalk's latent lip-sync network
(ports the bf16/f32 path of livetalking_tpu/models/sd_unet.py).

The reference's diffusers instantiation: in_channels 8 (masked || reference
latents), out_channels 4, block_out_channels (320, 640, 1280, 1280), 2
layers per block, cross_attention_dim 384 (Whisper features), 8 attention
heads, conv Transformer2D projections. MuseTalk runs ONE denoise step at
t=0. Every transformer's self-attention (16 per step at full width) runs
the ``csrc/attention.cu`` kernel on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import torch

from livetalking_tpu_torch.models.diffusion_blocks import (
    Params,
    conv,
    count_params,
    group_norm,
    linear,
    prepare,
    resnet_block,
    silu,
    t_conv,
    t_lin,
    t_norm,
    t_resnet,
    t_transformer,
    timestep_embedding,
    transformer_2d,
    tree_from_jax,
    upsample_nearest2x,
)

__all__ = ["UNetConfig", "MUSETALK", "apply", "init_params", "params_from_jax",
           "convert_torch_state_dict", "count_params"]


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_dim: int = 384
    heads: int = 8
    norm_eps: float = 1e-5

    @property
    def time_dim(self) -> int:
        return self.block_out[0] * 4


MUSETALK = UNetConfig()


def apply(params: Params, cfg: UNetConfig, x: torch.Tensor, t: torch.Tensor,
          ctx: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, in_ch) latents; t (B,) timesteps; ctx (B, S, cross_dim)
    -> (B, H, W, out_ch) predicted sample, f32. Runs in ``x``'s dtype."""
    temb = timestep_embedding(t, cfg.block_out[0])
    temb = linear(params["time2"], silu(linear(params["time1"], temb.to(x.dtype))))

    h = conv(params["conv_in"], x)
    skips: List[torch.Tensor] = [h]
    for blk in params["down"]:
        for j, rp in enumerate(blk["resnets"]):
            h = resnet_block(rp, h, temb, eps=cfg.norm_eps)
            if "attentions" in blk:
                h = transformer_2d(blk["attentions"][j], h, ctx, cfg.heads)
            skips.append(h)
        if "down" in blk:
            h = conv(blk["down"], h, stride=2)
            skips.append(h)

    mid = params["mid"]
    h = resnet_block(mid["r0"], h, temb, eps=cfg.norm_eps)
    h = transformer_2d(mid["attn"], h, ctx, cfg.heads)
    h = resnet_block(mid["r1"], h, temb, eps=cfg.norm_eps)

    for blk in params["up"]:
        for j, rp in enumerate(blk["resnets"]):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = resnet_block(rp, h, temb, eps=cfg.norm_eps)
            if "attentions" in blk:
                h = transformer_2d(blk["attentions"][j], h, ctx, cfg.heads)
        if "up" in blk:
            h = conv(blk["up"], upsample_nearest2x(h))

    h = silu(group_norm(params["norm_out"], h, eps=cfg.norm_eps))
    return conv(params["conv_out"], h).float()


# ---------------------------------------------------------------------------
# channel bookkeeping shared by init and conversion
# ---------------------------------------------------------------------------

def _down_plan(cfg: UNetConfig):
    """Per down block: (in_ch of each resnet, out_ch, has_attn, has_down)."""
    plan = []
    cin = cfg.block_out[0]
    for i, cout in enumerate(cfg.block_out):
        res_ins = [cin if j == 0 else cout for j in range(cfg.layers_per_block)]
        plan.append({
            "res_ins": res_ins, "out": cout,
            "attn": i < len(cfg.block_out) - 1,
            "down": i < len(cfg.block_out) - 1,
        })
        cin = cout
    return plan


def _skip_channels(cfg: UNetConfig):
    skips = [cfg.block_out[0]]
    for blk in _down_plan(cfg):
        skips += [blk["out"]] * cfg.layers_per_block
        if blk["down"]:
            skips.append(blk["out"])
    return skips


def _up_plan(cfg: UNetConfig):
    skips = _skip_channels(cfg)
    rev = list(reversed(cfg.block_out))
    plan = []
    prev = rev[0]
    for i, cout in enumerate(rev):
        res_ins = []
        for _ in range(cfg.layers_per_block + 1):
            res_ins.append(prev + skips.pop())
            prev = cout
        plan.append({
            "res_ins": res_ins, "out": cout,
            "attn": i > 0,
            "up": i < len(rev) - 1,
        })
    return plan


# ---------------------------------------------------------------------------
# random init
# ---------------------------------------------------------------------------

def _rc(g, kh, kw, ci, co, scale=0.3):
    w = torch.randn((co, ci, kh, kw), generator=g) * (scale / (kh * kw * ci) ** 0.5)
    return {"w": w, "b": torch.zeros(co)}


def _rl(g, i, o, bias=True, scale=0.3):
    return {"w": torch.randn((o, i), generator=g) * (scale / i ** 0.5),
            "b": torch.zeros(o) if bias else None}


def _rn(c):
    return {"g": torch.ones(c), "b": torch.zeros(c)}


def _r_resnet(g, ci, co, tdim):
    p = {"norm1": _rn(ci), "conv1": _rc(g, 3, 3, ci, co), "time_emb_proj": _rl(g, tdim, co),
         "norm2": _rn(co), "conv2": _rc(g, 3, 3, co, co)}
    if ci != co:
        p["conv_shortcut"] = _rc(g, 1, 1, ci, co)
    return p


def _r_transformer(g, c, cross):
    inner = 4 * c

    def attn(kv_dim):
        return {"q": _rl(g, c, c, bias=False), "k": _rl(g, kv_dim, c, bias=False),
                "v": _rl(g, kv_dim, c, bias=False), "o": _rl(g, c, c)}

    return {
        "norm": _rn(c),
        "proj_in": _rc(g, 1, 1, c, c),
        "proj_out": _rc(g, 1, 1, c, c),
        "block": {
            "norm1": _rn(c), "attn1": attn(c),
            "norm2": _rn(c), "attn2": attn(cross),
            "norm3": _rn(c),
            "ff": {"proj": _rl(g, c, 2 * inner), "out": _rl(g, inner, c)},
        },
    }


def init_params(seed: int = 2, cfg: UNetConfig = MUSETALK, dtype=torch.bfloat16,
                device="cpu") -> Params:
    """Random weights from ``torch.Generator(seed)`` with the reference's
    init: N(0, 0.3/sqrt(fan_in)) weights, zero biases, unit norms."""
    g = torch.Generator().manual_seed(seed)
    tdim = cfg.time_dim

    def blocks(plan, sample):
        out = []
        for blk in plan:
            b = {"resnets": [_r_resnet(g, ci, blk["out"], tdim) for ci in blk["res_ins"]]}
            if blk["attn"]:
                b["attentions"] = [_r_transformer(g, blk["out"], cfg.cross_dim)
                                   for _ in blk["res_ins"]]
            if blk[sample]:
                b[sample] = _rc(g, 3, 3, blk["out"], blk["out"])
            out.append(b)
        return out

    down = blocks(_down_plan(cfg), "down")
    up = blocks(_up_plan(cfg), "up")
    mc = cfg.block_out[-1]
    tree = {
        "conv_in": _rc(g, 3, 3, cfg.in_channels, cfg.block_out[0]),
        "time1": _rl(g, cfg.block_out[0], tdim),
        "time2": _rl(g, tdim, tdim),
        "down": down,
        "mid": {"r0": _r_resnet(g, mc, mc, tdim),
                "attn": _r_transformer(g, mc, cfg.cross_dim),
                "r1": _r_resnet(g, mc, mc, tdim)},
        "up": up,
        "norm_out": _rn(cfg.block_out[0]),
        "conv_out": _rc(g, 3, 3, cfg.block_out[0], cfg.out_channels),
    }
    return prepare(tree, device, dtype)


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's U-Net tree (leaves as numpy arrays) -> the port's."""
    return prepare(tree_from_jax(tree), device, dtype)


# ---------------------------------------------------------------------------
# diffusers checkpoint conversion
# ---------------------------------------------------------------------------

def convert_torch_state_dict(sd: Dict[str, Any], cfg: UNetConfig = MUSETALK,
                             dtype=torch.bfloat16, device="cpu") -> Params:
    """diffusers UNet2DConditionModel state dict -> the port's tree."""
    def blocks(plan, kind, n_layers, sample):
        out = []
        for i, blk in enumerate(plan):
            p = f"{kind}_blocks.{i}"
            b = {"resnets": [t_resnet(sd, f"{p}.resnets.{j}", with_time=True)
                             for j in range(n_layers)]}
            if blk["attn"]:
                b["attentions"] = [t_transformer(sd, f"{p}.attentions.{j}") for j in range(n_layers)]
            if blk[sample]:
                b[sample] = t_conv(sd, f"{p}.{sample}samplers.0.conv")
            out.append(b)
        return out

    tree = {
        "conv_in": t_conv(sd, "conv_in"),
        "time1": t_lin(sd, "time_embedding.linear_1"),
        "time2": t_lin(sd, "time_embedding.linear_2"),
        "down": blocks(_down_plan(cfg), "down", cfg.layers_per_block, "down"),
        "mid": {"r0": t_resnet(sd, "mid_block.resnets.0", with_time=True),
                "attn": t_transformer(sd, "mid_block.attentions.0"),
                "r1": t_resnet(sd, "mid_block.resnets.1", with_time=True)},
        "up": blocks(_up_plan(cfg), "up", cfg.layers_per_block + 1, "up"),
        "norm_out": t_norm(sd, "conv_norm_out"),
        "conv_out": t_conv(sd, "conv_out"),
    }
    return prepare(tree, device, dtype)
