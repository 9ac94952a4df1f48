"""UNet2DConditionModel (SD1.x layout), MuseTalk's latent lip-sync network
(ports the bf16/f32 path of livetalking_tpu/models/sd_unet.py).

The reference's diffusers instantiation: in_channels 8 (masked || reference
latents), out_channels 4, block_out_channels (320, 640, 1280, 1280), 2
layers per block, cross_attention_dim 384 (Whisper features), 8 attention
heads, conv Transformer2D projections. MuseTalk runs ONE denoise step at
t=0. Every transformer's self-attention (16 per step at full width) runs
the ``csrc/attention.cu`` kernel on the card.

The W8A8 twin (``quantize_unet``, ``calibrate_unet``, ``apply_int8``)
quantizes every conv (and, with ``attn_int8``, the softmax-safe
transformer matmuls); its 3x3 stride-1 convs (49 per step at full width)
run kernel 4 of ``csrc/conv.cu`` on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from livetalking_tpu_torch.models.diffusion_blocks import (
    Params,
    conv,
    conv_q,
    count_params,
    fetch_scales,
    group_norm_silu,
    linear,
    prepare,
    quantize_conv,
    quantize_transformer,
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

__all__ = ["UNetConfig", "MUSETALK", "apply", "apply_int8", "quantize_unet",
           "calibrate_unet", "init_params", "params_from_jax", "convert_torch_state_dict",
           "count_params"]


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

    h = group_norm_silu(params["norm_out"], h, eps=cfg.norm_eps)
    return conv(params["conv_out"], h).float()


# ---------------------------------------------------------------------------
# W8A8 int8 twin
# ---------------------------------------------------------------------------

def _q_resnet(rp: Params) -> Params:
    out = {"norm1": rp["norm1"], "norm2": rp["norm2"],
           "conv1": quantize_conv(rp["conv1"]), "conv2": quantize_conv(rp["conv2"])}
    if "time_emb_proj" in rp:
        out["time_emb_proj"] = rp["time_emb_proj"]
    if "conv_shortcut" in rp:
        out["conv_shortcut"] = quantize_conv(rp["conv_shortcut"])
    return out


def _q_block(blk: Params, attn_int8: bool) -> Params:
    b: Params = {"resnets": [_q_resnet(rp) for rp in blk["resnets"]]}
    if "attentions" in blk:
        b["attentions"] = ([quantize_transformer(a) for a in blk["attentions"]]
                           if attn_int8 else blk["attentions"])
    for key in ("down", "up"):
        if key in blk:
            b[key] = quantize_conv(blk[key])
    return b


@torch.inference_mode()
def quantize_unet(params: Params, attn_int8: bool = True) -> Params:
    """One-time int8 conversion of every U-Net conv (norms and the time
    embedding stay model-dtype), on the weights' device. ``attn_int8`` also
    quantizes the softmax-safe transformer matmuls (their activation scales
    stay dynamic, so ``calibrate_unet`` has no sites there)."""
    return {
        "conv_in": quantize_conv(params["conv_in"]),
        "time1": params["time1"], "time2": params["time2"],
        "down": [_q_block(b, attn_int8) for b in params["down"]],
        "mid": {"r0": _q_resnet(params["mid"]["r0"]),
                "attn": (quantize_transformer(params["mid"]["attn"])
                         if attn_int8 else params["mid"]["attn"]),
                "r1": _q_resnet(params["mid"]["r1"])},
        "up": [_q_block(b, attn_int8) for b in params["up"]],
        "norm_out": params["norm_out"],
        "conv_out": quantize_conv(params["conv_out"]),
    }


def _walk_int8(pq: Params, cfg: UNetConfig, x: torch.Tensor, t: torch.Tensor,
               ctx: torch.Tensor, full: Optional[Params] = None,
               rec: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """The graph shared by ``apply_int8`` (``full`` None) and
    ``calibrate_unet``: with ``full`` (the full-precision tree) it runs the
    full-precision graph and appends each conv site's activation scale
    ``max|a| * 1.25 / 127 + 1e-8`` (a device scalar) to ``rec`` in walk
    order."""
    cal = full is not None
    pf = full if cal else pq

    def cq(site_q, site_f, xx, stride=1, padding=1):
        if cal:
            rec.append(xx.float().abs().amax() * 1.25 / 127.0 + 1e-8)
            return conv(site_f, xx, stride=stride, padding=padding)
        return conv_q(site_q, xx, stride=stride, padding=padding)

    def resnet(rq, rf, h_in):
        h = cq(rq["conv1"], rf["conv1"], group_norm_silu(rf["norm1"], h_in, eps=cfg.norm_eps))
        if "time_emb_proj" in rf:
            tproj = linear(rf["time_emb_proj"], silu(temb))
            h = h + tproj[:, None, None, :].to(h.dtype)
        h = cq(rq["conv2"], rf["conv2"], group_norm_silu(rf["norm2"], h, eps=cfg.norm_eps))
        sc = h_in
        if "conv_shortcut" in rf:
            sc = cq(rq["conv_shortcut"], rf["conv_shortcut"], h_in, padding=0)
        return sc + h

    temb = timestep_embedding(t, cfg.block_out[0])
    temb = linear(pf["time2"], silu(linear(pf["time1"], temb.to(x.dtype))))

    h = cq(pq["conv_in"], pf["conv_in"], x)
    skips: List[torch.Tensor] = [h]
    for bq, bf in zip(pq["down"], pf["down"]):
        for j, (rq, rf) in enumerate(zip(bq["resnets"], bf["resnets"])):
            h = resnet(rq, rf, h)
            if "attentions" in bf:
                h = transformer_2d(bf["attentions"][j], h, ctx, cfg.heads)
            skips.append(h)
        if "down" in bf:
            h = cq(bq["down"], bf["down"], h, stride=2)
            skips.append(h)

    h = resnet(pq["mid"]["r0"], pf["mid"]["r0"], h)
    h = transformer_2d(pf["mid"]["attn"], h, ctx, cfg.heads)
    h = resnet(pq["mid"]["r1"], pf["mid"]["r1"], h)

    for bq, bf in zip(pq["up"], pf["up"]):
        for j, (rq, rf) in enumerate(zip(bq["resnets"], bf["resnets"])):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = resnet(rq, rf, h)
            if "attentions" in bf:
                h = transformer_2d(bf["attentions"][j], h, ctx, cfg.heads)
        if "up" in bf:
            h = cq(bq["up"], bf["up"], upsample_nearest2x(h))

    a_out = group_norm_silu(pf["norm_out"], h, eps=cfg.norm_eps)
    return cq(pq["conv_out"], pf["conv_out"], a_out).float()


def apply_int8(params_q: Params, cfg: UNetConfig, x: torch.Tensor, t: torch.Tensor,
               ctx: torch.Tensor) -> torch.Tensor:
    """int8 twin of ``apply``; params from ``quantize_unet`` (+ calibrate)."""
    return _walk_int8(params_q, cfg, x, t, ctx)


@torch.inference_mode()
def calibrate_unet(params: Params, params_q: Params, cfg: UNetConfig, x: torch.Tensor,
                   t: torch.Tensor, ctx: torch.Tensor) -> Params:
    """Static activation scales from representative inputs: one
    full-precision walk collecting every conv site's scale on the device,
    one host copy, then the assignment in the walk's order (in place on
    ``params_q``, which is returned)."""
    rec: List[torch.Tensor] = []
    _walk_int8(params_q, cfg, x, t, ctx, full=params, rec=rec)
    scales = fetch_scales(rec, x.device)

    def assign_resnet(rq):
        rq["conv1"]["as"] = next(scales)
        rq["conv2"]["as"] = next(scales)
        if "conv_shortcut" in rq:
            rq["conv_shortcut"]["as"] = next(scales)

    params_q["conv_in"]["as"] = next(scales)
    for bq in params_q["down"]:
        for rq in bq["resnets"]:
            assign_resnet(rq)
        if "down" in bq:
            bq["down"]["as"] = next(scales)
    assign_resnet(params_q["mid"]["r0"])
    assign_resnet(params_q["mid"]["r1"])
    for bq in params_q["up"]:
        for rq in bq["resnets"]:
            assign_resnet(rq)
        if "up" in bq:
            bq["up"]["as"] = next(scales)
    params_q["conv_out"]["as"] = next(scales)
    leftover = sum(1 for _ in scales)
    assert leftover == 0, f"scale walk/assign mismatch: {leftover} extra"
    return params_q


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
