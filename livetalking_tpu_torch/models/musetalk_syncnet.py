"""MuseTalk's dedicated audio-visual SyncNet (the LatentSync "StableSyncNet"
lineage), the frozen sync expert of the MuseTalk recipe's ``musetalk``
backend (ports livetalking_tpu/models/musetalk_syncnet.py).

Two ``DownEncoder2D`` towers (audio and visual): ``conv_in``, a ladder of
ResnetBlock2D blocks, each optionally followed by an AttentionBlock2D,
then GroupNorm + ReLU, flattened (NCHW order) and L2-normalized. Every
shape comes from a ``SyncNetConfig``, built from the reference's yaml
layout by ``SyncNetConfig.from_dict``; ``MUSETALK`` is the working default
(16 lower-half 256 px frames, 48 channels, against a 52-column mel).

- ResnetBlock2D: GN-silu-conv3x3 twice, a 1x1 shortcut on a channel
  change, then a stride ``downsample_factor`` conv with asymmetric
  padding ((0, 1) on a strided axis, (1, 1) on an unstrided one).
- AttentionBlock2D: GN -> conv1x1 -> tokens; LN -> 8-head self-attention
  (biased q/k/v/out) residual; LN -> GEGLU feed-forward residual;
  conv1x1 -> + input. The self-attention is
  ``diffusion_blocks.attention``, so it runs kernel 3 on the card, and
  its backward when the expert's input carries a gradient.

Parameters are the SD blocks' dictionaries (``models/diffusion_blocks.py``:
conv ``w`` (O, I, kh, kw), linear ``w`` (out, in)); NHWC activations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from livetalking_tpu_torch.models.diffusion_blocks import (
    Params,
    attention,
    conv,
    conv_asym,
    geglu_ff,
    group_norm,
    layer_norm,
    prepare,
    silu,
    t_conv,
    t_lin,
    t_norm,
    tree_from_jax,
)

Factor = Union[int, Tuple[int, int]]
HEADS = 8
FRAMES = 16  # the expert scores 16-frame clips


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    in_channels: int
    block_out: Tuple[int, ...]
    downsample_factors: Tuple[Factor, ...]
    attn_blocks: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class SyncNetConfig:
    audio: EncoderConfig
    visual: EncoderConfig

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SyncNetConfig":
        """The reference yaml layout: {"audio_encoder": {...}, "visual_encoder": {...}}."""

        def enc(e):
            return EncoderConfig(
                in_channels=int(e["in_channels"]),
                block_out=tuple(e["block_out_channels"]),
                downsample_factors=tuple(tuple(f) if isinstance(f, (list, tuple)) else int(f)
                                         for f in e["downsample_factors"]),
                attn_blocks=tuple(e["attn_blocks"]))

        return SyncNetConfig(audio=enc(d["audio_encoder"]), visual=enc(d["visual_encoder"]))


# 16 consecutive lower-half 256 px frames (48 ch, 128x256) against the
# clip's 52-column mel window; both ladders end at (1, 1, C)
MUSETALK = SyncNetConfig(
    audio=EncoderConfig(in_channels=1, block_out=(32, 64, 128, 256, 512, 1024),
                        downsample_factors=(2, 2, 2, 2, (5, 3), 1),
                        attn_blocks=(0, 0, 0, 0, 0, 0)),
    visual=EncoderConfig(in_channels=48, block_out=(64, 128, 256, 256, 512, 512, 1024, 1024),
                         downsample_factors=(2, 2, 2, 2, 2, 2, 2, (1, 2)),
                         attn_blocks=(0, 0, 0, 1, 1, 0, 0, 0)),
)


def _pads(f: Factor):
    """(stride, ((top, bottom), (left, right))) of a downsample factor."""
    fh, fw = (f, f) if isinstance(f, int) else f
    return (fh, fw), ((1, 1) if fh == 1 else (0, 1), (1, 1) if fw == 1 else (0, 1))


def _resnet(p: Params, x: torch.Tensor, factor: Factor) -> torch.Tensor:
    h = conv(p["conv1"], silu(group_norm(p["norm1"], x)))
    h = conv(p["conv2"], silu(group_norm(p["norm2"], h)))
    if "conv_shortcut" in p:
        x = conv(p["conv_shortcut"], x, padding=0)
    h = x + h
    if "downsample_conv" in p:
        stride, pad = _pads(factor)
        h = conv_asym(p["downsample_conv"], h, stride, pad)
    return h


def _attn_block(p: Params, x: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    h = conv(p["conv_in"], group_norm(p["norm1"], x), padding=0).reshape(B, H * W, C)
    h = attention(p["attn"], layer_norm(p["norm2"], h), None, HEADS) + h
    h = geglu_ff(p["ff"], layer_norm(p["norm3"], h)) + h
    h = conv(p["conv_out"], h.reshape(B, H, W, C), padding=0)
    return h + x


def _encoder(p: Params, cfg: EncoderConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, in_ch) -> (B, D) L2-normalized embedding."""
    h = conv(p["conv_in"], x)
    i = 0
    for factor, has_attn in zip(cfg.downsample_factors, cfg.attn_blocks):
        h = _resnet(p["down_blocks"][i], h, factor)
        i += 1
        if has_attn:
            h = _attn_block(p["down_blocks"][i], h)
            i += 1
    h = torch.relu(group_norm(p["norm_out"], h))
    e = h.permute(0, 3, 1, 2).reshape(h.shape[0], -1).float()  # NCHW order, as the reference
    return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True).clamp(min=1e-12)


def apply(params: Params, faces: torch.Tensor, audio: torch.Tensor,
          cfg: SyncNetConfig = MUSETALK):
    """faces (B, H, W, 3*FRAMES) in [0, 1]; audio (B, Ha, Wa, in_ch) mel.
    -> (vision_embeds, audio_embeds), both (B, D) unit vectors."""
    return (_encoder(params["visual_encoder"], cfg.visual, faces),
            _encoder(params["audio_encoder"], cfg.audio, audio))


def cosine_bce_loss(v_emb: torch.Tensor, a_emb: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """BCE on (cos + 1) / 2."""
    cos = (v_emb * a_emb).sum(-1)
    p = torch.clamp((cos + 1.0) * 0.5, 1e-7, 1.0 - 1e-7)
    labels = labels.float()
    return -torch.mean(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))


# ---------------------------------------------------------------------------
# init and conversion
# ---------------------------------------------------------------------------

def _rc(g, kh, kw, ci, co, scale=0.4):
    return {"w": torch.randn((co, ci, kh, kw), generator=g) * (scale / (kh * kw * ci) ** 0.5),
            "b": torch.zeros(co)}


def _rn(c):
    return {"g": torch.ones(c), "b": torch.zeros(c)}


def _rl(g, i, o, scale=0.4):
    return {"w": torch.randn((o, i), generator=g) * (scale / i ** 0.5), "b": torch.zeros(o)}


def _init_encoder(g, cfg: EncoderConfig) -> Params:
    blocks = []
    cin = cfg.block_out[0]
    conv_in = _rc(g, 3, 3, cfg.in_channels, cfg.block_out[0])
    for cout, factor, has_attn in zip(cfg.block_out, cfg.downsample_factors, cfg.attn_blocks):
        blk = {"norm1": _rn(cin), "conv1": _rc(g, 3, 3, cin, cout), "norm2": _rn(cout),
               "conv2": _rc(g, 3, 3, cout, cout)}
        if cin != cout:
            blk["conv_shortcut"] = _rc(g, 1, 1, cin, cout)
        if _pads(factor)[0] != (1, 1):
            blk["downsample_conv"] = _rc(g, 3, 3, cout, cout)
        blocks.append(blk)
        if has_attn:
            blocks.append({
                "norm1": _rn(cout), "conv_in": _rc(g, 1, 1, cout, cout), "norm2": _rn(cout),
                "attn": {n: _rl(g, cout, cout) for n in ("q", "k", "v", "o")},
                "norm3": _rn(cout),
                "ff": {"proj": _rl(g, cout, 8 * cout), "out": _rl(g, 4 * cout, cout)},
                "conv_out": _rc(g, 1, 1, cout, cout)})
        cin = cout
    return {"conv_in": conv_in, "down_blocks": blocks, "norm_out": _rn(cfg.block_out[-1])}


def init_params(seed: int = 0, cfg: SyncNetConfig = MUSETALK, dtype=torch.float32,
                device="cpu") -> Params:
    """Random weights from ``torch.Generator(seed)``."""
    g = torch.Generator().manual_seed(seed)
    tree = {"audio_encoder": _init_encoder(g, cfg.audio),
            "visual_encoder": _init_encoder(g, cfg.visual)}
    return prepare(tree, device, dtype)


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's tree (HWIO convs, (in, out) linears) -> the port's."""
    return prepare(tree_from_jax(tree), device, dtype)


def convert_torch_state_dict(sd: Dict[str, Any], cfg: SyncNetConfig = MUSETALK,
                             dtype=torch.float32, device="cpu") -> Params:
    """The reference checkpoint (``{"state_dict": ...}`` or the bare dict,
    keys with or without a ``module.`` prefix) -> the port's tree. Resnet
    and attention blocks are told apart by their keys, as the interleaved
    ``down_blocks`` list holds them."""
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}

    def enc(prefix: str) -> Params:
        blocks = []
        i = 0
        while (f"{prefix}.down_blocks.{i}.conv1.weight" in sd
               or f"{prefix}.down_blocks.{i}.attn.to_q.weight" in sd):
            b = f"{prefix}.down_blocks.{i}"
            if f"{b}.conv1.weight" in sd:  # ResnetBlock2D
                blk = {"norm1": t_norm(sd, f"{b}.norm1"), "conv1": t_conv(sd, f"{b}.conv1"),
                       "norm2": t_norm(sd, f"{b}.norm2"), "conv2": t_conv(sd, f"{b}.conv2")}
                for name in ("conv_shortcut", "downsample_conv"):
                    if f"{b}.{name}.weight" in sd:
                        blk[name] = t_conv(sd, f"{b}.{name}")
            else:  # AttentionBlock2D
                blk = {"norm1": t_norm(sd, f"{b}.norm1"), "conv_in": t_conv(sd, f"{b}.conv_in"),
                       "norm2": t_norm(sd, f"{b}.norm2"),
                       "attn": {"q": t_lin(sd, f"{b}.attn.to_q"),
                                "k": t_lin(sd, f"{b}.attn.to_k"),
                                "v": t_lin(sd, f"{b}.attn.to_v"),
                                "o": t_lin(sd, f"{b}.attn.to_out.0")},
                       "norm3": t_norm(sd, f"{b}.norm3"),
                       "ff": {"proj": t_lin(sd, f"{b}.ff.net.0.proj"),
                              "out": t_lin(sd, f"{b}.ff.net.2")},
                       "conv_out": t_conv(sd, f"{b}.conv_out")}
            blocks.append(blk)
            i += 1
        return {"conv_in": t_conv(sd, f"{prefix}.conv_in"), "down_blocks": blocks,
                "norm_out": t_norm(sd, f"{prefix}.norm_out")}

    return prepare({"audio_encoder": enc("audio_encoder"),
                    "visual_encoder": enc("visual_encoder")}, device, dtype)
