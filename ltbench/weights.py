"""Random weights from the seed, in the published checkpoint layouts.

``state_dicts(cfg, seed, device, dtype)`` returns ``{"whisper", "unet",
"vae"}``: an HF ``WhisperModel`` encoder state dict, a diffusers
``UNet2DConditionModel`` one (MuseTalk's ``unet.pth``) and a diffusers
``AutoencoderKL`` one (sd-vae-ft-mse, with its legacy mid-attention key
names), at the widths of the configuration file. All random leaves come
from one ``torch.Generator`` on ``device``, in one draw in the served
dtype, then scaled per leaf: weights N(0, (gain / sqrt(fan_in))^2) with the
gains the program's own random initialisation uses (0.3 for the U-Net and
the VAE, 1 for Whisper's linears, an absolute 0.02 for its convs), biases
N(0, 0.01^2), norms 1 + N(0, 0.01^2) and N(0, 0.01^2). Whisper's position
table is its fixed sinusoid. The program and the reference receive the same
tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = Tuple[str, tuple, str, float]  # key, shape, kind, gain


def _lin(specs, name, o, i, bias=True, gain=1.0):
    specs.append((name + ".weight", (o, i), "w", gain))
    if bias:
        specs.append((name + ".bias", (o,), "b", 0.0))


def _conv(specs, name, o, i, k, gain=0.3):
    specs.append((name + ".weight", (o, i, k, k), "w", gain))
    specs.append((name + ".bias", (o,), "b", 0.0))


def _norm(specs, name, c):
    specs.append((name + ".weight", (c,), "g", 0.0))
    specs.append((name + ".bias", (c,), "b", 0.0))


def whisper_specs(w: dict) -> List[Spec]:
    D, F_, L = w["d_model"], w["encoder_ffn_dim"], w["encoder_layers"]
    s: List[Spec] = [("encoder.conv1.weight", (D, w["num_mel_bins"], 3), "abs", 0.02),
                     ("encoder.conv1.bias", (D,), "b", 0.0),
                     ("encoder.conv2.weight", (D, D, 3), "abs", 0.02),
                     ("encoder.conv2.bias", (D,), "b", 0.0),
                     ("encoder.embed_positions.weight", (w["max_source_positions"], D), "pos", 0.0)]
    for i in range(L):
        p = f"encoder.layers.{i}"
        _lin(s, p + ".self_attn.q_proj", D, D)
        _lin(s, p + ".self_attn.k_proj", D, D, bias=False)
        _lin(s, p + ".self_attn.v_proj", D, D)
        _lin(s, p + ".self_attn.out_proj", D, D)
        _norm(s, p + ".self_attn_layer_norm", D)
        _lin(s, p + ".fc1", F_, D)
        _lin(s, p + ".fc2", D, F_)
        _norm(s, p + ".final_layer_norm", D)
    _norm(s, "encoder.layer_norm", D)
    return s


def _resnet(s, p, cin, cout, tdim=None):
    _norm(s, p + ".norm1", cin)
    _conv(s, p + ".conv1", cout, cin, 3)
    if tdim:
        _lin(s, p + ".time_emb_proj", cout, tdim, gain=0.3)
    _norm(s, p + ".norm2", cout)
    _conv(s, p + ".conv2", cout, cout, 3)
    if cin != cout:
        _conv(s, p + ".conv_shortcut", cout, cin, 1)


def _transformer(s, p, c, cross):
    _norm(s, p + ".norm", c)
    _conv(s, p + ".proj_in", c, c, 1)
    tb = p + ".transformer_blocks.0"
    for a, kv in (("attn1", c), ("attn2", cross)):
        _norm(s, f"{tb}.norm{a[-1]}", c)
        _lin(s, f"{tb}.{a}.to_q", c, c, bias=False, gain=0.3)
        _lin(s, f"{tb}.{a}.to_k", c, kv, bias=False, gain=0.3)
        _lin(s, f"{tb}.{a}.to_v", c, kv, bias=False, gain=0.3)
        _lin(s, f"{tb}.{a}.to_out.0", c, c, gain=0.3)
    _norm(s, tb + ".norm3", c)
    _lin(s, tb + ".ff.net.0.proj", 8 * c, c, gain=0.3)
    _lin(s, tb + ".ff.net.2", c, 4 * c, gain=0.3)
    _conv(s, p + ".proj_out", c, c, 1)


def unet_specs(u: dict) -> List[Spec]:
    ch, L = list(u["block_out_channels"]), u["layers_per_block"]
    cross, tdim = u["cross_attention_dim"], 4 * ch[0]
    s: List[Spec] = []
    _conv(s, "conv_in", ch[0], u["in_channels"], 3)
    _lin(s, "time_embedding.linear_1", tdim, ch[0], gain=0.3)
    _lin(s, "time_embedding.linear_2", tdim, tdim, gain=0.3)
    skips, cin = [ch[0]], ch[0]
    for i, kind in enumerate(u["down_block_types"]):
        for j in range(L):
            _resnet(s, f"down_blocks.{i}.resnets.{j}", cin if j == 0 else ch[i], ch[i], tdim)
            if kind.startswith("CrossAttn"):
                _transformer(s, f"down_blocks.{i}.attentions.{j}", ch[i], cross)
            skips.append(ch[i])
        if i < len(ch) - 1:
            _conv(s, f"down_blocks.{i}.downsamplers.0.conv", ch[i], ch[i], 3)
            skips.append(ch[i])
        cin = ch[i]
    _resnet(s, "mid_block.resnets.0", ch[-1], ch[-1], tdim)
    _transformer(s, "mid_block.attentions.0", ch[-1], cross)
    _resnet(s, "mid_block.resnets.1", ch[-1], ch[-1], tdim)
    rev, prev = ch[::-1], ch[-1]
    for i, kind in enumerate(u["up_block_types"]):
        for j in range(L + 1):
            _resnet(s, f"up_blocks.{i}.resnets.{j}", prev + skips.pop(), rev[i], tdim)
            prev = rev[i]
            if kind.startswith("CrossAttn"):
                _transformer(s, f"up_blocks.{i}.attentions.{j}", rev[i], cross)
        if i < len(rev) - 1:
            _conv(s, f"up_blocks.{i}.upsamplers.0.conv", rev[i], rev[i], 3)
    _norm(s, "conv_norm_out", ch[0])
    _conv(s, "conv_out", u["out_channels"], ch[0], 3)
    return s


def vae_specs(v: dict) -> List[Spec]:
    ch, L, lat = list(v["block_out_channels"]), v["layers_per_block"], v["latent_channels"]
    s: List[Spec] = []
    _conv(s, "encoder.conv_in", ch[0], v["in_channels"], 3)
    cin = ch[0]
    for i, c in enumerate(ch):
        for j in range(L):
            _resnet(s, f"encoder.down_blocks.{i}.resnets.{j}", cin if j == 0 else c, c)
        if i < len(ch) - 1:
            _conv(s, f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c, 3)
        cin = c

    def mid(p, c):
        _resnet(s, p + ".resnets.0", c, c)
        _norm(s, p + ".attentions.0.group_norm", c)
        for n in ("query", "key", "value", "proj_attn"):
            _lin(s, f"{p}.attentions.0.{n}", c, c, gain=0.3)
        _resnet(s, p + ".resnets.1", c, c)

    mid("encoder.mid_block", ch[-1])
    _norm(s, "encoder.conv_norm_out", ch[-1])
    _conv(s, "encoder.conv_out", 2 * lat, ch[-1], 3)
    _conv(s, "quant_conv", 2 * lat, 2 * lat, 1)
    _conv(s, "post_quant_conv", lat, lat, 1)
    _conv(s, "decoder.conv_in", ch[-1], lat, 3)
    mid("decoder.mid_block", ch[-1])
    rev, cin = ch[::-1], ch[-1]
    for i, c in enumerate(rev):
        for j in range(L + 1):
            _resnet(s, f"decoder.up_blocks.{i}.resnets.{j}", cin if j == 0 else c, c)
        if i < len(rev) - 1:
            _conv(s, f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c, 3)
        cin = c
    _norm(s, "decoder.conv_norm_out", ch[0])
    _conv(s, "decoder.conv_out", v["out_channels"], ch[0], 3)
    return s


def whisper_positions(n: int, d: int) -> np.ndarray:
    """Whisper's sinusoid: sin | cos over log-spaced timescales."""
    inc = math.log(10000.0) / (d // 2 - 1)
    inv = np.exp(-inc * np.arange(d // 2))
    t = np.arange(n)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _fill(specs: List[Spec], seed: int, salt: int, device, dtype) -> Dict[str, torch.Tensor]:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + salt) % (2 ** 63))
    sizes = [int(np.prod(shape)) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=dtype)
    out, off = {}, 0
    for (key, shape, kind, gain), n in zip(specs, sizes):
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "w":
            t.mul_(gain / math.sqrt(n // shape[0]))
        elif kind == "abs":
            t.mul_(gain)
        elif kind == "g":
            t.mul_(0.01).add_(1.0)
        elif kind == "b":
            t.mul_(0.01)
        else:  # "pos"
            t.copy_(torch.from_numpy(whisper_positions(*shape)))
        out[key] = t
    return out


def state_dicts(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Dict]:
    """The three state dicts of ``cfg`` (a configuration file's contents)."""
    return {"whisper": _fill(whisper_specs(cfg["whisper"]), seed, 1, device, dtype),
            "unet": _fill(unet_specs(cfg["unet"]), seed, 2, device, dtype),
            "vae": _fill(vae_specs(cfg["vae"]), seed, 3, device, dtype)}
