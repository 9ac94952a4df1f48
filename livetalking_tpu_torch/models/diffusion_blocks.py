"""Functional blocks of the Stable-Diffusion-family models MuseTalk uses,
AutoencoderKL and UNet2DConditionModel (ports the bf16/f32 half of
livetalking_tpu/models/diffusion_blocks.py).

Activations are NHWC at every public function, as in the reference; a
convolution views its NHWC input as a channels-last NCHW tensor (no copy)
and runs ``F.conv2d`` on it. Parameters are nested dictionaries in the
reference's tree structure with PyTorch leaf layouts: conv ``w``
(O, I, kh, kw), linear ``w`` (out, in), norm ``g``/``b``. GroupNorm,
LayerNorm and softmax run in f32; ``linear`` and ``layer_norm`` are the
shared primitives of ``models/layers.py``.

Self-attention (``attention`` with ``ctx=None``, and the VAE's
``spatial_attention``) goes through ``ops.attention.attention``, the
kernel's wrapper. Cross-attention over the 50 Whisper tokens keeps its own
two matmuls and f32 softmax here, as the reference keeps it outside any
kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.models.layers import layer_norm_f32 as layer_norm
from livetalking_tpu_torch.models.layers import linear_f32 as linear
from livetalking_tpu_torch.models.layers import to_numpy
from livetalking_tpu_torch.ops.attention import attention as attention_kernel

Params = Dict[str, Any]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def group_norm(p: Params, x: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """x (B, H, W, C); normalize per group over (H, W, C/groups).

    The reference's arithmetic: per-channel f32 spatial moments, combined
    into group moments, variance E[x^2] - E[x]^2 clamped at 0 before the
    rsqrt, then one per-(B, C) scale and shift."""
    B, H, W, C = x.shape
    n = H * W * (C // groups)
    xf = x.float()
    s1 = xf.sum(dim=(1, 2))                      # (B, C)
    s2 = (xf * xf).sum(dim=(1, 2))               # (B, C)
    g1 = s1.reshape(B, groups, C // groups).sum(-1)
    g2 = s2.reshape(B, groups, C // groups).sum(-1)
    mu = g1 / n
    var = (g2 / n - mu * mu).clamp(min=0.0)
    inv = torch.rsqrt(var + eps)
    mu_c = mu.repeat_interleave(C // groups, dim=-1)
    inv_c = inv.repeat_interleave(C // groups, dim=-1)
    scale = inv_c * p["g"].float()[None]
    shift = p["b"].float()[None] - mu_c * scale
    y = xf * scale[:, None, None, :] + shift[:, None, None, :]
    return y.to(x.dtype)


def conv(p: Params, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    y = F.conv2d(_nchw(x), p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride,
                 padding=padding)
    return _nhwc(y)


def conv_asym(p: Params, x: torch.Tensor, stride: int, pad) -> torch.Tensor:
    """Conv with per-side padding ((top, bottom), (left, right)); the VAE
    downsampler pads (0, 1, 0, 1)."""
    (top, bottom), (left, right) = pad
    xp = F.pad(_nchw(x), (left, right, top, bottom))
    return _nhwc(F.conv2d(xp, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride))


def resnet_block(p: Params, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                 eps: float = 1e-6) -> torch.Tensor:
    """diffusers ResnetBlock2D: GN-silu-conv (+temb) GN-silu-conv + shortcut."""
    h = conv(p["conv1"], silu(group_norm(p["norm1"], x, eps=eps)))
    if temb is not None and "time_emb_proj" in p:
        t = linear(p["time_emb_proj"], silu(temb))  # (B, C)
        h = h + t[:, None, None, :].to(h.dtype)
    h = conv(p["conv2"], silu(group_norm(p["norm2"], h, eps=eps)))
    if "conv_shortcut" in p:
        x = conv(p["conv_shortcut"], x, padding=0)
    return x + h


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, C) -> contiguous (B, heads, T, C/heads)."""
    B, T, C = t.shape
    return t.reshape(B, T, heads, C // heads).transpose(1, 2).contiguous()


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    B, H, T, D = o.shape
    return o.transpose(1, 2).reshape(B, T, H * D)


def spatial_attention(p: Params, x: torch.Tensor, heads: int = 1, eps: float = 1e-6) -> torch.Tensor:
    """VAE mid-block attention: GN -> self-attention over H*W -> +res."""
    B, H, W, C = x.shape
    h = group_norm(p["group_norm"], x, eps=eps).reshape(B, H * W, C)
    q, k, v = linear(p["q"], h), linear(p["k"], h), linear(p["v"], h)
    hd = C // heads
    o = attention_kernel(_split_heads(q, heads), _split_heads(k, heads),
                         _split_heads(v, heads), hd ** -0.5)
    return x + linear(p["o"], _merge_heads(o)).reshape(B, H, W, C)


def attention(p: Params, x: torch.Tensor, ctx: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """BasicTransformerBlock attention (to_q/k/v without bias, to_out
    with). x (B, T, C); ctx (B, S, D) for cross-attention, else self."""
    B, T, C = x.shape
    kv_src = x if ctx is None else ctx
    q = _split_heads(linear(p["q"], x), heads)
    k = _split_heads(linear(p["k"], kv_src), heads)
    v = _split_heads(linear(p["v"], kv_src), heads)
    scale = (C // heads) ** -0.5
    if ctx is None:
        o = attention_kernel(q, k, v, scale)
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        a = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.matmul(a, v).to(q.dtype)
    return linear(p["o"], _merge_heads(o))


def geglu_ff(p: Params, x: torch.Tensor) -> torch.Tensor:
    """diffusers FeedForward with GEGLU: proj to 2*inner, x * gelu(gate)."""
    h = linear(p["proj"], x)
    a, gate = h.chunk(2, dim=-1)
    h = a * F.gelu(gate.float()).to(a.dtype)
    return linear(p["out"], h)


def transformer_2d(p: Params, x: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
    """diffusers Transformer2DModel with one BasicTransformerBlock and conv
    projections (SD1.x, use_linear_projection=False)."""
    B, H, W, C = x.shape
    res = x
    h = group_norm(p["norm"], x, eps=1e-6)
    h = conv(p["proj_in"], h, padding=0).reshape(B, H * W, C)
    tb = p["block"]
    h = h + attention(tb["attn1"], layer_norm(tb["norm1"], h), None, heads)
    h = h + attention(tb["attn2"], layer_norm(tb["norm2"], h), ctx, heads)
    h = h + geglu_ff(tb["ff"], layer_norm(tb["norm3"], h))
    h = conv(p["proj_out"], h.reshape(B, H, W, C), padding=0)
    return h + res


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return _nhwc(F.interpolate(_nchw(x), scale_factor=2, mode="nearest"))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers get_timestep_embedding, flip_sin_to_cos=True,
    downscale_freq_shift=0 (SD1.x): [cos | sin], f32."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


# -- parameter trees ---------------------------------------------------------

def tree_from_jax(tree, dtype=torch.float32, device="cpu"):
    """The JAX package's SD parameter tree (leaves as numpy arrays) -> the
    port's: conv HWIO -> (O, I, kh, kw), linear (in, out) -> (out, in)."""
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            if key == "w" and val is not None:
                w = np.asarray(val, np.float32)
                w = w.transpose(3, 2, 0, 1) if w.ndim == 4 else w.T
                out[key] = _tensor(w, dtype, device)
            else:
                out[key] = tree_from_jax(val, dtype, device)
        return out
    if isinstance(tree, (list, tuple)):
        return [tree_from_jax(v, dtype, device) for v in tree]
    if tree is None:
        return None
    return _tensor(tree, dtype, device)


def prepare(tree, device, dtype: torch.dtype):
    """Every tensor of the tree onto ``device`` in ``dtype``; 4-D conv
    weights in channels-last memory (cuDNN's fast layout for NHWC
    activations)."""
    if isinstance(tree, dict):
        return {k: prepare(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [prepare(v, device, dtype) for v in tree]
    if tree is None:
        return None
    t = tree.to(device=device, dtype=dtype)
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t


def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(count_params(v) for v in tree)
    return 0 if tree is None else int(tree.numel())


# -- converter helpers (diffusers state dict -> the port's tree, f32) --------

def _tensor(a, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.from_numpy(np.array(to_numpy(a), np.float32)).to(device=device, dtype=dtype)


def t_conv(sd, prefix):
    return {"w": _tensor(sd[f"{prefix}.weight"]), "b": _tensor(sd[f"{prefix}.bias"])}


def t_lin(sd, prefix, bias=True):
    p = {"w": _tensor(sd[f"{prefix}.weight"])}
    p["b"] = _tensor(sd[f"{prefix}.bias"]) if bias and f"{prefix}.bias" in sd else None
    return p


def t_norm(sd, prefix):
    return {"g": _tensor(sd[f"{prefix}.weight"]), "b": _tensor(sd[f"{prefix}.bias"])}


def t_resnet(sd, prefix, with_time=False):
    p = {
        "norm1": t_norm(sd, f"{prefix}.norm1"),
        "conv1": t_conv(sd, f"{prefix}.conv1"),
        "norm2": t_norm(sd, f"{prefix}.norm2"),
        "conv2": t_conv(sd, f"{prefix}.conv2"),
    }
    if with_time and f"{prefix}.time_emb_proj.weight" in sd:
        p["time_emb_proj"] = t_lin(sd, f"{prefix}.time_emb_proj")
    if f"{prefix}.conv_shortcut.weight" in sd:
        p["conv_shortcut"] = t_conv(sd, f"{prefix}.conv_shortcut")
    return p


def t_spatial_attn(sd, prefix):
    """VAE mid attention; the modern (to_q/...) and the legacy
    (query/key/value/proj_attn) diffusers key layouts."""
    modern = f"{prefix}.to_q.weight" in sd
    names = ("to_q", "to_k", "to_v", "to_out.0") if modern else ("query", "key", "value", "proj_attn")
    return {
        "group_norm": t_norm(sd, f"{prefix}.group_norm"),
        "q": t_lin(sd, f"{prefix}.{names[0]}"),
        "k": t_lin(sd, f"{prefix}.{names[1]}"),
        "v": t_lin(sd, f"{prefix}.{names[2]}"),
        "o": t_lin(sd, f"{prefix}.{names[3]}"),
    }


def t_transformer(sd, prefix):
    tb = f"{prefix}.transformer_blocks.0"

    def attn(name):
        return {
            "q": t_lin(sd, f"{tb}.{name}.to_q", bias=False),
            "k": t_lin(sd, f"{tb}.{name}.to_k", bias=False),
            "v": t_lin(sd, f"{tb}.{name}.to_v", bias=False),
            "o": t_lin(sd, f"{tb}.{name}.to_out.0"),
        }

    return {
        "norm": t_norm(sd, f"{prefix}.norm"),
        "proj_in": t_conv(sd, f"{prefix}.proj_in"),
        "proj_out": t_conv(sd, f"{prefix}.proj_out"),
        "block": {
            "norm1": t_norm(sd, f"{tb}.norm1"),
            "attn1": attn("attn1"),
            "norm2": t_norm(sd, f"{tb}.norm2"),
            "attn2": attn("attn2"),
            "norm3": t_norm(sd, f"{tb}.norm3"),
            "ff": {
                "proj": t_lin(sd, f"{tb}.ff.net.0.proj"),
                "out": t_lin(sd, f"{tb}.ff.net.2"),
            },
        },
    }
