"""Functional blocks of the Stable-Diffusion-family models MuseTalk uses,
AutoencoderKL and UNet2DConditionModel (ports
livetalking_tpu/models/diffusion_blocks.py).

Activations are NHWC at every public function, as in the reference; a
convolution views its NHWC input as a channels-last NCHW tensor (no copy)
and runs ``F.conv2d`` on it. Parameters are nested dictionaries in the
reference's tree structure with PyTorch leaf layouts: conv ``w``
(O, I, kh, kw), linear ``w`` (out, in), norm ``g``/``b``. GroupNorm,
LayerNorm and softmax run in f32; ``linear`` and ``layer_norm`` are the
shared primitives of ``models/layers.py``. ``group_norm`` and
``group_norm_silu`` (a GroupNorm followed by SiLU) run kernel 6
(``ops.norm.group_norm``) on a CUDA bf16 tensor when no gradient is
recorded, the same arithmetic in plain PyTorch otherwise.

Self-attention (``attention`` with ``ctx=None``, and the VAE's
``spatial_attention``) goes through ``ops.attention.attention``, the
kernel's wrapper. Cross-attention over the 50 Whisper tokens keeps its own
two matmuls and f32 softmax here, as the reference keeps it outside any
kernel.

The W8A8 int8 half (``quantize_conv``, ``conv_q``, ``quantize_linear``,
``linear_q``, ``quantize_transformer``) keeps the reference's order of
operations: quantize ``clip(round(x.float() / sx), -127, 127)`` with a
static (``as``) or dynamic (abs-max / 127) activation scale, exact integer
sums, dequantize ``acc * (sx * ws) + b`` in f32, cast to ``x.dtype``, then
add a residual in ``x.dtype``. 3x3 stride-1 convs run kernel 4
(``ops.conv.conv3x3_q``) on the card; 1x1 and stride-2 convs and the
linears run the exact int8 GEMM ``ops.conv.int8_matmul``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.models.layers import layer_norm_f32 as layer_norm
from livetalking_tpu_torch.models.layers import linear_f32 as linear
from livetalking_tpu_torch.models.layers import to_numpy
from livetalking_tpu_torch.ops import norm as norm_ops
from livetalking_tpu_torch.ops.attention import attention as attention_kernel
from livetalking_tpu_torch.ops.conv import CHANNEL_MULTIPLE, conv3x3_q, int8_matmul
from livetalking_tpu_torch.parallel.tp import gather_conv_output

Params = Dict[str, Any]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x.float()).to(x.dtype)


def _norm(p: Params, x: torch.Tensor, groups: int, eps: float, silu: bool) -> torch.Tensor:
    """GroupNorm (then SiLU) on the kernel of ``ops/norm.py`` for a CUDA
    bf16 x when no gradient is recorded; the plain version otherwise."""
    records_grad = torch.is_grad_enabled() and (
        x.requires_grad or p["g"].requires_grad or p["b"].requires_grad)
    if norm_ops.routes_to_kernel(x.device.type, x.dtype, records_grad):
        return norm_ops.group_norm(x, p["g"], p["b"], groups, eps, silu=silu)
    return norm_ops.group_norm_plain(x, p["g"], p["b"], groups, eps, silu=silu)


def group_norm(p: Params, x: torch.Tensor, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """x (B, H, W, C); normalize per group over (H, W, C/groups).

    The reference's arithmetic (``ops.norm.group_norm_plain``): per-channel
    f32 spatial moments, combined into group moments, variance E[x^2] -
    E[x]^2 clamped at 0 before the rsqrt, then one per-(B, C) scale and
    shift."""
    return _norm(p, x, groups, eps, silu=False)


def group_norm_silu(p: Params, x: torch.Tensor, groups: int = 32,
                    eps: float = 1e-6) -> torch.Tensor:
    """``silu(group_norm(p, x))`` with the same two roundings, in one
    kernel pair on the card."""
    return _norm(p, x, groups, eps, silu=True)


def conv(p: Params, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """NHWC conv; a tp-sharded node (``parallel.tp.TPConv``) computes its
    output channels and gathers the rest over the tp group."""
    y = F.conv2d(_nchw(x), p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride,
                 padding=padding)
    return gather_conv_output(p, _nhwc(y))


def conv_asym(p: Params, x: torch.Tensor, stride: int, pad) -> torch.Tensor:
    """Conv with per-side padding ((top, bottom), (left, right)); the VAE
    downsampler pads (0, 1, 0, 1). tp-sharded nodes as in ``conv``."""
    (top, bottom), (left, right) = pad
    xp = F.pad(_nchw(x), (left, right, top, bottom))
    y = F.conv2d(xp, p["w"].to(x.dtype), p["b"].to(x.dtype), stride=stride)
    return gather_conv_output(p, _nhwc(y))


def resnet_block(p: Params, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                 eps: float = 1e-6) -> torch.Tensor:
    """diffusers ResnetBlock2D: GN-silu-conv (+temb) GN-silu-conv + shortcut."""
    h = conv(p["conv1"], group_norm_silu(p["norm1"], x, eps=eps))
    if temb is not None and "time_emb_proj" in p:
        t = linear(p["time_emb_proj"], silu(temb))  # (B, C)
        h = h + t[:, None, None, :].to(h.dtype)
    h = conv(p["conv2"], group_norm_silu(p["norm2"], h, eps=eps))
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
    q = _split_heads(_lin(p["q"], x), heads)
    k = _split_heads(_lin(p["k"], kv_src), heads)
    v = _split_heads(_lin(p["v"], kv_src), heads)
    scale = (C // heads) ** -0.5
    if ctx is None:
        o = attention_kernel(q, k, v, scale)
    else:
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        a = torch.softmax(s, dim=-1).to(q.dtype)
        o = torch.matmul(a, v).to(q.dtype)
    return _lin(p["o"], _merge_heads(o))


def geglu_ff(p: Params, x: torch.Tensor) -> torch.Tensor:
    """diffusers FeedForward with GEGLU: proj to 2*inner, x * gelu(gate)."""
    h = _lin(p["proj"], x)
    a, gate = h.chunk(2, dim=-1)
    h = a * F.gelu(gate.float()).to(a.dtype)
    return _lin(p["out"], h)


def transformer_2d(p: Params, x: torch.Tensor, ctx: torch.Tensor, heads: int) -> torch.Tensor:
    """diffusers Transformer2DModel with one BasicTransformerBlock and conv
    projections (SD1.x, use_linear_projection=False)."""
    B, H, W, C = x.shape
    res = x
    h = group_norm(p["norm"], x, eps=1e-6)
    # quantize_transformer stores the 1x1 projections as int8 linears
    if "wq" in p["proj_in"]:
        h = linear_q(p["proj_in"], h.reshape(B, H * W, C))
    else:
        h = conv(p["proj_in"], h, padding=0).reshape(B, H * W, C)
    tb = p["block"]
    h = h + attention(tb["attn1"], layer_norm(tb["norm1"], h), None, heads)
    h = h + attention(tb["attn2"], layer_norm(tb["norm2"], h), ctx, heads)
    h = h + geglu_ff(tb["ff"], layer_norm(tb["norm3"], h))
    if "wq" in p["proj_out"]:
        h = linear_q(p["proj_out"], h).reshape(B, H, W, C)
    else:
        h = conv(p["proj_out"], h.reshape(B, H, W, C), padding=0)
    return h + res


def _lin(p: Params, x: torch.Tensor) -> torch.Tensor:
    """int8 W8A8 linear when the tree holds quantized weights
    (``quantize_transformer``), the model-dtype linear otherwise."""
    return linear_q(p, x) if "wq" in p else linear(p, x)


# ---------------------------------------------------------------------------
# W8A8 int8 path (the VAE decoder and the latent U-Net)
# ---------------------------------------------------------------------------

def _dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor activation scale max|x| / 127 (floor 1e-8), on the device."""
    return x.float().abs().amax().clamp(min=1e-8) / 127.0


def quantize_act(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """clip(round(x / sx), -127, 127) as int8, in f32, rounding half to even."""
    return torch.round(x.float() / sx).clamp_(-127, 127).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize_conv(p: Params) -> Params:
    """Per-output-channel symmetric int8 weights for a conv site.

    ``wq`` is laid out once here for the kernels: (O, kh, kw, C) int8, tap
    ``(dy, dx)`` channel ``c`` at ``(dy*kw + dx)*C + c`` of row ``o``. A
    3x3 site whose C is not a multiple of ``ops.conv.CHANNEL_MULTIPLE`` (the
    U-Net's ``conv_in``, C = 8) gets zero input channels up to the next
    multiple: they add nothing to any sum. ``ws`` (O,) f32 per-channel
    scales, ``b`` (O,) f32 bias."""
    w = p["w"].float()  # (O, I, kh, kw)
    scale = w.abs().amax(dim=(1, 2, 3)).clamp(min=1e-8) / 127.0
    wq = torch.round(w / scale[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
    wq = wq.permute(0, 2, 3, 1).contiguous()
    O, kh, kw, C = wq.shape
    if kh == kw == 3 and C % CHANNEL_MULTIPLE:
        wq = F.pad(wq, (0, _round_up(C, CHANNEL_MULTIPLE) - C))
    return {"wq": wq, "ws": scale, "b": p["b"].float()}


def _im2col(xq: torch.Tensor, kh: int, kw: int, stride: int, padding: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*Ho*Wo, kh*kw*C), K in the (dy, dx, c) order of
    ``quantize_conv``'s layout."""
    B, H, W, C = xq.shape
    if kh == kw == 1 and stride == 1 and padding == 0:
        return xq.reshape(B * H * W, C)
    xp = F.pad(xq, (0, 0, padding, padding, padding, padding))
    Ho = (H + 2 * padding - kh) // stride + 1
    Wo = (W + 2 * padding - kw) // stride + 1
    taps = [xp[:, dy:dy + stride * (Ho - 1) + 1:stride, dx:dx + stride * (Wo - 1) + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(taps, dim=3).reshape(B * Ho * Wo, kh * kw * C)


def conv_q(pq: Params, x: torch.Tensor, stride: int = 1, padding: int = 1,
           residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 conv: activation scale static (``as``, calibrated) or dynamic;
    exact integer sums; ``acc * (sx * ws) + b`` in f32, cast to
    ``x.dtype``, then ``+ residual`` in ``x.dtype``.

    3x3 stride-1 pad-1 sites go to kernel 4 (``conv3x3_q``, which runs its
    plain version on CPU tensors), with ``x`` zero-padded to the weights'
    channel count; the others (1x1 shortcuts, stride-2 downsamplers) to the
    exact GEMM ``int8_matmul`` on im2col patches."""
    sx = pq["as"] if "as" in pq else _dynamic_scale(x)
    xq = quantize_act(x, sx)
    wq = pq["wq"]
    O, kh, kw, Cw = wq.shape
    B, H, W, C = x.shape
    if Cw != C:  # quantize_conv's zero channels
        xq = F.pad(xq, (0, Cw - C))
    scale = sx * pq["ws"]
    if kh == kw == 3 and stride == 1 and padding == 1:
        y = conv3x3_q(xq, wq, scale, pq["b"], out_dtype=x.dtype)
    else:
        Ho = (H + 2 * padding - kh) // stride + 1
        Wo = (W + 2 * padding - kw) // stride + 1
        acc = int8_matmul(_im2col(xq, kh, kw, stride, padding), wq.reshape(O, -1))
        y = (acc.float() * scale + pq["b"]).to(x.dtype).reshape(B, Ho, Wo, O)
    if residual is not None:
        y = y + residual.to(y.dtype)
    return y


def quantize_linear(p: Params) -> Params:
    """Per-output-channel symmetric int8 weights for a linear site: ``wq``
    (out, in) int8 (2-D, which tells linear sites from conv sites), ``ws``
    (out,) f32, ``b`` f32 or None."""
    w = p["w"].float()  # (out, in)
    scale = w.abs().amax(dim=1).clamp(min=1e-8) / 127.0
    wq = torch.round(w / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    b = p.get("b")
    return {"wq": wq.contiguous(), "ws": scale, "b": None if b is None else b.float()}


def linear_q(pq: Params, x: torch.Tensor) -> torch.Tensor:
    """W8A8 linear: dynamic per-tensor activation scale unless a static
    ``as`` is present; exact int32 sums, f32 dequant + bias, ``x.dtype``."""
    sx = pq.get("as")
    if sx is None:
        sx = _dynamic_scale(x)
    xq = quantize_act(x, sx)
    N, K = pq["wq"].shape
    acc = int8_matmul(xq.reshape(-1, K), pq["wq"])
    y = acc.float() * (sx * pq["ws"])
    if pq.get("b") is not None:
        y = y + pq["b"]
    return y.to(x.dtype).reshape(*x.shape[:-1], N)


def quantize_transformer(p: Params) -> Params:
    """int8 weights for the softmax-safe transformer matmuls: the
    proj_in/proj_out 1x1 convs (as int8 linears), self-attention v/o,
    cross-attention o and the GEGLU pair. q/k stay model-dtype so the
    attention scores are exact, and so do cross-attention's k/v (their
    source is the 50-token Whisper context)."""
    def q_proj(cp):  # 1x1 conv (O, I, 1, 1) -> int8 linear (O, I)
        return quantize_linear({"w": cp["w"][:, :, 0, 0], "b": cp.get("b")})

    tb = p["block"]
    return {
        "norm": p["norm"],
        "proj_in": q_proj(p["proj_in"]),
        "proj_out": q_proj(p["proj_out"]),
        "block": {
            "norm1": tb["norm1"],
            "attn1": {"q": tb["attn1"]["q"], "k": tb["attn1"]["k"],
                      "v": quantize_linear(tb["attn1"]["v"]),
                      "o": quantize_linear(tb["attn1"]["o"])},
            "norm2": tb["norm2"],
            "attn2": {"q": tb["attn2"]["q"], "k": tb["attn2"]["k"],
                      "v": tb["attn2"]["v"],
                      "o": quantize_linear(tb["attn2"]["o"])},
            "norm3": tb["norm3"],
            "ff": {"proj": quantize_linear(tb["ff"]["proj"]),
                   "out": quantize_linear(tb["ff"]["out"])},
        },
    }


def fetch_scales(rec, device) -> Iterator[torch.Tensor]:
    """A calibration walk's per-site scales (0-d device tensors) fetched in
    ONE host copy, handed out in walk order as 0-d f32 tensors on
    ``device`` (one device copy back)."""
    host = torch.stack([r.float() for r in rec]).cpu()
    return iter(host.to(device).unbind(0))


def quantized_from_jax(tree, dtype: torch.dtype = torch.float32, device="cpu"):
    """The JAX package's quantized (and calibrated) SD tree, leaves as numpy
    arrays, -> the port's: conv ``wq`` HWIO -> (O, kh, kw, C) with
    ``quantize_conv``'s channel padding, linear ``wq`` (in, out) ->
    (out, in), ``ws``/``b``/``as`` f32 tensors (``as`` 0-d). The folded
    upsampler weights ``wq4``/``ws4`` are dropped: the port runs every
    upsampler as conv3x3(nearest2x(x)) (ROADMAP "Leave out"). Sites that
    stayed full precision convert as ``tree_from_jax`` does, in ``dtype``."""
    if isinstance(tree, list):
        return [quantized_from_jax(v, dtype, device) for v in tree]
    if tree is None:
        return None
    if not isinstance(tree, dict):
        return _tensor(tree, dtype, device)
    if "wq" not in tree:
        if "w" in tree:
            return prepare(tree_from_jax(tree), device, dtype)
        return {k: quantized_from_jax(v, dtype, device) for k, v in tree.items()}
    wq = np.asarray(tree["wq"], np.int8)
    if wq.ndim == 4:
        w = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))
        C = w.shape[-1]
        if w.shape[1] == w.shape[2] == 3 and C % CHANNEL_MULTIPLE:
            w = F.pad(w, (0, _round_up(C, CHANNEL_MULTIPLE) - C))
    else:
        w = torch.from_numpy(np.ascontiguousarray(wq.T))
    out = {"wq": w.contiguous().to(device)}
    for key in ("ws", "b", "as"):
        if key in tree:
            out[key] = None if tree[key] is None else _tensor(tree[key], device=device)
    return out


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
