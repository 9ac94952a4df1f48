"""HuBERT speech encoder (ports livetalking_tpu/models/hubert.py).

The Ultralight and ER-NeRF families' audio front-end: the reference runs
HF ``HubertModel`` (hubert-large-ls960-ft) over 16 kHz speech and consumes
``last_hidden_state`` frames at 50 Hz. Same architecture family as the
JAX package: a wav2vec2-style conv feature extractor and a transformer
encoder, in the stable pre-LN "large" and the post-LN "base" variants.

Parameters are a dictionary of tensors in PyTorch layouts (conv1d
(O, I/groups, K), linear (out, in)); ``convert_torch_state_dict`` reads an
HF ``HubertModel`` (or ``HubertForCTC``) state dict, ``params_from_jax``
the JAX package's tree. The forward runs in the waveform's dtype, the
weights cast to it, as the reference does: ``HubertFeatures`` feeds f32
samples, so the served encoder computes in f32 over bf16-rounded weights.
Attention is a plain matmul pair with f32 scores and an f32 softmax, the
reference's rounding (no kernel there); the grouped positional conv is
one batched matmul over unfolded windows (``_pos_conv``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.models.layers import gelu_exact, layer_norm_f32, linear_f32, to_numpy


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # "layer" (large) | "group" (base)
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    do_stable_layer_norm: bool = True  # True for -large
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    layer_norm_eps: float = 1e-5

    @property
    def total_stride(self) -> int:
        return int(np.prod(self.conv_stride))

    @property
    def receptive_field(self) -> int:
        rf = 1
        for k, s in zip(reversed(self.conv_kernel), reversed(self.conv_stride)):
            rf = (rf - 1) * s + k
        return rf

    def out_length(self, n_samples: int) -> int:
        t = n_samples
        for k, s in zip(self.conv_kernel, self.conv_stride):
            t = (t - k) // s + 1
        return t


LARGE = HubertConfig()
BASE = HubertConfig(
    conv_bias=False, feat_extract_norm="group", hidden_size=768,
    num_layers=12, num_heads=12, intermediate_size=3072,
    do_stable_layer_norm=False,
)

Params = Dict[str, Any]


def _conv1d(x: torch.Tensor, w: torch.Tensor, b, stride: int) -> torch.Tensor:
    """x (B, C, T), w (O, C, K), no padding: the conv in ``x.dtype`` (f32
    accumulation), the bias added in f32, one cast back."""
    y = F.conv1d(x, w.to(x.dtype), None, stride)
    if b is not None:
        y = y.float() + b.float()[:, None]
    return y.to(x.dtype)


def _pos_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, groups: int) -> torch.Tensor:
    """The positional embedding's grouped conv, x (B, C, T), w (O, C/groups,
    K), padding K//2 -> (B, O, T + 1 - K % 2): the windows unfolded and
    one matmul batched over the groups, f32 accumulation, the bias added in
    f32. cuDNN runs this shape (K = 128, 16 groups of 64 channels in
    HuBERT-large) one group at a time with scalar FMAs."""
    B, C, _ = x.shape
    O, I, K = w.shape
    win = F.pad(x, (K // 2, K // 2)).unfold(2, K, 1)  # (B, C, T', K)
    Tn = win.shape[2]
    a = win.reshape(B, groups, I, Tn, K).permute(0, 1, 3, 2, 4).reshape(B, groups, Tn, I * K)
    wg = w.to(x.dtype).reshape(groups, O // groups, I * K).transpose(1, 2)
    y = torch.matmul(a, wg).permute(0, 1, 3, 2).reshape(B, O, Tn)
    return (y.float() + b.float()[:, None]).to(x.dtype)


def _attention(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, D = x.shape
    hd = D // n_heads
    q = linear_f32(p["q"], x) * (hd ** -0.5)
    k = linear_f32(p["k"], x)
    v = linear_f32(p["v"], x)

    def split(t):
        return t.reshape(B, T, n_heads, hd).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v)
    return linear_f32(p["o"], out.transpose(1, 2).reshape(B, T, D))


def feature_extractor(params: Params, cfg: HubertConfig, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) normalized waveform -> (B, T', conv_dim[-1])."""
    x = wav[:, None, :]  # (B, 1, T)
    eps = cfg.layer_norm_eps
    for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
        p = params["fe"][i]
        x = _conv1d(x, p["w"], p.get("bias"), s)
        if cfg.feat_extract_norm == "layer":
            x = layer_norm_f32(p["ln"], x.transpose(1, 2), eps).transpose(1, 2)
        elif i == 0:  # group norm == per-channel instance norm over time
            xf = x.float()
            mu = xf.mean(2, keepdim=True)
            var = xf.var(2, unbiased=False, keepdim=True)
            xf = (xf - mu) * torch.rsqrt(var + eps)
            x = (xf * p["gn"]["g"][:, None] + p["gn"]["b"][:, None]).to(x.dtype)
        x = gelu_exact(x)
    return x.transpose(1, 2)


def encoder(params: Params, cfg: HubertConfig, h: torch.Tensor) -> torch.Tensor:
    """(B, T, hidden) projected features -> last_hidden_state."""
    # positional conv embedding: grouped conv, same padding, and an even
    # kernel's extra trailing frame dropped
    pc = params["pos_conv"]
    pos = _pos_conv(h.transpose(1, 2), pc["w"], pc["b"], cfg.num_conv_pos_embedding_groups)
    if cfg.num_conv_pos_embeddings % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + gelu_exact(pos.transpose(1, 2))

    eps = cfg.layer_norm_eps
    if not cfg.do_stable_layer_norm:
        h = layer_norm_f32(params["enc_ln"], h, eps)
    for lp in params["layers"]:
        if cfg.do_stable_layer_norm:  # pre-LN (large)
            h = h + _attention(lp["attn"], layer_norm_f32(lp["ln1"], h, eps), cfg.num_heads)
            ff_in = layer_norm_f32(lp["ln2"], h, eps)
            h = h + linear_f32(lp["ff2"], gelu_exact(linear_f32(lp["ff1"], ff_in)))
        else:  # post-LN (base)
            h = layer_norm_f32(lp["ln1"], h + _attention(lp["attn"], h, cfg.num_heads), eps)
            h = layer_norm_f32(
                lp["ln2"], h + linear_f32(lp["ff2"], gelu_exact(linear_f32(lp["ff1"], h))), eps)
    if cfg.do_stable_layer_norm:
        h = layer_norm_f32(params["enc_ln"], h, eps)
    return h


def apply(params: Params, cfg: HubertConfig, wav: torch.Tensor,
          normalize: bool = True) -> torch.Tensor:
    """(B, T) raw 16 kHz waveform -> (B, T', hidden) last_hidden_state.

    ``normalize`` applies the Wav2Vec2Processor zero-mean/unit-variance
    input normalization (variance + 1e-7), in f32."""
    if normalize:
        wf = wav.float()
        mu = wf.mean(-1, keepdim=True)
        var = wf.var(-1, unbiased=False, keepdim=True)
        wav = ((wf - mu) / torch.sqrt(var + 1e-7)).to(wav.dtype)
    x = feature_extractor(params, cfg, wav)
    fp = params["fp"]
    x = layer_norm_f32(fp["ln"], x, cfg.layer_norm_eps)
    x = linear_f32(fp["proj"], x)
    return encoder(params, cfg, x)


def init_params(seed: int = 0, cfg: HubertConfig = LARGE, dtype=torch.bfloat16,
                device="cpu") -> Params:
    """Random weights from ``torch.Generator(seed)``: N(0, 1/fan_in)
    linears and feature convs, N(0, 0.02) positional conv, zero biases,
    unit norms."""
    g = torch.Generator().manual_seed(seed)

    def t(a, dt=dtype):
        return a.to(device=device, dtype=dt)

    def lin(i, o):
        return {"w": t(torch.randn((o, i), generator=g) / math.sqrt(i)), "b": t(torch.zeros(o))}

    def ln(d):
        return {"g": t(torch.ones(d)), "b": t(torch.zeros(d))}

    fe = []
    cin = 1
    for i, (d, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        p = {"w": t(torch.randn((d, cin, k), generator=g) / math.sqrt(k * cin))}
        if cfg.conv_bias:
            p["bias"] = t(torch.zeros(d))
        if cfg.feat_extract_norm == "layer":
            p["ln"] = ln(d)
        elif i == 0:
            p["gn"] = {"g": t(torch.ones(d), torch.float32), "b": t(torch.zeros(d), torch.float32)}
        fe.append(p)
        cin = d

    D = cfg.hidden_size
    layers = [{
        "attn": {"q": lin(D, D), "k": lin(D, D), "v": lin(D, D), "o": lin(D, D)},
        "ln1": ln(D), "ln2": ln(D),
        "ff1": lin(D, cfg.intermediate_size), "ff2": lin(cfg.intermediate_size, D),
    } for _ in range(cfg.num_layers)]
    K, G = cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    return {
        "fe": fe,
        "fp": {"ln": ln(cfg.conv_dim[-1]), "proj": lin(cfg.conv_dim[-1], D)},
        "pos_conv": {"w": t(torch.randn((D, D // G, K), generator=g) * 0.02),
                     "b": t(torch.zeros(D))},
        "enc_ln": ln(D),
        "layers": layers,
    }


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=dtype)


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's tree (leaves as numpy arrays; linears (in, out),
    conv1d (K, I, O)) -> the port's dictionary."""
    def lin(p):
        return {"w": _tensor(np.asarray(p["w"], np.float32).T, dtype, device),
                "b": _tensor(p["b"], dtype, device)}

    def ln(p):
        return {"g": _tensor(p["g"], dtype, device), "b": _tensor(p["b"], dtype, device)}

    def conv(w):
        return _tensor(np.asarray(w, np.float32).transpose(2, 1, 0), dtype, device)

    fe = []
    for p in tree["fe"]:
        q = {"w": conv(p["w"])}
        if "bias" in p:
            q["bias"] = _tensor(p["bias"], dtype, device)
        if "ln" in p:
            q["ln"] = ln(p["ln"])
        if "gn" in p:
            q["gn"] = {k: _tensor(p["gn"][k], torch.float32, device) for k in ("g", "b")}
        fe.append(q)
    return {
        "fe": fe,
        "fp": {"ln": ln(tree["fp"]["ln"]), "proj": lin(tree["fp"]["proj"])},
        "pos_conv": {"w": conv(tree["pos_conv"]["w"]),
                     "b": _tensor(tree["pos_conv"]["b"], dtype, device)},
        "enc_ln": ln(tree["enc_ln"]),
        "layers": [{
            "attn": {k: lin(lp["attn"][k]) for k in ("q", "k", "v", "o")},
            "ln1": ln(lp["ln1"]), "ln2": ln(lp["ln2"]),
            "ff1": lin(lp["ff1"]), "ff2": lin(lp["ff2"]),
        } for lp in tree["layers"]],
    }


def convert_torch_state_dict(sd: Dict[str, Any], cfg: HubertConfig = LARGE,
                             dtype=torch.bfloat16, device="cpu") -> Params:
    """transformers ``HubertModel`` state dict (``HubertForCTC``'s, whose
    keys carry a ``hubert.`` prefix, too) -> the port's dictionary."""
    sd = {k: to_numpy(v) for k, v in sd.items()}
    if any(k.startswith("hubert.") for k in sd):
        sd = {k[len("hubert."):]: v for k, v in sd.items() if k.startswith("hubert.")}

    def lin(prefix):
        return {"w": _tensor(sd[f"{prefix}.weight"], dtype, device),
                "b": _tensor(sd[f"{prefix}.bias"], dtype, device)}

    def ln(prefix):
        return {"g": _tensor(sd[f"{prefix}.weight"], dtype, device),
                "b": _tensor(sd[f"{prefix}.bias"], dtype, device)}

    fe = []
    for i in range(len(cfg.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        p = {"w": _tensor(sd[f"{base}.conv.weight"], dtype, device)}
        if f"{base}.conv.bias" in sd:
            p["bias"] = _tensor(sd[f"{base}.conv.bias"], dtype, device)
        if cfg.feat_extract_norm == "layer":
            p["ln"] = ln(f"{base}.layer_norm")
        elif i == 0:
            p["gn"] = {"g": _tensor(sd[f"{base}.layer_norm.weight"], torch.float32, device),
                       "b": _tensor(sd[f"{base}.layer_norm.bias"], torch.float32, device)}
        fe.append(p)

    # the positional conv is weight-normalized over dim 2 (the kernel axis);
    # both torch layouts: weight_g/weight_v and parametrizations.original0/1
    pcw = "encoder.pos_conv_embed.conv"
    if f"{pcw}.weight_g" in sd:
        g, v = sd[f"{pcw}.weight_g"], sd[f"{pcw}.weight_v"]
    else:
        g = sd[f"{pcw}.parametrizations.weight.original0"]
        v = sd[f"{pcw}.parametrizations.weight.original1"]
    norm = np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))
    w = g * v / np.maximum(norm, 1e-12)  # (O, I/groups, K)

    layers = []
    for i in range(cfg.num_layers):
        base = f"encoder.layers.{i}"
        layers.append({
            "attn": {"q": lin(f"{base}.attention.q_proj"), "k": lin(f"{base}.attention.k_proj"),
                     "v": lin(f"{base}.attention.v_proj"),
                     "o": lin(f"{base}.attention.out_proj")},
            "ln1": ln(f"{base}.layer_norm"),
            "ln2": ln(f"{base}.final_layer_norm"),
            "ff1": lin(f"{base}.feed_forward.intermediate_dense"),
            "ff2": lin(f"{base}.feed_forward.output_dense"),
        })
    return {
        "fe": fe,
        "fp": {"ln": ln("feature_projection.layer_norm"),
               "proj": lin("feature_projection.projection")},
        "pos_conv": {"w": _tensor(w, dtype, device), "b": _tensor(sd[f"{pcw}.bias"], dtype, device)},
        "enc_ln": ln("encoder.layer_norm"),
        "layers": layers,
    }
