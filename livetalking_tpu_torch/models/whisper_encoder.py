"""Whisper encoder (tiny by default) with stacked hidden states: the
MuseTalk audio feature network (ports livetalking_tpu/models/whisper_encoder.py).

Architecture: conv1d(80->d, k3) gelu -> conv1d(d->d, k3, s2) gelu ->
+sinusoidal positions -> pre-LN transformer layers (k_proj without bias)
-> final LayerNorm on the LAST stacked state only, the layout of HF's
``hidden_states`` tuple. ``apply_stacked`` returns every state:
(B, T_mel//2, layers+1, d_model).

Parameters are a dictionary of tensors in PyTorch layouts (conv1d
(O, I, K), linear (out, in)); ``convert_torch_state_dict`` reads an HF
``WhisperModel``/``WhisperEncoder`` state dict, ``params_from_jax`` the
JAX package's tree. The encoder's attention is a plain matmul pair with
an f32 softmax, as in the reference (no kernel there).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.models.layers import gelu_exact, layer_norm_f32, linear_f32, to_numpy

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 384
    num_layers: int = 4
    num_heads: int = 6
    ffn: int = 1536
    max_positions: int = 1500
    layer_norm_eps: float = 1e-5


TINY = WhisperConfig()


def _attn(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, D = x.shape
    hd = D // heads
    q = linear_f32(p["q"], x) * (hd ** -0.5)
    k = linear_f32(p["k"], x)
    v = linear_f32(p["v"], x)

    def split(t):
        return t.reshape(B, T, heads, hd).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.matmul(pr, v)
    return linear_f32(p["o"], o.transpose(1, 2).reshape(B, T, D))


def _conv1d(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    """(B, T, C) -> (B, T', O), padding 1."""
    y = F.conv1d(x.transpose(1, 2), p["w"].to(x.dtype), p["b"].to(x.dtype),
                 stride=stride, padding=1)
    return y.transpose(1, 2)


def apply_stacked(params: Params, cfg: WhisperConfig, mel: torch.Tensor) -> torch.Tensor:
    """(B, n_mels, T_mel) log-mel -> (B, T_mel//2, num_layers+1, d_model).

    Runs in ``mel``'s dtype, the weights cast to it, as the reference does:
    f32 mel gives an f32 encoder whatever the parameters' dtype."""
    x = mel.transpose(1, 2)  # (B, T, 80)
    x = gelu_exact(_conv1d(x, params["conv1"], 1))
    x = gelu_exact(_conv1d(x, params["conv2"], 2))
    T = x.shape[1]
    x = x + params["pos"][:T].to(x.dtype)

    states: List[torch.Tensor] = []
    eps = cfg.layer_norm_eps
    for lp in params["layers"]:
        states.append(x)
        x = x + _attn(lp["attn"], layer_norm_f32(lp["ln1"], x, eps), cfg.num_heads)
        x = x + linear_f32(lp["fc2"], gelu_exact(linear_f32(lp["fc1"], layer_norm_f32(lp["ln2"], x, eps))))
    states.append(layer_norm_f32(params["ln_post"], x, eps))
    return torch.stack(states, dim=2)


def _positions(cfg: WhisperConfig) -> np.ndarray:
    """Whisper's fixed sinusoidal positions: sin | cos concatenated."""
    D = cfg.d_model
    half = D // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / (half - 1))
    ang = np.arange(cfg.max_positions)[:, None] * freqs[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(np.float32)


def init_params(seed: int = 0, cfg: WhisperConfig = TINY, dtype=torch.bfloat16,
                device="cpu") -> Params:
    """Random weights from ``torch.Generator(seed)``: N(0, 1/fan_in)
    linears, N(0, 0.02) convs, zero biases, unit LayerNorms."""
    g = torch.Generator().manual_seed(seed)
    D = cfg.d_model

    def t(a):
        return a.to(device=device, dtype=dtype)

    def lin(i, o, bias=True):
        return {"w": t(torch.randn((o, i), generator=g) / math.sqrt(i)),
                "b": t(torch.zeros(o)) if bias else None}

    def ln():
        return {"g": torch.ones(D, device=device), "b": torch.zeros(D, device=device)}

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "attn": {"q": lin(D, D), "k": lin(D, D, bias=False), "v": lin(D, D), "o": lin(D, D)},
            "ln1": ln(), "ln2": ln(),
            "fc1": lin(D, cfg.ffn), "fc2": lin(cfg.ffn, D),
        })
    return {
        "conv1": {"w": t(torch.randn((D, cfg.n_mels, 3), generator=g) * 0.02), "b": t(torch.zeros(D))},
        "conv2": {"w": t(torch.randn((D, D, 3), generator=g) * 0.02), "b": t(torch.zeros(D))},
        "pos": t(torch.from_numpy(_positions(cfg))),
        "ln_post": ln(),
        "layers": layers,
    }


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=dtype)


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's tree (leaves as numpy arrays; linears (in, out),
    conv1d WIO) -> the port's dictionary."""
    def lin(p):
        return {"w": _tensor(np.asarray(p["w"], np.float32).T, dtype, device),
                "b": None if p.get("b") is None else _tensor(p["b"], dtype, device)}

    def ln(p):
        return {"g": _tensor(p["g"], torch.float32, device),
                "b": _tensor(p["b"], torch.float32, device)}

    def conv(p):
        return {"w": _tensor(np.asarray(p["w"], np.float32).transpose(2, 1, 0), dtype, device),
                "b": _tensor(p["b"], dtype, device)}

    return {
        "conv1": conv(tree["conv1"]), "conv2": conv(tree["conv2"]),
        "pos": _tensor(tree["pos"], dtype, device),
        "ln_post": ln(tree["ln_post"]),
        "layers": [{
            "attn": {k: lin(lp["attn"][k]) for k in ("q", "k", "v", "o")},
            "ln1": ln(lp["ln1"]), "ln2": ln(lp["ln2"]),
            "fc1": lin(lp["fc1"]), "fc2": lin(lp["fc2"]),
        } for lp in tree["layers"]],
    }


def convert_torch_state_dict(sd: Dict[str, Any], cfg: WhisperConfig = TINY,
                             dtype=torch.bfloat16, device="cpu") -> Params:
    """HF ``WhisperModel``/``WhisperEncoder`` state dict -> the port's
    dictionary. Keys may carry an ``encoder.``/``model.encoder.`` prefix."""
    sd = {k: to_numpy(v) for k, v in sd.items()}
    for prefix in ("model.encoder.", "encoder."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break

    def lin(prefix, bias=True):
        return {"w": _tensor(sd[f"{prefix}.weight"], dtype, device),
                "b": _tensor(sd[f"{prefix}.bias"], dtype, device) if bias else None}

    def ln(prefix):
        return {"g": _tensor(sd[f"{prefix}.weight"], torch.float32, device),
                "b": _tensor(sd[f"{prefix}.bias"], torch.float32, device)}

    layers = []
    for i in range(cfg.num_layers):
        b = f"layers.{i}"
        layers.append({
            "attn": {
                "q": lin(f"{b}.self_attn.q_proj"),
                "k": lin(f"{b}.self_attn.k_proj", bias=False),
                "v": lin(f"{b}.self_attn.v_proj"),
                "o": lin(f"{b}.self_attn.out_proj"),
            },
            "ln1": ln(f"{b}.self_attn_layer_norm"),
            "ln2": ln(f"{b}.final_layer_norm"),
            "fc1": lin(f"{b}.fc1"),
            "fc2": lin(f"{b}.fc2"),
        })
    return {
        "conv1": {"w": _tensor(sd["conv1.weight"], dtype, device),
                  "b": _tensor(sd["conv1.bias"], dtype, device)},
        "conv2": {"w": _tensor(sd["conv2.weight"], dtype, device),
                  "b": _tensor(sd["conv2.bias"], dtype, device)},
        "pos": _tensor(sd["embed_positions.weight"], dtype, device),
        "ln_post": ln("layer_norm"),
        "layers": layers,
    }
