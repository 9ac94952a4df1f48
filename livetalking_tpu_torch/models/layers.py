"""Shared conv layers (ports livetalking_tpu/models/layers.py).

  - ``ConvSpec`` is the reference's layer table entry, unchanged.
  - ``ConvLayer`` runs one entry: ``nn.Conv2d`` or ``nn.ConvTranspose2d``
    (cuDNN on the card), + residual, + activation, on NCHW tensors that
    are channels-last in memory when the module is.
  - ``ConvStack`` runs a list of them on NHWC activations (the
    training-only nets); ``load_jax_`` carries the reference's layers
    (HWIO) over.
  - BatchNorm is folded into the conv at load time (``fold_bn``), so the
    graph is conv+bias+act only, as in the reference.
  - The reference keeps folded weights as HWIO, with transposed-conv
    weights spatially flipped (``torch_tconv_to_hwio``).
    ``hwio_to_torch_conv`` / ``hwio_to_torch_tconv`` invert that, so a
    folded reference tree loads into ``nn.Conv2d`` / ``nn.ConvTranspose2d``
    weights.
  - ``linear_f32``, ``layer_norm_f32`` and ``gelu_exact`` are the Whisper
    and HuBERT encoders' and the SD blocks' primitives on parameter
    dictionaries: linear weights in PyTorch's (out, in) layout, norm
    gamma/beta under ``g``/``b``.
  - ``upsample2x_align_corners`` is the Ultralight U-Net's bilinear
    upsampler as the reference computes it: one interpolation product per
    axis, each rounded to the compute dtype.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """One conv (+folded BN) (+activation) layer.

    ``residual`` adds the layer input before the activation.
    """

    cin: int
    cout: int
    kernel: Any = 3
    stride: Any = 1
    padding: Any = 1
    residual: bool = False
    transpose: bool = False
    output_padding: Any = 0
    bn: bool = True  # whether the reference layer had a BatchNorm to fold
    act: Optional[str] = "relu"  # relu | sigmoid | leaky | None
    groups: int = 1  # feature groups (groups == cin -> depthwise)


class ConvLayer(nn.Module):
    """conv/tconv (+ residual) (+ activation) for one ``ConvSpec``.

    ``parallel.mesh.shard_params`` swaps ``self.conv`` for a
    ``parallel.tp.TPConv2d`` (this rank's output channels, gathered over
    tp), so a sharded layer runs this same ``forward``."""

    def __init__(self, spec: ConvSpec):
        super().__init__()
        self.spec = spec
        k, s, p = _pair(spec.kernel), _pair(spec.stride), _pair(spec.padding)
        if spec.transpose:
            self.conv = nn.ConvTranspose2d(spec.cin, spec.cout, k, s, p,
                                           _pair(spec.output_padding))
        else:
            self.conv = nn.Conv2d(spec.cin, spec.cout, k, s, p, groups=spec.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        if self.spec.residual:
            y = y + x
        act = self.spec.act
        if act == "relu":
            y = torch.relu(y)
        elif act == "sigmoid":
            y = torch.sigmoid(y)
        elif act == "leaky":
            y = nn.functional.leaky_relu(y, 0.01)
        return y

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """He-normal weights and zero bias (the reference's init, BN identity)."""
        kh, kw = _pair(self.spec.kernel)
        std = math.sqrt(2.0 / ((self.spec.cin // self.spec.groups) * kh * kw))
        w = self.conv.weight
        w.copy_(torch.randn(w.shape, generator=generator) * std)
        self.conv.bias.zero_()

    @torch.no_grad()
    def load_hwio_(self, w_hwio: np.ndarray, b: np.ndarray) -> None:
        """Load folded reference weights (HWIO; flipped HWIO for tconv)."""
        w = hwio_to_torch_tconv(w_hwio) if self.spec.transpose else hwio_to_torch_conv(w_hwio)
        if tuple(w.shape) != tuple(self.conv.weight.shape):
            raise ValueError(f"{self.spec}: weight {w.shape} != {tuple(self.conv.weight.shape)}")
        self.conv.weight.copy_(torch.from_numpy(np.array(w, np.float32)))
        self.conv.bias.copy_(torch.from_numpy(np.array(b, np.float32)))


class ConvStack(nn.Sequential):
    """``ConvLayer``s in order on NHWC activations, (B, H, W, C) ->
    (B, H', W', O): the layout the training-only nets (discriminators,
    sync experts) take, as the reference's do."""

    def __init__(self, specs: Sequence[ConvSpec]):
        super().__init__(*(ConvLayer(s) for s in specs))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def init_(self, generator: torch.Generator) -> "ConvStack":
        for layer in self:
            layer.init_(generator)
        return self

    def load_jax_(self, layers: Sequence[Any]) -> "ConvStack":
        """Load the reference's layer list ``[{"w": HWIO, "b"}, ...]``."""
        for layer, p in zip(self, layers, strict=True):
            layer.load_hwio_(np.asarray(p["w"], np.float32), np.asarray(p["b"], np.float32))
        return self


@functools.lru_cache(maxsize=None)
def _interp_matrix(n_in: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """(2 n_in, n_in) align-corners interpolation weights, in ``dtype``.

    Made outside inference mode even when the first call comes from a
    serving step under ``torch.inference_mode``: the cached tensor is
    shared with training, whose autograd cannot save an inference tensor."""
    n_out = 2 * n_in
    m = np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        m[:, 0] = 1.0
    else:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, n_in - 1)
        frac = (src - lo).astype(np.float32)
        m[np.arange(n_out), lo] += 1.0 - frac
        m[np.arange(n_out), hi] += frac
    with torch.inference_mode(False):
        return torch.from_numpy(m).to(device=device, dtype=dtype)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling with ``align_corners=True`` on an NCHW tensor.

    Two interpolation products, rows then columns, each accumulated in f32
    and rounded to ``x.dtype`` (the weights too), as the reference does;
    ``F.interpolate`` rounds once and so differs in bf16. Works on the
    channels-last layout (an NCHW view of NHWC memory) and returns one."""
    B, C, H, W = x.shape
    mh = _interp_matrix(H, x.device, x.dtype)
    mw = _interp_matrix(W, x.device, x.dtype)
    t = x.permute(0, 2, 3, 1).reshape(B, H, W * C)
    y = torch.matmul(mh, t).reshape(B * 2 * H, W, C)
    y = torch.matmul(mw, y)
    return y.reshape(B, 2 * H, 2 * W, C).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# weight layouts and BN folding (host-side numpy)
# ---------------------------------------------------------------------------

def torch_conv_to_hwio(w: np.ndarray) -> np.ndarray:
    """Conv2d weight (O, I, kh, kw) -> HWIO."""
    return np.transpose(w, (2, 3, 1, 0))


def torch_tconv_to_hwio(w: np.ndarray) -> np.ndarray:
    """ConvTranspose2d weight (I, O, kh, kw) -> spatially flipped HWIO."""
    return np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))


def hwio_to_torch_conv(w: np.ndarray) -> np.ndarray:
    """Inverse of ``torch_conv_to_hwio``: HWIO -> (O, I, kh, kw)."""
    return np.transpose(w, (3, 2, 0, 1))


def hwio_to_torch_tconv(w: np.ndarray) -> np.ndarray:
    """Inverse of ``torch_tconv_to_hwio``: flipped HWIO -> (I, O, kh, kw)."""
    return np.transpose(w, (2, 3, 0, 1))[:, :, ::-1, ::-1]


def fold_bn(
    w_hwio: np.ndarray,
    b: Optional[np.ndarray],
    gamma: np.ndarray,
    beta: np.ndarray,
    mean: np.ndarray,
    var: np.ndarray,
    eps: float = 1e-5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold BatchNorm(gamma, beta, mean, var) into conv (w, b).

    y = gamma * (conv(x) + b - mean) / sqrt(var + eps) + beta
      = conv(x) * s + (b - mean) * s + beta,  s = gamma / sqrt(var + eps)
    """
    s = gamma / np.sqrt(var + eps)
    w2 = w_hwio * s[None, None, None, :]
    b0 = b if b is not None else np.zeros_like(mean)
    b2 = (b0 - mean) * s + beta
    return w2, b2


def to_numpy(v) -> np.ndarray:
    """Tensor or array-like -> np.ndarray (checkpoint converters)."""
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


# ---------------------------------------------------------------------------
# Whisper primitives (parameter dictionaries)
# ---------------------------------------------------------------------------

def linear_f32(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` in ``x.dtype`` (the GEMM accumulates in f32)."""
    b = p.get("b")
    return F.linear(x, p["w"].to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm_f32(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, gamma/beta keys 'g'/'b'."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["g"].float() + p["b"].float()).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Non-approximate GELU in f32, output in ``x.dtype``."""
    return F.gelu(x.float()).to(x.dtype)
