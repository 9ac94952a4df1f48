"""Multi-scale patch discriminator, MuseTalk training only (ports
livetalking_tpu/models/multiscale_disc.py).

A Pix2PixHD-style patch discriminator on an image pyramid: one stack of
conv4x4-stride-2 + leaky ReLU layers per scale (no norm) and a 3x3
patch-logit head, each scale on the image average-pooled by its factor.
Trained with BCE; the generator's term is BCE-vs-real on the fake
patches. ``MultiScaleDisc`` is the net (one ``ConvStack`` per scale,
NHWC activations); ``params_from_jax`` loads the reference's tree into it.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from livetalking_tpu_torch.models.layers import ConvSpec, ConvStack

SCALES = (1.0, 0.5)


def _specs(in_ch: int = 3, base: int = 64, n_layers: int = 4) -> List[ConvSpec]:
    """conv4x4-stride2 chain in_ch -> base * 2^k, patch-logit head."""
    specs: List[ConvSpec] = []
    cin = in_ch
    for i in range(n_layers):
        cout = min(base * (2 ** i), 512)
        specs.append(ConvSpec(cin, cout, kernel=4, stride=2, padding=1, bn=False, act="leaky"))
        cin = cout
    specs.append(ConvSpec(cin, 1, kernel=3, stride=1, padding=1, bn=False, act=None))
    return specs


class MultiScaleDisc(nn.Module):
    """img (B, H, W, C) in [0, 1] -> per-scale patch-logit maps (B, h_s, w_s, 1)."""

    def __init__(self, scales: Sequence[float] = SCALES, in_ch: int = 3, base: int = 64,
                 n_layers: int = 4):
        super().__init__()
        self.scales = tuple(scales)
        self.stacks = nn.ModuleList(ConvStack(_specs(in_ch, base, n_layers)) for _ in scales)

    def forward(self, img: torch.Tensor) -> List[torch.Tensor]:
        return [stack(_downsample(img, int(round(1.0 / s))))
                for stack, s in zip(self.stacks, self.scales)]


def init_params(seed: int = 0, scales: Sequence[float] = SCALES, in_ch: int = 3,
                base: int = 64, n_layers: int = 4, dtype=torch.float32,
                device="cpu") -> MultiScaleDisc:
    """One independent conv stack per pyramid scale, from ``torch.Generator(seed)``."""
    g = torch.Generator().manual_seed(seed)
    net = MultiScaleDisc(scales, in_ch, base, n_layers)
    for stack in net.stacks:
        stack.init_(g)
    return net.to(device=device, dtype=dtype)


def params_from_jax(tree: List[Any], scales: Sequence[float] = SCALES, dtype=torch.float32,
                    device="cpu") -> MultiScaleDisc:
    w0 = tree[0][0]["w"]  # HWIO: in_ch and base
    net = MultiScaleDisc(scales, w0.shape[2], w0.shape[3], len(tree[0]) - 1)
    for stack, layers in zip(net.stacks, tree, strict=True):
        stack.load_jax_(layers)
    return net.to(device=device, dtype=dtype)


def _downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, H, W, C) mean over ``factor`` x ``factor`` windows (VALID)."""
    if factor == 1:
        return x
    return F.avg_pool2d(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


def gen_loss(net, fake: torch.Tensor) -> torch.Tensor:
    """Generator GAN term: fake patches judged real, averaged over scales."""
    logits = net(fake)
    return sum(_bce(lg, 1.0) for lg in logits) / len(logits)


def disc_loss(net, real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    """Discriminator BCE: real -> 1, fake -> 0, averaged over scales."""
    rl, fl = net(real), net(fake)
    return (sum(_bce(lg, 1.0) for lg in rl) + sum(_bce(lg, 0.0) for lg in fl)) / (2 * len(rl))
