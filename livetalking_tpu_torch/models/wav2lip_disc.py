"""Wav2Lip visual-quality discriminator, training only (ports
livetalking_tpu/models/wav2lip_disc.py).

A conv stack over the lower half of generated faces (plain conv + leaky
ReLU, no norm) down to 1x1x512 and a logit head, averaged to one logit
per face; trained with BCE as the perceptual-quality term of the full
Wav2Lip recipe (L1 + sync expert + GAN). ``QualityDisc`` is the net (a
``ConvStack``, NHWC activations); ``params_from_jax`` loads the
reference's tree into it.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from livetalking_tpu_torch.models.layers import ConvSpec, ConvStack


def _specs(img_size: int = 256) -> List[ConvSpec]:
    """Encoder over (img//2, img, 3) lower halves down to 1x1x512."""
    specs = [ConvSpec(3, 32, kernel=7, stride=1, padding=3, bn=False, act="leaky")]
    for cin, cout in [(32, 64), (64, 128), (128, 256), (256, 512)]:
        specs.append(ConvSpec(cin, cout, kernel=5, stride=2, padding=2, bn=False, act="leaky"))
        specs.append(ConvSpec(cout, cout, kernel=3, stride=1, padding=1, bn=False, act="leaky"))
    extent = img_size // 2 // 16
    while extent > 1:
        specs.append(ConvSpec(512, 512, kernel=3, stride=2, padding=1, bn=False, act="leaky"))
        extent //= 2
    specs.append(ConvSpec(512, 1, kernel=1, stride=1, padding=0, bn=False, act=None))
    return specs


class QualityDisc(nn.Module):
    """faces (B, H, W, 3) in [0, 1]; the lower half is judged. -> (B,) logits."""

    def __init__(self, img_size: int = 256):
        super().__init__()
        self.blocks = ConvStack(_specs(img_size))

    def forward(self, faces: torch.Tensor) -> torch.Tensor:
        return self.blocks(faces[:, faces.shape[1] // 2:]).mean(dim=(1, 2, 3))


def init_params(seed: int = 1, img_size: int = 256, dtype=torch.float32,
                device="cpu") -> QualityDisc:
    net = QualityDisc(img_size)
    net.blocks.init_(torch.Generator().manual_seed(seed))
    return net.to(device=device, dtype=dtype)


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32, device="cpu") -> QualityDisc:
    # the stack's length fixes its stride-2 tail; 32 * 2^n px is the
    # smallest face with that tail
    net = QualityDisc(32 * 2 ** (len(tree["blocks"]) - 10))
    net.blocks.load_jax_(tree["blocks"])
    return net.to(device=device, dtype=dtype)


def bce_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Binary cross-entropy on logits against a constant target (1 = real)."""
    return torch.mean(torch.clamp(logits, min=0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))
