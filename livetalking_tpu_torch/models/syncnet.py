"""SyncNet: the generic audio/visual lip-sync expert, training only (ports
livetalking_tpu/models/syncnet.py).

A face encoder over a 5-frame window of lower-half faces (channel-stacked)
and an audio encoder over the matching (80, 16) mel window, each giving
an L2-normalized 512-d embedding; their cosine scores sync, trained with
BCE on in-sync and offset pairs. Used by ``train/syncnet_train.py`` and as
the frozen expert of the Wav2Lip, Ultralight and MuseTalk (generic
backend) recipes. ``SyncNet`` is the net (two ``ConvStack``s, NHWC
activations); ``params_from_jax`` loads the reference's tree into it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from livetalking_tpu_torch.models.layers import ConvSpec, ConvStack

EMBED = 512
FRAMES = 5  # temporal window


def _face_specs(img_size: int) -> List[ConvSpec]:
    """Encoder over (img_size//2, img_size) lower-half crops, 3*FRAMES ch;
    stride-2 convs reach 1x1 spatial at 512 channels for 96..256 px."""
    specs = [ConvSpec(3 * FRAMES, 32, kernel=7, stride=1, padding=3)]
    chans = [(32, 64), (64, 128), (128, 256), (256, 512)]
    for cin, cout in chans:
        specs.append(ConvSpec(cin, cout, kernel=5, stride=2, padding=2))
        specs.append(ConvSpec(cout, cout, kernel=3, stride=1, padding=1, residual=True))
    extent = img_size // (2 ** len(chans))
    while extent > 1:
        specs.append(ConvSpec(512, 512, kernel=3, stride=2, padding=1))
        extent //= 2
    specs.append(ConvSpec(512, EMBED, kernel=1, stride=1, padding=0, act=None))
    return specs


def _audio_specs() -> List[ConvSpec]:
    """Encoder over (80, 16, 1) mel windows -> 512."""
    return [
        ConvSpec(1, 32, kernel=3, stride=1, padding=1),
        ConvSpec(32, 64, kernel=3, stride=(3, 1), padding=1),
        ConvSpec(64, 64, kernel=3, stride=1, padding=1, residual=True),
        ConvSpec(64, 128, kernel=3, stride=3, padding=1),
        ConvSpec(128, 128, kernel=3, stride=1, padding=1, residual=True),
        ConvSpec(128, 256, kernel=3, stride=(3, 2), padding=1),
        ConvSpec(256, 512, kernel=3, stride=1, padding=0),
        ConvSpec(512, EMBED, kernel=1, stride=1, padding=0, act=None),
    ]


class SyncNet(nn.Module):
    """faces (B, img//2, img, 3*FRAMES) lower-half window in [0, 1]; mels
    (B, 80, 16, 1). -> L2-normalized (B, 512) embeddings."""

    def __init__(self, img_size: int = 256):
        super().__init__()
        self.face = ConvStack(_face_specs(img_size))
        self.audio = ConvStack(_audio_specs())

    def forward(self, faces: torch.Tensor, mels: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        v = self.face(faces).reshape(faces.shape[0], -1)[:, :EMBED]
        a = self.audio(mels).reshape(mels.shape[0], -1)[:, :EMBED]
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)
        a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
        return v, a


def init_params(seed: int = 2, img_size: int = 256, dtype=torch.float32,
                device="cpu") -> SyncNet:
    g = torch.Generator().manual_seed(seed)
    net = SyncNet(img_size)
    net.face.init_(g)
    net.audio.init_(g)
    return net.to(device=device, dtype=dtype)


def params_from_jax(tree: Dict[str, Any], dtype=torch.float32, device="cpu") -> SyncNet:
    # the face stack's length fixes its stride-2 tail; 16 * 2^n px is the
    # smallest crop with that tail
    net = SyncNet(16 * 2 ** (len(tree["face"]) - 10))
    net.face.load_jax_(tree["face"])
    net.audio.load_jax_(tree["audio"])
    return net.to(device=device, dtype=dtype)


def cosine_bce_loss(v_emb: torch.Tensor, a_emb: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """BCE on (cos + 1) / 2 against sync labels (1 = in sync)."""
    cos = (v_emb * a_emb).sum(-1)
    p = torch.clamp((cos + 1.0) * 0.5, 1e-6, 1.0 - 1e-6)
    return -torch.mean(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))


def sync_probability(net, faces: torch.Tensor, mels: torch.Tensor) -> torch.Tensor:
    """(B,) probability-like sync score in [0, 1]."""
    v, a = net(faces, mels)
    return ((v * a).sum(-1) + 1.0) * 0.5
