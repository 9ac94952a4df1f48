"""Wav2Lip-256 lip-sync U-Net (ports livetalking_tpu/models/wav2lip.py).

Same architecture tables as the reference package: a face encoder of 8
stride-2 conv stacks (6ch 256px -> 512ch 1px), an audio encoder collapsing
a (80, 16) mel window to a 512-vector, and a transposed-conv decoder with
skip concatenation, ending in an 80->32->3 sigmoid head.

  - BatchNorm is folded into the conv weights at load time;
  - convolutions are cuDNN's; serving runs bf16 in channels-last memory;
  - the public functions keep the reference's NHWC layout, so the tests
    compare like with like (an NHWC tensor permuted to NCHW is a
    channels-last view, no copy);
  - ``make_infer_fn`` is the whole per-batch step: face-cycle gather,
    lower-half mask, /255, U-Net, uint8, all on the device.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from livetalking_tpu_torch.models.layers import (
    ConvLayer,
    ConvSpec,
    fold_bn,
    to_numpy,
    torch_conv_to_hwio,
    torch_tconv_to_hwio,
)

C = ConvSpec


def _res(ch: int, n: int) -> List[ConvSpec]:
    return [C(ch, ch, 3, 1, 1, residual=True) for _ in range(n)]


# Face encoder: 8 blocks, input (B, 256, 256, 6) [masked||reference on channels]
FACE_ENCODER: List[List[ConvSpec]] = [
    [C(6, 16, 7, 1, 3)],
    [C(16, 32, 3, 2, 1)] + _res(32, 2),
    [C(32, 64, 3, 2, 1)] + _res(64, 3),
    [C(64, 128, 3, 2, 1)] + _res(128, 2),
    [C(128, 256, 3, 2, 1)] + _res(256, 2),
    [C(256, 512, 3, 2, 1)] + _res(512, 1),
    [C(512, 512, 3, 2, 1)] + _res(512, 1),
    [C(512, 512, 4, 1, 0), C(512, 512, 1, 1, 0)],
]

# Audio encoder: input (B, 80, 16, 1) mel window -> (B, 1, 1, 512)
AUDIO_ENCODER: List[ConvSpec] = [
    C(1, 32, 3, 1, 1), *_res(32, 2),
    C(32, 64, 3, (3, 1), 1), *_res(64, 2),
    C(64, 128, 3, 3, 1), *_res(128, 2),
    C(128, 256, 3, (3, 2), 1), *_res(256, 1),
    C(256, 512, 3, 1, 0),
    C(512, 512, 1, 1, 0),
]

# Decoder: transposed-conv upsampling with encoder skip concat after each block
FACE_DECODER: List[List[ConvSpec]] = [
    [C(512, 512, 1, 1, 0)],
    [C(1024, 512, 4, 1, 0, transpose=True), *_res(512, 1)],
    [C(1024, 512, 3, 2, 1, transpose=True, output_padding=1), *_res(512, 1)],
    [C(1024, 512, 3, 2, 1, transpose=True, output_padding=1), *_res(512, 2)],
    [C(768, 384, 3, 2, 1, transpose=True, output_padding=1), *_res(384, 2)],
    [C(512, 256, 3, 2, 1, transpose=True, output_padding=1), *_res(256, 2)],
    [C(320, 128, 3, 2, 1, transpose=True, output_padding=1), *_res(128, 2)],
    [C(160, 64, 3, 2, 1, transpose=True, output_padding=1), *_res(64, 2)],
]

OUTPUT_BLOCK: List[ConvSpec] = [
    C(80, 32, 3, 1, 1),
    C(32, 3, 1, 1, 0, bn=False, act="sigmoid"),
]


def _seq(specs: List[ConvSpec]) -> nn.Sequential:
    return nn.Sequential(*[ConvLayer(s) for s in specs])


class Wav2Lip(nn.Module):
    """The network; ``forward`` takes and returns NHWC tensors."""

    def __init__(self):
        super().__init__()
        self.face_encoder_blocks = nn.ModuleList([_seq(b) for b in FACE_ENCODER])
        self.audio_encoder = _seq(AUDIO_ENCODER)
        self.face_decoder_blocks = nn.ModuleList([_seq(b) for b in FACE_DECODER])
        self.output_block = _seq(OUTPUT_BLOCK)

    def forward(self, mel: torch.Tensor, face: torch.Tensor) -> torch.Tensor:
        """mel (B, 80, 16, 1) normalized window, face (B, 256, 256, 6) in
        [0, 1] ([masked face, reference] on channels) -> (B, 256, 256, 3)
        RGB in [0, 1], float32."""
        skips = []
        x = face.permute(0, 3, 1, 2)
        for blk in self.face_encoder_blocks:
            x = blk(x)
            skips.append(x)
        x = self.audio_encoder(mel.permute(0, 3, 1, 2))
        for blk in self.face_decoder_blocks:
            x = blk(x)
            x = torch.cat([x, skips.pop()], dim=1)
        return self.output_block(x).permute(0, 2, 3, 1).float()

    def layers(self):
        """(layer, reference tree key path) for every ConvLayer, in tree order."""
        for i, blk in enumerate(self.face_encoder_blocks):
            for j, layer in enumerate(blk):
                yield layer, ("face_enc", i, j)
        for j, layer in enumerate(self.audio_encoder):
            yield layer, ("audio_enc", j)
        for i, blk in enumerate(self.face_decoder_blocks):
            for j, layer in enumerate(blk):
                yield layer, ("face_dec", i, j)
        for j, layer in enumerate(self.output_block):
            yield layer, ("out", j)


def init_model(seed: int = 0) -> Wav2Lip:
    """Random (He-normal) weights from ``torch.Generator(seed)``; BN identity."""
    g = torch.Generator().manual_seed(seed)
    model = Wav2Lip()
    for layer, _ in model.layers():
        layer.init_(g)
    return model.eval()


def params_from_jax(tree: Dict[str, Any]) -> Wav2Lip:
    """Load the reference package's folded parameter tree.

    ``tree`` is ``livetalking_tpu.models.wav2lip.init_params`` or
    ``convert_torch_state_dict`` output with leaves converted to numpy:
    ``{"face_enc": [[{"w": HWIO, "b"}, ...], ...], "audio_enc": [...],
    "face_dec": [[...]], "out": [...]}``."""
    model = Wav2Lip()
    for layer, path in model.layers():
        node = tree
        for k in path:
            node = node[k]
        layer.load_hwio_(np.asarray(node["w"], np.float32), np.asarray(node["b"], np.float32))
    return model.eval()


def _convert_layer(sd: Dict[str, np.ndarray], prefix: str, spec: ConvSpec) -> Dict[str, np.ndarray]:
    """One reference layer (conv_block.0 conv [+ conv_block.1 BN]) -> folded HWIO."""
    if spec.bn:
        w_t = np.asarray(sd[f"{prefix}.conv_block.0.weight"], np.float32)
        b_t = sd.get(f"{prefix}.conv_block.0.bias")
        b_t = None if b_t is None else np.asarray(b_t, np.float32)
        w = torch_tconv_to_hwio(w_t) if spec.transpose else torch_conv_to_hwio(w_t)
        w, b = fold_bn(
            w, b_t,
            np.asarray(sd[f"{prefix}.conv_block.1.weight"], np.float32),
            np.asarray(sd[f"{prefix}.conv_block.1.bias"], np.float32),
            np.asarray(sd[f"{prefix}.conv_block.1.running_mean"], np.float32),
            np.asarray(sd[f"{prefix}.conv_block.1.running_var"], np.float32),
        )
    else:  # plain nn.Conv2d (final output layer)
        w = torch_conv_to_hwio(np.asarray(sd[f"{prefix}.weight"], np.float32))
        b = np.asarray(sd[f"{prefix}.bias"], np.float32)
    return {"w": w, "b": b}


def convert_torch_state_dict(sd: Dict[str, Any]) -> Wav2Lip:
    """Reference ``wav2lip.pth`` state_dict -> the port's module, BN folded.

    Accepts the raw ``checkpoint["state_dict"]`` with optional ``module.``
    prefixes. Tensors may be torch tensors or numpy arrays."""
    sd = {k[len("module."):] if k.startswith("module.") else k: to_numpy(v) for k, v in sd.items()}

    def blk(prefix: str, specs: List[ConvSpec]):
        return [_convert_layer(sd, f"{prefix}.{j}", s) for j, s in enumerate(specs)]

    return params_from_jax({
        "face_enc": [blk(f"face_encoder_blocks.{i}", b) for i, b in enumerate(FACE_ENCODER)],
        "audio_enc": blk("audio_encoder", AUDIO_ENCODER),
        "face_dec": [blk(f"face_decoder_blocks.{i}", b) for i, b in enumerate(FACE_DECODER)],
        "out": blk("output_block", OUTPUT_BLOCK),
    })


def load_torch_checkpoint(path: str) -> Wav2Lip:
    """Load the reference ``wav2lip.pth`` (on the CPU) and convert."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_torch_state_dict(ckpt.get("state_dict", ckpt))


def prepare(model: Wav2Lip, device, dtype: torch.dtype) -> Wav2Lip:
    """Move to ``device``/``dtype`` in channels-last memory, eval mode."""
    return model.to(device=device, dtype=dtype, memory_format=torch.channels_last).eval()


# ---------------------------------------------------------------------------
# the per-batch inference step
# ---------------------------------------------------------------------------

def make_infer_fn(batch_size: int, img_size: int = 256, dtype: torch.dtype = torch.bfloat16):
    """Build the device step:

        (model, face_cycle_u8 (N, S, S, 3), idxs (B,), mel (B, 80, 16))
            -> frames_u8 (B, S, S, 3)

    The reference's host-side batch prep (gather, lower-half mask, concat,
    /255) runs on the device; ``face_cycle_u8`` stays resident there, only
    B indices go up per step. ``model`` must already be in ``dtype`` on the
    tensors' device (``prepare``). On a device mesh the same step takes
    ``parallel.mesh.shard_params(model, mesh)`` (tp) and each rank's
    ``shard_batch`` rows (dp, ``batch_size`` = B / dp); ``gather_batch``
    joins the frames."""
    half = img_size // 2

    @torch.inference_mode()
    def step(model: Wav2Lip, face_cycle: torch.Tensor, idxs: torch.Tensor,
             mel: torch.Tensor) -> torch.Tensor:
        if idxs.shape[0] != batch_size:
            raise ValueError(f"step built for B={batch_size}, got {idxs.shape[0]} indices")
        faces = face_cycle.index_select(0, idxs)                # (B, S, S, 3) uint8
        f = faces.to(dtype) / 255.0
        masked = f.clone()
        masked[:, half:] = 0
        x = torch.cat([masked, f], dim=-1)                       # (B, S, S, 6)
        out = model(mel.to(dtype)[..., None], x)                 # (B, S, S, 3) f32
        return (out * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)

    return step


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
