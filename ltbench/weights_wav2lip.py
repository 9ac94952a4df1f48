"""Random Wav2Lip-256 weights from the seed, in LiveTalking's checkpoint layout.

``state_dict(cfg, seed, device, avatars)`` returns the ``state_dict`` of
``wav2lip256.pth`` at the configuration's widths, BatchNorm unfolded: every
conv layer ``<p>.conv_block.0.{weight,bias}`` and ``<p>.conv_block.1.{weight,
bias,running_mean,running_var}``, the last layer ``output_block.1.{weight,
bias}``. Conv weights are N(0, 1 / fan_in), biases N(0, bias_std^2), the
BatchNorm scale 1 + N(0, bn_affine_std^2) (times ``res_bn_scale`` in the
residual layers) and shift N(0, bn_affine_std^2), all from one
``torch.Generator`` on ``device`` in one draw.

A network with random weights and identity BatchNorm statistics grows its
activations layer by layer, and its sigmoid then saturates: every output
level is 0 or 255 whatever the precision. So the running statistics are set
as training sets them, to the statistics of real inputs: one float32 pass of
the plain reference over calibration inputs (two faces of each of the first
``calibration_avatars`` avatars, with mel windows of the seed's speech)
normalises each layer with its own batch statistics and records them. The
same pass scales the last conv so that the sigmoid's input has a standard
deviation of ``logit_std`` over the calibration frames, and a mean of zero
per channel: the responsive range of the sigmoid.

With unit BatchNorm scales in its 31 residual layers the random network
amplifies a perturbation layer by layer: one bfloat16 rounding per layer
moved its output by about 200 levels squared (mean squared, 256 px faces).
A small scale on the residual branch's BatchNorm (``res_bn_scale``, the
"zero-gamma" initialisation of residual networks, here 0.1) keeps each
residual layer near the identity, and the output near a trained network's
sensitivity: about 11 levels squared for that rounding.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ltbench import reference_wav2lip as ref
from ltbench.traffic import Speech

Spec = Tuple[str, tuple, str, int]   # key, shape, kind, fan-in


def layers(cfg: dict) -> List[Tuple[str, list]]:
    """(key prefix, layer table entry) of every conv layer, in order."""
    out = []
    for i, blk in enumerate(cfg["face_encoder"]):
        out += [(f"face_encoder_blocks.{i}.{j}", s) for j, s in enumerate(blk)]
    out += [(f"audio_encoder.{j}", s) for j, s in enumerate(cfg["audio_encoder"])]
    for i, blk in enumerate(cfg["face_decoder"]):
        out += [(f"face_decoder_blocks.{i}.{j}", s) for j, s in enumerate(blk)]
    out += [(f"output_block.{j}", s) for j, s in enumerate(cfg["output_block"])]
    return out


def specs(cfg: dict) -> List[Spec]:
    out: List[Spec] = []
    for p, (cin, cout, k, _s, _p, kind, *_rest) in layers(cfg):
        fan_in = cin * k * k
        if kind == "out":
            out += [(p + ".weight", (cout, cin, k, k), "w", fan_in),
                    (p + ".bias", (cout,), "b", 0)]
            continue
        shape = (cin, cout, k, k) if kind == "tconv" else (cout, cin, k, k)
        c = p + ".conv_block."
        out += [(c + "0.weight", shape, "w", fan_in), (c + "0.bias", (cout,), "b", 0),
                (c + "1.weight", (cout,), "gres" if kind == "res" else "g", 0),
                (c + "1.bias", (cout,), "beta", 0),
                (c + "1.running_mean", (cout,), "zero", 0),
                (c + "1.running_var", (cout,), "one", 0)]
    return out


def _fill(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    w = cfg["weights"]
    sp = specs(cfg)
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + 5) % (2 ** 63))
    sizes = [int(np.prod(shape)) for _, shape, _, _ in sp]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    out, off = {}, 0
    for (key, shape, kind, fan_in), n in zip(sp, sizes):
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "w":
            t.mul_(1.0 / math.sqrt(fan_in))
        elif kind == "b":
            t.mul_(w["bias_std"])
        elif kind in ("g", "gres"):
            t.mul_(w["bn_affine_std"]).add_(1.0)
            if kind == "gres":
                t.mul_(w["res_bn_scale"])
        elif kind == "beta":
            t.mul_(w["bn_affine_std"])
        elif kind == "zero":
            t.zero_()
        else:
            t.fill_(1.0)
        out[key] = t
    return out


def calibration_inputs(cfg: dict, seed: int, avatars: List[dict], device) -> tuple:
    """(mel (n, 1, 80, 16), faces (n, 6, S, S)): two faces of each of the first
    ``calibration_avatars`` avatars, frames 0 and N / 2, beside windows 0 and 8 of
    the first 52 speech chunks of that avatar's session."""
    mc, sv = cfg["mel"], cfg["serving"]
    speech = Speech(seed)
    mels, faces = [], []
    for k, a in enumerate(avatars[:int(cfg["weights"]["calibration_avatars"])]):
        n = len(a["faces"])
        pcm = np.concatenate([speech.chunk(k, c) for c in range(52)])
        spec = ref.log_mel(torch.from_numpy(pcm).to(device), mc)
        win = ref.mel_windows(spec, 16, sv["l"], sv["fps"], mc["mel_step_size"])
        mels += [win[0], win[8]]
        faces += [torch.from_numpy(np.ascontiguousarray(a["faces"][i])).to(device)
                  for i in (0, n // 2)]
    return torch.stack(mels)[:, None], ref.face_input(torch.stack(faces))


@torch.inference_mode()
def state_dict(cfg: dict, seed: int, device, avatars: List[dict]) -> Dict[str, torch.Tensor]:
    """The checkpoint's state dict (float32 on ``device``), its running
    statistics and last layer set on calibration inputs from ``avatars``."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        sd = _fill(cfg, seed, device)
        mel, face = calibration_inputs(cfg, seed, avatars, device)
        stats: Dict[str, torch.Tensor] = {}
        logits = ref.network(sd, cfg, mel, face, stats=stats,
                             var_floor=cfg["weights"]["bn_var_floor"])
        sd.update(stats)
        last = "output_block.%d" % (len(cfg["output_block"]) - 1)
        scale = cfg["weights"]["logit_std"] / logits.std().clamp(min=1e-12)
        mean = logits.mean(dim=(0, 2, 3))
        sd[last + ".weight"].mul_(scale)
        sd[last + ".bias"].sub_(mean).mul_(scale)
        return sd
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
