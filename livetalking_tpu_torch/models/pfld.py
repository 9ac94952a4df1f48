"""PFLD-GhostOne landmark regressor: the Ultralight avatar build's
110-point landmark stage (ports livetalking_tpu/models/pfld.py; reference
avatars/ultralight/face_detect_utils/pfld_mobileone.py:12-134 and
get_landmark.py:70-114).

The reference network is MobileOne/GhostOne: every conv is a train-time
multi-branch block (N kxk conv+BN branches, a 1x1 scale branch, a BN skip).
``convert_torch_state_dict`` folds the branches of the shipped checkpoint
(``checkpoint_epoch_335.pth.tar``, key ``pfld_backbone``) into one conv
each (RepVGG-style: fold each conv+BN, pad the 1x1 scale kernel to the
centre, add an identity kernel for the skip BN, sum), so the forward is
plain conv + bias + ReLU (cuDNN, NCHW). The global pools are means over
the feature map (the reference's ``AvgPool2d(size // 2)`` of a map of
that size).

Output = 220 offsets + the training mean face (``mean_face.txt`` next to
the checkpoint, reference get_landmark.py:74), scaled by the crop size.
Parameters: ``{"conv1": {"w": (O, I/g, k, k), "b": (O,)}, ...}``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.models.layers import to_numpy
from livetalking_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

WIDTH = 0.5
INPUT_SIZE = 192
N_LANDMARKS = 110
N_BRANCHES = 6  # reference pfld_mobileone.py:17 num_conv_branches


def _c(x: int) -> int:
    return int(x * WIDTH)


# ghost bottlenecks in forward order: (name, cin, hidden, cout, stride)
_GHOSTS = [
    ("conv3_1", _c(64), _c(96), _c(80), 2),
    ("conv3_2", _c(80), _c(120), _c(80), 1),
    ("conv3_3", _c(80), _c(120), _c(80), 1),
    ("conv4_1", _c(80), _c(200), _c(96), 2),
    ("conv4_2", _c(96), _c(240), _c(96), 1),
    ("conv4_3", _c(96), _c(240), _c(96), 1),
    ("conv5_1", _c(96), _c(336), _c(144), 2),
    ("conv5_2", _c(144), _c(504), _c(144), 1),
    ("conv5_3", _c(144), _c(504), _c(144), 1),
    ("conv5_4", _c(144), _c(504), _c(144), 1),
    ("conv6", _c(144), _c(216), _c(16), 1),
]


def _conv(p: Params, x: torch.Tensor, stride: int = 1, padding: int = 0, groups: int = 1,
          relu: bool = False) -> torch.Tensor:
    y = F.conv2d(x, p["w"], p["b"], stride=stride, padding=padding, groups=groups)
    return torch.relu(y) if relu else y


def _ghost_module(p: Params, x: torch.Tensor, relu: bool) -> torch.Tensor:
    """GhostOneModule: 1x1 primary + depthwise 3x3 cheap, concatenated
    (reference base_module.py:88-120)."""
    x1 = _conv(p["primary"], x, relu=relu)
    x2 = _conv(p["cheap"], x1, padding=1, groups=x1.shape[1], relu=relu)
    return torch.cat([x1, x2], dim=1)


def _ghost_bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """GhostOneBottleneck: ghost(relu) -> [dw s2 linear] -> ghost(linear),
    no residual (reference base_module.py:123-152)."""
    h = _ghost_module(p["ghost1"], x, relu=True)
    if stride == 2:
        h = _conv(p["dw"], h, stride=2, padding=1, groups=h.shape[1])
    return _ghost_module(p["ghost2"], h, relu=False)


def _pool(h: torch.Tensor) -> torch.Tensor:
    return h.mean(dim=(2, 3), keepdim=True)


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, 3, 192, 192) BGR in [0, 1] -> (B, 220) landmark offsets
    (reference pfld_mobileone.py:99-134: multi-scale global-pool concat,
    then a 1x1 conv head)."""
    h = _conv(params["conv1"], x, stride=2, padding=1, relu=True)
    h = _conv(params["conv2"], h, padding=1, groups=h.shape[1], relu=True)
    pooled = [_pool(h)]
    for lo, hi in ((0, 3), (3, 6), (6, 10)):
        for name, _cin, _hid, _cout, stride in _GHOSTS[lo:hi]:
            h = _ghost_bottleneck(params[name], h, stride)
        pooled.append(_pool(h))
    h = _ghost_bottleneck(params["conv6"], h, 1)
    h = _conv(params["conv7"], h, padding=1, relu=True)
    pooled.append(_conv(params["conv8"], h, relu=True))  # 12x12 VALID conv -> 1x1
    out = _conv(params["conv_out"], torch.cat(pooled, dim=1))  # (B, 220, 1, 1)
    return out.reshape(out.shape[0], -1).float()


# ---------------------------------------------------------------------------
# conversion: fold the MobileOne train-time branches into plain convs
# ---------------------------------------------------------------------------


def _np_(v) -> np.ndarray:
    return to_numpy(v).astype(np.float32)


def _fold_conv_bn(w, bn_g, bn_b, bn_m, bn_v, eps=1e-5):
    """(out, in/g, kh, kw) conv + BN stats -> folded (w, b)."""
    s = bn_g / np.sqrt(bn_v + eps)
    return w * s[:, None, None, None], bn_b - bn_m * s


def _pad_center(w, k):
    """Pad a (out, in/g, 1, 1) kernel to kxk at the centre."""
    if w.shape[-1] == k:
        return w
    out = np.zeros(w.shape[:2] + (k, k), np.float32)
    out[:, :, k // 2, k // 2] = w[:, :, 0, 0]
    return out


def _identity_kernel(cin, cout, groups, k):
    """Identity conv kernel for the skip-BN branch (cin == cout)."""
    w = np.zeros((cout, cin // groups, k, k), np.float32)
    per = cin // groups
    for i in range(cout):
        w[i, i % per, k // 2, k // 2] = 1.0
    return w


def _fold_mobileone(sd, prefix, cin, cout, k, groups):
    """Fold a train-mode MobileOneBlock (reference base_module.py:193-298:
    num_conv_branches conv+BN branches, an optional 1x1 scale branch, an
    optional skip BN) into one (w, b) in numpy. Branches under the
    reference's named children (``rbr_conv.{i}.conv.weight`` /
    ``.bn.*``, base_module.py:402-419) or an indexed ``.0/.1`` Sequential;
    an inference-mode ``reparam_conv`` is taken as it is. A block with
    neither raises."""
    W = np.zeros((cout, cin // groups, k, k), np.float32)
    B = np.zeros((cout,), np.float32)

    def bn(p):
        return (_np_(sd[f"{p}.weight"]), _np_(sd[f"{p}.bias"]),
                _np_(sd[f"{p}.running_mean"]), _np_(sd[f"{p}.running_var"]))

    def conv_bn_keys(b):
        if f"{b}.conv.weight" in sd:        # reference named layout
            return f"{b}.conv.weight", f"{b}.bn"
        if f"{b}.0.weight" in sd:           # indexed Sequential layout
            return f"{b}.0.weight", f"{b}.1"
        return None

    folded = 0
    for i in range(N_BRANCHES):
        kk = conv_bn_keys(f"{prefix}.rbr_conv.{i}")
        if kk is None:
            break
        w, bias = _fold_conv_bn(_np_(sd[kk[0]]), *bn(kk[1]))
        W += w
        B += bias
        folded += 1
    kk = conv_bn_keys(f"{prefix}.rbr_scale")
    if kk is not None:  # 1x1 scale branch (k > 1)
        w, bias = _fold_conv_bn(_np_(sd[kk[0]]), *bn(kk[1]))
        W += _pad_center(w, k)
        B += bias
    if f"{prefix}.rbr_skip.weight" in sd:  # skip BN (cin == cout, s == 1)
        w, bias = _fold_conv_bn(_identity_kernel(cin, cout, groups, k), *bn(f"{prefix}.rbr_skip"))
        W += w
        B += bias
    if f"{prefix}.reparam_conv.weight" in sd:  # inference-mode checkpoint
        W = _np_(sd[f"{prefix}.reparam_conv.weight"])
        B = _np_(sd[f"{prefix}.reparam_conv.bias"])
    elif folded == 0:
        raise KeyError(f"{prefix}: no rbr_conv branches or reparam_conv in state "
                       "dict (unrecognized MobileOne key layout)")
    return {"w": W, "b": B}


def _fold_conv_block(sd, prefix, has_bn=True):
    """Conv_Block = conv (no bias) + optional BN (base_module.py:12-17)."""
    w = _np_(sd[f"{prefix}.0.weight"])
    if has_bn:
        w, b = _fold_conv_bn(w, *(_np_(sd[f"{prefix}.1.{n}"])
                                  for n in ("weight", "bias", "running_mean", "running_var")))
    else:
        b = np.zeros((w.shape[0],), np.float32)
    return {"w": w, "b": b}


def _ghost_params(sd, prefix, cin, hid, cout, stride):
    half_h, half_o = math.ceil(hid / 2), math.ceil(cout / 2)
    g1 = f"{prefix}.ghost_conv.0"
    g2 = f"{prefix}.ghost_conv.2"
    p = {
        "ghost1": {"primary": _fold_mobileone(sd, f"{g1}.primary_conv", cin, half_h, 1, 1),
                   "cheap": _fold_mobileone(sd, f"{g1}.cheap_operation", half_h, half_h, 3,
                                            half_h)},
        "ghost2": {"primary": _fold_mobileone(sd, f"{g2}.primary_conv", 2 * half_h, half_o, 1, 1),
                   "cheap": _fold_mobileone(sd, f"{g2}.cheap_operation", half_o, half_o, 3,
                                            half_o)},
    }
    if stride == 2:
        p["dw"] = _fold_mobileone(sd, f"{prefix}.ghost_conv.1", 2 * half_h, 2 * half_h, 3,
                                  2 * half_h)
    return p


def _to_torch(tree, dtype, device):
    """Nested {"w", "b"} numpy leaves -> tensors on ``device``."""
    if "w" in tree:
        return {k: torch.from_numpy(np.array(v, np.float32)).to(device=device, dtype=dtype)
                for k, v in tree.items()}
    return {k: _to_torch(v, dtype, device) for k, v in tree.items()}


def convert_torch_state_dict(sd: Dict[str, Any], dtype=torch.float32, device="cpu") -> Params:
    """``checkpoint_epoch_335.pth.tar``-style state dict (optionally under
    a ``pfld_backbone`` key, reference get_landmark.py:79-80). The unused
    ``localization`` STN head is ignored."""
    if "pfld_backbone" in sd and isinstance(sd["pfld_backbone"], dict):
        sd = sd["pfld_backbone"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    p: Params = {
        "conv1": _fold_mobileone(sd, "conv1", 3, _c(64), 3, 1),
        "conv2": _fold_mobileone(sd, "conv2", _c(64), _c(64), 3, _c(64)),
    }
    for name, cin, hid, cout, stride in _GHOSTS:
        p[name] = _ghost_params(sd, name, cin, hid, cout, stride)
    p["conv7"] = _fold_mobileone(sd, "conv7", _c(16), _c(32), 3, 1)
    p["conv8"] = _fold_conv_block(sd, "conv8", has_bn=False)
    p["conv_out"] = {"w": _np_(sd["conv_out.weight"]), "b": _np_(sd["conv_out.bias"])}
    return _to_torch(p, dtype, resolve_device(device))


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's tree (HWIO convs, as numpy arrays) -> the port's."""
    def conv(t):
        if "w" in t:
            return {"w": np.asarray(t["w"], np.float32).transpose(3, 2, 0, 1), "b": t["b"]}
        return {k: conv(v) for k, v in t.items()}

    return _to_torch(conv(tree), dtype, resolve_device(device))


# ---------------------------------------------------------------------------
# random init (zero-checkpoint convention)
# ---------------------------------------------------------------------------


def init_params(seed: int = 0, dtype=torch.float32, device="cpu") -> Params:
    """Random convs N(0, (0.4/sqrt(fan_in))^2) from ``torch.Generator(seed)``,
    zero biases."""
    g = torch.Generator().manual_seed(seed)

    def r(k, cin, cout, groups):
        fan = k * k * cin // groups
        w = torch.randn((cout, cin // groups, k, k), generator=g) * (0.4 / np.sqrt(fan))
        return {"w": w.numpy(), "b": np.zeros(cout, np.float32)}

    p: Params = {"conv1": r(3, 3, _c(64), 1), "conv2": r(3, _c(64), _c(64), _c(64))}
    for name, cin, hid, cout, stride in _GHOSTS:
        hh, ho = math.ceil(hid / 2), math.ceil(cout / 2)
        blk = {"ghost1": {"primary": r(1, cin, hh, 1), "cheap": r(3, hh, hh, hh)},
               "ghost2": {"primary": r(1, 2 * hh, ho, 1), "cheap": r(3, ho, ho, ho)}}
        if stride == 2:
            blk["dw"] = r(3, 2 * hh, 2 * hh, 2 * hh)
        p[name] = blk
    p["conv7"] = r(3, _c(16), _c(32), 1)
    p["conv8"] = r(INPUT_SIZE // 16, _c(32), _c(128), 1)
    p["conv_out"] = r(1, _c(512), 2 * N_LANDMARKS, 1)
    return _to_torch(p, dtype, resolve_device(device))


# ---------------------------------------------------------------------------
# Landmark front end (reference get_landmark.py Landmark.detect contract)
# ---------------------------------------------------------------------------


class PFLDLandmarker:
    """Crop-and-regress landmarker: square 1.05x face crop -> 192 px ->
    PFLD on ``device`` (the card unless the caller asks for the CPU) ->
    offsets + mean face, scaled back to crop pixels (reference
    get_landmark.py:83-114)."""

    def __init__(self, params: Params, mean_face: np.ndarray, device="cuda"):
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        if mean_face.shape != (2 * N_LANDMARKS,):
            raise ValueError(f"mean face {mean_face.shape}, expected ({2 * N_LANDMARKS},)")
        self.mean_face = mean_face.astype(np.float32)

    @torch.no_grad()
    def offsets(self, inp: np.ndarray) -> np.ndarray:
        """(B, 192, 192, 3) f32 BGR in [0, 1] -> (B, 220) offsets."""
        x = torch.from_numpy(np.ascontiguousarray(inp, np.float32)).to(self.device)
        return apply(self.params, x.permute(0, 3, 1, 2)).cpu().numpy()

    def landmarks(self, frame_bgr: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
        """(110, 2) int32 landmark pixels in frame coordinates."""
        import cv2

        H, W = frame_bgr.shape[:2]
        x1, y1, x2, y2 = box
        cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
        size = int(max(x2 - x1, y2 - y1) * 1.05)
        sx, sy = cx - size // 2, cy - size // 2
        ex, ey = sx + size, sy + size
        dx, dy = max(0, -sx), max(0, -sy)
        edx, edy = max(0, ex - W), max(0, ey - H)
        crop = frame_bgr[max(0, sy):min(H, ey), max(0, sx):min(W, ex)]
        if dx or dy or edx or edy:
            crop = cv2.copyMakeBorder(crop, dy, edy, dx, edx, cv2.BORDER_CONSTANT, 0)
        ch, cw = crop.shape[:2]
        inp = cv2.resize(crop, (INPUT_SIZE, INPUT_SIZE)).astype(np.float32) / 255.0
        lm = (self.offsets(inp[None])[0] + self.mean_face).reshape(-1, 2)
        lm[:, 0] *= cw
        lm[:, 1] *= ch
        lm[:, 0] += max(0, sx) - dx
        lm[:, 1] += max(0, sy) - dy
        return lm.astype(np.int32)


def _to_device(tree, device):
    if torch.is_tensor(tree):
        return tree.to(device)
    return {k: _to_device(v, device) for k, v in tree.items()}


def load_mean_face(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray(f.read().split(), np.float32)
