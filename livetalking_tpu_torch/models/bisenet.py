"""BiSeNet face parsing (19 classes) (ports livetalking_tpu/models/bisenet.py;
reference avatars/musetalk/utils/face_parsing/model.py + resnet.py): a
ResNet18 context path, attention-refinement modules, feature fusion and a
19-class head, used offline to build the feathered mouth-region masks
(reference avatars/musetalk/utils/blending.py:112-136).

NCHW tensors (channels-last in memory on the card), BatchNorm folded into
the convs at load, cuDNN convs. Parameters: ``{block: [{"w": (O, I, k, k),
"b": (O,)}, ...]}`` in the order of the JAX package's ``ConvSpec`` tables.

Two of the reference's XLA ops need care:

- the stem's max-pool is ``reduce_window(..., "SAME")``: 3x3, stride 2,
  padded only as far as SAME pads (for an even side: none before, one
  after), which is not ``max_pool2d(3, 2, padding=1)``;
- ``jax.image.resize(..., "bilinear")`` is half-pixel bilinear; it
  antialiases only when it shrinks, and every resize here enlarges (the
  /32 features to /16, /16 to /8, /8 to the input size), where it equals
  ``F.interpolate(mode="bilinear", align_corners=False)``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.models.layers import (
    ConvSpec,
    fold_bn,
    hwio_to_torch_conv,
    to_numpy,
    torch_conv_to_hwio,
)
from livetalking_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]

N_CLASSES = 19
# face-parsing class ids (reference face_parsing/__init__.py usage):
# 1 skin, 10 nose, 11 mouth-interior, 12 upper lip, 13 lower lip
MOUTH_CLASSES = (10, 11, 12, 13)
JAW_CLASSES = (1, 10, 11, 12, 13)
MEAN_RGB = (0.485, 0.456, 0.406)
STD_RGB = (0.229, 0.224, 0.225)


# --- architecture table ----------------------------------------------------


def _resnet18_specs() -> Dict[str, List[ConvSpec]]:
    """conv1 + 4 stages x 2 basic blocks (3x3+3x3, stride on the first
    block of stages 2-4; 1x1 downsample shortcuts)."""
    specs: Dict[str, List[ConvSpec]] = {"stem": [ConvSpec(3, 64, kernel=7, stride=2, padding=3)]}
    chans = [(64, 64, 1), (64, 128, 2), (128, 256, 2), (256, 512, 2)]
    for si, (cin, cout, stride) in enumerate(chans):
        blocks: List[ConvSpec] = []
        for bi in range(2):
            s = stride if bi == 0 else 1
            blocks += [
                ConvSpec(cin if bi == 0 else cout, cout, kernel=3, stride=s, padding=1),
                ConvSpec(cout, cout, kernel=3, stride=1, padding=1, act=None),
            ]
            if bi == 0 and (s != 1 or cin != cout):
                blocks.append(ConvSpec(cin, cout, kernel=1, stride=s, padding=0, act=None))
        specs[f"layer{si + 1}"] = blocks
    return specs


def _head_specs() -> Dict[str, List[ConvSpec]]:
    return {
        # attention refinement: 3x3 conv then channel attention (1x1, no act)
        "arm16": [ConvSpec(256, 128, kernel=3, stride=1, padding=1),
                  ConvSpec(128, 128, kernel=1, stride=1, padding=0, act=None)],
        "arm32": [ConvSpec(512, 128, kernel=3, stride=1, padding=1),
                  ConvSpec(128, 128, kernel=1, stride=1, padding=0, act=None)],
        "conv_avg": [ConvSpec(512, 128, kernel=1, stride=1, padding=0)],
        "head32": [ConvSpec(128, 128, kernel=3, stride=1, padding=1)],
        "head16": [ConvSpec(128, 128, kernel=3, stride=1, padding=1)],
        # feature fusion: 1x1 fuse + channel attention bottleneck
        "ffm": [ConvSpec(256, 256, kernel=1, stride=1, padding=0)],
        "ffm_att1": [ConvSpec(256, 64, kernel=1, stride=1, padding=0)],
        "ffm_att2": [ConvSpec(64, 256, kernel=1, stride=1, padding=0, act=None)],
        "out1": [ConvSpec(256, 256, kernel=3, stride=1, padding=1)],
        "out2": [ConvSpec(256, N_CLASSES, kernel=1, stride=1, padding=0, act=None, bn=False)],
    }


SPECS = {**_resnet18_specs(), **_head_specs()}


# --- forward ---------------------------------------------------------------


def _layer(p: Dict, spec: ConvSpec, x: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x, p["w"], p["b"], stride=spec.stride, padding=spec.padding)
    if spec.act == "relu":
        y = torch.relu(y)
    return y


def _run(params: List[Dict], specs: List[ConvSpec], x: torch.Tensor) -> torch.Tensor:
    for p, s in zip(params, specs):
        x = _layer(p, s, x)
    return x


def _basic_stage(params: List[Dict], specs: List[ConvSpec], x: torch.Tensor) -> torch.Tensor:
    """Two ResNet basic blocks from the flat spec list built above."""
    i = 0
    for bi in range(2):
        y = _layer(params[i + 1], specs[i + 1], _layer(params[i], specs[i], x))
        if bi == 0 and i + 2 < len(specs) and specs[i + 2].kernel == 1:
            sc = _layer(params[i + 2], specs[i + 2], x)
            i += 3
        else:
            sc = x
            i += 2
        x = torch.relu(y + sc)
    return x


def _maxpool_same(x: torch.Tensor, k: int = 3, s: int = 2) -> torch.Tensor:
    """``reduce_window(max, k, s, "SAME")``: output ceil(n / s), padded
    with -inf by SAME's split (the smaller half before)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.max_pool2d(F.pad(x, pads, value=float("-inf")), k, s)


def _upsize(x: torch.Tensor, size) -> torch.Tensor:
    if x.shape[2] > size[0] or x.shape[3] > size[1]:
        raise ValueError(f"resize {tuple(x.shape[2:])} -> {tuple(size)} shrinks: the "
                         "reference antialiases there")
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)


def _arm(params: List[Dict], specs: List[ConvSpec], x: torch.Tensor) -> torch.Tensor:
    feat = _layer(params[0], specs[0], x)
    att = torch.sigmoid(_layer(params[1], specs[1], feat.mean(dim=(2, 3), keepdim=True)))
    return feat * att


def apply(params: Params, img: torch.Tensor) -> torch.Tensor:
    """img: (B, 3, H, W) f32, ImageNet-normalized RGB. Returns
    (B, 19, H, W) class logits."""
    S = SPECS
    H, W = img.shape[2:]
    x = _maxpool_same(_run(params["stem"], S["stem"], img))
    x = _basic_stage(params["layer1"], S["layer1"], x)
    feat8 = _basic_stage(params["layer2"], S["layer2"], x)        # /8, 128
    feat16 = _basic_stage(params["layer3"], S["layer3"], feat8)   # /16, 256
    feat32 = _basic_stage(params["layer4"], S["layer4"], feat16)  # /32, 512

    avg = _run(params["conv_avg"], S["conv_avg"], feat32.mean(dim=(2, 3), keepdim=True))
    a32 = _arm(params["arm32"], S["arm32"], feat32) + avg
    a32 = _run(params["head32"], S["head32"], _upsize(a32, feat16.shape[2:]))

    a16 = _arm(params["arm16"], S["arm16"], feat16) + a32
    a16 = _run(params["head16"], S["head16"], _upsize(a16, feat8.shape[2:]))

    fused = _run(params["ffm"], S["ffm"], torch.cat([feat8, a16], dim=1))
    att = _run(params["ffm_att1"], S["ffm_att1"], fused.mean(dim=(2, 3), keepdim=True))
    att = torch.sigmoid(_run(params["ffm_att2"], S["ffm_att2"], att))
    fused = fused * att + fused

    out = _run(params["out2"], S["out2"], _run(params["out1"], S["out1"], fused))
    return _upsize(out, (H, W))


def make_parse_fn(size: int = 512, dtype=torch.float32):
    """(params, faces_bgr_u8 (B, size, size, 3) array or tensor) ->
    (B, size, size) int32 class map on the parameters' device (the
    reference FaceParsing.__call__ contract): BGR flipped to RGB,
    ImageNet-normalized, parsed, argmax over the classes."""

    @torch.no_grad()
    def parse(params, faces_bgr) -> torch.Tensor:
        dev = params["stem"][0]["w"].device
        faces = torch.as_tensor(faces_bgr).to(dev)
        if tuple(faces.shape[1:]) != (size, size, 3):
            raise ValueError(f"faces {tuple(faces.shape)}: expected (B, {size}, {size}, 3)")
        rgb = faces.flip(-1).to(dtype) / 255.0
        mean = torch.tensor(MEAN_RGB, dtype=dtype, device=dev)
        std = torch.tensor(STD_RGB, dtype=dtype, device=dev)
        x = ((rgb - mean) / std).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        return torch.argmax(apply(params, x), dim=1).to(torch.int32)

    return parse


def mouth_mask(class_map: np.ndarray, mode: str = "raw") -> np.ndarray:
    """Class map -> uint8 mouth-region mask (255 inside), the blending
    contract of reference blending.py:112-136 (``raw`` keeps mouth+lips,
    ``jaw`` adds skin for chin-wide blending)."""
    classes = JAW_CLASSES if mode == "jaw" else MOUTH_CLASSES
    return (np.isin(class_map, classes) * 255).astype(np.uint8)


# --- parameters --------------------------------------------------------------


def params_to(params: Params, device) -> Params:
    """The tree on ``device``; conv weights channels-last on the card."""
    dev = resolve_device(device)

    def move(t):
        t = t.to(dev)
        return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 and t.is_cuda else t

    return {k: [{n: move(t) for n, t in p.items()} for p in v] for k, v in params.items()}


def init_params(seed: int = 0, dtype=torch.float32, device="cpu") -> Params:
    """Random He-normal convs from ``torch.Generator(seed)``, zero biases
    (BatchNorm at identity)."""
    g = torch.Generator().manual_seed(seed)

    def conv(s: ConvSpec):
        fan = s.cin * s.kernel * s.kernel
        w = torch.randn((s.cout, s.cin, s.kernel, s.kernel), generator=g) * np.sqrt(2.0 / fan)
        return {"w": w.to(dtype), "b": torch.zeros(s.cout, dtype=dtype)}

    return params_to({name: [conv(s) for s in specs] for name, specs in SPECS.items()}, device)


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's tree (HWIO convs, as numpy arrays) -> the port's."""
    def conv(p):
        w = hwio_to_torch_conv(np.asarray(p["w"], np.float32))
        return {"w": torch.from_numpy(np.array(w)).to(dtype),
                "b": torch.from_numpy(np.array(p["b"], np.float32)).to(dtype)}

    return params_to({name: [conv(p) for p in tree[name]] for name in SPECS}, device)


def convert_torch_state_dict(sd: Dict[str, Any], dtype=torch.float32, device="cpu") -> Params:
    """The standard face-parsing BiSeNet checkpoint (``cp.resnet.*``,
    ``cp.arm16/32.*``, ``cp.conv_avg.*``, ``cp.conv_head16/32.*``,
    ``ffm.*``, ``conv_out.*``), BatchNorm folded into the convs."""
    def t(x):
        return to_numpy(x)

    def fold(conv_prefix, bn_prefix):
        w = torch_conv_to_hwio(t(sd[conv_prefix + ".weight"]))
        b = t(sd[conv_prefix + ".bias"]) if conv_prefix + ".bias" in sd else None
        if bn_prefix and bn_prefix + ".weight" in sd:
            w, b = fold_bn(w, b, t(sd[bn_prefix + ".weight"]), t(sd[bn_prefix + ".bias"]),
                           t(sd[bn_prefix + ".running_mean"]), t(sd[bn_prefix + ".running_var"]))
        b = b if b is not None else np.zeros(w.shape[-1])
        return {"w": torch.from_numpy(np.array(hwio_to_torch_conv(w), np.float32)).to(dtype),
                "b": torch.from_numpy(np.array(b, np.float32)).to(dtype)}

    p: Params = {}
    rn = "cp.resnet"
    p["stem"] = [fold(f"{rn}.conv1", f"{rn}.bn1")]
    for li in range(1, 5):
        blocks = []
        for bi in range(2):
            pref = f"{rn}.layer{li}.{bi}"
            blocks.append(fold(f"{pref}.conv1", f"{pref}.bn1"))
            blocks.append(fold(f"{pref}.conv2", f"{pref}.bn2"))
            if f"{pref}.downsample.0.weight" in sd:
                blocks.append(fold(f"{pref}.downsample.0", f"{pref}.downsample.1"))
        p[f"layer{li}"] = blocks
    for arm, pref in (("arm16", "cp.arm16"), ("arm32", "cp.arm32")):
        p[arm] = [fold(f"{pref}.conv.conv", f"{pref}.conv.bn"),
                  fold(f"{pref}.conv_atten", f"{pref}.bn_atten")]
    p["conv_avg"] = [fold("cp.conv_avg.conv", "cp.conv_avg.bn")]
    p["head32"] = [fold("cp.conv_head32.conv", "cp.conv_head32.bn")]
    p["head16"] = [fold("cp.conv_head16.conv", "cp.conv_head16.bn")]
    p["ffm"] = [fold("ffm.convblk.conv", "ffm.convblk.bn")]
    p["ffm_att1"] = [fold("ffm.conv1", "")]
    p["ffm_att2"] = [fold("ffm.conv2", "")]
    p["out1"] = [fold("conv_out.conv.conv", "conv_out.conv.bn")]
    p["out2"] = [fold("conv_out.conv_out", "")]
    return params_to(p, device)
