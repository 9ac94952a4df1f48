"""Ultralight digital-human U-Net, 160 px, MobileNetV2-style (ports
livetalking_tpu/models/ultralight.py).

Same layer table as the reference package: an inverted-residual encoder
6ch -> 512ch over 160 -> 10 px, a HuBERT audio branch (16ch 32x32 ->
512ch 10x10), concat and fuse at the bottleneck, a bilinear
align-corners up path with skip concats, and a 1x1 sigmoid head.

  - Parameters are a tree of ``{"w", "b"}`` leaves in the reference's
    nesting, weights in PyTorch's (O, I/groups, kh, kw) layout, BatchNorm
    folded at load; convolutions are cuDNN's on channels-last tensors.
  - Units add their residual in the compute dtype; the upsampler is
    ``layers.upsample2x_align_corners``, the reference's two rounded
    interpolation products.
  - The weights are per avatar. ``make_grouped_infer_fn`` runs n sessions
    with n different weight trees as ONE forward: the sessions' channels
    lie side by side (channel block s is session s), every 3x3 conv is a
    grouped conv over them (groups n, depthwise groups n*hidden) with the
    selected sessions' weights stacked on its output axis, every 1x1 conv
    one strided batched GEMM over the blocks, and the skip concats join
    each session's blocks. With n = 1 this is the plain per-avatar forward
    that ``apply`` and ``make_infer_fn`` run (the 1x1 convs one GEMM each,
    bias in its epilogue).
  - The public functions keep the reference's NHWC layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.models.layers import (
    ConvSpec,
    fold_bn,
    hwio_to_torch_conv,
    to_numpy,
    torch_conv_to_hwio,
    upsample2x_align_corners,
)

C = ConvSpec
CH = (32, 64, 128, 256, 512)
IMG_SIZE = 160
CROP = 168  # the avatar's face crops; the net sees their 160 px interior
# the masked copy's blacked-out rectangle: rows [5, 150), columns [5, 155)
MASK_ROWS, MASK_COLS = (5, 150), (5, 155)


def _ir_specs(inp: int, oup: int, stride: int, expand: int = 2) -> List[ConvSpec]:
    """InvertedResidual: pw-expand -> dw 3x3 -> pw-project, BN folded."""
    hidden = inp * expand
    return [
        C(inp, hidden, 1, 1, 0, act="relu"),
        C(hidden, hidden, 3, stride, 1, act="relu", groups=hidden),
        C(hidden, oup, 1, 1, 0, act=None),
    ]


def _double(inp: int, oup: int, stride: int) -> List[Tuple[str, List[ConvSpec], bool]]:
    return [("ir0", _ir_specs(inp, oup, stride), False), ("ir1", _ir_specs(oup, oup, 1), True)]


# name -> units (kind, specs, residual); kind 'c' is one plain conv
ARCH: Dict[str, Any] = {
    "inc": [("ir0", _ir_specs(6, CH[0], 1), False)],
    "down1": _double(CH[0], CH[1], 2),
    "down2": _double(CH[1], CH[2], 2),
    "down3": _double(CH[2], CH[3], 2),
    "down4": _double(CH[3], CH[4], 2),
    "a_conv1": [("ir0", _ir_specs(16, CH[1], 1), False)],
    "a_conv2": [("ir0", _ir_specs(CH[1], CH[2], 1), False)],
    "a_conv3": [("c", C(CH[2], CH[3], 3, 2, 1, act="relu"), None)],
    "a_conv4": [("ir0", _ir_specs(CH[3], CH[3], 1), True)],
    "a_conv5": [("c", C(CH[3], CH[4], 3, 2, 3, act="relu"), None)],
    "a_conv6": [("ir0", _ir_specs(CH[4], CH[4], 1), True)],
    "a_conv7": [("ir0", _ir_specs(CH[4], CH[4], 1), True)],
    "fuse0": _double(CH[4] * 2, CH[4], 1),
    "fuse1": _double(CH[4], CH[3], 1),
    "up1": _double(CH[4], CH[3] // 2, 1),
    "up2": _double(CH[3], CH[2] // 2, 1),
    "up3": _double(CH[2], CH[1] // 2, 1),
    "up4": _double(CH[1], CH[0], 1),
    "outc": [("c", C(CH[0], 3, 1, 1, 0, bn=False, act=None), None)],
}
AUDIO = ("a_conv1", "a_conv2", "a_conv3", "a_conv4", "a_conv5", "a_conv6", "a_conv7")

Params = Dict[str, Any]


def _unit_specs(kind, specs) -> List[ConvSpec]:
    return [specs] if kind == "c" else specs


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_tree(out.append, tree)
    return out


def _zip_tree(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_tree(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [_zip_tree(fn, *v) for v in zip(*trees)]
    return fn(*trees)


def init_params(seed: int = 0, dtype=torch.bfloat16, device="cpu") -> Params:
    """He-normal weights from ``torch.Generator(seed)``, zero biases (BN
    identity, so folded equals plain)."""
    g = torch.Generator().manual_seed(seed)

    def conv(spec: ConvSpec):
        k = spec.kernel
        fan_in = (spec.cin // spec.groups) * k * k
        w = torch.randn((spec.cout, spec.cin // spec.groups, k, k), generator=g)
        return {"w": (w * math.sqrt(2.0 / fan_in)).to(device=device, dtype=dtype),
                "b": torch.zeros(spec.cout, device=device, dtype=dtype)}

    return {name: [[conv(s) for s in _unit_specs(kind, specs)] for kind, specs, _ in units]
            for name, units in ARCH.items()}


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's tree (numpy leaves, HWIO weights) -> the port's."""
    def leaf(p):
        w = hwio_to_torch_conv(np.asarray(p["w"], np.float32))
        return {"w": torch.from_numpy(np.array(w, np.float32)).to(device=device, dtype=dtype),
                "b": torch.from_numpy(np.array(p["b"], np.float32)).to(device=device,
                                                                        dtype=dtype)}

    return {name: [[leaf(p) for p in block] for block in tree[name]] for name in ARCH}


def cast_params(params: Params, dtype=None, device=None) -> Params:
    return _map_tree(lambda t: t.to(device=device, dtype=dtype), params)


def count_params(params: Params) -> int:
    return sum(t.numel() for t in _leaves(params))


# ---------------------------------------------------------------------------
# the forward, over n sessions' channel blocks
# ---------------------------------------------------------------------------

def _pointwise(x: torch.Tensor, p: Dict[str, torch.Tensor], spec: ConvSpec,
               n: int) -> torch.Tensor:
    """A 1x1 conv over n session channel blocks as GEMMs on the
    channels-last memory, the bias added by the GEMM: one (B*H*W, C) x
    (C, O) product per session, as one strided batched GEMM for n > 1
    (a grouped 1x1 conv is not cuDNN's fast path)."""
    B, _, H, W = x.shape
    C, O = spec.cin, spec.cout
    rows = x.permute(0, 2, 3, 1).reshape(B * H * W, n, C)
    w = p["w"].reshape(n, O, C).transpose(1, 2)
    if n == 1:
        y = torch.addmm(p["b"], rows[:, 0], w[0])
    else:
        y = torch.empty((B * H * W, n, O), dtype=x.dtype, device=x.device)
        torch.baddbmm(p["b"].reshape(n, 1, O), rows.transpose(0, 1), w,
                      out=y.transpose(0, 1))
    return y.reshape(B, H, W, n * O).permute(0, 3, 1, 2)


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor], spec: ConvSpec, n: int) -> torch.Tensor:
    if spec.kernel == 1:
        y = _pointwise(x, p, spec, n)
    else:
        y = F.conv2d(x, p["w"], p["b"], spec.stride, spec.padding, groups=n * spec.groups)
    return torch.relu_(y) if spec.act == "relu" else y


def _run(params: Params, name: str, x: torch.Tensor, n: int) -> torch.Tensor:
    for p_block, (kind, specs, res) in zip(params[name], ARCH[name]):
        y = x
        for p, s in zip(p_block, _unit_specs(kind, specs)):
            y = _conv(y, p, s, n)
        x = (x + y) if res else y
    return x


def _join(n: int, *xs: torch.Tensor) -> torch.Tensor:
    """Concatenate NCHW tensors of n session channel blocks per session:
    block s of the result is block s of each input, in order."""
    B, _, H, W = xs[0].shape
    parts = [x.permute(0, 2, 3, 1).reshape(B, H, W, n, -1) for x in xs]
    return torch.cat(parts, -1).reshape(B, H, W, -1).permute(0, 3, 1, 2)


def _to_blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """(n*B, H, W, C) NHWC, session-major -> (B, n*C, H, W) channels-last."""
    nb, H, W, Cc = x.shape
    y = x.reshape(n, nb // n, H, W, Cc).permute(1, 2, 3, 0, 4).reshape(nb // n, H, W, n * Cc)
    return y.permute(0, 3, 1, 2)


def _from_blocks(y: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of ``_to_blocks``: (B, n*C, H, W) -> (n*B, H, W, C)."""
    B, nc, H, W = y.shape
    t = y.permute(0, 2, 3, 1).reshape(B, H, W, n, nc // n).permute(3, 0, 1, 2, 4)
    return t.reshape(n * B, H, W, nc // n)


def _forward(params: Params, face: torch.Tensor, audio: torch.Tensor, n: int) -> torch.Tensor:
    """face (n*B, 160, 160, 6), audio (n*B, 32, 32, 16), both NHWC in the
    compute dtype, session-major; ``params`` leaves hold the n sessions'
    weights stacked on the output axis -> (n*B, 160, 160, 3) f32 in [0, 1]."""
    x1 = _run(params, "inc", _to_blocks(face, n), n)  # 160, 32
    x2 = _run(params, "down1", x1, n)                  # 80, 64
    x3 = _run(params, "down2", x2, n)                  # 40, 128
    x4 = _run(params, "down3", x3, n)                  # 20, 256
    x5 = _run(params, "down4", x4, n)                  # 10, 512
    a = _to_blocks(audio, n)
    for name in AUDIO:
        a = _run(params, name, a, n)                   # 10, 512
    x = _run(params, "fuse1", _run(params, "fuse0", _join(n, x5, a), n), n)  # 10, 256
    for name, skip in (("up1", x4), ("up2", x3), ("up3", x2), ("up4", x1)):
        x = _run(params, name, _join(n, upsample2x_align_corners(x), skip), n)
    out = _run(params, "outc", x, n)
    return torch.sigmoid(_from_blocks(out, n).float())


def apply(params: Params, face: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
    """face (B, 160, 160, 6) in [0, 1]; audio (B, 32, 32, 16) ->
    (B, 160, 160, 3) in [0, 1] (float32). Runs in ``face``'s dtype; the
    weights must already be in it, on its device."""
    return _forward(params, face, audio.to(face.dtype), 1)


def select_params(stacked: Params, slots: torch.Tensor) -> Params:
    """n avatars' weights from a stacked tree (leaves (A, O, ...)) by slot,
    as one tree of (n*O, ...) leaves: the grouped convs' weights."""
    def pick(t):
        s = t.index_select(0, slots)
        return s.reshape((-1,) + tuple(t.shape[2:]))
    return _map_tree(pick, stacked)


def stack_params(trees: List[Params]) -> Params:
    """Stack per-avatar trees on a new leading (slot) axis."""
    return _zip_tree(lambda *xs: torch.stack(xs, 0), *trees)


def append_stacked(stacked: Params, tree: Params) -> Params:
    """A new stacked tree with ``tree`` in the next slot; ``stacked`` is
    left as it was."""
    return _zip_tree(lambda s, x: torch.cat([s, x[None].to(s.dtype)], 0), stacked, tree)


# ---------------------------------------------------------------------------
# torch checkpoint conversion (the reference's per-avatar ultralight.pth)
# ---------------------------------------------------------------------------

def _conv_bn(sd, conv_key: str, bn_key: str, has_bias: bool = False):
    w = torch_conv_to_hwio(sd[f"{conv_key}.weight"].astype(np.float32))
    b = sd[f"{conv_key}.bias"].astype(np.float32) if has_bias and f"{conv_key}.bias" in sd else None
    w, b = fold_bn(w, b, *(sd[f"{bn_key}.{k}"].astype(np.float32)
                           for k in ("weight", "bias", "running_mean", "running_var")))
    return {"w": w, "b": b}


def _convert_ir(sd, prefix: str) -> List[Dict]:
    """IR module: .conv Sequential indices 0/1 (pw+bn), 3/4 (dw+bn), 6/7 (pw+bn)."""
    return [_conv_bn(sd, f"{prefix}.conv.{c}", f"{prefix}.conv.{c + 1}") for c in (0, 3, 6)]


# ARCH name -> reference state_dict prefix per IR unit
_PREFIXES = {
    "inc": ["inc.inconv.0"],
    **{f"down{i}": [f"down{i}.maxpool_conv.0.double_conv.{j}" for j in (0, 1)]
       for i in range(1, 5)},
    **{f"a_conv{i}": [f"audio_model.conv{i}"] for i in (1, 2, 4, 6, 7)},
    **{f"fuse{i}": [f"fuse_conv.{i}.double_conv.{j}" for j in (0, 1)] for i in (0, 1)},
    **{f"up{i}": [f"up{i}.conv.double_conv.{j}" for j in (0, 1)] for i in range(1, 5)},
}


def convert_torch_state_dict(sd: Dict[str, Any], dtype=torch.bfloat16, device="cpu") -> Params:
    """Reference ``ultralight.pth`` state dict -> the port's tree, BN folded."""
    sd = {k: to_numpy(v) for k, v in sd.items()}
    tree = {name: [_convert_ir(sd, p) for p in prefixes] for name, prefixes in _PREFIXES.items()}
    # plain conv+bn audio layers (bias=True on the conv)
    tree["a_conv3"] = [[_conv_bn(sd, "audio_model.conv3", "audio_model.bn3", has_bias=True)]]
    tree["a_conv5"] = [[_conv_bn(sd, "audio_model.conv5", "audio_model.bn5", has_bias=True)]]
    tree["outc"] = [[{"w": torch_conv_to_hwio(sd["outc.conv.weight"].astype(np.float32)),
                      "b": sd["outc.conv.bias"].astype(np.float32)}]]
    return params_from_jax(tree, dtype, device)


def load_torch_checkpoint(path: str, dtype=torch.bfloat16, device="cpu") -> Params:
    """Load the reference ``ultralight.pth`` (a state dict, or one under
    ``"state_dict"``) on the CPU and convert it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return convert_torch_state_dict(sd, dtype, device)


# ---------------------------------------------------------------------------
# the per-batch steps
# ---------------------------------------------------------------------------

def _prep(crops: torch.Tensor, audio: torch.Tensor, dtype: torch.dtype):
    """The reference's host-side batch prep: the 160 px interior of each
    168 px crop, /255 in the compute dtype, a copy with the mouth rectangle
    blacked out, concat(real, masked); audio (B, 16, 32, 32) -> NHWC."""
    S = IMG_SIZE
    real = crops[:, 4:4 + S, 4:4 + S, :].to(dtype) / 255.0
    masked = real.clone()
    masked[:, MASK_ROWS[0]:MASK_ROWS[1], MASK_COLS[0]:MASK_COLS[1]] = 0
    return torch.cat([real, masked], -1), audio.permute(0, 2, 3, 1).to(dtype)


def _to_u8(out: torch.Tensor) -> torch.Tensor:
    return (out * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)


def make_infer_fn(batch_size: int, dtype=torch.bfloat16):
    """``step(params, crop_cycle_u8 (N, 168, 168, 3), idxs (B,), audio
    (B, 16, 32, 32)) -> (B, 160, 160, 3) uint8``, all on the device: gather,
    the reference's prep, the U-Net, uint8. ``params`` must be in ``dtype``
    on the tensors' device."""
    @torch.inference_mode()
    def step(params: Params, crop_cycle: torch.Tensor, idxs: torch.Tensor,
             audio: torch.Tensor) -> torch.Tensor:
        if idxs.shape[0] != batch_size:
            raise ValueError(f"step built for B={batch_size}, got {idxs.shape[0]} indices")
        x, a = _prep(crop_cycle.index_select(0, idxs), audio, dtype)
        return _to_u8(_forward(params, x, a, 1))

    return step


def make_grouped_infer_fn(n_sessions: int, batch_size: int, dtype=torch.bfloat16):
    """The cross-session super-batch step for per-avatar weights:

        step(stacked (leaves (A, ...)), crop_cycle (N, 168, 168, 3) u8,
             idxs (n*B,) global frame indices, slots (n,) avatar slot per
             session block, audio (n*B, 16, 32, 32) f32)
            -> (n*B, 160, 160, 3) uint8

    One forward for all n sessions: the slots' weights are gathered on the
    device and every conv runs grouped over the sessions."""
    n, B = n_sessions, batch_size

    @torch.inference_mode()
    def step(stacked: Params, crop_cycle: torch.Tensor, idxs: torch.Tensor,
             slots: torch.Tensor, audio: torch.Tensor) -> torch.Tensor:
        if idxs.shape[0] != n * B or slots.shape[0] != n:
            raise ValueError(f"step built for {n} sessions of B={B}, got {idxs.shape[0]} "
                             f"indices and {slots.shape[0]} slots")
        x, a = _prep(crop_cycle.index_select(0, idxs), audio, dtype)
        return _to_u8(_forward(select_params(stacked, slots), x, a, n))

    return step
