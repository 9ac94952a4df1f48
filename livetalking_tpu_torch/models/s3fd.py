"""S3FD face detector: the avatar build's face-detection backbone (ports
livetalking_tpu/models/s3fd.py; reference
avatars/wav2lip/face_detection/detection/sfd/net_s3fd.py:22-130 and
sfd_detector.py:41-47, whose ``s3fd.pth`` the converter loads).

The VGG16-style conv tower (cuDNN convs on NCHW tensors, channels-last in
memory on the card) and the per-scale anchor decode run on the device for
a whole chunk of frames; thresholding and NMS run on the host on the
compact (N_anchors, 5) result. Frames are padded (not resized) to a
multiple of 128, and the last chunk of a video is zero-padded to the
chunk size, so every chunk of a video has one shape.

Parameters: ``{name: {"w": (O, I, k, k), "b": (O,)}}`` for every conv and
``{"g": (C,)}`` for the three L2Norm scales.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.models.layers import to_numpy
from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.logger import logger

Params = Dict[str, Any]

MEAN_BGR = (104.0, 117.0, 123.0)  # reference detect.py:20 image mean
VARIANCES = (0.1, 0.2)  # SSD box-encoding variances (detect.py:46)

# (name, out_ch, kernel, stride, pad) of the VGG tower in forward order;
# pools sit between the stages exactly as reference net_s3fd.py:71-105
_TOWER = [
    ("conv1_1", 64, 3, 1, 1), ("conv1_2", 64, 3, 1, 1),
    ("conv2_1", 128, 3, 1, 1), ("conv2_2", 128, 3, 1, 1),
    ("conv3_1", 256, 3, 1, 1), ("conv3_2", 256, 3, 1, 1), ("conv3_3", 256, 3, 1, 1),
    ("conv4_1", 512, 3, 1, 1), ("conv4_2", 512, 3, 1, 1), ("conv4_3", 512, 3, 1, 1),
    ("conv5_1", 512, 3, 1, 1), ("conv5_2", 512, 3, 1, 1), ("conv5_3", 512, 3, 1, 1),
    ("fc6", 1024, 3, 1, 3), ("fc7", 1024, 1, 1, 0),
    ("conv6_1", 256, 1, 1, 0), ("conv6_2", 512, 3, 2, 1),
    ("conv7_1", 128, 1, 1, 0), ("conv7_2", 256, 3, 2, 1),
]
_POOL_AFTER = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")

# detection heads: (source feature, L2Norm scale or None, conf_ch)
_HEADS = [
    ("conv3_3", 10.0, 4),   # maxout background at stride 4
    ("conv4_3", 8.0, 2),
    ("conv5_3", 5.0, 2),
    ("fc7", None, 2),
    ("conv6_2", None, 2),
    ("conv7_2", None, 2),
]
_SRC_CH = {"conv3_3": 256, "conv4_3": 512, "conv5_3": 512, "fc7": 1024, "conv6_2": 512,
           "conv7_2": 256}


def _head_names(src: str, l2scale) -> Tuple[str, str]:
    prefix = f"{src}_norm" if l2scale is not None else src
    return f"{prefix}_mbox_conf", f"{prefix}_mbox_loc"


def _conv(p: Params, x: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad)


def _l2norm(p: Params, x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    n = torch.sqrt(torch.sum(torch.square(x), dim=1, keepdim=True)) + eps
    return x / n * p["g"].view(1, -1, 1, 1)


def apply(params: Params, x: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """x (B, 3, H, W) f32 BGR mean-subtracted. Returns per-scale
    (cls (B, h, w, 2) softmaxed, reg (B, h, w, 4)), strides 4..128."""
    feats = {}
    h = x
    for name, _cout, _k, stride, pad in _TOWER:
        h = torch.relu(_conv(params[name], h, stride, pad))
        feats[name] = h
        if name in _POOL_AFTER:
            h = F.max_pool2d(h, 2, 2)

    outs = []
    for src, l2scale, conf_ch in _HEADS:
        f = feats[src]
        if l2scale is not None:
            f = _l2norm(params[f"{src}_norm"], f)
        conf, loc = _head_names(src, l2scale)
        cls = _conv(params[conf], f, 1, 1).permute(0, 2, 3, 1)
        reg = _conv(params[loc], f, 1, 1).permute(0, 2, 3, 1)
        if conf_ch == 4:  # max-out background label (net_s3fd.py:125-128)
            bmax = cls[..., :3].amax(dim=-1, keepdim=True)
            cls = torch.cat([bmax, cls[..., 3:4]], dim=-1)
        outs.append((torch.softmax(cls.float(), dim=-1), reg.float()))
    return outs


def _decode_scale(cls: torch.Tensor, reg: torch.Tensor, stride: int) -> torch.Tensor:
    """Vectorized SSD decode for one scale: anchors are stride*4 squares
    centred at stride/2 + i*stride (reference detect.py:38-50, bbox.py
    decode). Returns (B, h*w, 5) [x1, y1, x2, y2, score]."""
    B, h, w, _ = cls.shape
    ax = stride / 2 + torch.arange(w, dtype=torch.float32, device=cls.device) * stride
    ay = stride / 2 + torch.arange(h, dtype=torch.float32, device=cls.device) * stride
    axc = ax[None, :].expand(h, w)
    ayc = ay[:, None].expand(h, w)
    aww = ahh = float(stride * 4)
    v0, v1 = VARIANCES
    cx = reg[..., 0] * v0 * aww + axc
    cy = reg[..., 1] * v0 * ahh + ayc
    ww = torch.exp(reg[..., 2] * v1) * aww
    hh = torch.exp(reg[..., 3] * v1) * ahh
    boxes = torch.stack([cx - ww / 2, cy - hh / 2, cx + ww / 2, cy + hh / 2, cls[..., 1]], dim=-1)
    return boxes.reshape(B, h * w, 5)


@torch.no_grad()
def detect(params: Params, imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) f32 BGR (raw pixels) -> (B, N_anchors, 5) decoded
    candidates, on the device of ``imgs``."""
    x = (imgs - torch.tensor(MEAN_BGR, device=imgs.device)).permute(0, 3, 1, 2)
    if x.is_cuda:
        x = x.contiguous(memory_format=torch.channels_last)
    outs = apply(params, x)
    return torch.cat([_decode_scale(cls, reg, 2 ** (i + 2)) for i, (cls, reg) in enumerate(outs)],
                     dim=1)


def nms(boxes: np.ndarray, thresh: float = 0.3) -> np.ndarray:
    """Plain numpy NMS (reference bbox.py nms semantics). boxes (N, 5)
    sorted internally by score desc; returns kept indices."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    x1, y1, x2, y2, s = boxes.T
    areas = (x2 - x1) * (y2 - y1)
    order = np.argsort(s)[::-1]
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1) * np.maximum(0.0, yy2 - yy1)
        iou = inter / (areas[i] + areas[order[1:]] - inter + 1e-12)
        order = order[1:][iou <= thresh]
    return np.asarray(keep, np.int64)


class S3FDDetector:
    """Batch face detector with the reference's serving contract
    (sfd_detector.py detect_from_batch): BGR uint8 frames in, per-frame
    [(x1, y1, x2, y2, score), ...] out, on ``device`` (the card unless the
    caller asks for the CPU)."""

    def __init__(self, params: Params, score_thresh: float = 0.5, nms_thresh: float = 0.3,
                 max_batch: int = 16, device="cuda"):
        self.device = resolve_device(device)
        self.params = params_to(params, self.device)
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.max_batch = max_batch  # the OOM halving floor is 1

    def detect_batch(self, frames_bgr: np.ndarray) -> List[np.ndarray]:
        """Chunked batch detection for arbitrarily long videos: frames go
        to the device in ``max_batch`` chunks (the final partial chunk is
        zero-padded to the chunk's shape), and a CUDA out-of-memory error
        halves the chunk size and retries (the reference's recovery
        policy, reference avatars/wav2lip/genavatar.py:98-104). Every other
        error propagates."""
        out: List[np.ndarray] = []
        i, chunk = 0, max(1, min(self.max_batch, len(frames_bgr)))
        while i < len(frames_bgr):
            n = min(chunk, len(frames_bgr) - i)
            block = frames_bgr[i: i + n]
            if n < chunk:  # pad the tail: one shape for the whole video
                pad = np.zeros((chunk - n,) + tuple(block.shape[1:]), block.dtype)
                block = np.concatenate([block, pad], axis=0)
            try:
                out.extend(self._detect_chunk(block)[:n])
                i += n
            except torch.cuda.OutOfMemoryError:
                if chunk == 1:
                    raise
                logger.warning("s3fd: out of device memory at batch %d - retrying at %d",
                               chunk, chunk // 2)
                chunk //= 2
        return out

    def _detect_chunk(self, frames_bgr: np.ndarray) -> List[np.ndarray]:
        B, H, W = frames_bgr.shape[:3]
        Hp = (H + 127) // 128 * 128
        Wp = (W + 127) // 128 * 128
        imgs = torch.zeros((B, Hp, Wp, 3), dtype=torch.float32, device=self.device)
        imgs[:, :H, :W] = torch.from_numpy(np.ascontiguousarray(frames_bgr)).to(self.device)
        cand = detect(self.params, imgs).cpu().numpy()
        out = []
        for b in range(B):
            c = cand[b]
            c = c[c[:, 4] > 0.05]  # reference anchor prefilter
            c = c[nms(c, self.nms_thresh)]
            c = c[c[:, 4] > self.score_thresh]
            # clip the padding region away
            c[:, [0, 2]] = np.clip(c[:, [0, 2]], 0, W)
            c[:, [1, 3]] = np.clip(c[:, [1, 3]], 0, H)
            out.append(c)
        return out


# ---------------------------------------------------------------------------
# init / conversion
# ---------------------------------------------------------------------------


def params_to(params: Params, device) -> Params:
    """The tree on ``device``; conv weights channels-last on the card."""
    def move(t):
        t = t.to(device)
        return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 and t.is_cuda else t

    return {k: {n: move(t) for n, t in v.items()} for k, v in params.items()}


def _conv_names():
    for name, *_ in _TOWER:
        yield name
    for src, l2scale, _ in _HEADS:
        yield from _head_names(src, l2scale)


def init_params(seed: int = 0, dtype=torch.float32, device="cpu") -> Params:
    """Random weights from ``torch.Generator(seed)``: N(0, (0.2/sqrt(fan_in))^2)
    convs, zero biases, the reference's L2Norm scales."""
    g = torch.Generator().manual_seed(seed)
    dev = resolve_device(device)
    p: Params = {}
    cin = 3
    for name, cout, k, _s, _pad in _TOWER:
        w = torch.randn((cout, cin, k, k), generator=g) * (0.2 / np.sqrt(k * k * cin))
        p[name] = {"w": w.to(dtype), "b": torch.zeros(cout, dtype=dtype)}
        cin = cout
    for src, l2scale, conf_ch in _HEADS:
        c = _SRC_CH[src]
        if l2scale is not None:
            p[f"{src}_norm"] = {"g": torch.full((c,), l2scale, dtype=dtype)}
        for head, co in zip(_head_names(src, l2scale), (conf_ch, 4)):
            w = torch.randn((co, c, 3, 3), generator=g) * (0.2 / np.sqrt(9 * c))
            p[head] = {"w": w.to(dtype), "b": torch.zeros(co, dtype=dtype)}
    return params_to(p, dev)


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(to_numpy(a), np.float32)).to(dtype)


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's tree (HWIO convs, as numpy arrays) -> the port's."""
    p: Params = {name: {"w": _tensor(np.asarray(tree[name]["w"]).transpose(3, 2, 0, 1), dtype),
                        "b": _tensor(tree[name]["b"], dtype)} for name in _conv_names()}
    for src, l2scale, _ in _HEADS:
        if l2scale is not None:
            p[f"{src}_norm"] = {"g": _tensor(tree[f"{src}_norm"]["g"], dtype)}
    return params_to(p, resolve_device(device))


def convert_torch_state_dict(sd: Dict[str, Any], dtype=torch.float32, device="cpu") -> Params:
    """``s3fd.pth`` layout: flat ``conv1_1.weight`` ... plus L2Norm scale
    vectors ``conv{3,4,5}_3_norm.weight`` (net_s3fd.py:22-68)."""
    p: Params = {name: {"w": _tensor(sd[f"{name}.weight"], dtype),
                        "b": _tensor(sd[f"{name}.bias"], dtype)} for name in _conv_names()}
    for src, l2scale, _ in _HEADS:
        if l2scale is not None:
            p[f"{src}_norm"] = {"g": _tensor(sd[f"{src}_norm.weight"], dtype)}
    return params_to(p, resolve_device(device))
