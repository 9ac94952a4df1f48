"""Device paste-back: bilinear resize + feathered blend + rect paste.

Ports livetalking_tpu/ops/pallas_blend.py, rect path (the masked variant
comes with MuseTalk). A batch of predicted (S, S) mouth crops goes back
into full frames on the device, so only finished frames leave it:

    gather full frames by cycle index          (torch.index_select)
    -> bilinear-resize each crop into its bbox  \
    -> feathered alpha blend over the frame      > csrc/blend.cu, in place
    -> write the blended pixels back            /

Crops are padded to a static per-avatar bucket ``(Ho, Wo)`` = (next
multiple of 8, next multiple of 128) >= the largest bbox of the cycle, as
in the reference. ``blend_rect_`` is the kernel's wrapper: on CPU tensors
it runs the plain version ``_blend_rect_plain``, on CUDA tensors it
launches the kernel, and on anything else it raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from livetalking_tpu_torch.utils.device import resolve_device

__all__ = [
    "bucket_shape",
    "blend_rect_",
    "make_resize_paste_fn",
    "resize_paste_plain",
    "DevicePasteBack",
]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bucket_shape(coords: Sequence[Tuple[int, int, int, int]]) -> Tuple[int, int]:
    """Static padded crop bucket covering every ``(y1, y2, x1, x2)`` bbox."""
    max_h = max(int(y2) - int(y1) for y1, y2, x1, x2 in coords)
    max_w = max(int(x2) - int(x1) for y1, y2, x1, x2 in coords)
    return _round_up(max(max_h, 8), 8), _round_up(max(max_w, 128), 128)


def _geometry(boxes: torch.Tensor, Ho: int, Wo: int, H: int, W: int):
    """Per item (h, w, oy, ox, dy, dx) from gathered (B, 4) boxes."""
    y1, y2, x1, x2 = boxes.long().unbind(1)
    h = (y2 - y1).clamp(1, Ho)
    w = (x2 - x1).clamp(1, Wo)
    oy = y1.clamp(0, H - Ho)
    ox = x1.clamp(0, W - Wo)
    return h, w, oy, ox, y1 - oy, x1 - ox


def _interp_weights(n_out: int, n: torch.Tensor, off: torch.Tensor, S: int):
    """(B, n_out, S) bilinear weights ``relu(1 - |pos - j|)``.

    Crop row r samples ``(r - off + 0.5) * S / max(n, 1) - 0.5`` (cv2
    INTER_LINEAR half-pixel centres), clamped to the edge; rows outside
    ``[off, off + n)`` get pos = -2 and so all-zero weights."""
    r = torch.arange(n_out, device=n.device)[None, :]
    i = (r - off[:, None]).float()
    scale = float(S) / n.float().clamp(min=1.0)
    pos = ((i + 0.5) * scale[:, None] - 0.5).clamp(0.0, float(S - 1))
    valid = (r >= off[:, None]) & (r < (off + n)[:, None])
    pos = torch.where(valid, pos, torch.full_like(pos, -2.0))
    j = torch.arange(S, device=n.device, dtype=torch.float32)
    return (1.0 - (pos[..., None] - j).abs()).clamp(min=0.0)


def _feather_alpha(n_out: int, n: torch.Tensor, off: torch.Tensor, feather: int):
    """(B, n_out) alpha: 0 outside the bbox, ramping 0 -> 1 over
    ``feather`` pixels from each bbox edge (0 = hard rectangle)."""
    r = torch.arange(n_out, device=n.device)[None, :]
    i = r - off[:, None]
    inside = (i >= 0) & (i < n[:, None])
    if feather <= 0:
        return inside.float()
    d = torch.minimum(i, n[:, None] - 1 - i).float()
    a = ((d + 1.0) / float(feather)).clamp(0.0, 1.0)
    return torch.where(inside, a, torch.zeros_like(a))


def _blend_rect_plain(pred: torch.Tensor, out: torch.Tensor, boxes: torch.Tensor,
                      *, Ho: int, Wo: int, feather: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same function, same arithmetic.

    ``pred`` (B, S, S, 3) uint8, ``out`` (B, H, W, 3) uint8 gathered frames
    updated in place, ``boxes`` (B, 4) (y1, y2, x1, x2). Returns ``out``."""
    B, H, W = out.shape[:3]
    S = pred.shape[1]
    h, w, oy, ox, dy, dx = _geometry(boxes, Ho, Wo, H, W)
    rv = _interp_weights(Ho, h, dy, S)                 # (B, Ho, S)
    rh = _interp_weights(Wo, w, dx, S)                 # (B, Wo, S)
    alpha = (_feather_alpha(Ho, h, dy, feather)[:, :, None]
             * _feather_alpha(Wo, w, dx, feather)[:, None, :])[..., None]
    resized = torch.einsum("bhs,bsjc,bwj->bhwc", rv, pred.float(), rh)

    dev = out.device
    bi = torch.arange(B, device=dev)[:, None, None]
    rows = (oy[:, None] + torch.arange(Ho, device=dev))[:, :, None]
    cols = (ox[:, None] + torch.arange(Wo, device=dev))[:, None, :]
    bg = out[bi, rows, cols].float()                   # (B, Ho, Wo, 3)
    crop = alpha * resized + (1.0 - alpha) * bg
    out[bi, rows, cols] = crop.round().clamp(0, 255).to(torch.uint8)
    return out


_launch_lock = threading.Lock()


@functools.cache
def _kernel_fn():
    from livetalking_tpu_torch.ops import _build

    fn = _build.library("blend").blend_rect_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(pred, out, boxes, Ho: int, Wo: int, feather: int) -> None:
    for name, t in (("pred", pred), ("out", out), ("boxes", boxes)):
        if t.device.type != "cuda":
            raise ValueError(f"blend kernel: {name} is on {t.device}, not CUDA")
        if t.device != out.device:
            raise ValueError(f"blend kernel: {name} on {t.device}, out on {out.device}")
        if not t.is_contiguous():
            raise ValueError(f"blend kernel: {name} must be contiguous")
    if pred.dtype != torch.uint8 or out.dtype != torch.uint8 or boxes.dtype != torch.int32:
        raise ValueError(f"blend kernel: dtypes pred {pred.dtype}, out {out.dtype}, "
                         f"boxes {boxes.dtype}; want uint8, uint8, int32")
    B = out.shape[0]
    if (out.dim() != 4 or out.shape[3] != 3 or pred.dim() != 4
            or pred.shape[0] != B or pred.shape[1] != pred.shape[2] or pred.shape[3] != 3
            or tuple(boxes.shape) != (B, 4)):
        raise ValueError(f"blend kernel: shapes pred {tuple(pred.shape)}, out "
                         f"{tuple(out.shape)}, boxes {tuple(boxes.shape)}")
    if not (0 < Ho <= out.shape[1] and 0 < Wo <= out.shape[2]) or feather < 0:
        raise ValueError(f"blend kernel: bucket ({Ho},{Wo}) / feather {feather} "
                         f"invalid for frames {tuple(out.shape[1:3])}")


def blend_rect_(pred: torch.Tensor, out: torch.Tensor, boxes: torch.Tensor,
                *, Ho: int, Wo: int, feather: int = 0) -> torch.Tensor:
    """Resize ``pred`` into each item's bbox and blend it into ``out``, in place.

    The wrapper of ``csrc/blend.cu``. CPU tensors run ``_blend_rect_plain``;
    CUDA tensors launch the kernel on the current stream (and count the
    launch in ``blend_rect_.launches``); anything else raises."""
    if pred.device.type == out.device.type == boxes.device.type == "cpu":
        return _blend_rect_plain(pred, out, boxes, Ho=Ho, Wo=Wo, feather=feather)
    _check_kernel_args(pred, out, boxes, Ho, Wo, feather)
    B, H, W = out.shape[:3]
    launch = _kernel_fn()
    with torch.cuda.device(out.device):
        err = launch(pred.data_ptr(), out.data_ptr(), boxes.data_ptr(),
                     B, pred.shape[1], H, W, Ho, Wo, feather,
                     torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"blend kernel launch failed: cudaError {err}")
    with _launch_lock:
        blend_rect_.launches += 1
    return out


blend_rect_.launches = 0


def _check_bucket(Ho: int, Wo: int, H: int, W: int) -> None:
    if Ho > H or Wo > W:
        raise ValueError(f"crop bucket ({Ho},{Wo}) exceeds frame ({H},{W})")


def _check_pred(pred_u8: torch.Tensor, S: int) -> None:
    if pred_u8.shape[1:] != (S, S, 3):
        raise ValueError(f"paste: pred {tuple(pred_u8.shape)}, want (B,{S},{S},3)")


def make_resize_paste_fn(S: int, Ho: int, Wo: int, H: int, W: int, feather: int = 0):
    """Build the batched paste-back step.

    Returns ``fn(pred_u8 (B,S,S,3), frames_u8 (N,H,W,3), idxs (B,),
    boxes (N,4)) -> (B,H,W,3) uint8`` full frames, all on one device."""
    _check_bucket(Ho, Wo, H, W)

    def paste(pred_u8, frames_u8, idxs, boxes):
        _check_pred(pred_u8, S)
        picked = frames_u8.index_select(0, idxs)
        box = boxes.index_select(0, idxs).to(torch.int32).contiguous()
        return blend_rect_(pred_u8.contiguous(), picked, box, Ho=Ho, Wo=Wo,
                           feather=feather)

    return paste


def resize_paste_plain(pred_u8, frames_u8, idxs, boxes, *, S: int, Ho: int,
                       Wo: int, H: int, W: int, feather: int = 0) -> torch.Tensor:
    """Plain PyTorch paste-back on any device (the test oracle)."""
    _check_bucket(Ho, Wo, H, W)
    _check_pred(pred_u8, S)
    picked = frames_u8.index_select(0, idxs)
    return _blend_rect_plain(pred_u8, picked, boxes.index_select(0, idxs),
                             Ho=Ho, Wo=Wo, feather=feather)


class DevicePasteBack:
    """Per-avatar device-resident composite path (no scheduler).

    Uploads the full-frame cycle once, derives the static crop bucket from
    the coord cycle, and ``paste_batch`` keeps the model output on the
    device through resize/blend/paste, returning finished full frames."""

    def __init__(self, frames: np.ndarray, coords, S: int, feather: int = 0,
                 device="cuda"):
        self.S = S
        H, W = frames.shape[1:3]
        self.Ho, self.Wo = bucket_shape(coords)
        self.available = self.Ho <= H and self.Wo <= W
        if not self.available:
            return
        dev = resolve_device(device)
        self.frames_dev = torch.from_numpy(np.ascontiguousarray(frames, np.uint8)).to(dev)
        self.boxes_dev = torch.as_tensor(np.asarray(coords, np.int32), device=dev)
        self._fn = make_resize_paste_fn(S, self.Ho, self.Wo, H, W, feather=feather)

    def paste_batch(self, pred_u8: torch.Tensor, idxs: np.ndarray) -> np.ndarray:
        """(B,S,S,3) uint8 device crops + (B,) cycle indices -> (B,H,W,3)."""
        idx = torch.as_tensor(np.asarray(idxs, np.int32), device=self.frames_dev.device)
        return self._fn(pred_u8, self.frames_dev, idx, self.boxes_dev).cpu().numpy()
