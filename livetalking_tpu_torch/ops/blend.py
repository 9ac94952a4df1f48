"""Device paste-back: bilinear resize + feathered blend + rect paste.

Ports livetalking_tpu/ops/pallas_blend.py. A batch of predicted (S, S)
mouth crops goes back into full frames on the device, so only finished
frames leave it:

    gather full frames by cycle index          (torch.index_select)
    -> bilinear-resize each crop into its bbox  \
    -> feathered alpha blend over the frame      > csrc/blend.cu, in place
    -> write the blended pixels back            /

Crops are padded to a static per-avatar bucket ``(Ho, Wo)`` = (next
multiple of 8, next multiple of 128) >= the largest bbox of the cycle, as
in the reference. ``blend_rect_`` is the kernel's wrapper: on CPU tensors
it runs the plain version ``_blend_rect_plain``, on CUDA tensors it
launches the kernel, and on anything else it raises.

The masked variant (MuseTalk) takes alpha from a per-cycle-index uint8
face-parse mask inside a larger crop box instead of the feathered rect:
``prepare_masked_paste_data`` builds its per-index planes on the host,
``blend_masked_`` is its kernel's wrapper (plain version
``_blend_masked_plain``), ``make_masked_paste_fn`` the batched step and
``MaskedDevicePasteBack`` the per-avatar path.
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
    "blend_masked_",
    "make_resize_paste_fn",
    "make_masked_paste_fn",
    "resize_paste_plain",
    "masked_paste_plain",
    "prepare_masked_paste_data",
    "DevicePasteBack",
    "MaskedDevicePasteBack",
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


# -- masked variant (MuseTalk) -------------------------------------------------

def _blend_masked_plain(pred: torch.Tensor, out: torch.Tensor, idxs: torch.Tensor,
                        origins: torch.Tensor, scalars: torch.Tensor, masks: torch.Tensor,
                        *, Ho: int, Wo: int) -> torch.Tensor:
    """Plain PyTorch version of the masked kernel: same function, same
    arithmetic.

    ``pred`` (B, S, S, 3) uint8, ``out`` (B, H, W, 3) uint8 gathered frames
    updated in place, ``idxs`` (B,) cycle indices into ``origins`` (N, 2)
    (oy, ox), ``scalars`` (N, 4) (h, w, dy, dx) and ``masks`` (N, Ho, Wo)
    uint8. Returns ``out``."""
    B, H, W = out.shape[:3]
    S = pred.shape[1]
    idx = idxs.long()
    org = origins.index_select(0, idx).long()
    h, w, dy, dx = scalars.index_select(0, idx).long().unbind(1)
    oy = org[:, 0].clamp(0, H - Ho)
    ox = org[:, 1].clamp(0, W - Wo)
    rv = _interp_weights(Ho, h, dy, S)                 # (B, Ho, S)
    rh = _interp_weights(Wo, w, dx, S)                 # (B, Wo, S)
    alpha = (masks.index_select(0, idx).float() / 255.0)[..., None]
    resized = torch.einsum("bhs,bsjc,bwj->bhwc", rv, pred.float(), rh)

    dev = out.device
    bi = torch.arange(B, device=dev)[:, None, None]
    rows = (oy[:, None] + torch.arange(Ho, device=dev))[:, :, None]
    cols = (ox[:, None] + torch.arange(Wo, device=dev))[:, None, :]
    bg = out[bi, rows, cols].float()                   # (B, Ho, Wo, 3)
    crop = alpha * resized + (1.0 - alpha) * bg
    out[bi, rows, cols] = crop.round().clamp(0, 255).to(torch.uint8)
    return out


@functools.cache
def _masked_kernel_fn():
    from livetalking_tpu_torch.ops import _build

    fn = _build.library("blend").blend_masked_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_masked_args(pred, out, idxs, origins, scalars, masks, Ho: int, Wo: int) -> None:
    named = (("pred", pred), ("out", out), ("idxs", idxs), ("origins", origins),
             ("scalars", scalars), ("masks", masks))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"masked blend kernel: {name} is on {t.device}, not CUDA")
        if t.device != out.device:
            raise ValueError(f"masked blend kernel: {name} on {t.device}, out on {out.device}")
        if not t.is_contiguous():
            raise ValueError(f"masked blend kernel: {name} must be contiguous")
    want = (torch.uint8, torch.uint8, torch.int32, torch.int32, torch.int32, torch.uint8)
    if tuple(t.dtype for _, t in named) != want:
        raise ValueError("masked blend kernel: dtypes "
                         + ", ".join(f"{n} {t.dtype}" for n, t in named)
                         + "; want uint8, uint8, int32, int32, int32, uint8")
    B, N = out.shape[0], origins.shape[0]
    if (out.dim() != 4 or out.shape[3] != 3 or pred.dim() != 4 or pred.shape[0] != B
            or pred.shape[1] != pred.shape[2] or pred.shape[3] != 3
            or tuple(idxs.shape) != (B,) or tuple(origins.shape) != (N, 2)
            or tuple(scalars.shape) != (N, 4) or tuple(masks.shape) != (N, Ho, Wo)):
        raise ValueError(f"masked blend kernel: shapes pred {tuple(pred.shape)}, out "
                         f"{tuple(out.shape)}, idxs {tuple(idxs.shape)}, origins "
                         f"{tuple(origins.shape)}, scalars {tuple(scalars.shape)}, masks "
                         f"{tuple(masks.shape)} for bucket ({Ho},{Wo})")
    if not (0 < Ho <= out.shape[1] and 0 < Wo <= out.shape[2]):
        raise ValueError(f"masked blend kernel: bucket ({Ho},{Wo}) invalid for frames "
                         f"{tuple(out.shape[1:3])}")


def blend_masked_(pred: torch.Tensor, out: torch.Tensor, idxs: torch.Tensor,
                  origins: torch.Tensor, scalars: torch.Tensor, masks: torch.Tensor,
                  *, Ho: int, Wo: int) -> torch.Tensor:
    """Resize ``pred`` into each item's bbox and blend it into ``out`` with
    the item's uint8 mask as alpha, in place.

    The wrapper of the masked kernel in ``csrc/blend.cu``. CPU tensors run
    ``_blend_masked_plain``; CUDA tensors launch the kernel on the current
    stream (and count the launch in ``blend_masked_.launches``); anything
    else raises. Indices must lie in ``[0, N)``: the kernel does not check
    them."""
    args = (pred, out, idxs, origins, scalars, masks)
    if all(t.device.type == "cpu" for t in args):
        return _blend_masked_plain(*args, Ho=Ho, Wo=Wo)
    _check_masked_args(*args, Ho=Ho, Wo=Wo)
    B, H, W = out.shape[:3]
    launch = _masked_kernel_fn()
    with torch.cuda.device(out.device):
        err = launch(*(t.data_ptr() for t in args), B, pred.shape[1], H, W, Ho, Wo,
                     torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked blend kernel launch failed: cudaError {err}")
    with _launch_lock:
        blend_masked_.launches += 1
    return out


blend_masked_.launches = 0


def make_masked_paste_fn(S: int, Ho: int, Wo: int, H: int, W: int):
    """Build the batched masked paste-back step.

    Returns ``fn(pred_u8 (B,S,S,3), frames_u8 (N,H,W,3), idxs (B,),
    origins (N,2) i32, scalars (N,4) i32, masks_u8 (N,Ho,Wo)) -> (B,H,W,3)
    uint8`` full frames, all on one device. ``origins`` are the clamped
    paste origins (oy, ox), ``scalars`` the bbox geometry (h, w, dy, dx)
    relative to them, and ``masks_u8`` must be zero outside the bbox
    (``prepare_masked_paste_data`` builds all three)."""
    _check_bucket(Ho, Wo, H, W)

    def paste(pred_u8, frames_u8, idxs, origins, scalars, masks_u8):
        _check_pred(pred_u8, S)
        picked = frames_u8.index_select(0, idxs)
        return blend_masked_(pred_u8.contiguous(), picked, idxs.to(torch.int32).contiguous(),
                             origins, scalars, masks_u8, Ho=Ho, Wo=Wo)

    return paste


def masked_paste_plain(pred_u8, frames_u8, idxs, origins, scalars, masks_u8, *, S: int,
                       Ho: int, Wo: int, H: int, W: int) -> torch.Tensor:
    """Plain PyTorch masked paste-back on any device (the test oracle)."""
    _check_bucket(Ho, Wo, H, W)
    _check_pred(pred_u8, S)
    picked = frames_u8.index_select(0, idxs)
    return _blend_masked_plain(pred_u8, picked, idxs, origins, scalars, masks_u8, Ho=Ho, Wo=Wo)


def prepare_masked_paste_data(face_boxes, crop_boxes, mask_imgs, Ho: int, Wo: int,
                              H: int, W: int):
    """Per-cycle-index masked-paste planes against a given (Ho, Wo) bucket.

    ``face_boxes`` are (x1, y1, x2, y2), ``crop_boxes`` (xs, ys, xe, ye) and
    ``mask_imgs`` the crop-sized face-parse masks (gray or BGR). Returns
    ``(origins (N,2) i32, scalars (N,4) i32, masks (N,Ho,Wo) u8)``: the
    clamped paste origin, the bbox geometry (h, w, dy, dx) relative to it,
    and the mask restricted to the bbox (outside it the reference blend is
    the identity, so alpha is zero there). Raises ``ValueError`` when a crop
    box exceeds the bucket. cv2 is needed only for BGR or mis-sized masks."""
    N = len(face_boxes)
    origins = np.zeros((N, 2), np.int32)
    scalars = np.zeros((N, 4), np.int32)
    masks = np.zeros((N, Ho, Wo), np.uint8)
    for i, ((x, y, x1, y1), (xs, ys, xe, ye), m) in enumerate(
            zip(face_boxes, crop_boxes, mask_imgs)):
        if ye - ys > Ho or xe - xs > Wo:
            raise ValueError(f"crop box {xe - xs}x{ye - ys} (index {i}) exceeds the "
                             f"paste bucket {Wo}x{Ho}")
        oy = int(np.clip(ys, 0, H - Ho))
        ox = int(np.clip(xs, 0, W - Wo))
        origins[i] = (oy, ox)
        scalars[i] = (y1 - y, x1 - x, y - oy, x - ox)
        g = m
        if g.ndim != 2 or g.shape != (ye - ys, xe - xs):
            import cv2

            if g.ndim != 2:
                g = cv2.cvtColor(g, cv2.COLOR_BGR2GRAY)
            if g.shape != (ye - ys, xe - xs):
                g = cv2.resize(g, (xe - xs, ye - ys))
        buf = np.zeros((Ho, Wo), np.uint8)
        buf[ys - oy:ye - oy, xs - ox:xe - ox] = g
        keep = np.zeros_like(buf)
        keep[y - oy:y1 - oy, x - ox:x1 - ox] = 1
        masks[i] = buf * keep
    return origins, scalars, masks


class MaskedDevicePasteBack:
    """Per-avatar masked composite path (no scheduler): per-cycle-index
    feathered face-parse masks inside a larger crop box. The frames and the
    prepared planes are uploaded once; ``paste_batch`` gathers by index on
    the device and returns finished full frames."""

    def __init__(self, frames: np.ndarray, face_boxes, crop_boxes, mask_imgs, S: int,
                 device="cuda"):
        self.S = S
        H, W = frames.shape[1:3]
        self.Ho, self.Wo = bucket_shape([(ys, ye, xs, xe) for (xs, ys, xe, ye) in crop_boxes])
        self.available = self.Ho <= H and self.Wo <= W
        if not self.available:
            return
        dev = resolve_device(device)
        origins, scalars, masks = prepare_masked_paste_data(
            face_boxes, crop_boxes, mask_imgs, self.Ho, self.Wo, H, W)
        self.frames_dev = torch.from_numpy(np.ascontiguousarray(frames, np.uint8)).to(dev)
        self.origins_dev = torch.from_numpy(origins).to(dev)
        self.scalars_dev = torch.from_numpy(scalars).to(dev)
        self.masks_dev = torch.from_numpy(masks).to(dev)
        self._fn = make_masked_paste_fn(S, self.Ho, self.Wo, H, W)

    def paste_batch(self, pred_u8: torch.Tensor, idxs: np.ndarray) -> np.ndarray:
        """(B,S,S,3) uint8 device crops + (B,) cycle indices -> (B,H,W,3)."""
        idx = torch.as_tensor(np.asarray(idxs, np.int32), device=self.frames_dev.device)
        return self._fn(pred_u8, self.frames_dev, idx, self.origins_dev, self.scalars_dev,
                        self.masks_dev).cpu().numpy()
