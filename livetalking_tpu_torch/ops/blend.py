"""Device paste-back: bilinear resize + feathered blend + rect paste.

Ports livetalking_tpu/ops/pallas_blend.py. A batch of predicted (S, S)
mouth crops goes back into full frames on the device, so only finished
frames leave it. One kernel (csrc/blend.cu) does the whole step: it reads
each item's cycle frame by index, resizes the crop into its bbox, blends
it and writes the finished frame once; no gathered copy is made first.

Crops are padded to a static per-avatar bucket ``(Ho, Wo)`` = (next
multiple of 8, next multiple of 128) >= the largest bbox of the cycle, as
in the reference.

Entries, each a wrapper of the kernel: on CPU tensors it runs its plain
version, on CUDA tensors it launches the kernel, on anything else it
raises.

- ``paste_rect`` (Wav2Lip; plain ``resize_paste_plain``) and
  ``paste_masked`` (MuseTalk, alpha from a per-cycle-index uint8
  face-parse mask inside a larger crop box; plain ``masked_paste_plain``):
  frames by index in, new full frames out.
- ``make_resize_paste_fn`` and ``make_masked_paste_fn``: the same steps
  with the static geometry checked once, as the avatars' step factories
  call them.
- ``blend_rect_`` and ``blend_masked_``: the kernel's in-place form on
  already-gathered frames (plain ``_blend_rect_plain``,
  ``_blend_masked_plain``).

No wrapper is differentiable: each raises when grad mode is on and an
input requires grad (``ops.conv.refuse_grad``). Both forms of a kernel
count their launches in ``blend_rect_.launches``
and ``blend_masked_.launches``. ``prepare_masked_paste_data`` builds the
masked path's per-index planes on the host; ``DevicePasteBack`` and
``MaskedDevicePasteBack`` are the per-avatar paths without a scheduler.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from livetalking_tpu_torch.ops.conv import _on, _stream, refuse_grad
from livetalking_tpu_torch.utils.device import resolve_device

__all__ = [
    "bucket_shape",
    "paste_rect",
    "paste_masked",
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


_launch_lock = threading.Lock()
_U8 = (torch.uint8,)
_I32 = (torch.int32,)
_IDX = (torch.int32, torch.int64)


@functools.cache
def _kernel_fn():
    from livetalking_tpu_torch.ops import _build

    fn = _build.library("blend").paste_launch
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_geometry(S: int, Ho: int, Wo: int, H: int, W: int, feather: int = 0) -> None:
    if not (S > 0 and 0 < Ho <= H and 0 < Wo <= W) or feather < 0:
        raise ValueError(f"paste: crop bucket ({Ho},{Wo}) must lie inside the frame "
                         f"({H},{W}), with S={S} > 0 and feather={feather} >= 0")


def _check_pred(pred_u8: torch.Tensor, S: int) -> None:
    if pred_u8.shape[1:] != (S, S, 3):
        raise ValueError(f"paste: pred {tuple(pred_u8.shape)}, want (B,{S},{S},3)")


def _check_tensors(kernel: str, dev: torch.device, named) -> None:
    """Raise unless each ``(name, tensor, dtypes, shape)`` lies on ``dev``
    (a CUDA device), has one of ``dtypes``, the shape and contiguous
    memory; ``pred`` needs only pixels of 3 contiguous bytes and
    non-negative strides, which the kernel reads as they are."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {dev}, not CUDA")
    index = dev.index
    for name, t, dtypes, shape in named:
        if not t.is_cuda or t.get_device() != index:
            raise ValueError(f"{kernel}: {name} is on {t.device}, not {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{kernel}: {name} is {t.dtype}, want one of {dtypes}")
        if t.shape != shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, want {shape}")
        if name == "pred":
            sb, sy, sx, sc = t.stride()
            if sx != 3 or sc != 1 or sb < 0 or sy < 0:
                raise ValueError(f"{kernel}: pred strides {t.stride()}, want (>=0, >=0, 3, 1)")
        elif not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _launch(masked: bool, fused: bool, pred, src, out, idxs, planes, S: int, Ho: int,
            Wo: int, feather: int) -> None:
    """Launch the kernel on ``out``'s device and current stream; raise if
    the launch failed. ``planes``: (boxes,) or (origins, scalars, masks)."""
    B, H, W = out.shape[:3]
    dev = out.device
    ptrs = [t.data_ptr() for t in planes]
    ptrs = [0] + ptrs if masked else ptrs + [0, 0, 0]  # boxes, origins, scalars, masks
    sb, sy = pred.stride()[:2]
    with _on(dev):
        err = _kernel_fn()(masked, fused, pred.data_ptr(), sb, sy,
                           0 if src is None else src.data_ptr(), out.data_ptr(),
                           0 if idxs is None else idxs.data_ptr(),
                           idxs is not None and idxs.dtype == torch.int64, *ptrs,
                           B, S, H, W, Ho, Wo, feather, _stream(dev))
    if err != 0:
        raise RuntimeError(f"paste kernel launch failed: cudaError {err}")
    counter = blend_masked_ if masked else blend_rect_
    with _launch_lock:
        counter.launches += 1


def _paste_rect(pred, frames, idxs, boxes, S: int, Ho: int, Wo: int, H: int, W: int,
                feather: int) -> torch.Tensor:
    """``paste_rect`` after the static geometry was checked."""
    refuse_grad("paste_rect", pred, frames)
    dev = frames.device
    if dev.type == pred.device.type == idxs.device.type == boxes.device.type == "cpu":
        return resize_paste_plain(pred, frames, idxs, boxes, S=S, Ho=Ho, Wo=Wo, H=H, W=W,
                                  feather=feather)
    B, N = idxs.shape[0], frames.shape[0]
    _check_tensors("paste_rect", dev, (("pred", pred, _U8, (B, S, S, 3)),
                                       ("frames", frames, _U8, (N, H, W, 3)),
                                       ("idxs", idxs, _IDX, (B,)),
                                       ("boxes", boxes, _I32, (N, 4))))
    out = torch.empty((B, H, W, 3), dtype=torch.uint8, device=dev)
    if B:
        _launch(False, True, pred, frames, out, idxs, (boxes,), S, Ho, Wo, feather)
    return out


def paste_rect(pred: torch.Tensor, frames: torch.Tensor, idxs: torch.Tensor,
               boxes: torch.Tensor, *, Ho: int, Wo: int, feather: int = 0) -> torch.Tensor:
    """Paste each crop ``pred[b]`` into a copy of ``frames[idxs[b]]``.

    ``pred`` (B, S, S, 3) uint8, ``frames`` (N, H, W, 3) uint8, ``idxs``
    (B,) int32 or int64 in [0, N) (the kernel does not check them),
    ``boxes`` (N, 4) int32 (y1, y2, x1, x2). Returns new (B, H, W, 3) uint8
    frames. CPU tensors run ``resize_paste_plain``; CUDA tensors launch the
    kernel in its fused form (counted in ``blend_rect_.launches``);
    anything else raises."""
    S, (H, W) = pred.shape[1], frames.shape[1:3]
    _check_geometry(S, Ho, Wo, H, W, feather)
    return _paste_rect(pred, frames, idxs, boxes, S, Ho, Wo, H, W, feather)


def _blend_rect_plain(pred: torch.Tensor, out: torch.Tensor, boxes: torch.Tensor,
                      *, Ho: int, Wo: int, feather: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel's in-place form: same function,
    same arithmetic.

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


def blend_rect_(pred: torch.Tensor, out: torch.Tensor, boxes: torch.Tensor,
                *, Ho: int, Wo: int, feather: int = 0) -> torch.Tensor:
    """Resize ``pred`` into each item's bbox and blend it into ``out``, in place.

    ``out`` (B, H, W, 3) uint8 holds already-gathered frames, ``boxes``
    (B, 4) int32 their bboxes; nothing outside a bbox is written. CPU
    tensors run ``_blend_rect_plain``; CUDA tensors launch the kernel's
    in-place form on the current stream (counted in
    ``blend_rect_.launches``); anything else raises."""
    refuse_grad("blend_rect_", pred, out)
    if pred.device.type == out.device.type == boxes.device.type == "cpu":
        return _blend_rect_plain(pred, out, boxes, Ho=Ho, Wo=Wo, feather=feather)
    B, H, W = out.shape[:3]
    S = pred.shape[1]
    _check_geometry(S, Ho, Wo, H, W, feather)
    _check_tensors("blend_rect_", out.device, (("pred", pred, _U8, (B, S, S, 3)),
                                               ("out", out, _U8, (B, H, W, 3)),
                                               ("boxes", boxes, _I32, (B, 4))))
    if B:
        _launch(False, False, pred, None, out, None, (boxes,), S, Ho, Wo, feather)
    return out


blend_rect_.launches = 0


def make_resize_paste_fn(S: int, Ho: int, Wo: int, H: int, W: int, feather: int = 0):
    """Build the batched paste-back step.

    Returns ``fn(pred_u8 (B,S,S,3), frames_u8 (N,H,W,3), idxs (B,),
    boxes (N,4)) -> (B,H,W,3) uint8`` full frames, all on one device: the
    geometry is checked here once, each call checks its tensors and runs
    ``paste_rect``'s kernel (or, on CPU tensors, its plain version)."""
    _check_geometry(S, Ho, Wo, H, W, feather)

    def paste(pred_u8, frames_u8, idxs, boxes):
        return _paste_rect(pred_u8, frames_u8, idxs, boxes, S, Ho, Wo, H, W, feather)

    return paste


def resize_paste_plain(pred_u8, frames_u8, idxs, boxes, *, S: int, Ho: int,
                       Wo: int, H: int, W: int, feather: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``paste_rect`` on any device (the test
    oracle): gather the frames and boxes, then ``_blend_rect_plain``."""
    _check_geometry(S, Ho, Wo, H, W, feather)
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
    """Plain PyTorch version of the masked kernel's in-place form: same
    function, same arithmetic.

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


def blend_masked_(pred: torch.Tensor, out: torch.Tensor, idxs: torch.Tensor,
                  origins: torch.Tensor, scalars: torch.Tensor, masks: torch.Tensor,
                  *, Ho: int, Wo: int) -> torch.Tensor:
    """Resize ``pred`` into each item's bbox and blend it into ``out`` with
    the item's uint8 mask as alpha, in place.

    ``out`` (B, H, W, 3) uint8 holds already-gathered frames; ``idxs`` (B,)
    index the planes ``origins`` (N, 2), ``scalars`` (N, 4) (int32) and
    ``masks`` (N, Ho, Wo) uint8, and must lie in ``[0, N)``: the kernel
    does not check them. Each mask must be zero outside its box (the
    ``scalars`` geometry), as ``prepare_masked_paste_data`` builds it: the
    kernel blends the box only. Where the mask is 0 the frame keeps its
    bytes.
    CPU tensors run ``_blend_masked_plain``; CUDA tensors launch the
    kernel's in-place form on the current stream (counted in
    ``blend_masked_.launches``); anything else raises."""
    args = (pred, out, idxs, origins, scalars, masks)
    refuse_grad("blend_masked_", pred, out)
    if all(t.device.type == "cpu" for t in args):
        return _blend_masked_plain(*args, Ho=Ho, Wo=Wo)
    B, H, W = out.shape[:3]
    S = pred.shape[1]
    _check_geometry(S, Ho, Wo, H, W)
    _check_tensors("blend_masked_", out.device,
                   (("pred", pred, _U8, (B, S, S, 3)), ("out", out, _U8, (B, H, W, 3)))
                   + _plane_specs(idxs, origins, scalars, masks, B, Ho, Wo))
    if B:
        _launch(True, False, pred, None, out, idxs, (origins, scalars, masks), S, Ho, Wo, 0)
    return out


blend_masked_.launches = 0


def _plane_specs(idxs, origins, scalars, masks, B: int, Ho: int, Wo: int) -> tuple:
    N = origins.shape[0]
    return (("idxs", idxs, _IDX, (B,)), ("origins", origins, _I32, (N, 2)),
            ("scalars", scalars, _I32, (N, 4)), ("masks", masks, _U8, (N, Ho, Wo)))


def _paste_masked(pred, frames, idxs, origins, scalars, masks, S: int, Ho: int, Wo: int,
                  H: int, W: int) -> torch.Tensor:
    """``paste_masked`` after the static geometry was checked."""
    args = (pred, frames, idxs, origins, scalars, masks)
    refuse_grad("paste_masked", pred, frames)
    if all(t.device.type == "cpu" for t in args):
        return masked_paste_plain(*args, S=S, Ho=Ho, Wo=Wo, H=H, W=W)
    dev = frames.device
    B = idxs.shape[0]
    _check_tensors("paste_masked", dev,
                   (("pred", pred, _U8, (B, S, S, 3)),
                    ("frames", frames, _U8, (frames.shape[0], H, W, 3)))
                   + _plane_specs(idxs, origins, scalars, masks, B, Ho, Wo))
    out = torch.empty((B, H, W, 3), dtype=torch.uint8, device=dev)
    if B:
        _launch(True, True, pred, frames, out, idxs, (origins, scalars, masks), S, Ho, Wo, 0)
    return out


def paste_masked(pred: torch.Tensor, frames: torch.Tensor, idxs: torch.Tensor,
                 origins: torch.Tensor, scalars: torch.Tensor, masks: torch.Tensor,
                 *, Ho: int, Wo: int) -> torch.Tensor:
    """Paste each crop ``pred[b]`` into a copy of ``frames[idxs[b]]`` with
    the index's uint8 mask as alpha.

    ``pred`` (B, S, S, 3) uint8, ``frames`` (N, H, W, 3) uint8, ``idxs``
    (B,) int32 or int64 in [0, N) (the kernel does not check them), and the
    planes of ``prepare_masked_paste_data``: ``origins`` (N, 2) and
    ``scalars`` (N, 4) int32, ``masks`` (N, Ho, Wo) uint8, zero outside
    each box (the kernel blends the box only). Returns new
    (B, H, W, 3) uint8 frames. CPU tensors run ``masked_paste_plain``; CUDA
    tensors launch the kernel in its fused form (counted in
    ``blend_masked_.launches``); anything else raises."""
    S, (H, W) = pred.shape[1], frames.shape[1:3]
    _check_geometry(S, Ho, Wo, H, W)
    return _paste_masked(pred, frames, idxs, origins, scalars, masks, S, Ho, Wo, H, W)


def make_masked_paste_fn(S: int, Ho: int, Wo: int, H: int, W: int):
    """Build the batched masked paste-back step.

    Returns ``fn(pred_u8 (B,S,S,3), frames_u8 (N,H,W,3), idxs (B,),
    origins (N,2) i32, scalars (N,4) i32, masks_u8 (N,Ho,Wo)) -> (B,H,W,3)
    uint8`` full frames, all on one device. ``origins`` are the clamped
    paste origins (oy, ox), ``scalars`` the bbox geometry (h, w, dy, dx)
    relative to them, and ``masks_u8`` must be zero outside the bbox
    (``prepare_masked_paste_data`` builds all three). The geometry is
    checked here once; each call checks its tensors and runs
    ``paste_masked``'s kernel (or, on CPU tensors, its plain version)."""
    _check_geometry(S, Ho, Wo, H, W)

    def paste(pred_u8, frames_u8, idxs, origins, scalars, masks_u8):
        return _paste_masked(pred_u8, frames_u8, idxs, origins, scalars, masks_u8, S, Ho, Wo,
                             H, W)

    return paste


def masked_paste_plain(pred_u8, frames_u8, idxs, origins, scalars, masks_u8, *, S: int,
                       Ho: int, Wo: int, H: int, W: int) -> torch.Tensor:
    """Plain PyTorch version of ``paste_masked`` on any device (the test
    oracle): gather the frames, then ``_blend_masked_plain``."""
    _check_geometry(S, Ho, Wo, H, W)
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
