"""Face detection for the offline avatar build, with pluggable backends
(ports livetalking_tpu/genavatar/face.py).

Backends, in ``auto`` preference order:

  - ``s3fd``: the reference's own detector (reference
    avatars/wav2lip/face_detection/detection/sfd/sfd_detector.py:41-47)
    on the device through models/s3fd.py, from ``models_dir/s3fd.pth``;
  - ``yunet``: cv2.FaceDetectorYN (ONNX model file required,
    ``--face_model`` / models_dir/face_detection_yunet.onnx);
  - ``haar``: cv2 Haar cascade when the cascade XML ships with cv2;
  - ``center``: geometric fallback (centred square, half the frame) —
    explicit opt-in only: it produces misaligned crops on real footage,
    so ``auto`` raises instead of degrading to it.

plus the reference's temporal box smoothing (mean over a window of 5,
reference avatars/wav2lip/genavatar.py:41-48) and pad application.
``cv2`` is imported where it is used.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.logger import logger

Box = Tuple[int, int, int, int]  # (x1, y1, x2, y2)

S3FD_WEIGHTS = "s3fd.pth"


class FaceDetector:
    """Strategy dispatcher. ``kind`` in {auto, s3fd, yunet, haar, center};
    S3FD runs on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, kind: str = "auto", model_path: Optional[str] = None,
                 models_dir: str = "./models", device="cuda"):
        import cv2

        self.kind = kind
        self.device = resolve_device(device)
        self._s3fd = None
        self._yunet = None
        self._haar = None

        s3fd_path = (model_path if kind == "s3fd" and model_path
                     else os.path.join(models_dir, S3FD_WEIGHTS))
        if kind in ("auto", "s3fd") and os.path.exists(s3fd_path):
            self._s3fd = _load_s3fd(s3fd_path, self.device)
            self.kind = "s3fd"
        elif kind == "s3fd":
            raise FileNotFoundError(
                f"s3fd weights not found at {s3fd_path} (the reference "
                "downloads the identical checkpoint; place it there)")
        elif kind in ("auto", "yunet") and model_path and os.path.exists(model_path):
            self._yunet = cv2.FaceDetectorYN.create(model_path, "", (320, 320))
            self.kind = "yunet"
        elif kind in ("auto", "haar"):
            xml = os.path.join(cv2.data.haarcascades, "haarcascade_frontalface_default.xml")
            if os.path.exists(xml):
                self._haar = cv2.CascadeClassifier(xml)
                self.kind = "haar"
            elif kind == "haar":
                raise FileNotFoundError(f"haar cascade not found at {xml}")
            else:
                raise RuntimeError(
                    "no face-detection backend available (no s3fd.pth, no "
                    "YuNet ONNX, no Haar cascade). Pass "
                    "face_detector='center' explicitly to build with "
                    "geometric center boxes (NOT recommended: crops will "
                    "be misaligned on real footage)")
        if self.kind == "yunet" and self._yunet is None:
            raise FileNotFoundError(
                "YuNet ONNX model not found (pass model_path or put "
                f"face_detection_yunet.onnx under {models_dir})")
        if self.kind not in ("s3fd", "yunet", "haar", "center"):
            raise ValueError(f"unknown face detector kind {self.kind!r}")
        if self.kind == "center":
            logger.warning("face detection using EXPLICIT geometric center boxes - "
                           "crops will be misaligned on real footage")

    def detect(self, frame_bgr: np.ndarray) -> Optional[Box]:
        import cv2

        H, W = frame_bgr.shape[:2]
        if self._s3fd is not None:
            return self.detect_batch(frame_bgr[None])[0]
        if self._yunet is not None:
            self._yunet.setInputSize((W, H))
            _, faces = self._yunet.detect(frame_bgr)
            if faces is not None and len(faces):
                x, y, w, h = faces[0][:4].astype(int)
                return (max(0, x), max(0, y), min(W, x + w), min(H, y + h))
            return None
        if self._haar is not None:
            gray = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
            faces = self._haar.detectMultiScale(gray, 1.1, 4)
            if len(faces):
                x, y, w, h = max(faces, key=lambda f: f[2] * f[3])
                return (x, y, x + w, y + h)
            return None
        # geometric fallback (explicit opt-in)
        s = min(H, W) // 2
        return ((W - s) // 2, (H - s) // 2, (W + s) // 2, (H + s) // 2)

    def detect_batch(self, frames_bgr: np.ndarray) -> List[Optional[Box]]:
        """(B, H, W, 3) uint8 -> per-frame best box or None. Batched on the
        device for s3fd; loops ``detect`` otherwise."""
        if self._s3fd is not None:
            out: List[Optional[Box]] = []
            for dets in self._s3fd.detect_batch(frames_bgr):
                if len(dets) == 0:
                    out.append(None)
                else:
                    x1, y1, x2, y2, _ = dets[np.argmax(dets[:, 4])]
                    out.append((int(x1), int(y1), int(x2), int(y2)))
            return out
        return [self.detect(f) for f in frames_bgr]


def _load_s3fd(path: str, device):
    import torch

    from livetalking_tpu_torch.models.s3fd import S3FDDetector, convert_torch_state_dict

    sd = torch.load(path, map_location="cpu", weights_only=True)
    logger.info("loaded s3fd detector weights from %s", path)
    return S3FDDetector(convert_torch_state_dict(sd), device=device)


def smooth_boxes(boxes: Sequence[Box], window: int = 5) -> List[Box]:
    """Temporal mean smoothing over a sliding window (reference
    avatars/wav2lip/genavatar.py:41-48)."""
    arr = np.asarray(boxes, np.float64)
    out = []
    for i in range(len(arr)):
        lo = max(0, i - window // 2)
        hi = min(len(arr), lo + window)
        out.append(tuple(int(round(v)) for v in arr[lo:hi].mean(axis=0)))
    return out


def apply_pads(box: Box, frame_hw: Tuple[int, int],
               pads: Tuple[int, int, int, int] = (0, 10, 0, 0)) -> Box:
    """Expand a box by (pad_top, pad_bottom, pad_left, pad_right) clamped
    to the frame (reference avatars/wav2lip/genavatar.py:112-118)."""
    H, W = frame_hw
    x1, y1, x2, y2 = box
    top, bottom, left, right = pads
    return (max(0, x1 - left), max(0, y1 - top), min(W, x2 + right), min(H, y2 + bottom))


def detect_track(frames: Sequence[np.ndarray], detector: FaceDetector, pads=(0, 10, 0, 0),
                 smooth_window: int = 5, batch: int = 8) -> List[Box]:
    """Per-frame boxes with hold-last-box on misses, smoothing, and pads.
    Batched through ``detector.detect_batch``; the ragged tail repeats the
    last frame, so every batch has one shape."""
    raw: List[Optional[Box]] = []
    frames = list(frames)
    for s in range(0, len(frames), batch):
        chunk = frames[s: s + batch]
        n = len(chunk)
        if n < batch:
            chunk = chunk + [chunk[-1]] * (batch - n)
        raw.extend(detector.detect_batch(np.stack(chunk))[:n])
    boxes: List[Box] = []
    last: Optional[Box] = None
    for box in raw:
        box = box or last
        if box is None:
            raise ValueError("no face detected in the first frame")
        boxes.append(box)
        last = box
    boxes = smooth_boxes(boxes, smooth_window)
    return [apply_pads(b, frames[0].shape[:2], pads) for b in boxes]
