"""Landmark stage for the avatar build pipelines (ports
livetalking_tpu/genavatar/landmarks.py).

The reference's ultralight genavatar derives its face crop from PFLD
landmarks (reference avatars/ultralight/genavatar.py:76-82: left contour
x = lm[1], upper y = lm[52], right contour x = lm[31], square of that
width), regressed by PFLD-GhostOne on SCRFD boxes
(get_landmark.py:70-114). Here the detector is pluggable
(genavatar/face.py, s3fd preferred) and PFLD runs on the device
(models/pfld.py) when its checkpoint is present:

    models_dir/pfld.pth       (= checkpoint_epoch_335.pth.tar)
    models_dir/mean_face.txt  (the training mean face, same file the
                               reference reads)
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from livetalking_tpu_torch.utils.logger import logger

PFLD_WEIGHTS = "pfld.pth"
MEAN_FACE = "mean_face.txt"

# ultralight crop landmark indices (reference genavatar.py:76-80)
IDX_LEFT_X = 1
IDX_UPPER_Y = 52
IDX_RIGHT_X = 31


def load_pfld_landmarker(models_dir: str = "./models", device="cuda"):
    """PFLDLandmarker on ``device`` when pfld.pth + mean_face.txt exist,
    else None."""
    wpath = os.path.join(models_dir, PFLD_WEIGHTS)
    mpath = os.path.join(models_dir, MEAN_FACE)
    if not (os.path.exists(wpath) and os.path.exists(mpath)):
        return None
    import torch

    from livetalking_tpu_torch.models.pfld import (
        PFLDLandmarker,
        convert_torch_state_dict,
        load_mean_face,
    )

    sd = torch.load(wpath, map_location="cpu", weights_only=False)
    params = convert_torch_state_dict(sd)
    logger.info("loaded PFLD landmarker from %s", wpath)
    return PFLDLandmarker(params, load_mean_face(mpath), device=device)


def musetalk_crop_box(lms: np.ndarray, frame_hw: Tuple[int, int],
                      bbox_shift: int = 0
                      ) -> Optional[Tuple[int, int, int, int]]:
    """Landmark-refined MuseTalk crop (reference
    avatars/musetalk/utils/preprocessing.py:126-140): x from the landmark
    extremes; the upper bound mirrors the half-face below it
    (``upper = half_face_y - (max_y - half_face_y)``), with ``bbox_shift``
    moving the half-face anchor. The reference anchors on dlib point 29
    (nose bridge); the PFLD-110 anchor is IDX_UPPER_Y — the same
    eye/nose-level row."""
    H, W = frame_hw
    half_y = int(lms[IDX_UPPER_Y][1]) + bbox_shift
    max_y = int(lms[:, 1].max())
    upper = max(0, half_y - (max_y - half_y))
    x1 = int(lms[:, 0].min())
    x2 = int(lms[:, 0].max())
    if x2 - x1 <= 0 or max_y - upper <= 0 or x1 < 0:
        return None
    return (max(0, x1), upper, min(W, x2), min(H, max_y))


def ultralight_crop_box(lms: np.ndarray, frame_hw: Tuple[int, int]
                        ) -> Optional[Tuple[int, int, int, int]]:
    """Landmark square crop (reference genavatar.py:76-82): x from the
    face contour, y from lm[52], height = width. None when degenerate."""
    H, W = frame_hw
    xmin = int(lms[IDX_LEFT_X][0])
    xmax = int(lms[IDX_RIGHT_X][0])
    ymin = int(lms[IDX_UPPER_Y][1])
    width = xmax - xmin
    if width <= 0:
        return None
    x1, y1 = max(0, xmin), max(0, ymin)
    x2, y2 = min(W, xmin + width), min(H, ymin + width)
    if x2 - x1 <= 0 or y2 - y1 <= 0:
        return None
    return (x1, y1, x2, y2)
