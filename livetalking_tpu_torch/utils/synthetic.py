"""Synthetic MuseTalk avatars for tests, the chip smoke test and air-gapped
demos (the port's counterpart of livetalking_tpu/utils/synthetic.py).

``musetalk_avatar_arrays`` draws the reference generator's avatar in
numpy alone (no cv2, which the GPU host may lack): frames with a drifting
ellipse "head", eyes and a mouth, a 240x240 face box centred in the frame,
its 256 px face crops, and per frame a crop box = face box + 10% with a
filled ellipse mask blurred by a 31x31 Gaussian (sigma 5, reflected
borders, as ``cv2.GaussianBlur(mask, (31, 31), 0)``).
``make_synthetic_musetalk_avatar`` writes the same avatar as a
reference-format directory with VAE-encoded ``latents.pt``.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.utils.device import resolve_device

FACE = 256


def _ellipse(H: int, W: int, cx: int, cy: int, ax: int, ay: int) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W]
    return ((xx - cx) / max(ax, 1)) ** 2 + ((yy - cy) / max(ay, 1)) ** 2 <= 1.0


def _gaussian_blur(img: np.ndarray, ksize: int = 31) -> np.ndarray:
    """Separable Gaussian, sigma from ksize as cv2 derives it, reflect-101
    borders, rounded to uint8."""
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = ksize // 2
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    x = np.pad(img.astype(np.float64), r, mode="reflect")
    x = sum(k[i] * x[i:i + img.shape[0], :] for i in range(ksize))
    x = sum(k[i] * x[:, i:i + img.shape[1]] for i in range(ksize))
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    t = F.interpolate(t, size=(size, size), mode="bilinear", align_corners=False)
    return t.round().clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0).numpy()


def musetalk_avatar_arrays(n_frames: int = 6, frame_hw: Tuple[int, int] = (480, 640),
                           seed: int = 0) -> Dict[str, list]:
    """``{"frames", "faces", "coords", "mask_coords", "masks"}``: BGR uint8
    frames (H, W, 3), face crops (N, 256, 256, 3), face boxes
    (x1, y1, x2, y2), crop boxes (xs, ys, xe, ye) and gray crop-sized
    masks, as the reference's avatar generator writes them."""
    rng = np.random.default_rng(seed)
    H, W = frame_hw
    fh = fw = min(H, W) // 2
    y1, x1 = (H - fh) // 2, (W - fw) // 2
    x2, y2 = x1 + fw, y1 + fh
    mx, my = fw // 10, fh // 10
    xs, ys, xe, ye = max(0, x1 - mx), max(0, y1 - my), min(W, x2 + mx), min(H, y2 + my)
    frames, faces, masks = [], [], []
    for i in range(n_frames):
        frame = np.full((H, W, 3), 40 + 10 * (i % 3), np.uint8)
        cx, cy = W // 2 + int(5 * np.sin(i)), H // 2
        frame[_ellipse(H, W, cx, cy, fw // 2, fh // 2)] = (90, 140, 200)
        frame[_ellipse(H, W, cx - 30, cy - 30, 10, 10)] = (30, 30, 30)
        frame[_ellipse(H, W, cx + 30, cy - 30, 10, 10)] = (30, 30, 30)
        frame[_ellipse(H, W, cx, cy + 40, 30, 10 + (i % 4) * 3)] = (40, 40, 120)
        noise = rng.integers(0, 8, frame.shape)
        frame = np.minimum(frame.astype(np.int32) + noise, 255).astype(np.uint8)
        frames.append(frame)
        faces.append(_resize(frame[y1:y2, x1:x2], FACE))
        m = np.where(_ellipse(ye - ys, xe - xs, (xe - xs) // 2, (ye - ys) // 2,
                              fw // 2, fh // 2), 255, 0).astype(np.uint8)
        masks.append(_gaussian_blur(m))
    return {"frames": frames, "faces": np.stack(faces),
            "coords": [(x1, y1, x2, y2)] * n_frames,
            "mask_coords": [(xs, ys, xe, ye)] * n_frames, "masks": masks}


def make_synthetic_musetalk_avatar(avatar_dir: str, vae_params, n_frames: int = 6,
                                   frame_hw: Tuple[int, int] = (480, 640), seed: int = 0,
                                   device="cuda") -> str:
    """Write a musetalk-format avatar directory (full_imgs/, mask/,
    coords.pkl, mask_coords.pkl, latents.pt of (1, 8, 32, 32) tensors)
    whose latents are encoded by ``vae_params`` on ``device`` (the card
    unless the caller asks for the CPU; a CUDA request without a card
    raises before anything is written)."""
    import cv2

    from livetalking_tpu_torch.models.musetalk import encode_avatar_latents

    device = resolve_device(device)

    a = musetalk_avatar_arrays(n_frames, frame_hw, seed)
    for sub in ("full_imgs", "mask"):
        os.makedirs(os.path.join(avatar_dir, sub), exist_ok=True)
    for i, (frame, mask) in enumerate(zip(a["frames"], a["masks"])):
        cv2.imwrite(os.path.join(avatar_dir, "full_imgs", f"{i}.png"), frame)
        cv2.imwrite(os.path.join(avatar_dir, "mask", f"{i}.png"), mask)
    lat = encode_avatar_latents(vae_params, a["faces"], device=device)
    torch.save([torch.from_numpy(np.ascontiguousarray(np.transpose(l, (2, 0, 1))[None]))
                for l in lat], os.path.join(avatar_dir, "latents.pt"))
    for name, boxes in (("coords.pkl", a["coords"]), ("mask_coords.pkl", a["mask_coords"])):
        with open(os.path.join(avatar_dir, name), "wb") as f:
            pickle.dump(boxes, f)
    return avatar_dir
