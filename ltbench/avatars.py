"""Synthetic MuseTalk avatars drawn from the seed, in bulk, on the device.

The repository's synthetic avatar, drawn with tensors: per frame a flat
background, a drifting ellipse head, two eyes and a mouth whose height
cycles, plus uniform noise; a face box of half the frame's shorter side,
centred; a crop box 10% wider each side; a filled ellipse mask over the
crop, blurred by a 31x31 Gaussian (sigma 5, reflected borders); 256 px face
crops resized bilinearly (half-pixel centres). Colours, drift phase and
noise differ per avatar, from the seed.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.nn import functional as F

FACE = 256


def _ellipse(yy, xx, cx, cy, ax, ay):
    """(n, H, W) bool from per-frame centres (n,) and axes (scalars or (n,))."""
    ax, ay = (a[:, None, None] if torch.is_tensor(a) else a for a in (ax, ay))
    return (((xx[None] - cx[:, None, None]) / ax) ** 2
            + ((yy[None] - cy[:, None, None]) / ay) ** 2) <= 1.0


def _blur(mask: torch.Tensor, ksize: int = 31) -> torch.Tensor:
    sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = ksize // 2
    k = torch.exp(-0.5 * (torch.arange(-r, r + 1, device=mask.device, dtype=torch.float64)
                          / sigma) ** 2)
    k = (k / k.sum())
    x = F.pad(mask.double()[None, None], (r, r, r, r), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    return x[0, 0].round().clamp(0, 255).to(torch.uint8)


def make(avatar_cfg: dict, seed: int, n: int, device) -> List[Dict]:
    """``n`` avatars of ``avatar_cfg["frames"]`` frames at ``frame_hw``, each
    ``{"frames", "faces", "coords", "mask_coords", "masks"}`` on the host
    (uint8 BGR frames (H, W, 3), faces (N, 256, 256, 3), (x1, y1, x2, y2)
    face boxes, (xs, ys, xe, ye) crop boxes, crop-sized uint8 masks)."""
    H, W = avatar_cfg["frame_hw"]
    N = int(avatar_cfg["frames"])
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed((int(seed) * 7919 + 17) % (2 ** 63))
    fw = min(H, W) // 2
    s = fw / 240.0
    x1, y1 = (W - fw) // 2, (H - fw) // 2
    x2, y2 = x1 + fw, y1 + fw
    m = fw // 10
    xs, ys, xe, ye = max(0, x1 - m), max(0, y1 - m), min(W, x2 + m), min(H, y2 + m)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :].expand(H, W)
    cyy = torch.arange(ye - ys, device=dev, dtype=torch.float32)[:, None].expand(ye - ys, xe - xs)
    cxx = torch.arange(xe - xs, device=dev, dtype=torch.float32)[None, :].expand(ye - ys, xe - xs)
    one = torch.ones(1, device=dev)
    mask = _ellipse(cyy, cxx, one * ((xe - xs) // 2), one * ((ye - ys) // 2), fw // 2, fw // 2)[0]
    mask = _blur(torch.where(mask, 255, 0).to(torch.uint8)).cpu().numpy()
    out = []
    for _ in range(n):
        tint = torch.randint(-25, 26, (3,), generator=g, device=dev).float()
        phase = float(torch.rand((), generator=g, device=dev)) * 6.283
        i = torch.arange(N, device=dev, dtype=torch.float32)
        cx = (W // 2 + torch.trunc(5 * s * torch.sin(i + phase)))
        cy = torch.full((N,), float(H // 2), device=dev)
        img = (40 + 10 * (i % 3))[:, None, None, None].expand(N, H, W, 3).clone()
        parts = (
            (_ellipse(yy, xx, cx, cy, fw // 2, fw // 2), torch.tensor([90., 140., 200.], device=dev) + tint),
            (_ellipse(yy, xx, cx - 30 * s, cy - 30 * s, 10 * s, 10 * s), torch.full((3,), 30., device=dev)),
            (_ellipse(yy, xx, cx + 30 * s, cy - 30 * s, 10 * s, 10 * s), torch.full((3,), 30., device=dev)),
            (_ellipse(yy, xx, cx, cy + 40 * s, 30 * s, (10 + (i % 4) * 3) * s),
             torch.tensor([40., 40., 120.], device=dev)),
        )
        for where, colour in parts:
            img = torch.where(where[..., None], colour.clamp(0, 255), img)
        noise = torch.randint(0, 8, (N, H, W, 3), generator=g, device=dev, dtype=torch.uint8)
        frames = (img.to(torch.int16) + noise).clamp(max=255).to(torch.uint8)
        crops = frames[:, y1:y2, x1:x2].permute(0, 3, 1, 2).float()
        faces = F.interpolate(crops, size=(FACE, FACE), mode="bilinear", align_corners=False)
        faces = faces.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
        host = frames.cpu().numpy()
        out.append({"frames": list(host), "faces": faces.cpu().numpy(),
                    "coords": [(x1, y1, x2, y2)] * N, "mask_coords": [(xs, ys, xe, ye)] * N,
                    "masks": [mask] * N})
        del img, frames, crops, faces
    return out
