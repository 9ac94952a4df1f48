"""ER-NeRF-class audio-driven volumetric head (ports
livetalking_tpu/models/ernerf.py).

The reference package's design, unchanged: three dense triplane feature
planes sampled bilinearly, a fixed number of samples per ray, volume
rendering as an exclusive cumulative sum of densities in log space, and a
per-frame audio latent (an MLP over the flattened HuBERT window)
concatenated to every sample's features. Parameters are a dictionary of
f32 tensors with the reference's keys and layouts (dense weights
(in, out)), so an avatar's ``ernerf.npz`` loads as it is.

``render_frame_batch`` renders every frame's rays in chunks of
``ray_chunk`` rays across the batch, so a B=16, 128 px, 32-sample step
(8.4 M samples) holds a few GB of intermediates, not tens. The training
step of the reference package is not ported yet.
"""

from __future__ import annotations

import functools
from typing import Any, Dict

import numpy as np
import torch
from torch.nn import functional as F

Params = Dict[str, Any]


def init_params(seed: int = 0, plane_res: int = 128, plane_ch: int = 16, audio_dim: int = 512,
                audio_lat: int = 32, hidden: int = 64, dtype=torch.float32,
                device="cpu") -> Params:
    """Triplane + MLP parameters from ``torch.Generator(seed)``.

    plane_res/plane_ch: triplane resolution and channels; audio_dim: the
    flattened per-frame audio window."""
    g = torch.Generator().manual_seed(seed)

    def t(a):
        return a.to(device=device, dtype=dtype)

    def dense(fan_in, fan_out):
        return {"w": t(torch.randn((fan_in, fan_out), generator=g) * fan_in ** -0.5),
                "b": t(torch.zeros(fan_out))}

    feat_in = 3 * plane_ch + audio_lat
    return {
        "planes": t(0.1 * torch.randn((3, plane_res, plane_res, plane_ch), generator=g)),
        "audio1": dense(audio_dim, 128),
        "audio2": dense(128, audio_lat),
        "trunk1": dense(feat_in, hidden),
        "trunk2": dense(hidden, hidden),
        "sigma": dense(hidden, 1),
        "color1": dense(hidden + 3, hidden),  # + view direction
        "color2": dense(hidden, 3),
    }


def params_from_jax(tree: Params, device="cpu") -> Params:
    """The JAX package's tree (same keys and layouts; numpy or tensor
    leaves) -> f32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def _dense(p, x):
    return x @ p["w"] + p["b"]


def audio_encoder(params: Params, audio_feat: torch.Tensor) -> torch.Tensor:
    """(B, audio_dim) flattened feature window -> (B, audio_lat)."""
    h = torch.relu(_dense(params["audio1"], audio_feat))
    return torch.tanh(_dense(params["audio2"], h))


def _bilinear_plane(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample an (R, R, C) plane at continuous uv in [-1, 1]^2 -> (..., C).

    Four taps and two lerps, as the reference: the fraction comes from the
    unclamped floor, the tap indices are clamped to the edge."""
    R = plane.shape[0]
    p = (uv + 1.0) * 0.5 * (R - 1)
    p0 = torch.floor(p)
    f = p - p0
    i0 = p0.to(torch.int64).clamp(0, R - 1)
    i1 = (i0 + 1).clamp(0, R - 1)
    flat = plane.reshape(R * R, -1)

    def tap(iy, ix):
        idx = iy * R + ix
        return flat.index_select(0, idx.reshape(-1)).reshape(idx.shape + (flat.shape[1],))

    v00 = tap(i0[..., 1], i0[..., 0])
    v01 = tap(i0[..., 1], i1[..., 0])
    v10 = tap(i1[..., 1], i0[..., 0])
    v11 = tap(i1[..., 1], i1[..., 0])
    fx = f[..., 0:1]
    fy = f[..., 1:2]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def triplane_features(planes: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """(3, R, R, C) planes, (..., 3) points in [-1, 1]^3 -> (..., 3C)."""
    return torch.cat([_bilinear_plane(planes[0], xyz[..., [0, 1]]),
                      _bilinear_plane(planes[1], xyz[..., [0, 2]]),
                      _bilinear_plane(planes[2], xyz[..., [1, 2]])], -1)


def field(params: Params, xyz: torch.Tensor, view_dir: torch.Tensor, audio_lat: torch.Tensor):
    """Density and colour at sample points: xyz (..., 3); view_dir and
    audio_lat broadcast along the sample axes. Returns (sigma (...,),
    rgb (..., 3))."""
    feats = triplane_features(params["planes"], xyz)
    a = audio_lat.expand(feats.shape[:-1] + audio_lat.shape[-1:])
    h = torch.relu(_dense(params["trunk1"], torch.cat([feats, a], -1)))
    h = torch.relu(_dense(params["trunk2"], h))
    sigma = F.softplus(_dense(params["sigma"], h)[..., 0] - 1.0)
    d = view_dir.expand(h.shape[:-1] + (3,))
    hc = torch.relu(_dense(params["color1"], torch.cat([h, d], -1)))
    rgb = torch.sigmoid(_dense(params["color2"], hc))
    return sigma, rgb


def render_rays(params: Params, rays_o: torch.Tensor, rays_d: torch.Tensor,
                audio_lat: torch.Tensor, *, n_samples: int = 32, near: float = 0.5,
                far: float = 2.5):
    """Volume-render a bundle of rays: rays_o/rays_d (R, 3); audio_lat
    (audio_lat,) for all rays or (R, audio_lat) per ray. Returns
    (rgb (R, 3), alpha (R,)); the caller composites over a background."""
    R = rays_o.shape[0]
    t = torch.linspace(near, far, n_samples, dtype=rays_o.dtype, device=rays_o.device)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * t[None, :, None]
    lat = audio_lat[None, None, :] if audio_lat.dim() == 1 else audio_lat[:, None, :]
    sigma, rgb = field(params, pts, rays_d[:, None, :], lat)
    delta = (far - near) / n_samples
    # transmittance: exclusive cumprod of exp(-sigma*delta), a cumsum in log space
    tau = sigma * delta                                                  # (R, N)
    trans = torch.exp(-torch.cat([torch.zeros((R, 1), dtype=tau.dtype, device=tau.device),
                                  torch.cumsum(tau, -1)[:, :-1]], -1))
    weights = trans * (1.0 - torch.exp(-tau))
    return (weights[..., None] * rgb).sum(1), weights.sum(1)


@functools.lru_cache(maxsize=8)
def _frame_rays_np(size: int, fov: float):
    i = (np.arange(size) + 0.5) / size * 2 - 1
    xs, ys = np.meshgrid(i, i)
    dirs = np.stack([xs * fov, ys * fov, -np.ones_like(xs)], -1)
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    origins = np.broadcast_to(np.array([0.0, 0.0, 2.0]), dirs.shape)
    return (origins.reshape(-1, 3).astype(np.float32), dirs.reshape(-1, 3).astype(np.float32))


def make_frame_rays(size: int, fov: float = 0.45, device="cpu"):
    """Static pinhole ray grid for a (size, size) head crop, the camera on
    the +z axis looking at the origin: (origins, directions), (size², 3)."""
    o, d = _frame_rays_np(size, fov)
    return torch.tensor(o, device=device), torch.tensor(d, device=device)


@torch.inference_mode()
def render_frame_batch(params: Params, audio_feats: torch.Tensor, bg_crops: torch.Tensor, *,
                       size: int = 64, n_samples: int = 32, ray_chunk: int = 32768) -> torch.Tensor:
    """Render B audio-conditioned head crops composited over backgrounds.

    audio_feats (B, audio_dim) flattened windows; bg_crops (B, size, size,
    3) f32 in [0, 1]. Returns (B, size, size, 3) uint8. The B*size² rays
    run in chunks of ``ray_chunk``, the batch's frames one after another."""
    B = audio_feats.shape[0]
    dev = audio_feats.device
    rays_o, rays_d = make_frame_rays(size, device=dev)
    lat = audio_encoder(params, audio_feats)                     # (B, A)
    P = size * size
    rgb = torch.empty((B * P, 3), dtype=torch.float32, device=dev)
    alpha = torch.empty((B * P,), dtype=torch.float32, device=dev)
    for s in range(0, B * P, ray_chunk):
        e = min(s + ray_chunk, B * P)
        r = torch.arange(s, e, device=dev)
        px = r % P
        rgb[s:e], alpha[s:e] = render_rays(params, rays_o[px], rays_d[px], lat[r // P],
                                           n_samples=n_samples)
    img = rgb.reshape(B, size, size, 3)
    a = alpha.reshape(B, size, size, 1)
    out = img * a + bg_crops * (1.0 - a)
    return (out * 255.0).round().clamp(0, 255).to(torch.uint8)
