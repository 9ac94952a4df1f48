"""ER-NeRF avatar plugin, model family "ernerf" (ports
livetalking_tpu/avatars/ernerf_avatar.py).

Exports ``load_model`` / ``load_avatar`` / ``warm_up`` plus a
``BaseAvatar`` subclass registered as ``avatar/ernerf``. An
audio-conditioned triplane NeRF (models/ernerf.py) renders the head crop
of each frame over that frame's own box crop, kept on the device at render
size; the host pastes it back like the other families. The shared model
is the HuBERT front-end (as Ultralight's); the field is per avatar
(``data/avatars/<id>/ernerf.npz``, the flat keys the JAX package writes).
No scheduler and no kernel run on this path.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Any, Dict, Sequence

import numpy as np
import torch

from livetalking_tpu_torch.audio_features.hubert_features import HubertFeatures
from livetalking_tpu_torch.avatars import ultralight_avatar
from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar
from livetalking_tpu_torch.models import ernerf
from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.image import mirror_indices, read_imgs
from livetalking_tpu_torch.utils.logger import logger

AUDIO_DIM = 16 * 32 * 32  # the flattened HuBERT window, as Ultralight shapes it


def _render_opts(opt) -> Dict[str, int]:
    return {"size": int(getattr(opt, "ernerf_size", 128) or 128),
            "n_samples": int(getattr(opt, "ernerf_samples", 32) or 32)}


def load_model(opt) -> Dict[str, Any]:
    """The shared HuBERT front-end (``ultralight_avatar.load_model``); the
    field lives with the avatar."""
    return ultralight_avatar.load_model(opt)


def flatten_params(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested parameter dictionary -> flat ``a.b.c`` keys of numpy arrays."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_params(v, key + "."))
        else:
            out[key] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def unflatten_params(flat: Dict[str, np.ndarray], device="cpu"):
    """Flat ``a.b.c`` keys -> the nested dictionary of f32 tensors."""
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        node = tree
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v, np.float32)).to(device)
    return tree


def avatar_from_arrays(avatar_id: str, frames: Sequence[np.ndarray], coords: Sequence[tuple],
                       nerf_params=None, device="cuda") -> Dict[str, Any]:
    """An avatar from arrays in memory: full frames (H, W, 3) uint8 BGR and
    boxes (y1, y2, x1, x2); ``nerf_params`` None renders a random field."""
    if len(frames) != len(coords):
        raise ValueError(f"avatar {avatar_id}: {len(frames)} frames, {len(coords)} boxes")
    dev = resolve_device(device)
    if nerf_params is not None:
        nerf_params = ernerf.params_from_jax(nerf_params, dev)
    return {"avatar_id": avatar_id, "frame_list_cycle": list(frames),
            "coord_list_cycle": [tuple(int(v) for v in c) for c in coords],
            "nerf_params": nerf_params}


def load_avatar(avatar_id: str, data_dir: str = "./data", device="cuda") -> Dict[str, Any]:
    """Avatar dir: ``{full_imgs/, coords.pkl (y1, y2, x1, x2), ernerf.npz}``;
    without ``ernerf.npz`` the session renders a random field."""
    dev = resolve_device(device)
    avatar_path = os.path.join(data_dir, "avatars", avatar_id)
    with open(os.path.join(avatar_path, "coords.pkl"), "rb") as f:
        coords = pickle.load(f)
    paths = glob.glob(os.path.join(avatar_path, "full_imgs", "*.[jpJP][pnPN]*[gG]"))
    paths = sorted(paths, key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))
    nerf_path = os.path.join(avatar_path, "ernerf.npz")
    nerf_params = None
    if os.path.exists(nerf_path):
        with np.load(nerf_path) as loaded:
            nerf_params = unflatten_params({k: loaded[k] for k in loaded.files}, dev)
        logger.info("loaded ernerf field from %s", nerf_path)
    return avatar_from_arrays(avatar_id, read_imgs(paths), coords, nerf_params, dev)


def warm_up(batch_size: int, model: Dict[str, Any], modelres: int = 128) -> None:
    """Render one batch on zeros with a random field (a graph smoke test)."""
    logger.info("warmup ernerf model...")
    dev = model["device"]
    params = ernerf.init_params(0, audio_dim=AUDIO_DIM, device=dev)
    feats = torch.zeros((batch_size, AUDIO_DIM), device=dev)
    bg = torch.zeros((batch_size, modelres, modelres, 3), device=dev)
    ernerf.render_frame_batch(params, feats, bg, size=modelres)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@register("avatar", "ernerf")
class NerfReal(BaseAvatar):
    def __init__(self, opt, model: Dict[str, Any], avatar: Dict[str, Any]):
        import cv2

        super().__init__(opt)
        self.model = model
        self.frame_list_cycle = avatar["frame_list_cycle"]
        self.coord_list_cycle = avatar["coord_list_cycle"]  # (y1, y2, x1, x2)
        ropts = _render_opts(opt)
        self._size, self._n_samples = ropts["size"], ropts["n_samples"]
        dev = model["device"]
        self.nerf_params = avatar.get("nerf_params")
        if self.nerf_params is None:
            self.nerf_params = ernerf.init_params(0, audio_dim=AUDIO_DIM, device=dev)

        # each cycle frame's own box region at render size, on the device:
        # the background the rendered head is composited over
        bgs = [cv2.resize(frame[y1:y2, x1:x2], (self._size, self._size)).astype(np.float32)
               / 255.0 for frame, (y1, y2, x1, x2) in zip(self.frame_list_cycle,
                                                            self.coord_list_cycle)]
        self.bg_cycle_device = torch.from_numpy(np.stack(bgs)).to(dev)
        self._n_frames = len(self.frame_list_cycle)

        self.asr = HubertFeatures(opt, self, hubert_params=model["hubert_params"],
                                  hubert_cfg=model["hubert_cfg"], audio_feat_length=(4, 4))
        self.asr.warm_up()

    def inference_batch(self, index: int, audiofeat_batch) -> np.ndarray:
        dev = self.bg_cycle_device.device
        idxs = torch.from_numpy(mirror_indices(self._n_frames, index, self.batch_size)).to(dev)
        feats = torch.as_tensor(audiofeat_batch, device=dev).reshape(self.batch_size, -1).float()
        bg = self.bg_cycle_device.index_select(0, idxs)
        pred = ernerf.render_frame_batch(self.nerf_params, feats, bg, size=self._size,
                                         n_samples=self._n_samples)
        return pred.cpu().numpy()  # (B, size, size, 3) uint8

    def paste_back_frame(self, pred_frame: np.ndarray, idx: int) -> np.ndarray:
        import cv2

        y1, y2, x1, x2 = self.coord_list_cycle[idx]
        frame = self.frame_list_cycle[idx].copy()
        frame[y1:y2, x1:x2] = cv2.resize(pred_frame, (x2 - x1, y2 - y1))
        return frame
