"""Wav2Lip avatar plugin, model family "wav2lip" (ports
livetalking_tpu/avatars/wav2lip_avatar.py).

Exports ``load_model`` / ``load_avatar`` / ``warm_up`` plus a
``BaseAvatar`` subclass registered as ``avatar/wav2lip``. The avatar
directory format is the reference's:
``data/avatars/<id>/{full_imgs/*.png, face_imgs/*.png, coords.pkl}`` with
coords entries ``(y1, y2, x1, x2)``. ``avatar_from_arrays`` builds the same
avatar from arrays already in memory.

The face-crop cycle is uploaded once per avatar; ``inference_batch`` sends
only B indices to the device and receives B uint8 frames back from the
step (models/wav2lip.py ``make_infer_fn``). Under ``--coalesce`` every
session shares one ``BatchScheduler``; with ``--device_paste_back`` its
super-batch step also runs the paste-back (ops/blend.py), so sessions
receive finished full frames.
"""

from __future__ import annotations

import glob
import os
import pickle
import threading
from typing import Any, Dict, Sequence

import numpy as np
import torch

from livetalking_tpu_torch.audio_features.mel_features import MelFeatures
from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar
from livetalking_tpu_torch.engine.scheduler import (
    AvatarStore,
    BatchScheduler,
    SchedulerConfigError,
    parse_buckets,
    resolve_coalesce_window,
)
from livetalking_tpu_torch.models import wav2lip as w2l
from livetalking_tpu_torch.ops.blend import DevicePasteBack, bucket_shape, make_resize_paste_fn
from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.image import mirror_indices, read_imgs
from livetalking_tpu_torch.utils.logger import logger

IMG_SIZE = 256

# shared cross-session batching state (one device worker per process,
# engine/scheduler.py) — created lazily when --coalesce sessions appear
_shared_lock = threading.Lock()
_shared: dict = {"store": None, "scheduler": None}


def make_step_factory(dtype: torch.dtype, store: AvatarStore,
                      paste_spec: Dict[str, int] = None):
    """``step_factory(n)`` for the shared scheduler: the Wav2Lip step for a
    super-batch of n, followed, when ``paste_spec`` ({"S","H","W","Ho","Wo"})
    is given, by the paste-back over the store's ``pb_frames``/``pb_boxes``
    planes, so the step returns finished full frames."""
    paste_fn = None
    if paste_spec is not None:
        paste_fn = make_resize_paste_fn(paste_spec["S"], paste_spec["Ho"], paste_spec["Wo"],
                                        paste_spec["H"], paste_spec["W"])

    def step_factory(n):
        step = w2l.make_infer_fn(n, IMG_SIZE, dtype)
        if paste_fn is None:
            return step

        @torch.inference_mode()
        def step_and_paste(net, buffer, idxs, mel):
            pred = step(net, buffer, idxs, mel)
            aux = store.aux  # re-read: grows as avatars register
            return paste_fn(pred, aux["pb_frames"], idxs, aux["pb_boxes"])
        return step_and_paste

    return step_factory


def get_shared_scheduler(model: Dict[str, Any], batch_size: int,
                         buckets=(1, 2, 4, 8),
                         coalesce_window_s: float = 0.0,
                         paste_spec: Dict[str, int] = None) -> tuple:
    """Lazily create the process-wide (AvatarStore, BatchScheduler) pair.

    ``paste_spec`` ({"S","H","W","Ho","Wo"}, from the FIRST session's
    avatar geometry) composes the device rect paste-back into the
    super-batch step, which then returns finished FULL frames."""
    with _shared_lock:
        cfg = {"batch_size": batch_size, "buckets": tuple(buckets),
               "coalesce_window_s": float(coalesce_window_s),
               "paste": (None if paste_spec is None
                         else (paste_spec["H"], paste_spec["W"]))}
        if _shared["scheduler"] is None:
            store = AvatarStore(IMG_SIZE, device=model["device"])
            if paste_spec is not None:
                _shared["paste_geom"] = dict(paste_spec)
            sched = BatchScheduler(
                model["net"], store,
                make_step_factory(model["dtype"], store, paste_spec),
                batch_size, buckets=buckets,
                coalesce_window_s=coalesce_window_s,
            )
            sched.start()
            _shared["store"] = store
            _shared["scheduler"] = sched
            _shared["config"] = cfg
        elif _shared.get("config") != cfg:
            # reject conflicting per-session flags instead of silently
            # batching with the first session's configuration
            raise SchedulerConfigError(
                f"coalesce: shared scheduler already running with "
                f"{_shared.get('config')}; conflicting session config {cfg} "
                "rejected (per-session scheduler overrides are not allowed "
                "under --coalesce)")
        return _shared["store"], _shared["scheduler"]


def reset_shared_scheduler() -> None:
    """Stop and drop the process-wide scheduler (tests / reconfiguration)."""
    with _shared_lock:
        if _shared["scheduler"] is not None:
            _shared["scheduler"].stop()
        _shared["scheduler"] = None
        _shared["store"] = None
        _shared.pop("config", None)
        _shared.pop("paste_geom", None)


def load_model(path: str, opt) -> Dict[str, Any]:
    """Load wav2lip weights onto ``opt.device``. Accepts the reference
    ``wav2lip.pth`` checkpoint; falls back to random init from seed 0 when
    no file exists (demo/bench mode — same graph, same speed, untrained
    output)."""
    device = resolve_device(getattr(opt, "device", "cuda"))
    dtype = torch.bfloat16 if getattr(opt, "dtype", "bfloat16") == "bfloat16" else torch.float32
    if path and os.path.exists(path):
        logger.info("Load checkpoint from: %s", path)
        net = w2l.load_torch_checkpoint(path)
    else:
        logger.warning("wav2lip checkpoint %s not found - using random init", path)
        net = w2l.init_model(seed=0)
    return {"net": w2l.prepare(net, device, dtype), "dtype": dtype, "device": device}


def avatar_from_arrays(avatar_id: str, frames: Sequence[np.ndarray], faces: np.ndarray,
                       coords: Sequence[tuple], device="cuda") -> Dict[str, Any]:
    """An avatar from in-memory arrays: full frames (H, W, 3) uint8 BGR,
    face crops (N, 256, 256, 3) uint8 and ``(y1, y2, x1, x2)`` boxes."""
    faces = np.ascontiguousarray(faces, np.uint8)
    if faces.shape[1:] != (IMG_SIZE, IMG_SIZE, 3) or not (len(frames) == len(coords) == len(faces)):
        raise ValueError(f"avatar {avatar_id}: {len(frames)} frames, {len(coords)} boxes, "
                         f"faces {faces.shape}; want one (256, 256, 3) face per frame")
    return {
        "avatar_id": avatar_id,
        "frame_list_cycle": list(frames),
        "coord_list_cycle": [tuple(int(v) for v in c) for c in coords],
        "face_cycle_host": faces,  # for the shared AvatarStore (coalesce mode)
        "face_cycle_device": torch.from_numpy(faces).to(resolve_device(device)),
    }


def load_avatar(avatar_id: str, data_dir: str = "./data", device="cuda") -> Dict[str, Any]:
    """Load a reference-format avatar directory onto host + device."""
    import cv2

    avatar_path = os.path.join(data_dir, "avatars", avatar_id)
    with open(os.path.join(avatar_path, "coords.pkl"), "rb") as f:
        coord_list_cycle = pickle.load(f)

    def _sorted_imgs(sub: str):
        paths = glob.glob(os.path.join(avatar_path, sub, "*.[jpJP][pnPN]*[gG]"))
        return sorted(paths, key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))

    frame_list_cycle = read_imgs(_sorted_imgs("full_imgs"))
    faces = np.stack(
        [cv2.resize(f, (IMG_SIZE, IMG_SIZE)) if f.shape[:2] != (IMG_SIZE, IMG_SIZE) else f
         for f in read_imgs(_sorted_imgs("face_imgs"))]
    )
    return avatar_from_arrays(avatar_id, frame_list_cycle, faces, coord_list_cycle, device)


def warm_up(batch_size: int, model: Dict[str, Any], modelres: int = IMG_SIZE) -> None:
    """Run the step once on zeros (a graph smoke test; the first call of
    a shape also sets up cuDNN)."""
    logger.info("warmup wav2lip model...")
    dev = model["device"]
    step = w2l.make_infer_fn(batch_size, modelres, model["dtype"])
    cycle = torch.zeros((1, modelres, modelres, 3), dtype=torch.uint8, device=dev)
    idxs = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    mel = torch.zeros((batch_size, 80, 16), device=dev)
    step(model["net"], cycle, idxs, mel)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@register("avatar", "wav2lip")
class LipReal(BaseAvatar):
    def __init__(self, opt, model: Dict[str, Any], avatar: Dict[str, Any]):
        super().__init__(opt)
        self.model = model
        self.frame_list_cycle = avatar["frame_list_cycle"]
        self.coord_list_cycle = avatar["coord_list_cycle"]
        self.face_cycle_device = avatar["face_cycle_device"]
        self._n_faces = int(self.face_cycle_device.shape[0])

        self._scheduler = None
        self._store_offset = 0
        self._scheduler_composes = False
        use_paste = bool(getattr(opt, "device_paste_back", False))
        if getattr(opt, "coalesce", False):
            paste_spec = None
            if use_paste:
                fh, fw = self.frame_list_cycle[0].shape[:2]
                ho, wo = bucket_shape(self.coord_list_cycle)  # (y1,y2,x1,x2)
                paste_spec = {"S": IMG_SIZE, "H": fh, "W": fw, "Ho": ho, "Wo": wo}
            store, self._scheduler = get_shared_scheduler(
                model, self.batch_size, buckets=parse_buckets(opt),
                coalesce_window_s=resolve_coalesce_window(opt, self.batch_size),
                paste_spec=paste_spec)
            aux = None
            if use_paste:
                # validate against the SHARED bucket/frame geometry fixed
                # by the first session BEFORE store.add (no remove API)
                geom = _shared["paste_geom"]
                fh, fw = self.frame_list_cycle[0].shape[:2]
                if (fh, fw) != (geom["H"], geom["W"]):
                    raise SchedulerConfigError(
                        f"coalesce+device_paste_back: avatar frame "
                        f"{fw}x{fh} != shared {geom['W']}x{geom['H']}")
                for i, (y1, y2, x1, x2) in enumerate(self.coord_list_cycle):
                    if y2 - y1 > geom["Ho"] or x2 - x1 > geom["Wo"]:
                        raise SchedulerConfigError(
                            f"coalesce+device_paste_back: face box "
                            f"{x2 - x1}x{y2 - y1} (frame {i}) exceeds the "
                            f"shared bucket {geom['Wo']}x{geom['Ho']}")
                aux = {
                    "pb_frames": np.stack(self.frame_list_cycle).astype(np.uint8),
                    "pb_boxes": np.asarray(self.coord_list_cycle, np.int32),
                }
                self._scheduler_composes = True
            self._store_offset, _ = store.add(
                avatar["avatar_id"], avatar["face_cycle_host"], aux=aux)
        else:
            self._step = w2l.make_infer_fn(self.batch_size, IMG_SIZE, model["dtype"])

        # on-device composite without the scheduler: resize+blend+paste
        # on the device so only finished full frames cross to the host
        self._device_paste = None
        if use_paste and self._scheduler is None:
            dp = DevicePasteBack(np.stack(self.frame_list_cycle), self.coord_list_cycle,
                                 IMG_SIZE, device=model["device"])
            if not dp.available:
                fh, fw = self.frame_list_cycle[0].shape[:2]
                raise SchedulerConfigError(
                    f"device_paste_back: bbox bucket {dp.Wo}x{dp.Ho} exceeds the "
                    f"{fw}x{fh} frame")
            self._device_paste = dp

        self.asr = MelFeatures(opt, self)
        self.asr.warm_up()

        # run every bucket's step once in the background now that this
        # avatar's cycle (and paste aux) is registered; (80, 16) is the
        # per-frame mel window shape the scheduler step takes
        if (self._scheduler is not None
                and int(getattr(opt, "scheduler_prewarm", 1))):
            self._scheduler.prewarm_async((80, 16))

    def submit_batch(self, index: int, audiofeat_batch):
        """Pipelined submission into the shared scheduler; synchronous
        ``inference_batch`` when not coalesced."""
        if self._scheduler is None:
            return self.inference_batch(index, audiofeat_batch)
        idxs = mirror_indices(self._n_faces, index, self.batch_size)
        return self._scheduler.submit(idxs + self._store_offset, audiofeat_batch)

    def resolve_batch(self, handle) -> np.ndarray:
        if isinstance(handle, np.ndarray):
            return handle
        return self._scheduler.wait(handle)

    def inference_batch(self, index: int, audiofeat_batch) -> np.ndarray:
        idxs = mirror_indices(self._n_faces, index, self.batch_size)
        if self._scheduler is not None:
            return self._scheduler.infer(idxs + self._store_offset, audiofeat_batch)
        dev = self.face_cycle_device.device
        pred = self._step(self.model["net"], self.face_cycle_device,
                          torch.from_numpy(idxs).to(dev), audiofeat_batch)
        if self._device_paste is not None:
            # the crop stays on the device through resize/blend/paste;
            # this device->host copy is finished (B, H, W, 3) frames
            return self._device_paste.paste_batch(pred, idxs)
        return pred.cpu().numpy()  # (B, 256, 256, 3) uint8

    def paste_back_frame(self, pred_frame: np.ndarray, idx: int) -> np.ndarray:
        if self._device_paste is not None or self._scheduler_composes:
            return pred_frame  # already a full frame
        import cv2

        y1, y2, x1, x2 = self.coord_list_cycle[idx]
        frame = self.frame_list_cycle[idx].copy()
        frame[y1:y2, x1:x2] = cv2.resize(pred_frame, (x2 - x1, y2 - y1))
        return frame
