"""Ultralight avatar plugin, model family "ultralight" (ports
livetalking_tpu/avatars/ultralight_avatar.py).

The shared model is the HuBERT audio front-end only; the U-Net weights are
per avatar (``data/avatars/<id>/ultralight.pth``). The avatar directory is
the reference's: ``{full_imgs/, face_imgs/ (168 px crops), coords.pkl
(x1, y1, x2, y2)}``; note the coordinate order differs from Wav2Lip's.
``avatar_from_arrays`` builds the same avatar from arrays in memory.

A step takes the 160 px interior of each crop through the U-Net
(models/ultralight.py). The paste-back writes the prediction into the 168
px crop and resizes that into the box. Under ``--coalesce`` every session
shares one ``BatchScheduler``: the registered avatars' weight trees are
stacked on a slot axis, the store's ``ul_slot`` plane maps every global
frame index to its avatar's slot, and one grouped forward runs all
sessions of a super-batch. With ``--device_paste_back`` the super-batch
step also runs the paste (kernel 1, ``csrc/blend.cu`` at S = 168), so
sessions receive finished full frames. Without ``--coalesce`` a session
runs its own step and pastes on the host.
"""

from __future__ import annotations

import glob
import os
import pickle
import threading
from typing import Any, Dict, Sequence

import numpy as np
import torch

from livetalking_tpu_torch.audio_features.hubert_features import HubertFeatures
from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar
from livetalking_tpu_torch.engine.scheduler import (
    AvatarStore,
    BatchScheduler,
    SchedulerConfigError,
    parse_buckets,
    resolve_coalesce_window,
)
from livetalking_tpu_torch.models import hubert as hub
from livetalking_tpu_torch.models import ultralight as ul
from livetalking_tpu_torch.ops.blend import bucket_shape, make_resize_paste_fn
from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.image import mirror_indices, read_imgs
from livetalking_tpu_torch.utils.logger import logger

CROP_SIZE = ul.CROP
S = ul.IMG_SIZE

# small config for tests and hosts without the pretrained HuBERT weights
TINY_HUBERT = hub.HubertConfig(
    conv_dim=(64, 64, 64, 64, 64, 64, 64),
    conv_kernel=(10, 3, 3, 3, 3, 2, 2),
    conv_stride=(5, 2, 2, 2, 2, 2, 2),
    hidden_size=1024,  # must stay 1024: features reshape to 32x32 planes
    num_layers=2, num_heads=4, intermediate_size=256,
)

# shared cross-session state (one scheduler per process), created lazily
# when --coalesce sessions appear: "stacked" holds every registered
# avatar's weights on a leading slot axis, "slots" maps avatar id -> slot
_shared_lock = threading.Lock()
_shared: dict = {"store": None, "scheduler": None, "stacked": None, "slots": {}}


def make_step_factory(dtype: torch.dtype, store: AvatarStore, batch_size: int,
                      paste_spec: Dict[str, int] = None):
    """``step_factory(n * batch_size)`` for the shared scheduler: the
    grouped U-Net step over the stacked weights for n session blocks,
    followed, when ``paste_spec`` ({"H","W","Ho","Wo"}) is given, by the
    paste of each prediction, written into its gathered 168 px crop, over
    the store's ``pb_frames``/``pb_boxes`` planes: one launch of kernel 1."""
    paste_fn = None
    if paste_spec is not None:
        paste_fn = make_resize_paste_fn(CROP_SIZE, paste_spec["Ho"], paste_spec["Wo"],
                                        paste_spec["H"], paste_spec["W"])

    def step_factory(total):
        n = total // batch_size
        grouped = ul.make_grouped_infer_fn(n, batch_size, dtype)

        @torch.inference_mode()
        def step(_model, buffer, idxs, audio):
            # One read of each, no lock: register_session_avatar swaps in a
            # new stacked tree (append_stacked copies, never edits) BEFORE
            # store.add swaps in the planes that make its avatar's indices
            # visible. A step that runs while a session registers reads
            # either tree whole, and every index it was given belongs to an
            # avatar registered before, whose slot both trees hold.
            stacked = _shared["stacked"]
            aux = store.aux
            slots = aux["ul_slot"].index_select(0, idxs)[::batch_size]
            pred = grouped(stacked, buffer, idxs, slots, audio)
            if paste_fn is None:
                return pred
            crops = buffer.index_select(0, idxs)
            crops[:, 4:4 + S, 4:4 + S] = pred
            return paste_fn(crops, aux["pb_frames"], idxs, aux["pb_boxes"])
        return step

    return step_factory


def get_shared_scheduler(model: Dict[str, Any], batch_size: int, buckets=(1, 2, 4, 8),
                         coalesce_window_s: float = 0.0,
                         paste_spec: Dict[str, int] = None) -> tuple:
    """Lazily create the process-wide (AvatarStore, BatchScheduler) pair.

    ``paste_spec`` ({"H","W","Ho","Wo"}: frame size and paste bucket)
    composes the device paste into the super-batch step. A later session
    must agree on the batch size, buckets, window, the model dtype and the
    paste geometry, bucket included, or is rejected."""
    with _shared_lock:
        cfg = {"batch_size": batch_size, "buckets": tuple(buckets),
               "coalesce_window_s": float(coalesce_window_s), "dtype": str(model["dtype"]),
               "paste": (None if paste_spec is None else
                         tuple(paste_spec[k] for k in ("H", "W", "Ho", "Wo")))}
        if _shared["scheduler"] is None:
            store = AvatarStore(item_shape=(CROP_SIZE, CROP_SIZE, 3), dtype=np.uint8,
                                device=model["device"])
            sched = BatchScheduler(None, store,
                                   make_step_factory(model["dtype"], store, batch_size,
                                                     paste_spec),
                                   batch_size, buckets=buckets,
                                   coalesce_window_s=coalesce_window_s)
            sched.start()
            _shared["store"] = store
            _shared["scheduler"] = sched
            _shared["config"] = cfg
        elif _shared.get("config") != cfg:
            raise SchedulerConfigError(
                f"coalesce: shared ultralight scheduler already running with "
                f"{_shared.get('config')}; conflicting session config {cfg} rejected")
        return _shared["store"], _shared["scheduler"]


def register_session_avatar(avatar: Dict[str, Any],
                            aux_extra: Dict[str, np.ndarray] = None) -> tuple:
    """Register one avatar's crops and U-Net weights (``avatar["unet_params"]``,
    already in the scheduler's dtype and on its device) with the shared
    store: the weights go into a new stacked tree first, then the crops
    with their ``ul_slot`` plane, so no index a step can see lacks a slot.
    Returns (store_offset, slot)."""
    aid = avatar["avatar_id"]
    with _shared_lock:
        store = _shared["store"]
        if aid in _shared["slots"]:
            return store.lookup(aid)[0], _shared["slots"][aid]
        slot = len(_shared["slots"])
        tree = avatar["unet_params"]
        _shared["stacked"] = (ul.stack_params([tree]) if _shared["stacked"] is None
                              else ul.append_stacked(_shared["stacked"], tree))
        _shared["slots"][aid] = slot
        crops = avatar["crop_cycle_host"]
        aux = {"ul_slot": np.full((crops.shape[0],), slot, np.int32)}
        aux.update(aux_extra or {})
        offset, _ = store.add(aid, crops, aux=aux)
    return offset, slot


def reset_shared_scheduler() -> None:
    """Stop and drop the process-wide scheduler (tests / reconfiguration)."""
    with _shared_lock:
        if _shared["scheduler"] is not None:
            _shared["scheduler"].stop()
        _shared.update(store=None, scheduler=None, stacked=None, slots={})
        _shared.pop("config", None)


def load_model(opt) -> Dict[str, Any]:
    """Load the shared HuBERT front-end onto ``opt.device``; the U-Net is
    per avatar (``load_avatar``).

    ``--models_dir``/hubert-large-ls960-ft must hold the HF checkpoint's
    ``pytorch_model.bin`` (read with ``torch.load(weights_only=True)``);
    without that directory HuBERT-large is random from seed 0
    (``hubert_size="tiny"`` on the opt object picks ``TINY_HUBERT``)."""
    device = resolve_device(getattr(opt, "device", "cuda"))
    dtype = torch.bfloat16 if getattr(opt, "dtype", "bfloat16") == "bfloat16" else torch.float32
    hdir = os.path.join(getattr(opt, "models_dir", "./models"), "hubert-large-ls960-ft")
    if os.path.isdir(hdir):
        path = os.path.join(hdir, "pytorch_model.bin")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path}: the HuBERT directory {hdir} has no "
                                    "pytorch_model.bin")
        logger.info("loading HuBERT weights from %s", path)
        cfg = hub.LARGE
        params = hub.convert_torch_state_dict(
            torch.load(path, map_location="cpu", weights_only=True), cfg, dtype, device)
    else:
        size = getattr(opt, "hubert_size", "large")
        cfg = TINY_HUBERT if size == "tiny" else hub.LARGE
        logger.warning("HuBERT weights not found at %s - random init (%s)", hdir, size)
        params = hub.init_params(0, cfg, dtype, device)
    return {"hubert_params": params, "hubert_cfg": cfg, "dtype": dtype, "device": device}


def avatar_from_arrays(avatar_id: str, frames: Sequence[np.ndarray], crops: np.ndarray,
                       coords: Sequence[tuple], unet_params=None, device="cuda") -> Dict[str, Any]:
    """An avatar from arrays in memory: full frames (H, W, 3) uint8 BGR, face
    crops (N, 168, 168, 3) uint8, boxes (x1, y1, x2, y2), and the U-Net
    tree (default random from seed 1), moved to ``device`` in f32."""
    crops = np.ascontiguousarray(crops, np.uint8)
    if crops.shape[1:] != (CROP_SIZE, CROP_SIZE, 3) or not len(frames) == len(coords) == len(crops):
        raise ValueError(f"avatar {avatar_id}: {len(frames)} frames, {len(coords)} boxes, "
                         f"crops {crops.shape}; want one (168, 168, 3) crop per frame")
    dev = resolve_device(device)
    if unet_params is None:
        unet_params = ul.init_params(1, torch.float32, dev)
    return {
        "avatar_id": avatar_id,
        "frame_list_cycle": list(frames),
        "coord_list_cycle": [tuple(int(v) for v in c) for c in coords],
        "crop_cycle_host": crops,
        "unet_params": ul.cast_params(unet_params, torch.float32, dev),
    }


def load_avatar(avatar_id: str, data_dir: str = "./data", device="cuda") -> Dict[str, Any]:
    """Load a reference-format Ultralight avatar directory; its
    ``ultralight.pth`` through the converter, random weights from seed 1
    when the file is missing."""
    import cv2

    dev = resolve_device(device)
    avatar_path = os.path.join(data_dir, "avatars", avatar_id)
    with open(os.path.join(avatar_path, "coords.pkl"), "rb") as f:
        coords = pickle.load(f)

    def _sorted_imgs(sub: str):
        paths = glob.glob(os.path.join(avatar_path, sub, "*.[jpJP][pnPN]*[gG]"))
        return sorted(paths, key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))

    crops = np.stack([
        cv2.resize(f, (CROP_SIZE, CROP_SIZE)) if f.shape[:2] != (CROP_SIZE, CROP_SIZE) else f
        for f in read_imgs(_sorted_imgs("face_imgs"))])
    unet_path = os.path.join(avatar_path, "ultralight.pth")
    unet = None
    if os.path.exists(unet_path):
        logger.info("loading ultralight U-Net from %s", unet_path)
        unet = ul.load_torch_checkpoint(unet_path, torch.float32, dev)
    else:
        logger.warning("%s not found - random U-Net init", unet_path)
    return avatar_from_arrays(avatar_id, read_imgs(_sorted_imgs("full_imgs")), crops, coords,
                              unet, dev)


def warm_up(batch_size: int, model: Dict[str, Any], modelres: int = S) -> None:
    """Run the U-Net step once on zeros with random weights (a graph smoke
    test; the first call of a shape also sets up cuDNN)."""
    logger.info("warmup ultralight model...")
    dev = model["device"]
    step = ul.make_infer_fn(batch_size, model["dtype"])
    params = ul.init_params(0, model["dtype"], dev)
    cycle = torch.zeros((1, CROP_SIZE, CROP_SIZE, 3), dtype=torch.uint8, device=dev)
    idxs = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    audio = torch.zeros((batch_size, 16, 32, 32), device=dev)
    step(params, cycle, idxs, audio)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@register("avatar", "ultralight")
class LightReal(BaseAvatar):
    def __init__(self, opt, model: Dict[str, Any], avatar: Dict[str, Any]):
        super().__init__(opt)
        self.model = model
        self.frame_list_cycle = avatar["frame_list_cycle"]
        self.coord_list_cycle = avatar["coord_list_cycle"]  # (x1, y1, x2, y2)
        self._crops_host = avatar["crop_cycle_host"]
        self._n_faces = int(self._crops_host.shape[0])
        dev = model["device"]
        self.unet_params = ul.cast_params(avatar["unet_params"], model["dtype"], dev)

        self._scheduler = None
        self._store_offset = 0
        self._scheduler_composes = False
        if getattr(opt, "coalesce", False):
            # no device copy of the crops of its own: they live in the store
            fh, fw = self.frame_list_cycle[0].shape[:2]
            boxes = np.asarray([(y1, y2, x1, x2) for (x1, y1, x2, y2) in self.coord_list_cycle],
                               np.int32)  # the paste's (y1, y2, x1, x2)
            paste_spec = None
            if getattr(opt, "device_paste_back", False):
                ho, wo = bucket_shape(boxes.tolist())
                if ho > fh or wo > fw:
                    raise SchedulerConfigError(
                        f"coalesce+device_paste_back: bbox bucket {wo}x{ho} exceeds the "
                        f"{fw}x{fh} frame")
                paste_spec = {"H": fh, "W": fw, "Ho": ho, "Wo": wo}
            store, self._scheduler = get_shared_scheduler(
                model, self.batch_size, buckets=parse_buckets(opt),
                coalesce_window_s=resolve_coalesce_window(opt, self.batch_size),
                paste_spec=paste_spec)
            aux_extra = None
            if paste_spec is not None:
                aux_extra = {"pb_frames": np.stack(self.frame_list_cycle).astype(np.uint8),
                             "pb_boxes": boxes}
                self._scheduler_composes = True
            reg = {"avatar_id": avatar["avatar_id"], "crop_cycle_host": self._crops_host,
                   "unet_params": self.unet_params}
            self._store_offset, self._slot = register_session_avatar(reg, aux_extra)
        else:
            self._step = ul.make_infer_fn(self.batch_size, model["dtype"])
            self._crops_dev = torch.from_numpy(self._crops_host).to(dev)

        self.asr = HubertFeatures(opt, self, hubert_params=model["hubert_params"],
                                  hubert_cfg=model["hubert_cfg"], audio_feat_length=(4, 4))
        self.asr.warm_up()

        # run every bucket's step once in the background now that this
        # avatar's crops, weights and paste planes are registered; (16, 32,
        # 32) is one frame's HuBERT feature image
        if self._scheduler is not None and int(getattr(opt, "scheduler_prewarm", 1)):
            self._scheduler.prewarm_async((16, 32, 32))

    def submit_batch(self, index: int, audiofeat_batch, rid=None):
        """Pipelined submission into the shared scheduler; synchronous
        ``inference_batch`` when not coalesced."""
        if self._scheduler is None:
            return self.inference_batch(index, audiofeat_batch)
        idxs = mirror_indices(self._n_faces, index, self.batch_size)
        return self._scheduler.submit(idxs + self._store_offset, audiofeat_batch, rid)

    def resolve_batch(self, handle) -> np.ndarray:
        if isinstance(handle, np.ndarray):
            return handle
        return self._scheduler.wait(handle)

    def inference_batch(self, index: int, audiofeat_batch) -> np.ndarray:
        idxs = mirror_indices(self._n_faces, index, self.batch_size)
        if self._scheduler is not None:
            return self._scheduler.infer(idxs + self._store_offset, audiofeat_batch)
        dev = self._crops_dev.device
        pred = self._step(self.unet_params, self._crops_dev, torch.from_numpy(idxs).to(dev),
                          audiofeat_batch)
        return pred.cpu().numpy()  # (B, 160, 160, 3) uint8

    def paste_back_frame(self, pred_frame: np.ndarray, idx: int) -> np.ndarray:
        if self._scheduler_composes:
            return pred_frame  # already a full frame
        import cv2

        x1, y1, x2, y2 = self.coord_list_cycle[idx]
        frame = self.frame_list_cycle[idx].copy()
        crop = self._crops_host[idx].copy()
        crop[4:4 + S, 4:4 + S] = pred_frame
        frame[y1:y2, x1:x2] = cv2.resize(crop, (x2 - x1, y2 - y1))
        return frame
