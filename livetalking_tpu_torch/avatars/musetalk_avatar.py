"""MuseTalk avatar plugin, model family "musetalk" (ports
livetalking_tpu/avatars/musetalk_avatar.py).

Exports ``load_model`` / ``load_avatar`` / ``warm_up`` plus a
``BaseAvatar`` subclass registered as ``avatar/musetalk``. The avatar
directory format is the reference's: ``{full_imgs/, coords.pkl
(x1, y1, x2, y2), latents.pt, mask/, mask_coords.pkl (xs, ys, xe, ye)}``;
``latents.pt`` holds per-frame (1, 8, 32, 32) U-Net input latents =
cat(masked-half latents, reference latents). ``avatar_from_arrays`` builds
the same avatar from arrays in memory, encoding the faces with the port's
VAE.

A step is Whisper features -> PE -> one U-Net step at t=0 -> VAE decode ->
uint8 BGR face (models/musetalk.py), on the device. Under ``--coalesce``
every session shares one ``BatchScheduler`` and one Whisper
``FeatureCoalescer``; with ``--device_paste_back`` the super-batch step also
runs the masked paste-back (ops/blend.py), so sessions receive finished
full frames.

``--vae_int8`` / ``--unet_int8`` run the W8A8 decoder / U-Net
(``--vae_mid_int8``, ``--attn_int8`` widen them). The first session
quantizes the shared weights once and calibrates static activation scales
on its avatar's latents (``session_params``); a later session asking for
other int8 flags is rejected, never served the first session's trees.
"""

from __future__ import annotations

import glob
import os
import pickle
import threading
from typing import Any, Dict, Sequence

import numpy as np
import torch

from livetalking_tpu_torch.audio_features.whisper_features import (
    WhisperFeatures,
    make_batched_encode_factory,
)
from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar
from livetalking_tpu_torch.engine.feature_coalescer import FeatureCoalescer
from livetalking_tpu_torch.engine.scheduler import (
    AvatarStore,
    BatchScheduler,
    SchedulerConfigError,
    parse_buckets,
    resolve_coalesce_window,
)
from livetalking_tpu_torch.models import musetalk as mt
from livetalking_tpu_torch.models import sd_unet, sd_vae
from livetalking_tpu_torch.models import whisper_encoder as we
from livetalking_tpu_torch.ops.blend import (
    MaskedDevicePasteBack,
    bucket_shape,
    make_masked_paste_fn,
    prepare_masked_paste_data,
)
from livetalking_tpu_torch.ops.whisper_mel import log_mel_spectrogram
from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.image import mirror_indices, read_imgs
from livetalking_tpu_torch.utils.logger import logger

FACE = 256
LATENT_SHAPE = (32, 32, 8)
TINY_UNET = sd_unet.UNetConfig(block_out=(32, 64, 96, 96), heads=4)

# shared cross-session state (one scheduler and one feature coalescer per
# process), created lazily when --coalesce sessions appear
_shared_lock = threading.Lock()
_shared: dict = {"store": None, "scheduler": None}


def make_step_factory(unet_cfg, dtype: torch.dtype, store: AvatarStore,
                      paste_spec: Dict[str, int] = None, vae_int8: bool = False,
                      unet_int8: bool = False, mesh=None):
    """``step_factory(n)`` for the shared scheduler: the MuseTalk step for a
    super-batch of n (int8 decoder / U-Net per the flags), followed, when
    ``paste_spec`` ({"S","H","W","Ho","Wo"}) is given, by the masked
    paste-back over the store's ``pb_*`` planes, so the step returns
    finished full frames.

    With a ``mesh`` the step is ``make_sharded_infer_fn`` on every rank
    (parameters from ``parallel.mesh.shard_params``; no int8 route) and
    the paste runs on rank 0 alone, on the gathered faces: 256 px faces
    move about 5x fewer bytes than 480x640 frames would."""
    if mesh is not None and (vae_int8 or unet_int8):
        raise ValueError("the sharded MuseTalk step has no int8 route")
    paste_fn = None
    if paste_spec is not None and (mesh is None or mesh.rank == 0):
        paste_fn = make_masked_paste_fn(paste_spec["S"], paste_spec["Ho"], paste_spec["Wo"],
                                        paste_spec["H"], paste_spec["W"])

    def step_factory(n):
        if mesh is not None:
            step = mt.make_sharded_infer_fn(unet_cfg, n, mesh, dtype=dtype)
        else:
            step = mt.make_infer_fn(unet_cfg, n, dtype=dtype, vae_int8=vae_int8,
                                    unet_int8=unet_int8)

        @torch.inference_mode()
        def step_and_paste(params, buffer, idxs, whisper):
            pred = step(params[0], params[1], buffer, idxs, whisper)
            if paste_fn is None:
                return pred
            aux = store.aux  # re-read: grows as avatars register
            return paste_fn(pred, aux["pb_frames"], idxs, aux["pb_origins"],
                            aux["pb_scalars"], aux["pb_masks"])
        return step_and_paste

    return step_factory


def get_shared_scheduler(model: Dict[str, Any], batch_size: int, buckets=(1, 2, 4, 8),
                         coalesce_window_s: float = 0.0,
                         paste_spec: Dict[str, int] = None, params: tuple = None,
                         vae_int8: bool = False, unet_int8: bool = False) -> tuple:
    """Lazily create the process-wide (AvatarStore, BatchScheduler) pair.

    ``params`` is the (U-Net, VAE) pair the step runs (default the model's
    full-precision trees; the int8 flags need the quantized ones).
    ``paste_spec`` (from the FIRST session's avatar geometry) composes the
    masked paste-back into the super-batch step. Later sessions must agree
    on the frame size, the int8 flags and fit the shared crop bucket."""
    with _shared_lock:
        cfg = {"batch_size": batch_size, "vae_int8": bool(vae_int8),
               "unet_int8": bool(unet_int8), "buckets": tuple(buckets),
               "coalesce_window_s": float(coalesce_window_s),
               "paste": (None if paste_spec is None
                         else (paste_spec["H"], paste_spec["W"]))}
        if _shared["scheduler"] is None:
            store = AvatarStore(item_shape=LATENT_SHAPE, dtype=np.float32, device=model["device"])
            if paste_spec is not None:
                _shared["paste_geom"] = dict(paste_spec)
            sched = BatchScheduler(
                params or (model["unet_params"], model["vae_params"]), store,
                make_step_factory(model["unet_cfg"], model["dtype"], store, paste_spec,
                                  vae_int8=vae_int8, unet_int8=unet_int8),
                batch_size, buckets=buckets, coalesce_window_s=coalesce_window_s)
            sched.start()
            _shared["store"] = store
            _shared["scheduler"] = sched
            _shared["config"] = cfg
        elif _shared.get("config") != cfg:
            raise SchedulerConfigError(
                f"coalesce: shared scheduler already running with "
                f"{_shared.get('config')}; conflicting session config {cfg} "
                "rejected (per-session scheduler overrides are not allowed "
                "under --coalesce)")
        return _shared["store"], _shared["scheduler"]


def get_shared_feature_coalescer(model: Dict[str, Any], opt) -> FeatureCoalescer:
    """Process-wide cross-session Whisper encoder: one batched encode per
    tick for every speaking session, so their scheduler submissions land
    together and super-batches stay full."""
    with _shared_lock:
        cfg = {"batch_size": opt.batch_size, "l": opt.l, "r": opt.r,
               "fps": int(getattr(opt, "fps", 25)),
               "whisper_short_window": bool(getattr(opt, "whisper_short_window", False)),
               "buckets": parse_buckets(opt),
               # opt-in only: a feature-side hold serializes into the
               # request's critical path
               "coalesce_window_s": max(0.0, float(getattr(
                   opt, "feature_window_ms", 0.0) or 0.0) / 1000.0)}
        if _shared.get("feat_coalescer") is None:
            factory, n_samples = make_batched_encode_factory(
                model["whisper_params"], model["whisper_cfg"], batch_size=cfg["batch_size"],
                l=cfg["l"], r=cfg["r"], short_window=cfg["whisper_short_window"],
                fps=cfg["fps"], device=model["device"])
            fc = FeatureCoalescer(factory, n_samples, buckets=cfg["buckets"],
                                  coalesce_window_s=cfg["coalesce_window_s"])
            fc.start()
            fc.prewarm()  # every bucket's first call in the background
            _shared["feat_coalescer"] = fc
            _shared["feat_config"] = cfg
        elif _shared.get("feat_config") != cfg:
            raise SchedulerConfigError(
                f"coalesce: shared feature coalescer already running with "
                f"{_shared.get('feat_config')}; conflicting session config "
                f"{cfg} rejected")
        return _shared["feat_coalescer"]


def reset_shared_scheduler() -> None:
    """Stop and drop the process-wide scheduler and feature coalescer."""
    with _shared_lock:
        if _shared["scheduler"] is not None:
            _shared["scheduler"].stop()
        _shared["scheduler"] = None
        _shared["store"] = None
        if _shared.get("feat_coalescer") is not None:
            _shared["feat_coalescer"].stop()
        _shared["feat_coalescer"] = None
        for key in ("config", "feat_config", "paste_geom"):
            _shared.pop(key, None)


def _load_state_dict(dirpath: str, names: Sequence[str]):
    """The first of ``names`` under ``dirpath`` as a state dict (``.bin``
    with torch.load, ``.safetensors`` with safetensors), else None."""
    for name in names:
        path = os.path.join(dirpath, name)
        if not os.path.exists(path):
            continue
        if name.endswith(".safetensors"):
            from safetensors.torch import load_file

            return load_file(path)
        return torch.load(path, map_location="cpu", weights_only=False)
    return None


def load_model(opt) -> Dict[str, Any]:
    """Load the Whisper-tiny encoder, the VAE and the latent U-Net from
    ``--models_dir`` onto ``opt.device``.

    Missing checkpoints fall back to random weights from fixed seeds
    (Whisper 0, VAE 1, U-Net 2), as the reference does: same graph, same
    speed, untrained output. ``musetalk_size="tiny"`` picks a narrow U-Net
    for tests."""
    device = resolve_device(getattr(opt, "device", "cuda"))
    dtype = torch.bfloat16 if getattr(opt, "dtype", "bfloat16") == "bfloat16" else torch.float32
    models_dir = getattr(opt, "models_dir", "./models")

    wdir = os.path.join(models_dir, "whisper")
    sd = _load_state_dict(wdir, ("model.safetensors", "pytorch_model.bin"))
    if sd is not None:
        logger.info("loading whisper weights from %s", wdir)
        whisper_params = we.convert_torch_state_dict(sd, we.TINY, dtype, device)
    else:
        logger.warning("whisper weights not found at %s - random init", wdir)
        whisper_params = we.init_params(0, we.TINY, dtype, device)

    vdir = os.path.join(models_dir, "sd-vae-ft-mse")
    sd = _load_state_dict(vdir, ("diffusion_pytorch_model.bin",
                                 "diffusion_pytorch_model.safetensors"))
    if sd is not None:
        logger.info("loading VAE weights from %s", vdir)
        vae_params = sd_vae.convert_torch_state_dict(sd, dtype, device)
    else:
        logger.warning("VAE weights not found at %s - random init", vdir)
        vae_params = sd_vae.init_params(1, dtype, device)

    upath = os.path.join(models_dir, "musetalkV15", "unet.pth")
    if os.path.exists(upath):
        logger.info("loading musetalk unet from %s", upath)
        sd = torch.load(upath, map_location="cpu", weights_only=False)
        sd = sd.get("state_dict", sd)
        unet_cfg = sd_unet.MUSETALK
        unet_params = sd_unet.convert_torch_state_dict(sd, unet_cfg, dtype, device)
    else:
        size = getattr(opt, "musetalk_size", "full")
        unet_cfg = TINY_UNET if size == "tiny" else sd_unet.MUSETALK
        logger.warning("musetalk unet not found at %s - random init (%s)", upath, size)
        unet_params = sd_unet.init_params(2, unet_cfg, dtype, device)

    return {"whisper_params": whisper_params, "whisper_cfg": we.TINY,
            "vae_params": vae_params, "unet_params": unet_params, "unet_cfg": unet_cfg,
            "dtype": dtype, "device": device}


def avatar_from_arrays(avatar_id: str, frames: Sequence[np.ndarray], faces: np.ndarray,
                       coords: Sequence[tuple], mask_coords: Sequence[tuple],
                       masks: Sequence[np.ndarray], vae_params,
                       device="cuda") -> Dict[str, Any]:
    """An avatar from in-memory arrays: full frames (H, W, 3) uint8 BGR,
    face crops (N, 256, 256, 3) uint8 BGR, face boxes (x1, y1, x2, y2),
    crop boxes (xs, ys, xe, ye) and crop-sized masks. The faces are
    encoded to U-Net input latents by ``vae_params`` on ``device``."""
    faces = np.ascontiguousarray(faces, np.uint8)
    n = len(frames)
    if faces.shape[1:] != (FACE, FACE, 3) or not (
            n == len(faces) == len(coords) == len(mask_coords) == len(masks)):
        raise ValueError(f"avatar {avatar_id}: {n} frames, faces {faces.shape}, "
                         f"{len(coords)} boxes, {len(mask_coords)} crop boxes, "
                         f"{len(masks)} masks; want one of each per frame")
    dev = resolve_device(device)
    lat = mt.encode_avatar_latents(vae_params, faces, device=dev)
    return _avatar(avatar_id, list(frames), list(masks), coords, mask_coords, lat, dev)


def _avatar(avatar_id, frames, masks, coords, mask_coords, lat: np.ndarray, dev):
    return {
        "avatar_id": avatar_id,
        "frame_list_cycle": frames,
        "mask_list_cycle": masks,
        "coord_list_cycle": [tuple(int(v) for v in c) for c in coords],
        "mask_coords_list_cycle": [tuple(int(v) for v in c) for c in mask_coords],
        "latent_cycle_host": lat,  # for the shared AvatarStore (coalesce mode)
        "latent_cycle_device": torch.from_numpy(lat).to(dev),
    }


def load_avatar(avatar_id: str, data_dir: str = "./data", device="cuda") -> Dict[str, Any]:
    """Load a reference-format MuseTalk avatar directory."""
    avatar_path = os.path.join(data_dir, "avatars", avatar_id)
    latents = torch.load(os.path.join(avatar_path, "latents.pt"), map_location="cpu",
                         weights_only=False)
    # list of (1, 8, 32, 32) NCHW tensors -> (N, 32, 32, 8)
    lat = np.stack([t.detach().float().reshape(8, 32, 32).numpy() for t in latents])
    lat = np.ascontiguousarray(np.transpose(lat, (0, 2, 3, 1)), np.float32)
    with open(os.path.join(avatar_path, "coords.pkl"), "rb") as f:
        coords = pickle.load(f)
    with open(os.path.join(avatar_path, "mask_coords.pkl"), "rb") as f:
        mask_coords = pickle.load(f)

    def _sorted_imgs(sub: str):
        paths = glob.glob(os.path.join(avatar_path, sub, "*.[jpJP][pnPN]*[gG]"))
        return sorted(paths, key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))

    return _avatar(avatar_id, read_imgs(_sorted_imgs("full_imgs")),
                   read_imgs(_sorted_imgs("mask")), coords, mask_coords, lat,
                   resolve_device(device))


def _check_quant_flags(model: Dict[str, Any], key: str, wanted: Dict[str, bool]) -> None:
    """The quantized trees cached in the shared ``model`` were built with the
    FIRST session's flags; a later session asking for other flags is
    rejected instead of being served them. Trees installed without a flag
    record are accepted as they are."""
    recorded = model.get(key)
    if recorded is not None and recorded != wanted:
        raise SchedulerConfigError(
            f"quantized params cached with {recorded}; conflicting session config "
            f"{wanted} rejected (per-session int8 flag overrides are not allowed once "
            "quantization ran)")


def _with_dummy_scales(tree):
    """Every quantized conv site with a placeholder activation scale of 1,
    so a warm-up runs the static-scale graph the calibrated trees run.
    Linear sites (2-D ``wq``) keep their dynamic scales, as calibrated
    trees do."""
    if isinstance(tree, dict):
        out = {k: _with_dummy_scales(v) for k, v in tree.items()}
        if "wq" in out and out["wq"].dim() == 4:
            out["as"] = torch.tensor(1.0, device=out["wq"].device)
        return out
    if isinstance(tree, list):
        return [_with_dummy_scales(v) for v in tree]
    return tree


def _int8_flags(opt) -> tuple:
    """(vae_int8, unet_int8, vae_mid_int8, attn_int8) of ``opt``."""
    return (bool(getattr(opt, "vae_int8", False)), bool(getattr(opt, "unet_int8", False)),
            bool(getattr(opt, "vae_mid_int8", True)), bool(getattr(opt, "attn_int8", True)))


def _calibration_context(model: Dict[str, Any], nb: int) -> torch.Tensor:
    """(nb, 50, cross_dim) U-Net context with the encoder's statistics: 1 s
    of noise through the model's Whisper encoder, read in the runtime's
    window layout (10 positions x 5 layer states per 50-row window). The
    noise comes from ``numpy.random.default_rng(0)``: the reference draws
    it with jax.random, whose bits no other generator reproduces."""
    ucfg, wcfg, dev = model["unet_cfg"], model["whisper_cfg"], model["device"]
    rng = np.random.default_rng(0)
    if wcfg.d_model == ucfg.cross_dim:
        wav = torch.from_numpy((rng.standard_normal(16000) * 0.1).astype(np.float32)).to(dev)
        states = we.apply_stacked(model["whisper_params"], wcfg, log_mel_spectrogram(wav)[None])[0]
        ctx = states.reshape(-1, wcfg.d_model)[:nb * 50].reshape(nb, 50, wcfg.d_model)
    else:  # a custom config whose widths differ: a magnitude-only proxy
        ctx = torch.from_numpy(rng.standard_normal((nb, 50, ucfg.cross_dim)).astype(np.float32))
    pe = torch.from_numpy(mt.positional_encoding_table(50, ucfg.cross_dim))
    return (ctx.float().to(dev) + pe.to(dev)).to(model["dtype"])


@torch.inference_mode()
def session_params(model: Dict[str, Any], opt, latent_cycle: torch.Tensor) -> tuple:
    """(U-Net, VAE) trees a session's step runs under ``opt``'s int8 flags.

    The first session that asks for int8 quantizes the shared weights once
    and calibrates static scales: the decoder on the reference-face half
    of its first 4 latents (``[..., 4:]``, the decode-time distribution),
    the U-Net on its first min(4, N) latents and a context with the
    Whisper encoder's statistics. Later sessions reuse those trees, and
    are rejected when their flags differ."""
    vae_int8, unet_int8, mid_int8, attn_int8 = _int8_flags(opt)
    vae_params, unet_params = model["vae_params"], model["unet_params"]
    if vae_int8:
        if "vae_params_q" in model:
            _check_quant_flags(model, "vae_q_flags", {"vae_mid_int8": mid_int8})
        else:
            q = sd_vae.quantize_decoder(vae_params, mid_int8=mid_int8)
            model["vae_params_q"] = sd_vae.calibrate_decoder(vae_params, q,
                                                             latent_cycle[:4, :, :, 4:])
            model["vae_q_flags"] = {"vae_mid_int8": mid_int8}
            logger.info("musetalk: int8 VAE decoder calibrated")
        vae_params = model["vae_params_q"]
    if unet_int8:
        if "unet_params_q" in model:
            _check_quant_flags(model, "unet_q_flags", {"attn_int8": attn_int8})
        else:
            nb = min(4, latent_cycle.shape[0])
            q = sd_unet.quantize_unet(unet_params, attn_int8=attn_int8)
            t = torch.zeros((nb,), device=latent_cycle.device)
            model["unet_params_q"] = sd_unet.calibrate_unet(
                unet_params, q, model["unet_cfg"], latent_cycle[:nb].to(model["dtype"]), t,
                _calibration_context(model, nb))
            model["unet_q_flags"] = {"attn_int8": attn_int8}
            logger.info("musetalk: int8 U-Net calibrated")
        unet_params = model["unet_params_q"]
    return unet_params, vae_params


def warm_up(batch_size: int, model: Dict[str, Any], modelres: int = FACE, opt=None) -> None:
    """Run the step sessions will run once on zeros (a graph smoke test; the
    first call of a shape also sets up cuDNN): with int8 flags, on quantized
    trees with placeholder activation scales, the graph of the calibrated
    trees."""
    vae_int8, unet_int8, mid_int8, attn_int8 = _int8_flags(opt)
    logger.info("warmup musetalk model... (vae_int8=%s unet_int8=%s attn_int8=%s "
                "vae_mid_int8=%s)", vae_int8, unet_int8, attn_int8, mid_int8)
    dev = model["device"]
    step = mt.make_infer_fn(model["unet_cfg"], batch_size, dtype=model["dtype"],
                            vae_int8=vae_int8, unet_int8=unet_int8)
    up, vp = model["unet_params"], model["vae_params"]
    if unet_int8:
        up = _with_dummy_scales(sd_unet.quantize_unet(up, attn_int8=attn_int8))
    if vae_int8:
        vp = _with_dummy_scales(sd_vae.quantize_decoder(vp, mid_int8=mid_int8))
    cycle = torch.zeros((1,) + LATENT_SHAPE, device=dev)
    idxs = torch.zeros((batch_size,), dtype=torch.int32, device=dev)
    whisper = torch.zeros((batch_size, 50, model["unet_cfg"].cross_dim), device=dev)
    step(up, vp, cycle, idxs, whisper)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def blend_face(body: np.ndarray, face: np.ndarray, face_box, mask: np.ndarray,
               crop_box) -> np.ndarray:
    """Host blend of the predicted face into the full frame with the
    crop's mask as alpha (reference avatars/musetalk/myutil.py:4-26)."""
    x, y, x1, y1 = face_box
    xs, ys, xe, ye = crop_box
    face_large = body[ys:ye, xs:xe].copy()
    face_large[y - ys:y1 - ys, x - xs:x1 - xs] = face
    if mask.ndim == 3:
        import cv2

        mask = cv2.cvtColor(mask, cv2.COLOR_BGR2GRAY)
    m = (mask / 255.0).astype(np.float32)[..., None]
    region = body[ys:ye, xs:xe].astype(np.float32)
    body[ys:ye, xs:xe] = (face_large.astype(np.float32) * m + region * (1.0 - m)).astype(np.uint8)
    return body


@register("avatar", "musetalk")
class MuseReal(BaseAvatar):
    def __init__(self, opt, model: Dict[str, Any], avatar: Dict[str, Any]):
        super().__init__(opt)
        self.model = model
        self.frame_list_cycle = avatar["frame_list_cycle"]
        self.mask_list_cycle = avatar["mask_list_cycle"]
        self.coord_list_cycle = avatar["coord_list_cycle"]
        self.mask_coords_list_cycle = avatar["mask_coords_list_cycle"]
        self.latent_cycle_device = avatar["latent_cycle_device"]
        self._n_frames = int(self.latent_cycle_device.shape[0])
        vae_int8, unet_int8 = _int8_flags(opt)[:2]
        self._unet_params, self._vae_params = session_params(model, opt,
                                                             self.latent_cycle_device)

        self._scheduler = None
        self._store_offset = 0
        self._scheduler_composes = False
        feat_coalescer = None
        use_paste = bool(getattr(opt, "device_paste_back", False))
        fh, fw = self.frame_list_cycle[0].shape[:2]
        if getattr(opt, "coalesce", False):
            paste_spec = None
            if use_paste:
                ho, wo = bucket_shape([(ys, ye, xs, xe)
                                       for (xs, ys, xe, ye) in self.mask_coords_list_cycle])
                paste_spec = {"S": FACE, "H": fh, "W": fw, "Ho": ho, "Wo": wo}
            store, self._scheduler = get_shared_scheduler(
                model, self.batch_size, buckets=parse_buckets(opt),
                coalesce_window_s=resolve_coalesce_window(opt, self.batch_size),
                paste_spec=paste_spec, params=(self._unet_params, self._vae_params),
                vae_int8=vae_int8, unet_int8=unet_int8)
            # validate the feature-coalescer config BEFORE store.add: a
            # rejected session must not leak its cycle into the shared store
            feat_coalescer = get_shared_feature_coalescer(model, opt)
            aux = None
            if use_paste:
                # prepared against the SHARED bucket fixed by the first
                # session; a too-big crop raises before store.add
                geom = _shared["paste_geom"]
                if (fh, fw) != (geom["H"], geom["W"]):
                    raise SchedulerConfigError(
                        f"coalesce+device_paste_back: avatar frame {fw}x{fh} != shared "
                        f"{geom['W']}x{geom['H']}")
                try:
                    origins, scalars, masks = prepare_masked_paste_data(
                        self.coord_list_cycle, self.mask_coords_list_cycle,
                        self.mask_list_cycle, geom["Ho"], geom["Wo"], geom["H"], geom["W"])
                except ValueError as e:
                    raise SchedulerConfigError(f"coalesce+device_paste_back: {e}") from e
                aux = {"pb_frames": np.stack(self.frame_list_cycle).astype(np.uint8),
                       "pb_origins": origins, "pb_scalars": scalars, "pb_masks": masks}
                self._scheduler_composes = True
            self._store_offset, _ = store.add(avatar["avatar_id"], avatar["latent_cycle_host"],
                                              aux=aux)
        else:
            self._step = mt.make_infer_fn(model["unet_cfg"], self.batch_size,
                                          dtype=model["dtype"], vae_int8=vae_int8,
                                          unet_int8=unet_int8)

        # on-device composite with the per-frame masks without the
        # scheduler; under --coalesce the scheduler's step composes instead
        self._device_paste = None
        if use_paste and self._scheduler is None:
            dp = MaskedDevicePasteBack(np.stack(self.frame_list_cycle), self.coord_list_cycle,
                                       self.mask_coords_list_cycle, self.mask_list_cycle, FACE,
                                       device=model["device"])
            if not dp.available:
                raise SchedulerConfigError(
                    f"device_paste_back: crop bucket {dp.Wo}x{dp.Ho} exceeds the "
                    f"{fw}x{fh} frame")
            self._device_paste = dp

        self.asr = WhisperFeatures(opt, self, whisper_params=model["whisper_params"],
                                   whisper_cfg=model["whisper_cfg"], coalescer=feat_coalescer)
        self.asr.warm_up()

        # run every bucket's step once in the background now that this
        # avatar's cycle (and paste planes) are registered
        if self._scheduler is not None and int(getattr(opt, "scheduler_prewarm", 1)):
            self._scheduler.prewarm_async(tuple(self.asr._zero.shape[1:]))

    def submit_batch(self, index: int, audiofeat_batch, rid=None):
        """Pipelined submission into the shared scheduler; synchronous
        ``inference_batch`` when not coalesced."""
        if self._scheduler is None:
            return self.inference_batch(index, audiofeat_batch)
        idxs = mirror_indices(self._n_frames, index, self.batch_size)
        return self._scheduler.submit(idxs + self._store_offset, audiofeat_batch, rid)

    def resolve_batch(self, handle) -> np.ndarray:
        if isinstance(handle, np.ndarray):
            return handle
        return self._scheduler.wait(handle)

    def inference_batch(self, index: int, audiofeat_batch) -> np.ndarray:
        idxs = mirror_indices(self._n_frames, index, self.batch_size)
        if self._scheduler is not None:
            return self._scheduler.infer(idxs + self._store_offset, audiofeat_batch)
        dev = self.latent_cycle_device.device
        pred = self._step(self._unet_params, self._vae_params, self.latent_cycle_device,
                          torch.from_numpy(idxs).to(dev), audiofeat_batch)
        if self._device_paste is not None:
            return self._device_paste.paste_batch(pred, idxs)
        return pred.cpu().numpy()  # (B, 256, 256, 3) uint8 BGR

    def paste_back_frame(self, pred_frame: np.ndarray, idx: int) -> np.ndarray:
        if self._device_paste is not None or self._scheduler_composes:
            return pred_frame  # already a full frame
        import cv2

        x1, y1, x2, y2 = self.coord_list_cycle[idx]
        frame = self.frame_list_cycle[idx].copy()
        face = cv2.resize(pred_frame.astype(np.uint8), (x2 - x1, y2 - y1))
        return blend_face(frame, face, (x1, y1, x2, y2), self.mask_list_cycle[idx],
                          self.mask_coords_list_cycle[idx])
