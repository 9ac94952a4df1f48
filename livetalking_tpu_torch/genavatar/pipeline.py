"""Model-specific avatar build pipelines (ports
livetalking_tpu/genavatar/pipeline.py).

Output directory formats are the runtime loaders' (and the reference's):
  - wav2lip  (reference avatars/wav2lip/genavatar.py:50-166):
    full_imgs/ + face_imgs/ (img_size crops) + coords.pkl (y1, y2, x1, x2)
  - musetalk (reference avatars/musetalk/genavatar.py:49-183):
    full_imgs/ + coords.pkl (x1, y1, x2, y2) + latents.pt + mask/ +
    mask_coords.pkl
  - ultralight (reference avatars/ultralight/genavatar.py:40-95):
    full_imgs/ + face_imgs/ (168 px) + coords.pkl (x1, y1, x2, y2)
    [+ per-avatar ultralight.pth supplied by training]
  - ernerf (the JAX package's own format): full_imgs/ + coords.pkl
    (y1, y2, x1, x2) + ernerf.npz, a triplane field fit to the clip by
    ``models/ernerf.py::make_train_step``

Every builder runs its models (S3FD, PFLD, BiSeNet, the VAE encoder, the
HuBERT front-end, the field's fit) on ``device``, the card unless the
caller asks for the CPU. ``cv2`` is imported where it is used.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from livetalking_tpu_torch.genavatar.face import FaceDetector, detect_track
from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.logger import logger

Progress = Optional[Callable[[int, str], None]]

def _report(progress: Progress, pct: int, msg: str) -> None:
    if progress:
        progress(pct, msg)


def load_frames(video_path: str, watermark: bool = True) -> List[np.ndarray]:
    """Video file or image directory -> list of BGR frames (reference
    video2imgs, avatars/wav2lip/genavatar.py:60-75)."""
    import cv2

    frames: List[np.ndarray] = []
    if os.path.isdir(video_path):
        paths = sorted(glob.glob(os.path.join(video_path, "*.[jpJP][pnPN]*[gG]")))
        frames = [cv2.imread(p) for p in paths]
    else:
        cap = cv2.VideoCapture(video_path)
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    if watermark:
        for f in frames:
            cv2.putText(f, "LiveTalking", (10, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.3,
                        (128, 128, 128), 1)
    return frames


def _write_frames(dirpath: str, frames: Sequence[np.ndarray]) -> None:
    import cv2

    os.makedirs(dirpath, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(dirpath, f"{i}.png"), f)


def _pickle(path: str, obj) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _crops(frames, boxes, size: int) -> List[np.ndarray]:
    import cv2

    return [cv2.resize(f[y1:y2, x1:x2], (size, size)) for f, (x1, y1, x2, y2) in zip(frames, boxes)]


def generate_wav2lip_avatar(
    video_path: str,
    avatar_id: str,
    data_dir: str = "./data",
    img_size: int = 256,
    pads: Tuple[int, int, int, int] = (0, 10, 0, 0),
    face_detector: Optional[FaceDetector] = None,
    progress_callback: Progress = None,
    device="cuda",
) -> str:
    dev = resolve_device(device)
    avatar_dir = os.path.join(data_dir, "avatars", avatar_id)
    detector = face_detector or FaceDetector(device=dev)

    _report(progress_callback, 5, "decoding frames")
    frames = load_frames(video_path)
    _report(progress_callback, 25, "detecting faces")
    boxes = detect_track(frames, detector, pads)

    _report(progress_callback, 55, "cropping faces")
    _write_frames(os.path.join(avatar_dir, "full_imgs"), frames)
    _write_frames(os.path.join(avatar_dir, "face_imgs"), _crops(frames, boxes, img_size))
    # wav2lip coords use (y1, y2, x1, x2) (reference genavatar.py:126-138)
    _pickle(os.path.join(avatar_dir, "coords.pkl"),
            [(y1, y2, x1, x2) for (x1, y1, x2, y2) in boxes])
    _report(progress_callback, 100, "done")
    logger.info("wav2lip avatar %s built: %d frames", avatar_id, len(frames))
    return avatar_dir


def _feathered_mask(box: Tuple[int, int, int, int], crop_box, blur: int) -> np.ndarray:
    """Geometric stand-in for the BiSeNet face-parse mask (the reference
    uses a parsing net + Gaussian feathering, avatars/musetalk/utils/
    blending.py:112-136; ``_parsed_mask`` when its weights are present)."""
    import cv2

    x1, y1, x2, y2 = box
    xs, ys, xe, ye = crop_box
    mask = np.zeros((ye - ys, xe - xs, 3), np.uint8)
    cx, cy = (x1 + x2) // 2 - xs, (y1 + y2) // 2 - ys
    cv2.ellipse(mask, (cx, cy), ((x2 - x1) // 2, (y2 - y1) // 2), 0, 0, 360,
                (255, 255, 255), -1)
    k = blur | 1
    return cv2.GaussianBlur(mask, (k, k), 0)


def _load_face_parser(models_dir: str = "./models", device="cuda"):
    """The BiSeNet face parser on ``device`` when its checkpoint exists
    (``face-parse*.pth`` or ``79999_iter.pth`` under ``models_dir``): a
    ``(face_bgr_512) -> class_map`` callable, else None. A checkpoint that
    is present but does not load raises."""
    cands = (glob.glob(os.path.join(models_dir, "face-parse*.pth"))
             + glob.glob(os.path.join(models_dir, "79999_iter.pth")))
    if not cands:
        return None
    import torch

    from livetalking_tpu_torch.models import bisenet

    sd = torch.load(cands[0], map_location="cpu", weights_only=False)
    params = bisenet.convert_torch_state_dict(sd, device=device)
    fn = bisenet.make_parse_fn(512)
    logger.info("face parser loaded from %s", cands[0])
    return lambda face_bgr: fn(params, face_bgr[None])[0].cpu().numpy()


def _parsed_mask(parse, frame: np.ndarray, box, crop_box, blur: int) -> np.ndarray:
    """BiSeNet path of the reference mask build (blending.py:112-136):
    parse the face crop, keep the mouth region, Gaussian-feather."""
    import cv2

    from livetalking_tpu_torch.models.bisenet import mouth_mask

    x1, y1, x2, y2 = box
    xs, ys, xe, ye = crop_box
    face = cv2.resize(frame[y1:y2, x1:x2], (512, 512))
    classes = parse(face.astype(np.uint8))
    m = cv2.resize(mouth_mask(classes), (x2 - x1, y2 - y1), interpolation=cv2.INTER_NEAREST)
    full = np.zeros((ye - ys, xe - xs), np.uint8)
    full[y1 - ys:y2 - ys, x1 - xs:x2 - xs] = m
    k = blur | 1
    full = cv2.GaussianBlur(full, (k, k), 0)
    return cv2.cvtColor(full, cv2.COLOR_GRAY2BGR)


def generate_musetalk_avatar(
    video_path: str,
    avatar_id: str,
    data_dir: str = "./data",
    vae_params=None,
    bbox_shift: int = 0,
    version: str = "v15",
    face_detector: Optional[FaceDetector] = None,
    models_dir: str = "./models",
    progress_callback: Progress = None,
    device="cuda",
) -> str:
    import cv2
    import torch

    from livetalking_tpu_torch.genavatar.landmarks import load_pfld_landmarker, musetalk_crop_box
    from livetalking_tpu_torch.models.musetalk import encode_avatar_latents

    dev = resolve_device(device)
    avatar_dir = os.path.join(data_dir, "avatars", avatar_id)
    detector = face_detector or FaceDetector(device=dev)

    _report(progress_callback, 5, "decoding frames")
    frames = load_frames(video_path)
    H, W = frames[0].shape[:2]
    _report(progress_callback, 20, "detecting faces")
    boxes = detect_track(frames, detector, pads=(0, 0, 0, 0))

    # landmark refinement when PFLD weights are available (reference
    # preprocessing.py:126-140 fuses detector boxes with landmarks)
    landmarker = load_pfld_landmarker(models_dir, dev)
    if landmarker is not None:
        _report(progress_callback, 30, "regressing landmarks")

        def shifted(b):  # detector-box fallback keeps the bbox_shift too
            x1, y1, x2, y2 = b
            return (x1, max(0, y1 + bbox_shift), x2, min(H, y2 + bbox_shift))

        boxes = [musetalk_crop_box(landmarker.landmarks(frame, box), (H, W), bbox_shift)
                 or shifted(box) for frame, box in zip(frames, boxes)]
    elif bbox_shift:
        boxes = [(x1, max(0, y1 + bbox_shift), x2, min(H, y2 + bbox_shift))
                 for (x1, y1, x2, y2) in boxes]
    if version == "v15":  # extra chin margin (reference genavatar.py:121-124)
        boxes = [(x1, y1, x2, min(H, y2 + (y2 - y1) // 10)) for (x1, y1, x2, y2) in boxes]

    _report(progress_callback, 40, "encoding VAE latents")
    if vae_params is None:
        raise ValueError("musetalk avatar build requires VAE params")
    faces = np.stack(_crops(frames, boxes, 256)).astype(np.uint8)
    latents = encode_avatar_latents(vae_params, faces, device=dev)

    _report(progress_callback, 70, "building masks")
    _write_frames(os.path.join(avatar_dir, "full_imgs"), frames)
    mask_dir = os.path.join(avatar_dir, "mask")
    os.makedirs(mask_dir, exist_ok=True)
    parse = _load_face_parser(models_dir, dev)
    mask_coords = []
    for i, (x1, y1, x2, y2) in enumerate(boxes):
        mx, my = (x2 - x1) // 10, (y2 - y1) // 10
        crop_box = (max(0, x1 - mx), max(0, y1 - my), min(W, x2 + mx), min(H, y2 + my))
        blur = max(5, (x2 - x1) // 12)
        if parse is not None:
            mask = _parsed_mask(parse, frames[i], (x1, y1, x2, y2), crop_box, blur)
        else:
            mask = _feathered_mask((x1, y1, x2, y2), crop_box, blur)
        cv2.imwrite(os.path.join(mask_dir, f"{i}.png"), mask)
        mask_coords.append(crop_box)

    tensors = [torch.from_numpy(np.transpose(lat, (2, 0, 1))[None]) for lat in latents]
    torch.save(tensors, os.path.join(avatar_dir, "latents.pt"))
    _pickle(os.path.join(avatar_dir, "coords.pkl"), boxes)
    _pickle(os.path.join(avatar_dir, "mask_coords.pkl"), mask_coords)
    _report(progress_callback, 100, "done")
    logger.info("musetalk avatar %s built: %d frames", avatar_id, len(frames))
    return avatar_dir


def generate_ultralight_avatar(
    video_path: str,
    avatar_id: str,
    data_dir: str = "./data",
    unet_checkpoint: Optional[str] = None,
    face_detector: Optional[FaceDetector] = None,
    models_dir: str = "./models",
    progress_callback: Progress = None,
    device="cuda",
) -> str:
    from livetalking_tpu_torch.genavatar.landmarks import (
        load_pfld_landmarker,
        ultralight_crop_box,
    )

    dev = resolve_device(device)
    avatar_dir = os.path.join(data_dir, "avatars", avatar_id)
    detector = face_detector or FaceDetector(device=dev)

    _report(progress_callback, 5, "decoding frames")
    frames = load_frames(video_path)
    _report(progress_callback, 30, "detecting faces")
    boxes = detect_track(frames, detector, pads=(0, 0, 0, 0))
    H, W = frames[0].shape[:2]

    # landmark-derived square crops when PFLD weights are available
    # (reference genavatar.py:76-82); square-expanded detector boxes
    # otherwise
    landmarker = load_pfld_landmarker(models_dir, dev)
    if landmarker is not None:
        _report(progress_callback, 45, "regressing landmarks")
        boxes = [ultralight_crop_box(landmarker.landmarks(frame, box), (H, W)) or box
                 for frame, box in zip(frames, boxes)]
    else:
        logger.info("no PFLD weights (models/pfld.pth + mean_face.txt): "
                    "using square-expanded detector boxes")
        sq = []
        for (x1, y1, x2, y2) in boxes:
            s = max(x2 - x1, y2 - y1)
            cx, cy = (x1 + x2) // 2, (y1 + y2) // 2
            x1, y1 = max(0, cx - s // 2), max(0, cy - s // 2)
            sq.append((x1, y1, min(W, x1 + s), min(H, y1 + s)))
        boxes = sq

    _report(progress_callback, 60, "cropping")
    _write_frames(os.path.join(avatar_dir, "full_imgs"), frames)
    _write_frames(os.path.join(avatar_dir, "face_imgs"), _crops(frames, boxes, 168))
    _pickle(os.path.join(avatar_dir, "coords.pkl"), boxes)  # (x1, y1, x2, y2)

    if unet_checkpoint and os.path.exists(unet_checkpoint):
        import shutil

        shutil.copy(unet_checkpoint, os.path.join(avatar_dir, "ultralight.pth"))
    else:
        logger.warning("no per-avatar ultralight checkpoint provided - "
                       "runtime will use random U-Net weights")
    _report(progress_callback, 100, "done")
    logger.info("ultralight avatar %s built: %d frames", avatar_id, len(frames))
    return avatar_dir


def _clip_audio(video_path: str, audio_path: Optional[str]) -> Optional[np.ndarray]:
    """16 kHz mono f32 audio for the ER-NeRF fit: ``audio_path`` (its decode
    errors raise), else the video's own track; None when the video (or
    frame directory) has none that decodes."""
    import subprocess

    from livetalking_tpu_torch.utils.audio import decode_audio, resample

    if audio_path:
        wav, sr = decode_audio(audio_path)
    elif os.path.isdir(video_path):
        return None
    else:
        try:
            wav, sr = decode_audio(video_path)
        except (RuntimeError, ValueError, subprocess.CalledProcessError) as e:
            # no decoder (RuntimeError), the native decoder's "no audio
            # stream" (ValueError) or the ffmpeg CLI's failure
            logger.warning("ernerf: no usable audio track (%s) - zero conditioning", e)
            return None
    wav = np.asarray(resample(wav, sr, 16000), np.float32)
    if wav.size == 0:
        if audio_path:
            raise ValueError(f"ernerf: {audio_path} holds no audio")
        logger.warning("ernerf: empty audio track - zero conditioning")
        return None
    return wav


def generate_ernerf_avatar(
    video_path: str,
    avatar_id: str,
    data_dir: str = "./data",
    size: int = 64,
    train_steps: int = 200,
    batch: int = 4,
    hubert_params=None,
    hubert_cfg=None,
    face_detector: Optional[FaceDetector] = None,
    progress_callback: Progress = None,
    device="cuda",
    audio_path: Optional[str] = None,
) -> str:
    """Build an ER-NeRF avatar: frames, boxes and a per-avatar triplane
    field fit photometrically to the clip, conditioned on its audio.

    The audio is ``audio_path`` when given, else the video's own track.
    The features are the serving extractor's HuBERT windows (multiplier 2,
    window (4, 4)), zeros when the video has no audio track to decode; the
    fit draws its frames and its random solid backgrounds from
    ``np.random.default_rng(0)``, as the reference does."""
    import cv2
    import torch

    from livetalking_tpu_torch.audio_features.base import clamp_window_indices
    from livetalking_tpu_torch.avatars.ernerf_avatar import AUDIO_DIM, save_avatar_field
    from livetalking_tpu_torch.models import ernerf
    from livetalking_tpu_torch.models import hubert as hub

    dev = resolve_device(device)
    avatar_dir = os.path.join(data_dir, "avatars", avatar_id)
    detector = face_detector or FaceDetector(device=dev)

    _report(progress_callback, 5, "decoding frames")
    frames = load_frames(video_path)
    _report(progress_callback, 20, "detecting faces")
    boxes = detect_track(frames, detector, pads=(0, 10, 0, 0))
    _write_frames(os.path.join(avatar_dir, "full_imgs"), frames)
    _pickle(os.path.join(avatar_dir, "coords.pkl"),
            [(y1, y2, x1, x2) for (x1, y1, x2, y2) in boxes])

    n = len(frames)
    _report(progress_callback, 35, "extracting audio features")
    feats = np.zeros((n, AUDIO_DIM), np.float32)
    wav = _clip_audio(video_path, audio_path)
    if wav is not None:
        cfg = hubert_cfg or hub.LARGE
        params = hubert_params or hub.init_params(0, cfg, device=dev)
        with torch.no_grad():
            h = hub.apply(params, cfg, torch.from_numpy(wav)[None].to(dev))[0].float().cpu().numpy()
        rows = clamp_window_indices(n, h.shape[0], (4, 4), start=0, multiplier=2.0)
        win = h[rows].reshape(n, -1)[:, :AUDIO_DIM]  # narrower with the tests' tiny configs
        feats[:, : win.shape[1]] = win

    _report(progress_callback, 45, "fitting triplane field")
    crops = np.stack([cv2.resize(f[y1:y2, x1:x2], (size, size)).astype(np.float32) / 255.0
                      for f, (x1, y1, x2, y2) in zip(frames, boxes)])
    params = ernerf.init_params(0, audio_dim=AUDIO_DIM, device=dev)
    tx, step = ernerf.make_train_step(lr=2e-3, size=size, n_samples=16)
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    for it in range(train_steps):
        sel = rng.integers(0, n, (batch,))
        # a random solid background per sample: the field has to explain the
        # head with alpha ~ 1 instead of leaning on one background; serving
        # composites over the frame's own box crop
        bg = np.broadcast_to(rng.random((batch, 1, 1, 3)).astype(np.float32),
                             (batch, size, size, 3))
        params, opt_state, loss = step(params, opt_state, torch.from_numpy(feats[sel]).to(dev),
                                       torch.from_numpy(np.ascontiguousarray(bg)).to(dev),
                                       torch.from_numpy(crops[sel]).to(dev))
        if it % max(1, train_steps // 10) == 0:
            _report(progress_callback, 45 + int(50 * it / train_steps),
                    f"fit step {it}/{train_steps} loss={float(loss):.4f}")

    save_avatar_field(params, avatar_dir)
    _report(progress_callback, 100, "done")
    logger.info("ernerf avatar %s built: %d frames, %d fit steps", avatar_id, n, train_steps)
    return avatar_dir
