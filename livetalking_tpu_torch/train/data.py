"""Training data: avatar-directory sampling and whole-utterance feature
windows (ports livetalking_tpu/train/data.py).

Samples (target frame, reference frame, aligned audio window) triples from
an avatar directory of the genavatar formats plus a 16 kHz utterance. The
windows are the serving extractors' (``audio_features/base.py``
``clamp_window_indices``; mel 16 wide at 80/fps, Whisper [0, 5] x 2,
HuBERT [4, 4] x 2), so a net trained here sees the feature distribution
the streaming pipeline feeds it. Each feature function runs the port's
front-end once over the whole clip, on the device its parameters live on,
and returns numpy; batch assembly is host numpy with the reference's
``np.random.RandomState`` draws, so a seed gives the reference's batches
byte for byte.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from livetalking_tpu_torch.audio_features.base import clamp_window_indices

FPS = 25
SR = 16000


def n_video_frames(n_samples: int, fps: int = FPS) -> int:
    return int(n_samples / SR * fps)


def _mel(audio: np.ndarray) -> np.ndarray:
    from livetalking_tpu_torch.ops import mel as melops

    return melops.melspectrogram(torch.from_numpy(np.asarray(audio, np.float32))).numpy()


# ---------------------------------------------------------------------------
# whole-utterance feature windows (one row per video frame)
# ---------------------------------------------------------------------------

def mel_windows(audio: np.ndarray, fps: int = FPS) -> np.ndarray:
    """(n_samples,) f32 -> (F, 80, 16) mel windows: window i starts at mel
    column int(i * 80 / fps), the serving slicer's truncation."""
    F = n_video_frames(audio.shape[0], fps)
    m = _mel(audio)  # (80, T)
    T = m.shape[1]
    starts = np.minimum((np.arange(F) * (80.0 / fps)).astype(np.int32), max(T - 16, 0))
    return np.stack([m[:, s: s + 16] for s in starts]).astype(np.float32)


def sync_mel_windows(audio: np.ndarray, clip_starts: np.ndarray, fps: int = FPS) -> np.ndarray:
    """(n,) clip start frames -> (n, 80, 16, 1) mel windows for the 5-frame
    sync expert, one at each clip's start."""
    return mel_windows(audio, fps)[np.asarray(clip_starts, np.int64)][..., None]


def sync_mel16_windows(audio: np.ndarray, clip_starts: np.ndarray, fps: int = FPS,
                       width: int = 52) -> np.ndarray:
    """(n,) clip start frames -> (n, 80, 52, 1) mel windows for MuseTalk's
    16-frame expert (16 frames at 25 fps = 0.64 s = ~52 columns at 80/s)."""
    m = _mel(audio)
    T = m.shape[1]
    starts = np.minimum((np.asarray(clip_starts, np.int64) * (80.0 / fps)).astype(np.int64),
                        max(T - width, 0))
    return np.stack([m[:, s: s + width] for s in starts]).astype(np.float32)[..., None]


def _param_device(tree) -> torch.device:
    from livetalking_tpu_torch.utils.tree import tree_leaves

    return tree_leaves(tree)[0].device


@torch.no_grad()
def whisper_windows(audio: np.ndarray, whisper_params, whisper_cfg=None,
                    fps: int = FPS) -> np.ndarray:
    """-> (F, 50, 384) U-Net cross-attention windows: the Whisper-tiny
    stacked hidden states at 50 Hz, window [0, 5] x 2, over the whole clip
    in f32. A clip is cut at Whisper's 30 s window."""
    from livetalking_tpu_torch.models import whisper_encoder as we
    from livetalking_tpu_torch.ops.whisper_mel import N_SAMPLES, log_mel_spectrogram

    cfg = whisper_cfg or we.TINY
    F = min(n_video_frames(audio.shape[0], fps), cfg.max_positions // 2)
    rows = clamp_window_indices(F, cfg.max_positions, (0, 5), start=0, multiplier=2.0)
    dev = _param_device(whisper_params)
    wav = torch.from_numpy(np.asarray(audio[:N_SAMPLES], np.float32)).to(dev)
    states = we.apply_stacked(whisper_params, cfg, log_mel_spectrogram(wav)[None])[0]
    g = states.index_select(0, torch.from_numpy(rows.reshape(-1)).long().to(dev))
    return g.reshape(F, -1, cfg.d_model).float().cpu().numpy()


@torch.no_grad()
def hubert_windows(audio: np.ndarray, hubert_params, hubert_cfg=None,
                   fps: int = FPS) -> np.ndarray:
    """-> (F, 32, 32, 16) HuBERT window planes (NHWC, the Ultralight
    U-Net's audio input), over the whole clip in f32."""
    from livetalking_tpu_torch.models import hubert as hub

    cfg = hubert_cfg or hub.LARGE
    F = n_video_frames(audio.shape[0], fps)
    rows = clamp_window_indices(F, cfg.out_length(audio.shape[0]), (4, 4), start=0,
                                multiplier=2.0)
    plane = int(np.sqrt(cfg.hidden_size))
    dev = _param_device(hubert_params)
    wav = torch.from_numpy(np.asarray(audio, np.float32)).to(dev)
    h = hub.apply(hubert_params, cfg, wav[None])[0]  # (feat_len, H)
    g = h.index_select(0, torch.from_numpy(rows.reshape(-1)).long().to(dev))
    g = g.reshape(F, rows.shape[1], plane, plane).permute(0, 2, 3, 1)
    return g.float().cpu().numpy()


# ---------------------------------------------------------------------------
# avatar-directory frame loading (genavatar formats)
# ---------------------------------------------------------------------------

def _read_dir(dirpath: str) -> np.ndarray:
    import cv2

    paths = sorted(glob.glob(os.path.join(dirpath, "*.png")),
                   key=lambda p: int(os.path.splitext(os.path.basename(p))[0]))
    if not paths:
        raise FileNotFoundError(f"no frames under {dirpath}")
    return np.stack([cv2.imread(p) for p in paths])


def load_faces(avatar_dir: str, family: str) -> np.ndarray:
    """(N, S, S, 3) uint8 BGR face crops: wav2lip ``face_imgs/`` as they
    are (256 px); ultralight ``face_imgs/`` (168 px) cut to the centre 160;
    musetalk ``full_imgs/`` cropped by ``coords.pkl`` and resized to 256
    with Lanczos (the VAE's input crop)."""
    import cv2

    if family == "wav2lip":
        return _read_dir(os.path.join(avatar_dir, "face_imgs"))
    if family == "ultralight":
        return _read_dir(os.path.join(avatar_dir, "face_imgs"))[:, 4:164, 4:164]
    if family == "musetalk":
        frames = _read_dir(os.path.join(avatar_dir, "full_imgs"))
        with open(os.path.join(avatar_dir, "coords.pkl"), "rb") as f:
            boxes = pickle.load(f)
        return np.stack([cv2.resize(img[y1:y2, x1:x2], (256, 256),
                                    interpolation=cv2.INTER_LANCZOS4)
                         for img, (x1, y1, x2, y2) in zip(frames, boxes)])
    raise ValueError(f"unknown family {family!r}")


# ---------------------------------------------------------------------------
# batch assembly
# ---------------------------------------------------------------------------

def mask_wav2lip(face01: np.ndarray) -> np.ndarray:
    """The lower half blacked out."""
    m = face01.copy()
    m[:, face01.shape[1] // 2:] = 0.0
    return m


def mask_ultralight(face01: np.ndarray) -> np.ndarray:
    """The interior rectangle, rows [5, 150) and columns [5, 145) of the
    160 px crop, blacked out."""
    m = face01.copy()
    m[:, 5:150, 5:145] = 0.0
    return m


def make_batch(family: str, faces: np.ndarray, feats: np.ndarray, idx: np.ndarray,
               rng: np.random.RandomState, audio: Optional[np.ndarray] = None,
               fps: int = FPS, clip_len: int = 5) -> Dict[str, np.ndarray]:
    """One training batch for the frame indices ``idx``.

    faces (N, S, S, 3) uint8 BGR; feats per-frame feature rows (the
    ``*_windows`` output). Reference frames are drawn uniformly away from
    the target. With ``audio`` the batch carries one sync mel window per
    ``clip_len``-frame clip (``sync_mel16`` for the 16-frame expert)."""
    idx = np.asarray(idx, np.int64)
    N = faces.shape[0]
    ref_idx = (idx + rng.randint(1, max(N, 2), size=idx.shape)) % max(N, 1)
    tgt = faces[idx].astype(np.float32)
    ref = faces[ref_idx].astype(np.float32)
    f = feats[np.minimum(idx, feats.shape[0] - 1)]

    if family == "wav2lip":
        t01, r01 = tgt / 255.0, ref / 255.0
        batch = {"mel": f[..., None].astype(np.float32),          # (B, 80, 16, 1)
                 "face": np.concatenate([mask_wav2lip(t01), r01], axis=-1),
                 "target": t01}
    elif family == "musetalk":
        batch = {"gt": tgt[..., ::-1] / 127.5 - 1.0, "ref": ref[..., ::-1] / 127.5 - 1.0,
                 "audio": f}
    elif family == "ultralight":
        # (real, masked) as the serving input; the "real" slot holds an
        # off-time frame so the target's mouth cannot leak through
        t01, r01 = tgt / 255.0, ref / 255.0
        batch = {"face": np.concatenate([r01, mask_ultralight(t01)], axis=-1),
                 "audio": f, "target": t01}
    else:
        raise ValueError(f"unknown family {family!r}")

    if audio is not None:
        starts = idx.reshape(-1, clip_len)[:, 0]
        if clip_len == 16:
            batch["sync_mel16"] = sync_mel16_windows(audio, starts, fps)
        else:
            batch["sync_mel"] = sync_mel_windows(audio, starts, fps)
    return {k: np.ascontiguousarray(v) for k, v in batch.items()}


def clip_batches(family: str, faces: np.ndarray, feats: np.ndarray, batch_size: int,
                 rng: np.random.RandomState, clip_len: int = 1,
                 audio: Optional[np.ndarray] = None,
                 fps: int = FPS) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches: ``clip_len > 1`` samples consecutive-frame clips
    (``batch_size`` a multiple of it), else independent frames."""
    n_usable = min(faces.shape[0], feats.shape[0])
    if n_usable < clip_len:
        raise ValueError(f"need >= {clip_len} aligned frames, have {n_usable}")
    if clip_len > 1 and batch_size % clip_len:
        raise ValueError(
            f"batch_size ({batch_size}) must be a multiple of clip_len ({clip_len}): the "
            f"sync/GAN recipes sample whole {clip_len}-frame clips; use e.g. --batch_size "
            f"{((batch_size + clip_len - 1) // clip_len) * clip_len}")
    while True:
        if clip_len > 1:
            starts = rng.randint(0, n_usable - clip_len + 1, size=batch_size // clip_len)
            idx = (starts[:, None] + np.arange(clip_len)[None]).reshape(-1)
        else:
            idx = rng.randint(0, n_usable, size=batch_size)
        yield make_batch(family, faces, feats, idx, rng, audio=audio, fps=fps,
                         clip_len=clip_len)
