"""Whisper feature extractor for MuseTalk (ports
livetalking_tpu/audio_features/whisper_features.py).

Per ``run_step``: ingest ``2*batch_size`` 20 ms chunks, run the
Whisper-tiny encoder over the rolling window (zero-padded to the 30 s
Whisper chunk, as the HF extractor does, or over the window itself with
``--whisper_short_window``), stack all hidden states, and gather per-video-
frame windows ``[0, 5]`` at 50 Hz (multiplier 2, start l/2), each reshaped
to (50, 384) cross-attention context rows. The (B, 50, 384) context batch
stays on the device for the U-Net step.

``make_batched_encode_factory`` builds the same encode for k sessions at
once (engine/feature_coalescer.py): the same mel, encoder and gather per
row, so coalesced rows equal solo rows exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from livetalking_tpu_torch.audio_features.base import BaseFeatureExtractor, clamp_window_indices
from livetalking_tpu_torch.models import whisper_encoder as we
from livetalking_tpu_torch.ops.whisper_mel import log_mel_spectrogram
from livetalking_tpu_torch.utils import spans
from livetalking_tpu_torch.utils.logger import logger


def _window_geometry(cfg, batch_size: int, l: int, r: int, short_window: bool, fps: int,
                     audio_feat_length=(0, 5)):
    """(n_samples, mel_samples, rows (B, 10), n_ctx) of one encode."""
    window_frames = 2 * batch_size + l + r
    n_samples = window_frames * (16000 // (fps * 2))
    if short_window:
        mel_samples = ((n_samples + 319) // 320) * 320  # position-aligned
        feat_len = mel_samples // 320                   # encoder positions at 50 Hz
    else:
        mel_samples = None                              # the full 30 s pad
        feat_len = cfg.max_positions                    # 1500
    rows = clamp_window_indices(batch_size, feat_len, tuple(audio_feat_length),
                                start=l // 2, multiplier=2.0)
    n_ctx = rows.shape[1] * (cfg.num_layers + 1)        # 10 * 5 = 50
    return n_samples, mel_samples, rows, n_ctx


def _encode(params, cfg, wavs: torch.Tensor, mel_samples, rows: torch.Tensor,
            batch_size: int, n_ctx: int) -> torch.Tensor:
    """(k, n_samples) f32 -> (k, B, n_ctx, D) f32 context rows.

    The mel rows are independent in one batched call; the encoder runs
    once per row, because PyTorch's GEMMs choose their blocking by the
    number of rows and a stacked batch would round differently from the
    row alone. So every row is exactly its solo encode."""
    if mel_samples is None:
        mels = log_mel_spectrogram(wavs)
    else:
        mels = log_mel_spectrogram(wavs, n_samples=mel_samples)
    states = torch.cat([we.apply_stacked(params, cfg, m[None]) for m in mels])  # (k, T, L+1, D)
    g = states.index_select(1, rows.reshape(-1))
    return g.reshape(wavs.shape[0], batch_size, n_ctx, cfg.d_model).float()


def make_batched_encode_factory(whisper_params, whisper_cfg, batch_size: int,
                                l: int, r: int, short_window: bool = False,
                                fps: int = 25, device="cuda"):
    """``batched_fn_factory`` for the FeatureCoalescer:
    factory(k) -> fn((k, n_samples) float32 numpy) -> (k, B, n_ctx, D)
    tensor on ``device``. Returns ``(factory, n_samples)``."""
    cfg = whisper_cfg or we.TINY
    dev = torch.device(device)
    n_samples, mel_samples, rows, n_ctx = _window_geometry(
        cfg, batch_size, l, r, short_window, fps)
    rows_dev = torch.from_numpy(rows).long().to(dev)

    def factory(k: int):
        @torch.inference_mode()
        def fn(wavs):
            w = torch.as_tensor(np.asarray(wavs, np.float32)).to(dev)
            if tuple(w.shape) != (k, n_samples):
                raise ValueError(f"batched encode: got {tuple(w.shape)}, want ({k}, {n_samples})")
            return _encode(whisper_params, cfg, w, mel_samples, rows_dev, batch_size, n_ctx)
        return fn

    return factory, n_samples


class WhisperFeatures(BaseFeatureExtractor):
    def __init__(self, opt, parent=None, whisper_params=None, whisper_cfg=None,
                 audio_feat_length=(0, 5), coalescer=None):
        super().__init__(opt, parent)
        self._coalescer = coalescer  # cross-session batched encoding
        self._cfg = whisper_cfg or we.TINY
        self._params = whisper_params
        self.audio_feat_length = tuple(audio_feat_length)
        self._dev = torch.device(getattr(opt, "device", "cuda"))

        # --whisper_short_window: encode the rolling window itself instead
        # of the 30 s zero-padded chunk; identical mel values for the real
        # frames, ~20x fewer encoder positions. Off by default: the padded
        # window is the distribution the reference nets were fed
        short = bool(getattr(opt, "whisper_short_window", False))
        self._n_samples, self._mel_samples, rows, self._n_ctx = _window_geometry(
            self._cfg, self.batch_size, self.stride_left_size, self.stride_right_size,
            short, self.fps, self.audio_feat_length)
        self._rows = torch.from_numpy(rows).long().to(self._dev)
        self._zero = torch.zeros((self.batch_size, self._n_ctx, self._cfg.d_model),
                                 dtype=torch.float32, device=self._dev)
        self.last_is_silence = True

    @torch.inference_mode()
    def _fn(self, wav: np.ndarray) -> torch.Tensor:
        """(n_samples,) -> (B, n_ctx, D) on the session's device."""
        w = torch.from_numpy(np.asarray(wav, np.float32)).to(self._dev)[None]
        return _encode(self._params, self._cfg, w, self._mel_samples, self._rows,
                       self.batch_size, self._n_ctx)[0]

    def run_step(self) -> None:
        n_speech = self._ingest_step_frames()
        is_all_silence = n_speech == 0
        if len(self.frames) <= self.stride_left_size + self.stride_right_size:
            return
        rid = next(self._rids)

        if is_all_silence and self.last_is_silence:
            # sustained silence: no encoder run (the inference thread skips
            # the U-Net too)
            feats = self._zero
        else:
            audio = np.concatenate(self.frames).astype(np.float32)
            if audio.shape[0] < self._n_samples:
                audio = np.concatenate(
                    [np.zeros(self._n_samples - audio.shape[0], np.float32), audio])
            elif audio.shape[0] > self._n_samples:
                audio = audio[-self._n_samples:]
            # the encode with the coalescer's wait; its count is the
            # coalesced batch's rows (the coalescer notes them)
            with spans.span("features.encode", rid, 1):
                if self._coalescer is not None:
                    try:
                        feats = self._coalescer.encode(audio)
                    except Exception as e:
                        # a stopped or wedged coalescer must not kill the
                        # render loop: the avatar idles for this tick (the
                        # reference's silence-synthesis degradation)
                        logger.warning("feature coalescer encode failed (%s): "
                                       "silence features this tick", e)
                        feats = self._zero
                else:
                    feats = self._fn(audio)

        self._put_feats(feats, rid)
        self._trim_frames()
        self.last_is_silence = is_all_silence
