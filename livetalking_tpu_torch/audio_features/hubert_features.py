"""HuBERT feature extractor for the Ultralight and ER-NeRF families (ports
livetalking_tpu/audio_features/hubert_features.py).

Per ``run_step``: ingest ``2*batch_size`` 20 ms chunks; when the whole step
and the previous step were silence, emit zero features without running the
network; otherwise run HuBERT over the rolling window of ``2*B + l + r``
chunks (16,640 samples at B=16, l=r=10: 51 encoder frames) and gather per
video frame the windows ``audio_feat_length=[4, 4]`` at 50 Hz (multiplier
2, start l/2), each reshaped to a (16, 32, 32) feature image. One
(B, 16, 32, 32) f32 tensor per step goes into ``feat_queue``, on the
session's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from livetalking_tpu_torch.audio_features.base import BaseFeatureExtractor, clamp_window_indices
from livetalking_tpu_torch.models import hubert as hub
from livetalking_tpu_torch.utils import spans


class HubertFeatures(BaseFeatureExtractor):
    def __init__(self, opt, parent=None, hubert_params=None, hubert_cfg=None,
                 audio_feat_length=(4, 4)):
        super().__init__(opt, parent)
        self._cfg = hubert_cfg or hub.LARGE
        self._params = hubert_params
        self.audio_feat_length = tuple(audio_feat_length)
        self.last_is_silence = True
        self._dev = torch.device(getattr(opt, "device", "cuda"))

        window_frames = 2 * self.batch_size + self.stride_left_size + self.stride_right_size
        self._n_samples = window_frames * self.chunk
        feat_len = self._cfg.out_length(self._n_samples)
        rows = clamp_window_indices(self.batch_size, feat_len, self.audio_feat_length,
                                    start=self.stride_left_size // 2, multiplier=2.0)
        self._n_ctx = rows.shape[1]
        # (n_ctx, hidden) flattens to n_ctx planes of 32x32
        self._plane = math.isqrt(self._cfg.hidden_size)
        if self._plane * self._plane != self._cfg.hidden_size:
            raise ValueError(f"hidden size {self._cfg.hidden_size} is not a square")
        self._rows = torch.from_numpy(rows.reshape(-1)).long().to(self._dev)
        self._zero = torch.zeros((self.batch_size, self._n_ctx, self._plane, self._plane),
                                 dtype=torch.float32, device=self._dev)

    @torch.inference_mode()
    def _fn(self, wav: np.ndarray) -> torch.Tensor:
        """(n_samples,) -> (B, n_ctx, 32, 32) f32 on the session's device."""
        w = torch.from_numpy(np.asarray(wav, np.float32)).to(self._dev)[None]
        h = hub.apply(self._params, self._cfg, w)[0]  # (feat_len, hidden)
        g = h.index_select(0, self._rows)
        return g.reshape(self.batch_size, self._n_ctx, self._plane, self._plane).float()

    def run_step(self) -> None:
        n_speech = self._ingest_step_frames()
        is_all_silence = n_speech == 0
        if len(self.frames) <= self.stride_left_size + self.stride_right_size:
            return
        rid = next(self._rids)

        if is_all_silence and self.last_is_silence:
            feats = self._zero  # no network on sustained silence
        else:
            audio = np.concatenate(self.frames).astype(np.float32)
            if audio.shape[0] < self._n_samples:
                audio = np.concatenate(
                    [np.zeros(self._n_samples - audio.shape[0], np.float32), audio])
            elif audio.shape[0] > self._n_samples:
                audio = audio[-self._n_samples:]
            with spans.span("features.encode", rid, 1):
                feats = self._fn(audio)

        self._put_feats(feats, rid)
        self._trim_frames()
        self.last_is_silence = is_all_silence
