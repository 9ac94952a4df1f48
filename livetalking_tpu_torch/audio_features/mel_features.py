"""Mel-window feature extractor for Wav2Lip (ports
livetalking_tpu/audio_features/mel_features.py).

Per ``run_step``: ingest ``2*batch_size`` 20 ms chunks, concatenate the
rolling buffer (l + r stride context + the new chunks), run the mel +
window gather on the session's device, and put one (B, 80, 16) device
tensor into ``feat_queue``.
"""

from __future__ import annotations

import numpy as np

from livetalking_tpu_torch.audio_features.base import BaseFeatureExtractor
from livetalking_tpu_torch.ops.mel import make_mel_chunks_fn
from livetalking_tpu_torch.utils import spans


class MelFeatures(BaseFeatureExtractor):
    def __init__(self, opt, parent=None):
        super().__init__(opt, parent)
        self._fn = make_mel_chunks_fn(
            self.batch_size, self.stride_left_size, self.stride_right_size, self.fps,
            device=opt.device,
        )
        self._window_frames = 2 * self.batch_size + self.stride_left_size + self.stride_right_size

    def run_step(self) -> None:
        self._ingest_step_frames()
        if len(self.frames) <= self.stride_left_size + self.stride_right_size:
            return
        rid = next(self._rids)

        audio = np.concatenate(self.frames).astype(np.float32)
        want = self._window_frames * self.chunk
        if audio.shape[0] < want:  # first step without full warm-up context
            audio = np.concatenate([np.zeros(want - audio.shape[0], np.float32), audio])
        elif audio.shape[0] > want:
            audio = audio[-want:]

        with spans.span("features.encode", rid, 1):
            feats = self._fn(audio)  # (B, 80, 16) device tensor
        self._put_feats(feats, rid)
        self._trim_frames()
