"""Feature-extractor ring buffer shared by the extractors (ports
livetalking_tpu/audio_features/base.py).

  - ``queue``: input, fed by TTS with 20 ms chunks;
  - ``output_queue``: audio passthrough to the frame composer;
  - ``feat_queue`` (maxsize 2): the back-pressure point to the inference
    thread; it carries device tensors, which the model step or the shared
    scheduler consumes;
  - starvation synthesizes silence (type=1) after a 10 ms timeout so the
    avatar idles instead of stalling;
  - when the parent session plays custom choreography audio
    (``custom_audiotype > 1``), that stream takes priority;
  - ``warm_up`` pre-rolls ``l + r`` stride frames.

``clamp_window_indices`` is the static window gather of the Whisper
features (the reference's ``_get_sliced_feature`` indexing).
"""

from __future__ import annotations

import queue
from dataclasses import dataclass, field
from queue import Queue
from typing import TYPE_CHECKING, List, Optional

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar


@dataclass
class AudioFrameData:
    """One 20 ms audio chunk + its type and event metadata.

    ``type``: 0 = speech, 1 = silence, >1 = custom choreography audio
    (reference avatars/base_avatar.py:57-61).
    """

    data: np.ndarray
    type: int = 0
    userdata: dict = field(default_factory=dict)


class BaseFeatureExtractor:
    def __init__(self, opt, parent: Optional["BaseAvatar"] = None):
        self.opt = opt
        self.parent = parent
        self.fps = opt.fps
        self.sample_rate = 16000
        self.chunk = self.sample_rate // (opt.fps * 2)  # 320 samples = 20 ms
        self.batch_size = opt.batch_size
        self.stride_left_size = opt.l
        self.stride_right_size = opt.r

        self.queue: Queue[AudioFrameData] = Queue()
        self.output_queue: Queue[AudioFrameData] = Queue()
        self.feat_queue: Queue = Queue(maxsize=2)
        self.frames: List[np.ndarray] = []

    # -- ingest -----------------------------------------------------------
    def put_audio_frame(self, audio_chunk: np.ndarray, datainfo: Optional[dict] = None) -> None:
        self.queue.put(AudioFrameData(data=audio_chunk, type=0, userdata=datainfo or {}))

    def flush_talk(self) -> None:
        self.queue.queue.clear()

    # -- frame acquisition --------------------------------------------------
    def get_audio_frame(self) -> AudioFrameData:
        """Next 20 ms frame: custom audio > queued speech > synthesized silence."""
        parent = self.parent
        if parent is not None and parent.custom_audiotype > 1:
            data = parent.get_custom_audio_stream(parent.custom_audiotype)
            return AudioFrameData(data=data, type=parent.custom_audiotype, userdata={})
        try:
            return self.queue.get(block=True, timeout=0.01)
        except queue.Empty:
            return AudioFrameData(data=np.zeros(self.chunk, np.float32), type=1, userdata={})

    def get_audio_out(self) -> AudioFrameData:
        return self.output_queue.get()

    def warm_up(self) -> None:
        for _ in range(self.stride_left_size + self.stride_right_size):
            frame = self.get_audio_frame()
            self.frames.append(frame.data)
            self.output_queue.put(frame)
        for _ in range(self.stride_left_size):
            self.output_queue.get()

    def get_next_feat(self, block: bool = True, timeout: Optional[float] = None):
        return self.feat_queue.get(block, timeout)

    # -- per-step work ------------------------------------------------------
    def _ingest_step_frames(self) -> int:
        """Pull 2*batch_size frames in; returns count of speech frames."""
        n_speech = 0
        for _ in range(self.batch_size * 2):
            frame = self.get_audio_frame()
            if frame.type == 0:
                n_speech += 1
            self.frames.append(frame.data)
            self.output_queue.put(frame)
        return n_speech

    def _trim_frames(self) -> None:
        """Keep only the l+r stride context for the next step."""
        keep = self.stride_left_size + self.stride_right_size
        self.frames = self.frames[-keep:]

    def run_step(self) -> None:
        raise NotImplementedError



def clamp_window_indices(
    batch_size: int,
    feat_len: int,
    window: tuple,
    start: int,
    multiplier: float,
) -> np.ndarray:
    """Static clamp-to-edge index matrix for windowed feature slicing.

    Row i holds the feature indices for video frame ``i + start``: the
    range [center - window[0]*m, center + window[1]*m) with
    center = (i+start)*m, clamped to [0, feat_len-1].
    """
    rows = []
    for i in range(batch_size):
        center = int((i + start) * multiplier)
        lo = int(center - window[0] * multiplier)
        hi = int(center + window[1] * multiplier)
        rows.append(np.clip(np.arange(lo, hi), 0, feat_len - 1))
    return np.stack(rows).astype(np.int32)
