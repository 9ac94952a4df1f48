"""Local output transports: in-process queue (tests/embedding) and null sink
(ports livetalking_tpu/streamout/local.py).

``queue`` exposes the composed A/V stream as bounded ``queue.Queue``s so a
host application (or a test) can consume frames directly. ``null``
discards frames but keeps counters (throughput probes).
"""

from __future__ import annotations

import queue
from typing import Optional

import numpy as np

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.streamout.base import BaseOutput


@register("streamout", "queue")
class QueueOutput(BaseOutput):
    """Bounded in-process A/V queues (video maxsize mirrors the reference
    WebRTC track queue depth of 100, reference server/webrtc.py:58)."""

    def __init__(self, opt=None, parent=None, maxsize: int = 100, **kw):
        super().__init__(opt, parent)
        self.video_queue: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=maxsize)
        self.audio_queue: "queue.Queue[tuple]" = queue.Queue(maxsize=maxsize * 2)
        self.started = False

    def start(self) -> None:
        self.started = True

    def push_video_frame(self, frame: np.ndarray) -> None:
        try:
            self.video_queue.put_nowait(frame)
        except queue.Full:  # drop-oldest keeps latency bounded
            try:
                self.video_queue.get_nowait()
            except queue.Empty:
                pass
            self.video_queue.put_nowait(frame)

    def push_audio_frame(self, frame: np.ndarray, eventpoint: Optional[dict] = None) -> None:
        try:
            self.audio_queue.put_nowait((frame, eventpoint))
        except queue.Full:
            try:
                self.audio_queue.get_nowait()
            except queue.Empty:
                pass
            self.audio_queue.put_nowait((frame, eventpoint))
        if eventpoint and self.parent is not None:
            self.parent.notify(eventpoint)

    def get_buffer_size(self) -> int:
        return self.video_queue.qsize()

    def stop(self) -> None:
        self.started = False


@register("streamout", "null")
class NullOutput(BaseOutput):
    def __init__(self, opt=None, parent=None, **kw):
        super().__init__(opt, parent)
        self.video_frames = 0
        self.audio_frames = 0

    def start(self) -> None:
        pass

    def push_video_frame(self, frame) -> None:
        self.video_frames += 1

    def push_audio_frame(self, frame, eventpoint=None) -> None:
        self.audio_frames += 1
        if eventpoint and self.parent is not None:
            self.parent.notify(eventpoint)

    def stop(self) -> None:
        pass
