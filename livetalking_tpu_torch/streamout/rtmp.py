"""RTMP output transport on the port's native muxer (ports
livetalking_tpu/streamout/rtmp.py).

The muxer opens lazily from the first video frame's dimensions; audio
arriving before video is buffered (at most 500 frames, 10 s) until the
stream is up; the compose thread is paced at the frame rate; a rolling
``final fps`` log every 100 frames; eventpoints fire whatever state the
muxer is in. The encoder/muxer is ``livetalking_tpu_torch/native`` (h264 +
aac -> FLV over RTMP via libavformat; a local path with no scheme writes
the same FLV to a file).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.streamout.base import BaseOutput
from livetalking_tpu_torch.utils.logger import logger


@register("streamout", "rtmp")
class RTMPOutput(BaseOutput):
    def __init__(self, opt=None, parent=None, **kw):
        super().__init__(opt, parent)
        self._muxer = None
        self._pre_video_audio: List[np.ndarray] = []
        self._frame_count = 0
        self._fps_t0 = time.perf_counter()
        self._next_deadline: Optional[float] = None
        self._last_error = ""  # a repeated failure (no muxer, no server) is logged once
        self.push_url = getattr(opt, "push_url", "rtmp://localhost/live/livestream")

    def start(self) -> None:
        pass  # lazy init on first video frame (dimensions unknown until then)

    def _ensure_muxer(self, frame: np.ndarray) -> None:
        if self._muxer is not None:
            return
        from livetalking_tpu_torch.native import AVMuxer

        h, w = frame.shape[:2]
        fps = getattr(self.opt, "fps", 25)
        logger.info("rtmp: opening %s (%dx%d@%d)", self.push_url, w, h, fps)
        self._muxer = AVMuxer(self.push_url, w, h, fps)
        for pcm in self._pre_video_audio:
            self._muxer.write_audio(pcm)
        self._pre_video_audio.clear()

    def push_video_frame(self, frame: np.ndarray) -> None:
        try:
            self._ensure_muxer(frame)
            self._muxer.write_video(frame)
        except Exception as e:
            if str(e) != self._last_error:
                logger.error("rtmp video write failed (retried every frame): %s", e)
                self._last_error = str(e)
            return

        # pacing: hold the egress at the video frame rate
        now = time.perf_counter()
        if self._next_deadline is None:
            self._next_deadline = now
        self._next_deadline += 1.0 / getattr(self.opt, "fps", 25)
        delay = self._next_deadline - now
        if delay > 0:
            time.sleep(delay)
        elif delay < -1.0:
            self._next_deadline = now

        self._frame_count += 1
        if self._frame_count >= 100:
            t = time.perf_counter()
            logger.info("rtmp final fps:%.4f", self._frame_count / (t - self._fps_t0))
            self._frame_count = 0
            self._fps_t0 = t

    def push_audio_frame(self, frame: np.ndarray, eventpoint=None) -> None:
        if self._muxer is None:
            # bound the pre-open buffer (~10 s) so a persistently failing
            # muxer cannot grow memory without limit
            self._pre_video_audio.append(np.asarray(frame, np.int16))
            if len(self._pre_video_audio) > 500:
                self._pre_video_audio.pop(0)
        else:
            try:
                self._muxer.write_audio(frame)
            except Exception as e:
                logger.error("rtmp audio write failed: %s", e)
        # eventpoints fire regardless of muxer state: SSE consumers track
        # speaking status through them
        if eventpoint and self.parent is not None:
            self.parent.notify(eventpoint)

    def stop(self) -> None:
        if self._muxer is not None:
            self._muxer.close()
            self._muxer = None
