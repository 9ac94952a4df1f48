"""WebRTC media bridge (ports livetalking_tpu/server/webrtc.py): per-session
audio/video tracks with wall-clock pacing and playback-time eventpoints.

  - video: 40 ms per frame at a 90 kHz RTP clock (step 3600); audio: 20 ms
    frames at 16 kHz; pacing by sleeping until the next frame's wall-clock
    deadline, resynced after 10 frame times of lag;
  - frame queues are 100 deep and drop the oldest frame; the engine
    throttles on ``get_buffer_size`` (video backlog);
  - eventpoints attached to audio frames fire (``player.notify``) when the
    frame is *sent*, i.e. at playback time, not synthesis time;
  - ``final fps`` logged as a rolling 100-frame average at the egress;
  - the per-session render pipeline starts lazily on the first
    ``recv()`` so no work happens before the peer connection pulls media.

Requires aiortc + PyAV at import; callers gate the import
(``app.build_web_app``), and tests inject stand-ins.
"""

from __future__ import annotations

import asyncio
import fractions
import time
from threading import Event, Thread
from typing import Optional

import numpy as np
from aiortc import MediaStreamTrack
from av import AudioFrame, VideoFrame

from livetalking_tpu_torch.utils.logger import logger

AUDIO_PTIME = 0.020
SAMPLE_RATE = 16000
AUDIO_TIME_BASE = fractions.Fraction(1, SAMPLE_RATE)
VIDEO_CLOCK_RATE = 90000
VIDEO_PTIME = 1 / 25
VIDEO_TIME_BASE = fractions.Fraction(1, VIDEO_CLOCK_RATE)


class PlayerStreamTrack(MediaStreamTrack):
    """One outgoing media track fed by the engine's frame composer."""

    def __init__(self, player: "HumanPlayer", kind: str):
        super().__init__()
        self.kind = kind
        self._player = player
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=100)
        self._start_wall: Optional[float] = None
        self._timestamp = 0
        self._frame_count = 0
        self._fps_t0 = time.perf_counter()

    async def next_timestamp(self) -> tuple:
        if self.readyState != "live":
            raise Exception("track ended")
        video = self.kind == "video"
        rate = VIDEO_CLOCK_RATE if video else SAMPLE_RATE
        if self._start_wall is None:
            self._start_wall = time.time()
            self._timestamp = 0
        else:
            self._timestamp += 3600 if video else int(AUDIO_PTIME * SAMPLE_RATE)
            wait = self._start_wall + self._timestamp / rate - time.time()
            if wait > 0:
                await asyncio.sleep(wait)
            elif wait < -10 * (VIDEO_PTIME if video else AUDIO_PTIME):
                self._start_wall = time.time() - self._timestamp / rate  # fell far behind: resync
        return self._timestamp, VIDEO_TIME_BASE if video else AUDIO_TIME_BASE

    async def recv(self):
        self._player._start(self)
        frame, eventpoint = await self._queue.get()
        pts, time_base = await self.next_timestamp()
        frame.pts = pts
        frame.time_base = time_base
        if eventpoint:
            self._player.notify(eventpoint)

        self._frame_count += 1
        if self._frame_count >= 100:
            now = time.perf_counter()
            logger.info("%s final fps:%.4f", self.kind, self._frame_count / (now - self._fps_t0))
            self._frame_count = 0
            self._fps_t0 = now
        return frame

    def put_frame(self, frame, eventpoint=None) -> None:
        """Thread-safe enqueue from the render thread (drop-oldest)."""
        loop = self._player._loop
        if loop is None:
            return

        def _put():
            if self._queue.full():
                try:
                    self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    pass
            self._queue.put_nowait((frame, eventpoint))

        loop.call_soon_threadsafe(_put)

    def buffer_size(self) -> int:
        return self._queue.qsize()


class HumanPlayer:
    """Owns the audio+video tracks of one session and bridges the engine's
    streamout plugin to aiortc."""

    def __init__(self, avatar_session):
        self.avatar_session = avatar_session
        self.audio = PlayerStreamTrack(self, "audio")
        self.video = PlayerStreamTrack(self, "video")
        self._started = False
        self._quit: Optional[Event] = None
        self._thread: Optional[Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # wire ourselves into the session's streamout plugin
        output = getattr(avatar_session, "output", None)
        if output is not None:
            attach = getattr(output, "attach_player", None)
            if attach is not None:
                attach(self)
            elif hasattr(output, "_player"):
                output._player = self

    # -- engine side (render thread) -----------------------------------
    def push_video(self, frame_bgr: np.ndarray) -> None:
        frame = VideoFrame.from_ndarray(frame_bgr, format="bgr24")
        self.video.put_frame(frame)

    def push_audio(self, pcm16: np.ndarray, eventpoint=None) -> None:
        frame = AudioFrame(format="s16", layout="mono", samples=pcm16.shape[0])
        frame.planes[0].update(pcm16.astype(np.int16).tobytes())
        frame.sample_rate = SAMPLE_RATE
        self.audio.put_frame(frame, eventpoint)

    def get_buffer_size(self) -> int:
        return self.video.buffer_size()

    def notify(self, eventpoint) -> None:
        self.avatar_session.notify(eventpoint)

    # -- aiortc side ----------------------------------------------------
    def _start(self, track: PlayerStreamTrack) -> None:
        if self._started:
            return
        self._started = True
        self._loop = asyncio.get_event_loop()
        self._quit = Event()
        self._thread = Thread(
            target=self.avatar_session.render, args=(self._quit,),
            daemon=True, name=f"render-{self.avatar_session.sessionid}",
        )
        self._thread.start()

    def stop(self) -> None:
        if self._quit is not None:
            self._quit.set()
        self.audio.stop()
        self.video.stop()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
