"""Virtual camera output (pyvirtualcam) + local speaker playback (PyAudio)
(ports livetalking_tpu/streamout/virtualcam.py).

Lazy camera init from the first frame's dimensions, BGR->RGB,
``sleep_until_next_frame`` pacing; audio plays on a separate PyAudio thread
with the output device selectable via ``--audio_output_device``.
``pyvirtualcam`` is a gated import (the module fails to import without
it); without ``pyaudio`` the camera runs without speakers.
"""

from __future__ import annotations

import queue
from threading import Thread
from typing import Optional

import numpy as np
import pyvirtualcam  # gated import

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.streamout.base import BaseOutput
from livetalking_tpu_torch.utils.logger import logger

try:
    import pyaudio
except ImportError:  # camera can still work without speakers
    pyaudio = None


@register("streamout", "virtualcam")
class VirtualCamOutput(BaseOutput):
    def __init__(self, opt=None, parent=None, **kw):
        super().__init__(opt, parent)
        self._cam: Optional["pyvirtualcam.Camera"] = None
        self._audio_queue: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=200)
        self._audio_thread: Optional[Thread] = None
        self._running = False

    def start(self) -> None:
        self._running = True
        if pyaudio is not None:
            self._audio_thread = Thread(target=self._audio_loop, daemon=True)
            self._audio_thread.start()
        else:
            logger.warning("pyaudio unavailable - virtualcam runs without speakers")

    def _audio_loop(self) -> None:
        pa = pyaudio.PyAudio()
        device = getattr(self.opt, "audio_output_device", None)
        stream = pa.open(format=pyaudio.paInt16, channels=1, rate=16000,
                         output=True, output_device_index=device)
        while self._running:
            try:
                pcm = self._audio_queue.get(timeout=0.5)
            except queue.Empty:
                continue
            stream.write(pcm.tobytes())
        stream.stop_stream()
        stream.close()
        pa.terminate()

    def push_video_frame(self, frame: np.ndarray) -> None:
        if self._cam is None:
            h, w = frame.shape[:2]
            self._cam = pyvirtualcam.Camera(width=w, height=h,
                                            fps=getattr(self.opt, "fps", 25))
            logger.info("virtualcam started: %dx%d -> %s", w, h, self._cam.device)
        self._cam.send(frame[..., ::-1])  # BGR -> RGB
        self._cam.sleep_until_next_frame()

    def push_audio_frame(self, frame: np.ndarray, eventpoint=None) -> None:
        try:
            self._audio_queue.put_nowait(np.asarray(frame, np.int16))
        except queue.Full:
            pass
        if eventpoint and self.parent is not None:
            self.parent.notify(eventpoint)

    def stop(self) -> None:
        self._running = False
        if self._cam is not None:
            self._cam.close()
            self._cam = None
