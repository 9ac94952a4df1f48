"""TTS plugin base class (ports livetalking_tpu/tts/base.py).

``msgqueue`` of ``(text, datainfo)``; a worker thread loops
``process_tts``; ``flush_talk`` clears the queue and flips state to PAUSE
so an in-flight synthesis stops emitting chunks mid-utterance.
"""

from __future__ import annotations

import queue
from enum import Enum
from queue import Queue
from threading import Thread
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

from livetalking_tpu_torch.utils.audio import resample
from livetalking_tpu_torch.utils.logger import logger

if TYPE_CHECKING:  # pragma: no cover
    from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar


class State(Enum):
    RUNNING = 0
    PAUSE = 1


class BaseTTS:
    def __init__(self, opt, parent: "BaseAvatar"):
        self.opt = opt
        self.parent = parent
        self.sample_rate = 16000
        self.chunk = self.sample_rate // (opt.fps * 2)  # 320 samples / 20 ms
        self.msgqueue: Queue[Tuple[str, dict]] = Queue()
        self.state = State.RUNNING

    def flush_talk(self) -> None:
        self.msgqueue.queue.clear()
        self.state = State.PAUSE

    def put_msg_txt(self, msg: str, datainfo: Optional[dict] = None) -> None:
        if msg:
            self.msgqueue.put((msg, datainfo or {}))

    def render(self, quit_event) -> None:
        Thread(target=self.process_tts, args=(quit_event,), daemon=True).start()

    def process_tts(self, quit_event) -> None:
        while not quit_event.is_set():
            try:
                msg = self.msgqueue.get(block=True, timeout=1)
                self.state = State.RUNNING
            except queue.Empty:
                continue
            try:
                self.txt_to_audio(msg)
            except Exception:
                logger.exception("tts plugin error; utterance dropped")
        self.stop_tts()
        logger.info("tts thread stop")

    def emit_pcm(self, stream: np.ndarray, text: str, textevent: dict,
                 emit_start: bool = True, emit_end: bool = True) -> None:
        """Chunk a full 16 kHz float32 utterance into 20 ms frames with
        start/end eventpoints and feed the parent."""
        streamlen = stream.shape[0]
        idx = 0
        while streamlen >= self.chunk and self.state == State.RUNNING:
            eventpoint = {}
            streamlen -= self.chunk
            if idx == 0 and emit_start:
                eventpoint = {"status": "start", "text": text}
            elif streamlen < self.chunk and emit_end:
                eventpoint = {"status": "end", "text": text}
            eventpoint.update(**textevent)
            self.parent.put_audio_frame(stream[idx : idx + self.chunk], eventpoint)
            idx += self.chunk

    def stream_pcm16(self, byte_iter, src_sr: int, msg: Tuple[str, dict]) -> None:
        """Progressively emit a raw int16 PCM byte stream as 20 ms frames.

        Per chunk: convert, resample to 16 kHz, emit whole 20 ms frames,
        carrying the remainder (and any odd byte) to the next chunk. The
        ``start`` eventpoint rides the first frame and a trailing silence
        frame carries ``end``; under ``State.PAUSE`` no further speech
        frame is emitted.
        """
        text, textevent = msg
        first = True
        carry_bytes = b""
        carry = np.array([], np.float32)
        for chunk in byte_iter:
            if not chunk:
                continue
            data = carry_bytes + chunk
            if len(data) % 2:
                data, carry_bytes = data[:-1], data[-1:]
            else:
                carry_bytes = b""
            stream = np.frombuffer(data, dtype=np.int16).astype(np.float32) / 32767.0
            if src_sr != self.sample_rate:
                stream = resample(stream, src_sr, self.sample_rate)
            stream = np.concatenate([carry, stream])
            idx = 0
            n = stream.shape[0]
            while n - idx >= self.chunk and self.state == State.RUNNING:
                eventpoint = {}
                if first:
                    eventpoint = {"status": "start", "text": text}
                    first = False
                eventpoint.update(**textevent)
                self.parent.put_audio_frame(stream[idx : idx + self.chunk], eventpoint)
                idx += self.chunk
            carry = stream[idx:]
        endpoint = {"status": "end", "text": text}
        endpoint.update(**textevent)
        self.parent.put_audio_frame(np.zeros(self.chunk, np.float32), endpoint)

    def txt_to_audio(self, msg: Tuple[str, dict]) -> None:
        raise NotImplementedError

    def stop_tts(self) -> None:
        pass
