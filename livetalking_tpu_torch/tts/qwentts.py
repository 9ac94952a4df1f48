"""Qwen-TTS realtime, DashScope SDK gated (ports livetalking_tpu/tts/qwentts.py).

One persistent realtime WebSocket session; each utterance is
``append_text`` + ``commit``; base64 24 kHz PCM deltas arrive in callbacks
and are resampled to 16 kHz with a remainder carried across deltas. Needs
env ``DASHSCOPE_API_KEY``.
"""

from __future__ import annotations

import base64
import os
import threading

import dashscope  # gated import
import numpy as np
from dashscope.audio.qwen_tts_realtime import (
    QwenTtsRealtime,
    QwenTtsRealtimeCallback,
)

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.audio import resample
from livetalking_tpu_torch.utils.logger import logger

SRC_SR = 24000


@register("tts", "qwentts")
class QwenTTS(BaseTTS):
    def __init__(self, opt, parent):
        super().__init__(opt, parent)
        self.voice = opt.REF_FILE or "Cherry"
        self.model = getattr(opt, "qwen_tts_model", "qwen3-tts-flash-realtime")
        api_key = os.environ.get("DASHSCOPE_API_KEY")
        if api_key:
            dashscope.api_key = api_key
        else:
            logger.warning("QwenTTS: DASHSCOPE_API_KEY not set")

        self._remainder = np.array([], np.float32)
        self._done = threading.Event()
        self._first = True
        self._text = ""
        self._textevent: dict = {}
        self._client = None

        outer = self

        class _Callback(QwenTtsRealtimeCallback):
            def on_open(self) -> None:
                logger.info("QwenTTS websocket open")

            def on_close(self, code, msg) -> None:
                logger.info("QwenTTS websocket closed: %s %s", code, msg)
                outer._done.set()

            def on_event(self, response: dict) -> None:
                kind = response.get("type", "")
                if kind == "response.audio.delta":
                    data = response.get("delta", "")
                    if data:
                        outer._on_audio(base64.b64decode(data))
                elif kind == "response.done":
                    outer._flush()
                    outer._done.set()
                elif kind == "error":
                    logger.error("QwenTTS error: %s", response)
                    outer._done.set()

        self._callback = _Callback()

    def _ensure_client(self):
        if self._client is None:
            self._client = QwenTtsRealtime(model=self.model, callback=self._callback,
                                           voice=self.voice)
            self._client.connect()
        return self._client

    def _emit(self, stream: np.ndarray) -> None:
        stream = np.concatenate([self._remainder, stream])
        idx = 0
        while stream.shape[0] - idx >= self.chunk and self.state == State.RUNNING:
            ev = {}
            if self._first:
                ev = {"status": "start", "text": self._text}
                self._first = False
            ev.update(**self._textevent)
            self.parent.put_audio_frame(stream[idx : idx + self.chunk], ev)
            idx += self.chunk
        self._remainder = stream[idx:]

    def _on_audio(self, pcm: bytes) -> None:
        x = np.frombuffer(pcm, dtype=np.int16).astype(np.float32) / 32767.0
        self._emit(resample(x, SRC_SR, 16000))

    def _flush(self) -> None:
        ev = {"status": "end", "text": self._text}
        ev.update(**self._textevent)
        self.parent.put_audio_frame(np.zeros(self.chunk, np.float32), ev)
        self._remainder = np.array([], np.float32)

    def txt_to_audio(self, msg):
        text, textevent = msg
        self._text = text
        self._textevent = textevent
        self._first = True
        self._done.clear()
        client = self._ensure_client()
        client.append_text(text)
        client.commit()
        self._done.wait(timeout=60)

    def stop_tts(self):
        if self._client is not None:
            try:
                self._client.close()
            except Exception:
                pass
