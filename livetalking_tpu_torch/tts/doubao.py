"""Volcano Engine (Doubao) TTS over the binary WebSocket protocol (ports
livetalking_tpu/tts/doubao.py).

4-byte default header ``11 10 11 00``, gzip-compressed JSON payload prefixed
with its big-endian length; the server replies with audio-only messages
(type 0xb) whose payload is ``[seq:int32][size:uint32][pcm16 @ 16 kHz]``; a
negative sequence number ends the stream. Credentials via env
``DOUBAO_APPID`` / ``DOUBAO_TOKEN``.
"""

from __future__ import annotations

import asyncio
import copy
import gzip
import json
import os
import time
import uuid

import websockets

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.logger import logger


@register("tts", "doubao")
class DoubaoTTS(BaseTTS):
    def __init__(self, opt, parent):
        super().__init__(opt, parent)
        self.appid = os.getenv("DOUBAO_APPID")
        self.token = os.getenv("DOUBAO_TOKEN")
        self.api_url = getattr(
            opt, "doubao_url", "wss://openspeech.bytedance.com/api/v1/tts/ws_binary"
        )
        self.request_template = {
            "app": {"appid": self.appid, "token": "access_token", "cluster": "volcano_tts"},
            "user": {"uid": "livetalking"},
            "audio": {
                "voice_type": "", "encoding": "pcm", "rate": 16000,
                "speed_ratio": 1.0, "volume_ratio": 1.0, "pitch_ratio": 1.0,
            },
            "request": {"reqid": "", "text": "", "text_type": "plain", "operation": "submit"},
        }

    def txt_to_audio(self, msg):
        import queue as _q
        from threading import Thread

        text, textevent = msg
        voice = textevent.get("tts", {}).get("ref_file", self.opt.REF_FILE)

        pipe: "_q.Queue" = _q.Queue()
        _SENTINEL = object()

        def producer():
            loop = asyncio.new_event_loop()
            try:
                loop.run_until_complete(self._collect(text, voice, pipe))
            finally:
                loop.close()
                pipe.put(_SENTINEL)

        Thread(target=producer, daemon=True).start()

        def byte_iter():
            while True:
                item = pipe.get()
                if item is _SENTINEL:
                    return
                yield item

        self.stream_pcm16(byte_iter(), 16000, msg)

    async def _collect(self, text: str, voice: str, out) -> None:
        """Stream audio frames from the websocket into ``out`` as they
        arrive (the emission loop drains progressively)."""
        t0 = time.perf_counter()
        try:
            req = copy.deepcopy(self.request_template)
            req["user"]["uid"] = str(getattr(self.parent, "sessionid", "0"))
            req["audio"]["voice_type"] = voice
            req["request"]["text"] = text
            req["request"]["reqid"] = str(uuid.uuid4())
            payload = gzip.compress(json.dumps(req).encode())
            frame = bytearray(b"\x11\x10\x11\x00")
            frame.extend(len(payload).to_bytes(4, "big"))
            frame.extend(payload)

            headers = {"Authorization": f"Bearer; {self.token}"}
            first = True
            try:  # websockets >= 14 renamed extra_headers
                conn = websockets.connect(self.api_url, additional_headers=headers,
                                          ping_interval=None)
            except TypeError:
                conn = websockets.connect(self.api_url, extra_headers=headers,
                                          ping_interval=None)
            async with conn as ws:
                await ws.send(bytes(frame))
                while True:
                    res = await ws.recv()
                    header_size = res[0] & 0x0F
                    message_type = res[1] >> 4
                    flags = res[1] & 0x0F
                    payload = res[header_size * 4:]
                    if message_type != 0xB:
                        break
                    if flags == 0:  # ACK without audio
                        continue
                    if first:
                        logger.info("doubao time to first chunk: %.3fs", time.perf_counter() - t0)
                        first = False
                    seq = int.from_bytes(payload[:4], "big", signed=True)
                    out.put(payload[8:])
                    if seq < 0:
                        break
        except Exception:
            logger.exception("doubao")
