"""Tencent Cloud streaming TTS, signed POST, 16 kHz PCM stream (ports
livetalking_tpu/tts/tencent.py).

HMAC-SHA1 signature over the sorted params against
``tts.cloud.tencent.com/stream``, action ``TextToStreamAudio``; the first
chunk may be a JSON error envelope, otherwise chunks are raw int16 16 kHz
PCM. Credentials from env ``TENCENT_APPID`` / ``TENCENT_SECRET_ID`` /
``TENCENT_SECRET_KEY``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time
import uuid

import requests

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.logger import logger

_HOST = "tts.cloud.tencent.com"
_PATH = "/stream"
_ACTION = "TextToStreamAudio"


@register("tts", "tencent")
class TencentTTS(BaseTTS):
    def __init__(self, opt, parent):
        super().__init__(opt, parent)
        self.appid = os.getenv("TENCENT_APPID")
        self.secret_id = os.getenv("TENCENT_SECRET_ID")
        self.secret_key = os.getenv("TENCENT_SECRET_KEY")
        self.voice = opt.REF_FILE or "101001"
        self.endpoint = getattr(opt, "tencent_endpoint", f"https://{_HOST}{_PATH}")

    def _signature(self, params: dict) -> str:
        sign_str = "POST" + _HOST + _PATH + "?" + "&".join(
            f"{k}={params[k]}" for k in sorted(params)
        )
        digest = hmac.new(self.secret_key.encode(), sign_str.encode(), hashlib.sha1).digest()
        return base64.b64encode(digest).decode()

    def _params(self, session_id: str, text: str, voice: str) -> dict:
        ts = int(time.time())
        return {
            "Action": _ACTION,
            "AppId": int(self.appid),
            "SecretId": self.secret_id,
            "ModelType": 1,
            "VoiceType": int(voice),
            "Codec": "pcm",
            "SampleRate": 16000,
            "Speed": 0,
            "Volume": 0,
            "SessionId": session_id,
            "Text": text,
            "Timestamp": ts,
            "Expired": ts + 24 * 3600,
        }

    def txt_to_audio(self, msg):
        text, textevent = msg
        voice = textevent.get("tts", {}).get("ref_file", self.voice)
        self.stream_pcm16(self._request(text, voice), 16000, msg)

    def _request(self, text, voice):
        t0 = time.perf_counter()
        params = self._params(str(uuid.uuid1()), text, voice)
        headers = {"Content-Type": "application/json", "Authorization": self._signature(params)}
        try:
            res = requests.post(self.endpoint, headers=headers,
                                data=json.dumps(params), stream=True)
            first = True
            for chunk in res.iter_content(chunk_size=6400):
                if first:
                    try:  # an error comes back as a JSON envelope
                        rsp = json.loads(chunk)
                        logger.error("tencent tts: %s", rsp["Response"]["Error"]["Message"])
                        return
                    except (ValueError, KeyError):
                        logger.info("tencent time to first chunk: %.3fs", time.perf_counter() - t0)
                        first = False
                if chunk and self.state == State.RUNNING:
                    yield chunk
        except Exception:
            logger.exception("tencent")
