"""Coqui XTTS streaming TTS (ports livetalking_tpu/tts/xtts.py).

One-time ``POST {server}/clone_speaker`` with the reference wav to obtain
the speaker embedding dict, then per utterance ``POST {server}/tts_stream``
with ``{**speaker, text, language, stream_chunk_size}`` streaming raw int16
PCM at 24 kHz.
"""

from __future__ import annotations

import time

import requests

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.logger import logger

SRC_SR = 24000


@register("tts", "xtts")
class XTTS(BaseTTS):
    def __init__(self, opt, parent):
        super().__init__(opt, parent)
        self.speaker = None  # lazily cloned on first utterance

    def _get_speaker(self, ref_audio: str, server_url: str) -> dict:
        with open(ref_audio, "rb") as f:
            files = {"wav_file": ("reference.wav", f)}
            response = requests.post(f"{server_url}/clone_speaker", files=files)
        return response.json()

    def txt_to_audio(self, msg):
        text, textevent = msg
        if self.speaker is None:
            self.speaker = self._get_speaker(self.opt.REF_FILE, self.opt.TTS_SERVER)
        self.stream_pcm16(
            self._request(text, "zh-cn", self.opt.TTS_SERVER, "20"), SRC_SR, msg
        )

    def _request(self, text, language, server_url, stream_chunk_size):
        t0 = time.perf_counter()
        body = dict(self.speaker)
        body.update({"text": text, "language": language,
                     "stream_chunk_size": stream_chunk_size})
        try:
            res = requests.post(f"{server_url}/tts_stream", json=body, stream=True)
            if res.status_code != 200:
                logger.error("xtts error: %s", res.text)
                return
            first = True
            for chunk in res.iter_content(chunk_size=None):
                if first:
                    logger.info("xtts time to first chunk: %.3fs", time.perf_counter() - t0)
                    first = False
                if chunk and self.state == State.RUNNING:
                    yield chunk
        except Exception:
            logger.exception("xtts")
