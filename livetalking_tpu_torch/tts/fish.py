"""Fish-Speech TTS, HTTP streaming POST (ports livetalking_tpu/tts/fish.py).

POST ``{server}/v1/tts`` with ``{text, reference_id, format: wav,
streaming: true, use_memory_cache: on}``; the stream is consumed as raw
int16 PCM at 44.1 kHz.
"""

from __future__ import annotations

import time

import requests

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.logger import logger

SRC_SR = 44100


@register("tts", "fishtts")
class FishTTS(BaseTTS):
    def txt_to_audio(self, msg):
        text, textevent = msg
        ref_file = textevent.get("tts", {}).get("ref_file", self.opt.REF_FILE)
        self.stream_pcm16(self._request(text, ref_file, self.opt.TTS_SERVER), SRC_SR, msg)

    def _request(self, text, reffile, server_url):
        t0 = time.perf_counter()
        req = {
            "text": text,
            "reference_id": reffile,
            "format": "wav",
            "streaming": True,
            "use_memory_cache": "on",
        }
        try:
            res = requests.post(
                f"{server_url}/v1/tts", json=req, stream=True,
                headers={"content-type": "application/json"},
            )
            logger.info("fish_speech time to POST: %.3fs", time.perf_counter() - t0)
            if res.status_code != 200:
                logger.error("fishtts error: %s", res.text)
                return
            first = True
            for chunk in res.iter_content(chunk_size=17640):  # 44.1k * 20ms * 2B * 10
                if first:
                    logger.info("fish_speech time to first chunk: %.3fs", time.perf_counter() - t0)
                    first = False
                if chunk and self.state == State.RUNNING:
                    yield chunk
        except Exception:
            logger.exception("fishtts")
