"""vLLM-Omni / OpenAI-compatible speech endpoint TTS (ports
livetalking_tpu/tts/omnitts.py).

POST ``{server}/v1/audio/speech`` with ``{input, voice, response_format:
pcm, stream: true}``; the response streams raw int16 PCM at a configurable
source rate (24 kHz default, ``omni_sr`` on the options).
"""

from __future__ import annotations

import time

import requests

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.logger import logger


@register("tts", "omnitts")
class OmniTTS(BaseTTS):
    def __init__(self, opt, parent):
        super().__init__(opt, parent)
        self.server_url = opt.TTS_SERVER.rstrip("/")
        self.src_sr = int(getattr(opt, "omni_sr", 24000))
        self.voice = opt.REF_FILE or "default"

    def txt_to_audio(self, msg):
        text, textevent = msg
        voice = textevent.get("tts", {}).get("ref_file", self.voice)
        self.stream_pcm16(self._request(text, voice), self.src_sr, msg)

    def _request(self, text, voice):
        t0 = time.perf_counter()
        body = {"input": text, "voice": voice, "response_format": "pcm", "stream": True}
        url = f"{self.server_url}/v1/audio/speech"
        try:
            res = requests.post(url, json=body, stream=True,
                                headers={"Content-Type": "application/json"})
            if res.status_code != 200:
                logger.error("omnitts error: %s", res.text)
                return
            first = True
            for chunk in res.iter_content(chunk_size=self.src_sr // 25):
                if first:
                    logger.info("omnitts time to first chunk: %.3fs", time.perf_counter() - t0)
                    first = False
                if chunk and self.state == State.RUNNING:
                    yield chunk
        except Exception:
            logger.exception("omnitts")
