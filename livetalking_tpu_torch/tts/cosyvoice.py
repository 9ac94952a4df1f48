"""CosyVoice zero-shot TTS, HTTP streaming GET with a prompt wav upload
(ports livetalking_tpu/tts/cosyvoice.py).

GET ``{server}/inference_zero_shot`` with form data ``{tts_text,
prompt_text}`` and the prompt wav as a multipart file; the response streams
raw int16 PCM at 24 kHz in 9600-byte chunks.
"""

from __future__ import annotations

import time

import requests

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.logger import logger

SRC_SR = 24000


@register("tts", "cosyvoice")
class CosyVoiceTTS(BaseTTS):
    def txt_to_audio(self, msg):
        text, textevent = msg
        ref_file = textevent.get("tts", {}).get("ref_file", self.opt.REF_FILE)
        ref_text = textevent.get("tts", {}).get("ref_text", self.opt.REF_TEXT)
        self.stream_pcm16(
            self._request(text, ref_file, ref_text, self.opt.TTS_SERVER), SRC_SR, msg
        )

    def _request(self, text, reffile, reftext, server_url):
        t0 = time.perf_counter()
        payload = {"tts_text": text, "prompt_text": reftext}
        try:
            with open(reffile, "rb") as f:
                files = [("prompt_wav", ("prompt_wav", f, "application/octet-stream"))]
                res = requests.request(
                    "GET", f"{server_url}/inference_zero_shot",
                    data=payload, files=files, stream=True,
                )
            logger.info("cosy_voice time to request: %.3fs", time.perf_counter() - t0)
            if res.status_code != 200:
                logger.error("cosyvoice error: %s", res.text)
                return
            first = True
            for chunk in res.iter_content(chunk_size=9600):  # 24k * 20ms * 2B * 10
                if first:
                    logger.info("cosy_voice time to first chunk: %.3fs", time.perf_counter() - t0)
                    first = False
                if chunk and self.state == State.RUNNING:
                    yield chunk
        except Exception:
            logger.exception("cosyvoice")
