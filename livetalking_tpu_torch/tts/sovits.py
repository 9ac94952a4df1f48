"""GPT-SoVITS voice-clone TTS, HTTP chunked streaming (ports
livetalking_tpu/tts/sovits.py).

POST ``{server}/tts`` with ``{text, text_lang, ref_audio_path, prompt_text,
prompt_lang, media_type: ogg, streaming_mode: true}``; each streamed chunk
is a self-contained ogg segment decoded and emitted progressively.
"""

from __future__ import annotations

import time

import numpy as np
import requests

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.audio import load_pcm16k
from livetalking_tpu_torch.utils.logger import logger


@register("tts", "gpt-sovits")
class SovitsTTS(BaseTTS):
    def txt_to_audio(self, msg):
        text, textevent = msg
        ref_file = textevent.get("tts", {}).get("ref_file", self.opt.REF_FILE)
        ref_text = textevent.get("tts", {}).get("ref_text", self.opt.REF_TEXT)

        first = True
        t0 = time.perf_counter()
        for chunk in self._request(text, ref_file, ref_text, "zh", self.opt.TTS_SERVER):
            try:
                stream = load_pcm16k(chunk)  # decode one ogg segment
            except Exception:
                logger.exception("sovits chunk decode failed")
                continue
            eventinfo = dict(textevent)
            idx = 0
            n = stream.shape[0]
            while n - idx >= self.chunk and self.state == State.RUNNING:
                ev = {}
                if first:
                    ev = {"status": "start", "text": text}
                    first = False
                ev.update(**eventinfo)
                self.parent.put_audio_frame(stream[idx : idx + self.chunk], ev)
                idx += self.chunk
        endpoint = {"status": "end", "text": text}
        endpoint.update(**textevent)
        self.parent.put_audio_frame(np.zeros(self.chunk, np.float32), endpoint)
        logger.info("sovits utterance done in %.3fs", time.perf_counter() - t0)

    def _request(self, text, reffile, reftext, language, server_url):
        t0 = time.perf_counter()
        req = {
            "text": text,
            "text_lang": language,
            "ref_audio_path": reffile,
            "prompt_text": reftext,
            "prompt_lang": language,
            "media_type": "ogg",
            "streaming_mode": True,
        }
        try:
            res = requests.post(f"{server_url}/tts", json=req, stream=True)
            logger.info("gpt_sovits time to POST: %.3fs", time.perf_counter() - t0)
            if res.status_code != 200:
                logger.error("sovits error: %s", res.text)
                return
            first = True
            for chunk in res.iter_content(chunk_size=None):
                if first:
                    logger.info("gpt_sovits time to first chunk: %.3fs", time.perf_counter() - t0)
                    first = False
                if chunk and self.state == State.RUNNING:
                    yield chunk
        except Exception:
            logger.exception("sovits")
