"""IndexTTS2 via a Gradio server, gated on ``gradio_client`` (ports
livetalking_tpu/tts/indextts2.py).

The text is split into sentence segments, each synthesized through the
Gradio ``/gen_single`` endpoint with an uploaded reference voice, decoded
and emitted as 20 ms frames: one start on the first segment, one end on a
trailing silence frame.
"""

from __future__ import annotations

import re
import time

import numpy as np

from gradio_client import Client, handle_file  # gated import

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.audio import load_pcm16k
from livetalking_tpu_torch.utils.logger import logger

_SENT_SPLIT = re.compile(r"(?<=[。！？!?.;；])")


@register("tts", "indextts2")
class IndexTTS2(BaseTTS):
    def __init__(self, opt, parent):
        super().__init__(opt, parent)
        self.client = Client(opt.TTS_SERVER)
        self.ref_audio = opt.REF_FILE

    def txt_to_audio(self, msg):
        text, textevent = msg
        ref = textevent.get("tts", {}).get("ref_file", self.ref_audio)
        segments = [s for s in _SENT_SPLIT.split(text) if s.strip()] or [text]
        first = True
        for seg in segments:
            if self.state != State.RUNNING:
                break
            t0 = time.perf_counter()
            try:
                result = self.client.predict(
                    prompt=handle_file(ref), text=seg, api_name="/gen_single"
                )
            except Exception:
                logger.exception("indextts2 segment failed")
                continue
            path = result.get("value") if isinstance(result, dict) else result
            logger.info("indextts2 segment %.3fs", time.perf_counter() - t0)
            stream = load_pcm16k(path)
            # exactly one start (first successful segment) and one end
            # (trailing silence chunk below) per message
            self.emit_pcm(stream, text, textevent,
                          emit_start=first, emit_end=False)
            first = False
        if not first and self.state == State.RUNNING:
            tail = {"status": "end", "text": text}
            tail.update(**textevent)
            self.parent.put_audio_frame(
                np.zeros(self.chunk, np.float32), tail)
