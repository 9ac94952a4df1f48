"""Microsoft Edge TTS plugin (ports livetalking_tpu/tts/edge.py;
non-streaming: buffers the whole utterance).

The voice comes from ``REF_FILE`` or a per-message ``tts.ref_file``
override; the MP3 is decoded (the native decoder first) and resampled to
16 kHz mono, then emitted as 20 ms chunks with start/end eventpoints.
Requires the ``edge_tts`` package (network service).
"""

from __future__ import annotations

import asyncio
import io
import time

import edge_tts  # gated import: module load fails cleanly when absent

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.audio import load_pcm16k
from livetalking_tpu_torch.utils.logger import logger


@register("tts", "edgetts")
class EdgeTTS(BaseTTS):
    def txt_to_audio(self, msg):
        text, textevent = msg
        voice = textevent.get("tts", {}).get(
            "ref_file", self.opt.REF_FILE or "zh-CN-YunxiaNeural"
        )
        t0 = time.time()
        buf = io.BytesIO()
        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(self._synth(voice, text, buf))
        finally:
            loop.close()
        logger.info("-------edge tts time:%.4fs", time.time() - t0)
        if buf.getbuffer().nbytes <= 0:
            logger.error("edgetts returned no audio")
            return
        stream = load_pcm16k(buf.getvalue())
        self.emit_pcm(stream, text, textevent)

    async def _synth(self, voice: str, text: str, buf: io.BytesIO) -> None:
        try:
            communicate = edge_tts.Communicate(text, voice)
            async for chunk in communicate.stream():
                if chunk["type"] == "audio" and self.state == State.RUNNING:
                    buf.write(chunk["data"])
        except Exception:
            logger.exception("edgetts")
