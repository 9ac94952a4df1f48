"""Deterministic offline TTS for tests, benches and air-gapped demos
(ports livetalking_tpu/tts/dummy.py).

Synthesizes a fixed-rate tone per character (~80 ms/char, 220-660 Hz by
char hash) so pipelines can be driven end-to-end with zero network.
"""

from __future__ import annotations

import numpy as np

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS


@register("tts", "dummy")
class DummyTTS(BaseTTS):
    SAMPLES_PER_CHAR = 1280  # 80 ms

    def txt_to_audio(self, msg):
        text, textevent = msg
        n = max(1, len(text)) * self.SAMPLES_PER_CHAR
        t = np.arange(n, dtype=np.float32) / self.sample_rate
        freq = 220.0 * (1 + (hash(text) % 3))
        stream = (0.3 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        self.emit_pcm(stream, text, textevent)
