"""Azure Cognitive Services TTS, SDK gated (ports livetalking_tpu/tts/azure.py).

A persistent SpeechSynthesizer configured for Raw16Khz16BitMonoPcm, emitting
20 ms frames from the ``synthesizing`` callback as audio arrives.
Credentials via env ``AZURE_SPEECH_KEY`` / ``AZURE_TTS_REGION``.
"""

from __future__ import annotations

import os

import azure.cognitiveservices.speech as speechsdk  # gated import
import numpy as np

from livetalking_tpu_torch.registry import register
from livetalking_tpu_torch.tts.base import BaseTTS, State
from livetalking_tpu_torch.utils.logger import logger


@register("tts", "azuretts")
class AzureTTS(BaseTTS):
    CHUNK_BYTES = 640  # 20 ms of 16 kHz s16 mono

    def __init__(self, opt, parent):
        super().__init__(opt, parent)
        self.audio_buffer = b""
        self.voice = opt.REF_FILE or "zh-CN-XiaoxiaoMultilingualNeural"
        speech_key = os.getenv("AZURE_SPEECH_KEY")
        region = os.getenv("AZURE_TTS_REGION")
        endpoint = f"wss://{region}.tts.speech.microsoft.com/cognitiveservices/websocket/v2"
        self.speech_config = speechsdk.SpeechConfig(subscription=speech_key, endpoint=endpoint)
        self.speech_config.speech_synthesis_voice_name = self.voice
        self.speech_config.set_speech_synthesis_output_format(
            speechsdk.SpeechSynthesisOutputFormat.Raw16Khz16BitMonoPcm
        )
        self.synthesizer = speechsdk.SpeechSynthesizer(
            speech_config=self.speech_config, audio_config=None
        )
        self.synthesizer.synthesizing.connect(self._on_synthesizing)

    def txt_to_audio(self, msg):
        text, textevent = msg
        voice = textevent.get("tts", {}).get("ref_file", self.voice)
        if voice != self.speech_config.speech_synthesis_voice_name:
            # the synthesizer snapshots its config at construction: a new
            # voice needs a fresh synthesizer, not a config mutation
            self.speech_config.speech_synthesis_voice_name = voice
            self.synthesizer = speechsdk.SpeechSynthesizer(
                speech_config=self.speech_config, audio_config=None
            )
            self.synthesizer.synthesizing.connect(self._on_synthesizing)
        result = self.synthesizer.speak_text(text)
        try:
            fb = result.properties.get_property(
                speechsdk.PropertyId.SpeechServiceResponse_SynthesisFirstByteLatencyMs)
            fin = result.properties.get_property(
                speechsdk.PropertyId.SpeechServiceResponse_SynthesisFinishLatencyMs)
            logger.info("azure tts first-byte %sms finish %sms", fb, fin)
        except Exception:
            pass

    def _on_synthesizing(self, evt) -> None:
        if evt.result.reason == speechsdk.ResultReason.Canceled:
            logger.info("azure synthesis canceled: %s", evt.result.cancellation_details.reason)
        if self.state != State.RUNNING:
            self.audio_buffer = b""
            return
        self.audio_buffer += evt.result.audio_data
        while len(self.audio_buffer) >= self.CHUNK_BYTES:
            chunk, self.audio_buffer = (
                self.audio_buffer[: self.CHUNK_BYTES],
                self.audio_buffer[self.CHUNK_BYTES :],
            )
            frame = np.frombuffer(chunk, dtype=np.int16).astype(np.float32) / 32767.0
            self.parent.put_audio_frame(frame)
