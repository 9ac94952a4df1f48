"""Local STT WebSocket endpoint speaking the FunASR client protocol (ports
livetalking_tpu/server/asr_server.py).

Mirrors the reference's ``/api/asr`` (reference server/asr_server.py:
124-256): the browser sends a JSON config (``is_speaking: true``), streams
binary PCM16 chunks, then ``is_speaking: false``; the server replies with
``{"text", "mode", "is_final", "timestamp"}``. The backend is Whisper-tiny
on the card (``WhisperTorchSTT``: models/whisper_encoder.py +
models/whisper_decoder.py).

Loading semantics match the reference (reference server/asr_server.py:
33-67): lazy singleton with double-checked locking, and inference
serialized by a lock (one decode at a time on the card; concurrent
requests queue). ``aiohttp`` is imported only by the handler, and
``transformers`` only by the checkpoint loader.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
import zlib
from typing import Optional, Protocol

import numpy as np
import torch

from livetalking_tpu_torch.models import whisper_decoder as wd
from livetalking_tpu_torch.models import whisper_encoder as we
from livetalking_tpu_torch.ops.whisper_mel import log_mel_spectrogram
from livetalking_tpu_torch.server.textnorm import postprocess
from livetalking_tpu_torch.utils.audio import resample
from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.logger import logger

SAMPLE_RATE = 16000  # browser client records 16 kHz mono PCM16

# OpenAI Whisper's decoding fallback bar: gzip ratio above this means the
# text is a repetition loop
COMPRESSION_RATIO_THRESHOLD = 2.4
TEMPERATURES = (0.0, 0.3, 0.6)


def compression_ratio(text: str) -> float:
    """len(bytes)/len(gzip(bytes)) — degenerate repetitions compress far
    better than natural language."""
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


class SttBackend(Protocol):
    def transcribe(self, audio: np.ndarray, sample_rate: int,
                   language: str = "auto") -> str:
        """float32 PCM in [-1,1] -> transcript text. Blocking."""
        ...


class WhisperTorchSTT:
    """Whisper STT on the card: whisper log-mel (ops/whisper_mel.py) ->
    encoder final hidden state -> language detection -> KV-cached greedy
    decode with the temperature ladder 0 / 0.3 / 0.6, retried while the
    transcript's ``compression_ratio`` exceeds the bar.

    Built from parameter dictionaries and a tokenizer (any object with
    ``decode(ids, skip_special_tokens=True)``); ``from_pretrained`` loads
    an HF checkpoint directory."""

    def __init__(self, enc_params, dec_params, tokenizer, enc_cfg: we.WhisperConfig = we.TINY,
                 dec_cfg: wd.WhisperDecoderConfig = wd.TINY_DECODER, max_new: int = 128,
                 dtype=torch.bfloat16, device="cuda"):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.enc_params, self.dec_params = enc_params, dec_params
        self.enc_cfg, self.cfg = enc_cfg, dec_cfg
        self.max_new = max_new
        self._tokenizer = tokenizer
        self._decode = wd.make_greedy_decode(dec_params, dec_cfg, max_new=max_new, dtype=dtype)
        ids = torch.arange(dec_cfg.vocab_size, device=self.device)
        # language tokens end at task_transcribe-2; task_transcribe-1 is <|translate|>
        self._is_lang = (ids >= dec_cfg.lang_en) & (ids < dec_cfg.task_transcribe - 1)

    @classmethod
    def from_pretrained(cls, models_dir: str = "./models", max_new: int = 128, device="cuda"):
        """HF ``WhisperModel`` and ``WhisperTokenizer`` from
        ``models_dir/whisper``, bf16, through the port's converters."""
        dev = resolve_device(device)
        import transformers

        wdir = os.path.join(models_dir, "whisper")
        t0 = time.perf_counter()
        sd = transformers.WhisperModel.from_pretrained(wdir).state_dict()
        dtype = torch.bfloat16
        enc = we.convert_torch_state_dict(sd, we.TINY, dtype, dev)
        dec = wd.convert_torch_state_dict(sd, wd.TINY_DECODER, dtype, dev)
        tok = transformers.WhisperTokenizer.from_pretrained(wdir)
        del sd
        stt = cls(enc, dec, tok, max_new=max_new, dtype=dtype, device=dev)
        logger.info("[ASR] WhisperTorchSTT ready in %.1fs (weights: %s)",
                    time.perf_counter() - t0, wdir)
        return stt

    @torch.no_grad()
    def encode(self, audio: np.ndarray) -> torch.Tensor:
        """16 kHz float32 PCM (<= 30 s) -> final encoder state (1, 1500, D)."""
        x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(self.device)
        mel = log_mel_spectrogram(x)[None]  # (1, 80, 3000)
        return we.apply_stacked(self.enc_params, self.enc_cfg, mel.to(self.dtype))[:, :, -1, :]

    @torch.no_grad()
    def detect_language(self, enc: torch.Tensor) -> int:
        """Logits from <|sot|> alone (a 2-slot cache), masked to the
        language-token block."""
        cfg = self.cfg
        cross_kv = wd.precompute_cross_kv(self.dec_params, cfg, enc)
        caches = wd.empty_caches(cfg, 1, 2, self.dtype, self.device)
        sot = torch.tensor([cfg.sot], device=self.device)
        logits, _ = wd.decode_step(self.dec_params, cfg, sot, 0, caches, cross_kv)
        return int(torch.argmax(logits.masked_fill(~self._is_lang, float("-inf")), dim=-1)[0])

    def decode(self, enc: torch.Tensor, prompt: torch.Tensor, temperature: float = 0.0,
               seed: int = 0):
        return self._decode(enc, prompt, temperature=temperature, seed=seed)

    def transcribe(self, audio: np.ndarray, sample_rate: int, language: str = "auto") -> str:
        if sample_rate != SAMPLE_RATE:
            audio = resample(audio, sample_rate, SAMPLE_RATE)
        audio = audio[: SAMPLE_RATE * 30].astype(np.float32)
        enc = self.encode(audio)

        cfg = self.cfg
        if language == "zh":
            lang_tok = cfg.lang_zh
        elif language == "en":
            lang_tok = cfg.lang_en
        else:
            lang_tok = self.detect_language(enc)
        prompt = torch.tensor([[cfg.sot, lang_tok, cfg.task_transcribe, cfg.no_timestamps]],
                              device=self.device)
        # Whisper-style temperature fallback: a transcript that gzip
        # compresses too well is a degenerate repetition loop
        text = ""
        for temperature in TEMPERATURES:
            tokens, n_valid = self.decode(enc, prompt, temperature=temperature,
                                          seed=int(temperature * 10))
            ids = tokens[0].cpu().numpy()[: int(n_valid[0])]
            text = self._tokenizer.decode(ids, skip_special_tokens=True).strip()
            if compression_ratio(text) <= COMPRESSION_RATIO_THRESHOLD:
                break
            logger.warning("[ASR] degenerate transcript at T=%.1f "
                           "(compression ratio %.2f) - retrying",
                           temperature, compression_ratio(text))
        return text


# --- lazy singleton loader (reference server/asr_server.py:28-67) --------

_stt_backend: Optional[SttBackend] = None
_stt_device = "cuda"
_stt_load_lock = threading.Lock()
_stt_inference_lock = threading.Lock()


def set_stt_backend(backend: Optional[SttBackend]) -> None:
    """Inject/replace the STT backend (tests, alternate engines)."""
    global _stt_backend
    _stt_backend = backend


def set_stt_device(device) -> None:
    """The device the lazy loader builds the backend on (the server's
    ``--device``; the card by default)."""
    global _stt_device
    _stt_device = str(device)


def _whisper_dir() -> str:
    return os.path.join(os.environ.get("LIVETALKING_MODELS_DIR", "./models"), "whisper")


def is_funasr_available() -> bool:
    """Availability gate (name kept for parity with the reference import
    site): True when a backend is injected or local whisper weights exist."""
    if _stt_backend is not None:
        return True
    return os.path.isdir(_whisper_dir())


def _load_stt() -> SttBackend:
    """Lazy singleton with double-checked locking: concurrent first
    requests share one model initialization."""
    global _stt_backend
    if _stt_backend is not None:
        return _stt_backend
    with _stt_load_lock:
        if _stt_backend is not None:
            return _stt_backend
        logger.info("[ASR] loading Whisper-tiny STT on %s (first request)...", _stt_device)
        _stt_backend = WhisperTorchSTT.from_pretrained(
            models_dir=os.path.dirname(_whisper_dir()), device=_stt_device)
    return _stt_backend


def _run_inference(audio_float32: np.ndarray, sample_rate: int, language: str):
    """Blocking transcription — call from ``run_in_executor``. Returns
    (text, inference_ms, audio_duration_s)."""
    backend = _load_stt()
    t0 = time.perf_counter()
    with _stt_inference_lock:
        text = backend.transcribe(audio_float32, sample_rate, language)
    inference_ms = (time.perf_counter() - t0) * 1000
    audio_duration_s = len(audio_float32) / sample_rate
    logger.info(
        "[ASR] inference done: %.0f ms for %.1f s audio (RTF %.3f): %r",
        inference_ms, audio_duration_s,
        inference_ms / 1000 / max(audio_duration_s, 1e-3), text[:100])
    return text, inference_ms, audio_duration_s


# --- WebSocket handler ----------------------------------------------------

async def asr_websocket_handler(request):
    """FunASR-protocol handler (see module docstring for the flow)."""
    from aiohttp import web

    ws = web.WebSocketResponse()
    await ws.prepare(request)
    logger.info("[ASR] websocket connected from %s", request.remote)

    audio_buffer = bytearray()
    config: dict = {}
    chunks = 0

    try:
        async for msg in ws:
            if msg.type == web.WSMsgType.TEXT:
                try:
                    data = json.loads(msg.data)
                except json.JSONDecodeError:
                    logger.warning("[ASR] invalid JSON ignored")
                    continue

                if data.get("is_speaking") is True:
                    config = data
                    audio_buffer = bytearray()
                    chunks = 0
                    logger.info("[ASR] recording started (mode=%s itn=%s)",
                                config.get("mode", "offline"), config.get("itn", True))

                elif data.get("is_speaking") is False:
                    nbytes = len(audio_buffer)
                    logger.info("[ASR] recording stopped: %d chunks, %d bytes", chunks, nbytes)
                    mode = config.get("mode", "offline")
                    response_mode = "2pass-offline" if mode == "2pass" else mode

                    if nbytes < 640:  # < 20 ms
                        await ws.send_str(json.dumps({
                            "text": "", "mode": response_mode,
                            "is_final": True, "timestamp": None}))
                        continue
                    if nbytes % 2:
                        audio_buffer = audio_buffer[:-1]

                    pcm = np.frombuffer(bytes(audio_buffer), np.int16)
                    audio = pcm.astype(np.float32) / 32768.0
                    loop = asyncio.get_event_loop()
                    try:
                        text, _, _ = await loop.run_in_executor(
                            None, _run_inference, audio, SAMPLE_RATE,
                            config.get("language", "auto"))
                        if text:
                            # SenseVoice-parity transcript post-pass:
                            # punctuation + (protocol-flagged) ITN
                            text = postprocess(text, itn=bool(config.get("itn", True)))
                    except Exception:
                        logger.exception("[ASR] inference failed")
                        text = ""

                    await ws.send_str(json.dumps({
                        "text": text, "mode": response_mode,
                        "is_final": True, "timestamp": None}))

            elif msg.type == web.WSMsgType.BINARY:
                audio_buffer.extend(msg.data)
                chunks += 1
            elif msg.type in (web.WSMsgType.ERROR, web.WSMsgType.CLOSE):
                break
    except asyncio.CancelledError:
        logger.info("[ASR] websocket handler cancelled")
    except Exception:
        logger.exception("[ASR] websocket handler error")

    logger.info("[ASR] websocket disconnected (%s)", request.remote)
    return ws
