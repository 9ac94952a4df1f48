"""Host-side audio decode + resample (ports livetalking_tpu/utils/audio.py).

The engine contract is 16 kHz mono float32. WAV decodes with stdlib
``wave``/numpy; other containers go through ``soundfile`` or the ``ffmpeg``
CLI when present (the first-party native decoder of the reference package
comes with a later slice). Resampling is ``scipy.signal.resample_poly``.
"""

from __future__ import annotations

import io
import shutil
import subprocess
import wave
from fractions import Fraction
from typing import Tuple, Union

import numpy as np

TARGET_SR = 16000


def resample(x: np.ndarray, sr_orig: int, sr_new: int) -> np.ndarray:
    """Polyphase resample float32 mono audio."""
    if sr_orig == sr_new or x.shape[0] == 0:
        return x.astype(np.float32, copy=False)
    from scipy.signal import resample_poly

    frac = Fraction(sr_new, sr_orig).limit_denominator(1000)
    y = resample_poly(x.astype(np.float64), frac.numerator, frac.denominator)
    return y.astype(np.float32)


def _decode_wav_stdlib(data: bytes) -> Tuple[np.ndarray, int]:
    with wave.open(io.BytesIO(data), "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if n_ch > 1:
        x = x.reshape(-1, n_ch)[:, 0]
    return x, sr


def _decode_ffmpeg(data: bytes) -> Tuple[np.ndarray, int]:
    if not shutil.which("ffmpeg"):
        raise RuntimeError("cannot decode non-WAV audio: no decoder available")
    proc = subprocess.run(
        ["ffmpeg", "-v", "error", "-i", "pipe:0", "-f", "f32le", "-ac", "1",
         "-ar", str(TARGET_SR), "pipe:1"],
        input=data, stdout=subprocess.PIPE, check=True,
    )
    return np.frombuffer(proc.stdout, dtype="<f4").copy(), TARGET_SR


def decode_audio(src: Union[bytes, str, io.BytesIO]) -> Tuple[np.ndarray, int]:
    """Decode an audio file (bytes / path / BytesIO) to (float32 mono, sr)."""
    if isinstance(src, io.BytesIO):
        data = src.getvalue()
    elif isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()

    if data[:4] == b"RIFF":
        try:
            return _decode_wav_stdlib(data)
        except (wave.Error, ValueError, EOFError):
            pass
    try:
        import soundfile as sf
    except ImportError:
        return _decode_ffmpeg(data)
    x, sr = sf.read(io.BytesIO(data))
    x = np.asarray(x, dtype=np.float32)
    if x.ndim > 1:
        x = x[:, 0]
    return x, sr


def load_pcm16k(src: Union[bytes, str, io.BytesIO]) -> np.ndarray:
    """Decode + downmix + resample to the engine contract: 16 kHz mono f32."""
    x, sr = decode_audio(src)
    return resample(x, sr, TARGET_SR)
