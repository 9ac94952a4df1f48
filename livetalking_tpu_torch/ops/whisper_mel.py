"""Whisper log-mel spectrogram on tensors (ports livetalking_tpu/ops/whisper_mel.py).

Same numerics as openai-whisper / HF ``WhisperFeatureExtractor``: pad or
truncate to 30 s, centred STFT with reflect padding (n_fft 400, hop 160,
periodic Hann), power spectrum with the trailing frame dropped, slaney mel
(80 mels, 0-8 kHz), log10 clamped at 1e-10, floored at the spectrogram's
max - 8, then (x + 4) / 4.

A smaller ``n_samples`` (a multiple of 2*HOP, so encoder positions stay
frame-aligned) gives the same mel values for the real frames over a
shorter window: the ``--whisper_short_window`` serving path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.ops.mel import MelConfig, mel_filterbank

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SECONDS = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_SECONDS  # 480000
N_FRAMES = N_SAMPLES // HOP  # 3000


@functools.cache
def whisper_mel_filters() -> np.ndarray:
    """(80, 201) slaney filterbank, 0-8 kHz."""
    cfg = MelConfig(sample_rate=SAMPLE_RATE, n_fft=N_FFT, win=N_FFT, n_mels=N_MELS,
                    fmin=0.0, fmax=8000.0)
    return mel_filterbank(cfg)


def log_mel_spectrogram(audio: torch.Tensor, n_samples: int = N_SAMPLES) -> torch.Tensor:
    """(T,) or (k, T) float32 PCM, T <= n_samples -> (80, n_samples/160) or
    (k, 80, n_samples/160) log-mel on ``audio``'s device. A batch is k
    independent spectrograms (each floored at its own max)."""
    x = torch.as_tensor(audio).float()
    single = x.dim() == 1
    if single:
        x = x[None]
    T = x.shape[-1]
    if T > n_samples:
        raise ValueError(f"audio of {T} samples is longer than the mel window {n_samples}")
    if n_samples % (2 * HOP):
        raise ValueError(f"n_samples {n_samples} is not a multiple of {2 * HOP}")
    x = F.pad(x, (0, n_samples - T))
    pad = N_FFT // 2
    x = F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]

    n_frames = 1 + n_samples // HOP  # +1 before the trailing drop
    win = torch.from_numpy(
        (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(N_FFT) / N_FFT)).astype(np.float32)
    ).to(x.device)
    frames = x.unfold(-1, N_FFT, HOP)[:, :n_frames] * win          # (k, F+1, 400)
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1).abs() ** 2        # (k, F+1, 201)
    spec = spec[:, :-1]                                              # whisper drops the last frame
    fb = torch.from_numpy(whisper_mel_filters()).to(x.device)        # (80, 201)
    mel = spec @ fb.T                                                # (k, F, 80)

    log_spec = torch.log10(mel.clamp(min=1e-10))
    peak = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    out = ((log_spec + 4.0) / 4.0).transpose(1, 2)                   # (k, 80, F)
    return out[0] if single else out
