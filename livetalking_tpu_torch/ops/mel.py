"""Wav2Lip mel-spectrogram front-end on tensors (ports livetalking_tpu/ops/mel.py).

Same numerics as the reference pipeline:

  preemphasis(0.97) -> centered STFT (n_fft 800, hop 200, win 800, periodic
  Hann, zero padding) -> |.| -> slaney mel filterbank (80 mels, fmin 55,
  fmax 7600) -> 20*log10(max(1e-5, .)) - 20 -> symmetric +/-4 dB normalize.

Per step it is one host->device copy of the raw PCM window followed by
framing, ``torch.fft.rfft`` and one matmul on the session's device; the
(B, 80, 16) window batch the Wav2Lip audio encoder consumes stays there.
``mel_chunk_starts`` reproduces the reference's overlapping 16-step window
slicing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MelConfig:
    sample_rate: int = 16000
    n_fft: int = 800
    hop: int = 200
    win: int = 800
    n_mels: int = 80
    fmin: float = 55.0
    fmax: float = 7600.0
    preemphasis: float = 0.97
    ref_level_db: float = 20.0
    min_level_db: float = -100.0
    max_abs_value: float = 4.0


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    log_region = f >= min_log_hz
    mel = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


def mel_filterbank(cfg: MelConfig = MelConfig()) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) slaney-normalized triangular filterbank."""
    n_bins = 1 + cfg.n_fft // 2
    fft_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(_hz_to_mel(np.array(cfg.fmin)), _hz_to_mel(np.array(cfg.fmax)), cfg.n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : cfg.n_mels + 2] - hz_pts[:cfg.n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _periodic_hann(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def num_mel_frames(n_samples: int, cfg: MelConfig = MelConfig()) -> int:
    """Centered STFT frame count: 1 + n_samples // hop."""
    return 1 + n_samples // cfg.hop


def melspectrogram(audio: torch.Tensor, cfg: MelConfig = MelConfig()) -> torch.Tensor:
    """(T,) PCM -> (n_mels, 1 + T//hop) normalized mel on ``audio``'s device."""
    x = audio.float()
    # preemphasis: y[n] = x[n] - k * x[n-1], y[0] = x[0]
    y = torch.cat([x[:1], x[1:] - cfg.preemphasis * x[:-1]])
    pad = cfg.n_fft // 2
    y = torch.nn.functional.pad(y, (pad, pad))  # center=True, zero padding

    n_frames = num_mel_frames(audio.shape[0], cfg)
    window = torch.from_numpy(_periodic_hann(cfg.win)).to(y.device)
    frames = y.unfold(0, cfg.n_fft, cfg.hop)[:n_frames] * window

    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1).abs()      # (F, n_bins)
    fb = torch.from_numpy(mel_filterbank(cfg)).to(y.device)       # (n_mels, n_bins)
    mel = spec @ fb.T                                              # (F, n_mels)

    min_level = 10.0 ** (cfg.min_level_db / 20.0)
    db = 20.0 * torch.log10(mel.clamp(min=min_level)) - cfg.ref_level_db
    v = cfg.max_abs_value
    norm = ((2.0 * v) * ((db - cfg.min_level_db) / (-cfg.min_level_db)) - v).clamp(-v, v)
    return norm.T  # (n_mels, F)


def mel_chunk_starts(
    batch_size: int,
    n_frames_audio: int,
    stride_left: int,
    stride_right: int,
    fps: int,
    cfg: MelConfig = MelConfig(),
) -> np.ndarray:
    """Static start columns of each 16-wide mel window for one batch step.

    Windows start at ``left + i * (80/fps)`` where ``left`` skips the left
    stride context (80 mel frames per second / 50 audio frames per second),
    clamped so the window fits in the spectrogram.
    """
    samples = n_frames_audio * (cfg.sample_rate // (fps * 2))
    total_cols = num_mel_frames(samples, cfg)
    left = max(0.0, stride_left * 80.0 / 50.0)
    mult = 80.0 / fps
    step = 16
    starts = []
    for i in range(batch_size):
        s = int(left + i * mult)
        if s + step > total_cols:
            s = total_cols - step
        starts.append(s)
    return np.asarray(starts, dtype=np.int32)


def make_mel_chunks_fn(
    batch_size: int,
    stride_left: int,
    stride_right: int,
    fps: int,
    cfg: MelConfig = MelConfig(),
    device="cuda",
):
    """Build a ``(T,) PCM -> (B, n_mels, 16)`` feature-window function.

    T is fixed: ``(2*batch_size + stride_left + stride_right) * chunk``
    with chunk = 320 samples (20 ms at 16 kHz). The input may be a numpy
    array or a tensor; the output lives on ``device``.
    """
    dev = torch.device(device)
    chunk = cfg.sample_rate // (fps * 2)
    n_audio_frames = 2 * batch_size + stride_left + stride_right
    n_samples = n_audio_frames * chunk
    starts = torch.from_numpy(
        mel_chunk_starts(batch_size, n_audio_frames, stride_left, stride_right, fps, cfg)
    ).long()
    window_cols = (starts[:, None] + torch.arange(16)[None, :]).to(dev)  # (B, 16)

    def mel_chunks(audio) -> torch.Tensor:
        audio = torch.as_tensor(audio).to(dev, non_blocking=True)
        if tuple(audio.shape) != (n_samples,):
            raise ValueError(f"mel window: got {tuple(audio.shape)}, want ({n_samples},)")
        mel = melspectrogram(audio, cfg)  # (80, F)
        return mel[:, window_cols].permute(1, 0, 2).contiguous()  # (B, 80, 16)

    return mel_chunks
