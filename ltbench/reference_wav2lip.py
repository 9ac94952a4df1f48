"""Plain PyTorch reference of LiveTalking's Wav2Lip-256 serving, in float32.

It follows LiveTalking's published code (``avatars/wav2lip/models/
wav2lip_v2.py``, ``avatars/wav2lip/audio.py`` with ``hparams.py``,
``lipasr.py`` and ``lipreal.py``) and works on the published checkpoint
layout: every conv layer is ``conv_block.0`` (``nn.Conv2d`` or
``nn.ConvTranspose2d``) and ``conv_block.1`` (``nn.BatchNorm2d`` with its
running statistics), kept apart and run as eval-mode BatchNorm; the output
layer is a plain ``nn.Conv2d`` and a sigmoid. It imports nothing of the
program under test.

  - ``log_mel``: preemphasis 0.97, centred STFT (n_fft 800, hop 200, win
    800, periodic Hann), magnitude, slaney mel filterbank (80 mels, 55-7600
    Hz), ``20 log10(max(1e-5, m)) - 20``, symmetric normalisation to
    [-4, 4] from a -100 dB floor;
  - ``mel_windows``: the 16-column windows of one feature request, cut at
    ``l * 80 / 50 + i * 80 / fps`` columns (the stride context skipped, 3.2
    mel frames per video frame at 25 fps), the last window kept inside;
  - ``network``: the face encoder, the audio encoder and the decoder with
    its skip concatenations, from the configuration file's layer tables;
  - ``face_input``: the lower half of the face blanked, [masked, reference]
    on channels, / 255;
  - ``faces_u8``: x 255, rounded, as uint8;
  - ``paste``: the face resized bilinearly (half-pixel centres) to its box
    and written into a copy of the frame.

Departures from the published code, each deliberate:

  - the STFT pads with zeros (librosa >= 0.10's default; older librosa
    reflected), as the served front-end does;
  - the output is rounded to the nearest level; ``lipreal.py`` truncates
    (``astype(np.uint8)``) before its paste. The served step rounds;
  - ``paste`` resizes in float32 and rounds once; ``cv2.resize`` works in
    11-bit fixed point, so the two differ by up to one level;
  - the network runs NCHW float32 tensors with TF32 off (``network`` sets
    both of ``torch.backends``' switches), in blocks of frames; the log-mel
    runs in float32 too;
  - ``stats`` (weights only) runs BatchNorm on the batch's own statistics
    and records them, the way the synthetic weights get running statistics;
    ``bits`` (the control only) rounds each conv's weights (per output
    channel) and input (per call) to that many bits, symmetric.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

MEL_COLS_PER_S = 80.0     # mel frames per second at hop 200, 16 kHz
AUDIO_FRAMES_PER_S = 50.0  # 20 ms chunks


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def _slaney_mel(f):
    f = np.asarray(f, np.float64)
    lin = f * 3.0 / 200.0
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) * 27.0
                    / np.log(6.4), lin)


def _slaney_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((m - 15.0) * np.log(6.4) / 27.0),
                    m * 200.0 / 3.0)


def mel_basis(mel: dict) -> np.ndarray:
    """(num_mels, n_fft / 2 + 1) float64: librosa's ``filters.mel`` (slaney
    scale and area normalisation) between ``fmin`` and ``fmax``."""
    bins = np.arange(mel["n_fft"] // 2 + 1) * mel["sample_rate"] / mel["n_fft"]
    edges = _slaney_hz(np.linspace(_slaney_mel(mel["fmin"]), _slaney_mel(mel["fmax"]),
                                   mel["num_mels"] + 2))
    out = np.zeros((mel["num_mels"], bins.shape[0]))
    for m in range(mel["num_mels"]):
        lo, mid, hi = edges[m], edges[m + 1], edges[m + 2]
        rise = (bins - lo) / (mid - lo)
        fall = (hi - bins) / (hi - mid)
        out[m] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return out


def log_mel(pcm: torch.Tensor, mel: dict) -> torch.Tensor:
    """(T,) float PCM at 16 kHz -> (num_mels, 1 + T // hop) normalised log-mel."""
    x = pcm.float()
    k = mel["preemphasis"]
    x = torch.cat([x[:1], x[1:] - k * x[:-1]])
    win = torch.hann_window(mel["win_size"], periodic=True, device=x.device)
    spec = torch.stft(x, mel["n_fft"], mel["hop_size"], mel["win_size"], window=win,
                      center=True, pad_mode="constant", return_complex=True).abs()
    m = torch.from_numpy(mel_basis(mel)).float().to(x.device) @ spec
    floor = 10.0 ** (mel["min_level_db"] / 20.0)
    db = 20.0 * torch.log10(m.clamp(min=floor)) - mel["ref_level_db"]
    v, lo = mel["max_abs_value"], mel["min_level_db"]
    return ((2 * v) * ((db - lo) / -lo) - v).clamp(-v, v)


def mel_windows(spec: torch.Tensor, frames: int, l: int, fps: int, step: int) -> torch.Tensor:
    """(num_mels, T) -> (frames, num_mels, step): ``lipasr.py``'s windows."""
    left = max(0.0, l * MEL_COLS_PER_S / AUDIO_FRAMES_PER_S)
    mult = MEL_COLS_PER_S / fps
    out = []
    for i in range(frames):
        s = int(left + i * mult)
        if s + step > spec.shape[1]:
            s = spec.shape[1] - step
        out.append(spec[:, s:s + step])
    return torch.stack(out)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------

def _quant(t: torch.Tensor, bits: int, dim: Optional[int]) -> torch.Tensor:
    """Symmetric rounding to ``bits``: per slice of ``dim``, or per tensor."""
    qmax = float(2 ** (bits - 1) - 1)
    if dim is None:
        s = t.abs().amax().clamp(min=1e-12) / qmax
    else:
        red = [d for d in range(t.dim()) if d != dim]
        s = t.abs().amax(dim=red, keepdim=True).clamp(min=1e-12) / qmax
    return torch.round(t / s).clamp(-qmax, qmax) * s


def _layer(sd, p: str, spec: list, x: torch.Tensor, eps: float,
           stats: Optional[Dict[str, torch.Tensor]], bits: int, var_floor: float) -> torch.Tensor:
    cin, cout, k, s, pad, kind = spec[:6]
    stride = tuple(s) if isinstance(s, list) else (s, s)
    conv = p + (".weight" if kind == "out" else ".conv_block.0.weight")
    w, b = sd[conv], sd[conv[:-len("weight")] + "bias"]
    xin = x
    if bits:
        x = _quant(x, bits, None)
        w = _quant(w, bits, 1 if kind == "tconv" else 0)
    if kind == "tconv":
        y = F.conv_transpose2d(x, w, b, stride, pad, output_padding=spec[6])
    else:
        y = F.conv2d(x, w, b, stride, pad)
    if kind == "out":
        return y
    bn = p + ".conv_block.1."
    if stats is not None:
        stats[bn + "running_mean"] = y.mean(dim=(0, 2, 3))
        stats[bn + "running_var"] = torch.maximum(
            y.var(dim=(0, 2, 3), unbiased=False), var_floor * (y * y).mean(dim=(0, 2, 3)))
    mean = stats[bn + "running_mean"] if stats is not None else sd[bn + "running_mean"]
    var = stats[bn + "running_var"] if stats is not None else sd[bn + "running_var"]
    y = ((y - mean[:, None, None]) * torch.rsqrt(var[:, None, None] + eps)
         * sd[bn + "weight"][:, None, None] + sd[bn + "bias"][:, None, None])
    if kind == "res":
        y = y + xin
    return torch.relu(y)


def network(sd: Dict[str, torch.Tensor], cfg: dict, mel: torch.Tensor, face: torch.Tensor,
            stats: Optional[Dict[str, torch.Tensor]] = None, bits: int = 0,
            var_floor: float = 0.0) -> torch.Tensor:
    """``Wav2Lip.forward``: mel (B, 1, 80, 16), face (B, 6, 256, 256) in [0, 1]
    -> the logits (B, 3, 256, 256) before the sigmoid, TF32 off. With
    ``stats``, each BatchNorm's variance is at least ``var_floor`` times its
    input's mean square."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps = cfg["batchnorm_eps"]

    def seq(prefix, specs, x):
        for j, spec in enumerate(specs):
            x = _layer(sd, f"{prefix}.{j}", spec, x, eps, stats, bits, var_floor)
        return x

    feats = []
    x = face
    for i, blk in enumerate(cfg["face_encoder"]):
        x = seq(f"face_encoder_blocks.{i}", blk, x)
        feats.append(x)
    x = seq("audio_encoder", cfg["audio_encoder"], mel)
    for i, blk in enumerate(cfg["face_decoder"]):
        x = seq(f"face_decoder_blocks.{i}", blk, x)
        x = torch.cat([x, feats.pop()], dim=1)
    return seq("output_block", cfg["output_block"], x)


def face_input(faces_u8: torch.Tensor) -> torch.Tensor:
    """(B, S, S, 3) uint8 faces -> (B, 6, S, S): [lower half blanked, face] / 255."""
    f = faces_u8.float()
    masked = f.clone()
    masked[:, f.shape[1] // 2:] = 0.0
    return torch.cat([masked, f], dim=3).permute(0, 3, 1, 2) / 255.0


def faces_u8(logits: torch.Tensor) -> torch.Tensor:
    """(B, 3, S, S) logits -> (B, S, S, 3) uint8: sigmoid x 255, rounded."""
    return (torch.sigmoid(logits) * 255.0).round().clamp(0, 255).to(torch.uint8) \
        .permute(0, 2, 3, 1)


def paste(face: torch.Tensor, frame: torch.Tensor, box) -> torch.Tensor:
    """A copy of the (H, W, 3) uint8 ``frame`` with the (S, S, 3) uint8
    ``face`` resized bilinearly (half-pixel centres, edges clamped) into the
    box (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = (int(v) for v in box)
    f = face.permute(2, 0, 1)[None].float()
    r = F.interpolate(f, size=(y2 - y1, x2 - x1), mode="bilinear", align_corners=False)
    out = frame.clone()
    out[y1:y2, x1:x2] = r[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8)
    return out


def f32_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in sd.items()}


__all__ = ["face_input", "faces_u8", "f32_state", "log_mel", "mel_basis", "mel_windows",
           "network", "paste"]
