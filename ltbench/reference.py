"""Plain PyTorch reference of MuseTalk v1.5 serving, in float32.

It works from the published checkpoint layouts (HF ``WhisperModel`` encoder
keys, diffusers ``UNet2DConditionModel`` and ``AutoencoderKL`` keys) and
the published descriptions, and imports nothing of the program under test:

  - ``log_mel``: Whisper's log-mel (30 s pad, centred STFT, slaney mel,
    log10, max - 8 floor, (x + 4) / 4);
  - ``whisper_states``: Whisper-tiny's encoder with every hidden state
    stacked (the input of each layer, the last one after the final norm);
  - ``unet``: SD-1.x ``UNet2DConditionModel`` at one timestep;
  - ``vae_encode`` (posterior mean x 0.18215) and ``vae_decode``;
  - ``paste``: the face resized bilinearly (half-pixel centres) into its
    face box and blended into the full frame with the crop's mask as alpha;
  - ``Quant``: fake quantisation of the W8A8 route this repository serves
    (per-output-channel symmetric weights, static activation scales from a
    calibration walk, dynamic per-tensor scales in the transformer's
    softmax-safe matmuls), at any bit width, so the same walk gives the
    int4 control.

Tensors are NCHW here; faces and frames are uint8 BGR, NHWC, as served.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
from torch.nn import functional as F

SR = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
N_SAMPLES = 30 * SR
SCALING = 0.18215


# ---------------------------------------------------------------------------
# Whisper front end
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    lin = f / f_sp
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filters(n_mels: int = N_MELS) -> np.ndarray:
    """(n_mels, 201) slaney-normalised filterbank on the slaney mel scale,
    0-8 kHz (librosa's ``filters.mel`` defaults, which Whisper ships)."""
    fft = np.linspace(0, SR / 2, 1 + N_FFT // 2)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - fft[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return w.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int = N_MELS) -> torch.Tensor:
    """(k, T) f32 PCM at 16 kHz, T <= 30 s -> (k, n_mels, 3000)."""
    x = F.pad(audio.float(), (0, N_SAMPLES - audio.shape[-1]))
    win = torch.hann_window(N_FFT, periodic=True, device=x.device)
    spec = torch.stft(x, N_FFT, HOP, window=win, center=True, pad_mode="reflect",
                      return_complex=True)
    power = spec[..., :-1].abs() ** 2                                   # (k, 201, 3000)
    fb = torch.from_numpy(mel_filters(n_mels)).to(x.device)
    mel = torch.einsum("mf,kft->kmt", fb, power)
    logs = torch.log10(mel.clamp(min=1e-10))
    logs = torch.maximum(logs, logs.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


def _ln(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def whisper_states(sd: Dict[str, torch.Tensor], mel: torch.Tensor, heads: int) -> torch.Tensor:
    """HF Whisper encoder over (k, 80, 3000) -> (k, 1500, layers + 1, d): the
    input of every layer and the final-normed output (``hidden_states``)."""
    def p(name):
        return sd["encoder." + name]

    x = F.gelu(F.conv1d(mel, p("conv1.weight"), p("conv1.bias"), padding=1))
    x = F.gelu(F.conv1d(x, p("conv2.weight"), p("conv2.bias"), stride=2, padding=1))
    x = x.transpose(1, 2)
    x = x + p("embed_positions.weight")[: x.shape[1]]
    k, T, D = x.shape
    hd = D // heads
    states = []
    n_layers = len({n.split(".")[2] for n in sd if n.startswith("encoder.layers.")})
    for i in range(n_layers):
        states.append(x)

        def lp(name):
            return p(f"layers.{i}.{name}")

        h = _ln(x, lp("self_attn_layer_norm.weight"), lp("self_attn_layer_norm.bias"))
        q = F.linear(h, lp("self_attn.q_proj.weight"), lp("self_attn.q_proj.bias")) * hd ** -0.5
        kk = F.linear(h, lp("self_attn.k_proj.weight"))
        v = F.linear(h, lp("self_attn.v_proj.weight"), lp("self_attn.v_proj.bias"))
        q, kk, v = (t.reshape(k, T, heads, hd).transpose(1, 2) for t in (q, kk, v))
        a = torch.softmax(q @ kk.transpose(-1, -2), dim=-1) @ v
        a = a.transpose(1, 2).reshape(k, T, D)
        x = x + F.linear(a, lp("self_attn.out_proj.weight"), lp("self_attn.out_proj.bias"))
        h = _ln(x, lp("final_layer_norm.weight"), lp("final_layer_norm.bias"))
        h = F.gelu(F.linear(h, lp("fc1.weight"), lp("fc1.bias")))
        x = x + F.linear(h, lp("fc2.weight"), lp("fc2.bias"))
    states.append(_ln(x, p("layer_norm.weight"), p("layer_norm.bias")))
    return torch.stack(states, dim=2)


def audio_context(states: torch.Tensor, batch: int, l: int) -> torch.Tensor:
    """One encoder window's states (1500, L + 1, d) -> (batch, 10 (L + 1), d)
    cross-attention rows: video frame i of the window reads encoder
    positions [2 (i + l/2), 2 (i + l/2) + 10), clamped, every layer's state
    of a position together."""
    T, n, D = states.shape
    rows = []
    for i in range(batch):
        c = 2 * (i + l // 2)
        idx = torch.arange(c, c + 10, device=states.device).clamp(0, T - 1)
        rows.append(states[idx].reshape(10 * n, D))
    return torch.stack(rows)


def positional_encoding(n: int, d: int, device) -> torch.Tensor:
    """MuseTalk's PositionalEncoding: sin on even, cos on odd channels."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


# ---------------------------------------------------------------------------
# quantisation of the served W8A8 route
# ---------------------------------------------------------------------------

class Quant:
    """Fake quantisation at ``bits`` (8: the served route, 4: the control).

    ``calibrating`` records each static site's scale ``max|a| * 1.25 / qmax
    + 1e-8`` from a full-precision walk; afterwards static sites quantise
    with the recorded scale. Weights: per output channel ``max|w| / qmax``.
    Dynamic sites: ``max(max|x|, 1e-8) / qmax`` per call. Quantised values
    are ``clip(round(v / s), -qmax, qmax)``, rounding half to even."""

    def __init__(self, bits: int):
        self.qmax = float(2 ** (bits - 1) - 1)
        self.scales: Dict[str, torch.Tensor] = {}
        self.calibrating = False
        self._wq: Dict[int, tuple] = {}

    def _q(self, v, s):
        return torch.round(v / s).clamp_(-self.qmax, self.qmax)

    def _weight(self, w):
        key = id(w)
        if key not in self._wq:
            flat = w.reshape(w.shape[0], -1)
            ws = flat.abs().amax(dim=1).clamp(min=1e-8) / self.qmax
            self._wq[key] = (w, self._q(w, ws.reshape((-1,) + (1,) * (w.dim() - 1))), ws)
        return self._wq[key][1:]

    def conv(self, name, x, w, b, stride=1, padding=1):
        if self.calibrating:
            self.scales[name] = x.abs().amax() * 1.25 / self.qmax + 1e-8
            return F.conv2d(x, w, b, stride=stride, padding=padding)
        sx = self.scales[name]
        wq, ws = self._weight(w)
        acc = F.conv2d(self._q(x, sx), wq, None, stride=stride, padding=padding)
        return acc * (sx * ws)[None, :, None, None] + b[None, :, None, None]

    def linear(self, x, w, b):
        if self.calibrating:
            return F.linear(x, w, b)
        sx = x.abs().amax().clamp(min=1e-8) / self.qmax
        wq, ws = self._weight(w)
        y = F.linear(self._q(x, sx), wq) * (sx * ws)
        return y if b is None else y + b


def _conv(sd, name, x, q: Optional[Quant], stride=1, padding=1):
    w, b = sd[name + ".weight"], sd[name + ".bias"]
    if q is not None:
        return q.conv(name, x, w, b, stride, padding)
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def _linear(sd, name, x, q: Optional[Quant] = None):
    w, b = sd[name + ".weight"], sd.get(name + ".bias")
    if q is not None:
        return q.linear(x, w, b)
    return F.linear(x, w, b)


def _gn(sd, name, x, eps):
    return F.group_norm(x, 32, sd[name + ".weight"], sd[name + ".bias"], eps)


# ---------------------------------------------------------------------------
# UNet2DConditionModel (SD-1.x), one step
# ---------------------------------------------------------------------------

def _resnet(sd, p, x, temb, eps, q: Optional[Quant], q_short: bool = True):
    h = _conv(sd, p + ".conv1", F.silu(_gn(sd, p + ".norm1", x, eps)), q)
    if temb is not None:
        h = h + _linear(sd, p + ".time_emb_proj", F.silu(temb))[:, :, None, None]
    h = _conv(sd, p + ".conv2", F.silu(_gn(sd, p + ".norm2", h, eps)), q)
    if p + ".conv_shortcut.weight" in sd:
        x = _conv(sd, p + ".conv_shortcut", x, q if q_short else None, padding=0)
    return x + h


def _heads(t, n):
    B, T, C = t.shape
    return t.reshape(B, T, n, C // n).transpose(1, 2)


def _attend(q, k, v, heads):
    B, T, C = q.shape
    s = _heads(q, heads) @ _heads(k, heads).transpose(-1, -2) * (C // heads) ** -0.5
    o = torch.softmax(s, dim=-1) @ _heads(v, heads)
    return o.transpose(1, 2).reshape(B, T, C)


def _transformer(sd, p, x, ctx, heads, q: Optional[Quant]):
    """Transformer2DModel with conv projections and one BasicTransformerBlock.
    Under ``q`` the 1x1 projections, self-attention's v and out, cross-
    attention's out and the GEGLU pair are quantised (dynamic scales);
    q, k and cross-attention's k, v stay full precision."""
    B, C, H, W = x.shape
    dq = q if q is not None and not q.calibrating else None
    h = _gn(sd, p + ".norm", x, 1e-6)
    h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)

    def proj(name, t):
        w, b = sd[f"{p}.{name}.weight"][:, :, 0, 0], sd[f"{p}.{name}.bias"]
        return dq.linear(t, w, b) if dq is not None else F.linear(t, w, b)

    h = proj("proj_in", h)
    tb = p + ".transformer_blocks.0"
    n = _ln(h, sd[tb + ".norm1.weight"], sd[tb + ".norm1.bias"])
    a = _attend(_linear(sd, tb + ".attn1.to_q", n), _linear(sd, tb + ".attn1.to_k", n),
                _linear(sd, tb + ".attn1.to_v", n, dq), heads)
    h = h + _linear(sd, tb + ".attn1.to_out.0", a, dq)
    n = _ln(h, sd[tb + ".norm2.weight"], sd[tb + ".norm2.bias"])
    a = _attend(_linear(sd, tb + ".attn2.to_q", n), _linear(sd, tb + ".attn2.to_k", ctx),
                _linear(sd, tb + ".attn2.to_v", ctx), heads)
    h = h + _linear(sd, tb + ".attn2.to_out.0", a, dq)
    n = _ln(h, sd[tb + ".norm3.weight"], sd[tb + ".norm3.bias"])
    hidden, gate = _linear(sd, tb + ".ff.net.0.proj", n, dq).chunk(2, dim=-1)
    h = h + _linear(sd, tb + ".ff.net.2", hidden * F.gelu(gate), dq)
    h = proj("proj_out", h)
    return h.reshape(B, H, W, C).permute(0, 3, 1, 2) + x


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers ``get_timestep_embedding`` with flip_sin_to_cos, shift 0."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / half)
    e = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(e), torch.sin(e)], dim=-1)


def unet(sd: Dict[str, torch.Tensor], cfg: dict, x: torch.Tensor, t: torch.Tensor,
         ctx: torch.Tensor, q: Optional[Quant] = None) -> torch.Tensor:
    """(B, in, h, w) latents, (B,) timesteps, (B, S, cross) context ->
    (B, out, h, w). ``cfg`` is the published ``musetalk.json``."""
    eps, heads = cfg["norm_eps"], cfg["attention_head_dim"]
    n_layers = cfg["layers_per_block"]
    temb = timestep_embedding(t, cfg["block_out_channels"][0])
    temb = _linear(sd, "time_embedding.linear_2",
                   F.silu(_linear(sd, "time_embedding.linear_1", temb)))
    h = _conv(sd, "conv_in", x, q)
    skips = [h]
    for i, kind in enumerate(cfg["down_block_types"]):
        for j in range(n_layers):
            h = _resnet(sd, f"down_blocks.{i}.resnets.{j}", h, temb, eps, q)
            if kind.startswith("CrossAttn"):
                h = _transformer(sd, f"down_blocks.{i}.attentions.{j}", h, ctx, heads, q)
            skips.append(h)
        if f"down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            h = _conv(sd, f"down_blocks.{i}.downsamplers.0.conv", h, q, stride=2)
            skips.append(h)
    h = _resnet(sd, "mid_block.resnets.0", h, temb, eps, q)
    h = _transformer(sd, "mid_block.attentions.0", h, ctx, heads, q)
    h = _resnet(sd, "mid_block.resnets.1", h, temb, eps, q)
    for i, kind in enumerate(cfg["up_block_types"]):
        for j in range(n_layers + 1):
            h = torch.cat([h, skips.pop()], dim=1)
            h = _resnet(sd, f"up_blocks.{i}.resnets.{j}", h, temb, eps, q)
            if kind.startswith("CrossAttn"):
                h = _transformer(sd, f"up_blocks.{i}.attentions.{j}", h, ctx, heads, q)
        if f"up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            h = _conv(sd, f"up_blocks.{i}.upsamplers.0.conv",
                      F.interpolate(h, scale_factor=2.0, mode="nearest"), q)
    h = F.silu(_gn(sd, "conv_norm_out", h, eps))
    return _conv(sd, "conv_out", h, q)


# ---------------------------------------------------------------------------
# AutoencoderKL (sd-vae-ft-mse)
# ---------------------------------------------------------------------------

def _vae_attention(sd, p, x):
    """Single-head spatial self-attention; modern or legacy key names."""
    names = (("to_q", "to_k", "to_v", "to_out.0") if p + ".to_q.weight" in sd
             else ("query", "key", "value", "proj_attn"))
    B, C, H, W = x.shape
    h = _gn(sd, p + ".group_norm", x, 1e-6).reshape(B, C, H * W).transpose(1, 2)
    qkv = [_linear(sd, f"{p}.{n}", h) for n in names[:3]]
    o = _linear(sd, f"{p}.{names[3]}", _attend(*qkv, 1))
    return x + o.transpose(1, 2).reshape(B, C, H, W)


def _n_blocks(sd, prefix):
    return len({k[len(prefix):].split(".")[0] for k in sd if k.startswith(prefix)})


def vae_encode(sd: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, 3, 256, 256) RGB in [-1, 1] -> (B, 4, 32, 32) posterior mean x 0.18215."""
    h = _conv(sd, "encoder.conv_in", x, None)
    for i in range(_n_blocks(sd, "encoder.down_blocks.")):
        for j in range(_n_blocks(sd, f"encoder.down_blocks.{i}.resnets.")):
            h = _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", h, None, 1e-6, None)
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            h = _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                      F.pad(h, (0, 1, 0, 1)), None, stride=2, padding=0)
    h = _resnet(sd, "encoder.mid_block.resnets.0", h, None, 1e-6, None)
    h = _vae_attention(sd, "encoder.mid_block.attentions.0", h)
    h = _resnet(sd, "encoder.mid_block.resnets.1", h, None, 1e-6, None)
    h = _conv(sd, "encoder.conv_out", F.silu(_gn(sd, "encoder.conv_norm_out", h, 1e-6)), None)
    moments = _conv(sd, "quant_conv", h, None, padding=0)
    return moments[:, : moments.shape[1] // 2] * SCALING


def vae_decode(sd: Dict[str, torch.Tensor], z: torch.Tensor,
               q: Optional[Quant] = None) -> torch.Tensor:
    """(B, 4, 32, 32) scaled latents -> (B, 3, 256, 256) RGB in [0, 1].
    Under ``q`` the mid and up resnets' 3x3 convs and the upsamplers are
    quantised; the latent-side convs, the mid attention, the 1x1 shortcuts
    and the output conv stay full precision."""
    h = _conv(sd, "post_quant_conv", z / SCALING, None, padding=0)
    h = _conv(sd, "decoder.conv_in", h, None)
    h = _resnet(sd, "decoder.mid_block.resnets.0", h, None, 1e-6, q, q_short=False)
    h = _vae_attention(sd, "decoder.mid_block.attentions.0", h)
    h = _resnet(sd, "decoder.mid_block.resnets.1", h, None, 1e-6, q, q_short=False)
    for i in range(_n_blocks(sd, "decoder.up_blocks.")):
        for j in range(_n_blocks(sd, f"decoder.up_blocks.{i}.resnets.")):
            h = _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", h, None, 1e-6, q, q_short=False)
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            h = _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                      F.interpolate(h, scale_factor=2.0, mode="nearest"), q)
    h = _conv(sd, "decoder.conv_out", F.silu(_gn(sd, "decoder.conv_norm_out", h, 1e-6)), None)
    return (h / 2.0 + 0.5).clamp(0.0, 1.0)


# ---------------------------------------------------------------------------
# avatars, faces and frames
# ---------------------------------------------------------------------------

def avatar_latents(vae_sd, faces_bgr: torch.Tensor) -> torch.Tensor:
    """(N, 256, 256, 3) uint8 BGR faces -> (N, 8, 32, 32) U-Net inputs:
    the latents of the face with its lower half blanked, then of the face."""
    x = faces_bgr.flip(-1).permute(0, 3, 1, 2).float() / 255.0
    x = (x - 0.5) / 0.5
    masked = x.clone()
    masked[:, :, x.shape[2] // 2:] = 0.0
    return torch.cat([vae_encode(vae_sd, masked), vae_encode(vae_sd, x)], dim=1)


def faces_u8(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, 256, 256) RGB in [0, 1] -> (B, 256, 256, 3) uint8 BGR."""
    return (img * 255.0).round().clamp(0, 255).to(torch.uint8).flip(1).permute(0, 2, 3, 1)


def paste(face: torch.Tensor, frame: torch.Tensor, face_box, crop_box,
          mask: torch.Tensor) -> torch.Tensor:
    """Blend a (256, 256, 3) uint8 face into a copy of a (H, W, 3) uint8
    frame: resized bilinearly (half-pixel centres, edge-clamped) to the face
    box (x1, y1, x2, y2), alpha = the crop-sized uint8 ``mask`` (crop box
    (xs, ys, xe, ye)) / 255 inside the face box, rounded to the nearest."""
    x1, y1, x2, y2 = (int(v) for v in face_box)
    xs, ys = int(crop_box[0]), int(crop_box[1])
    f = face.permute(2, 0, 1)[None].float()
    r = F.interpolate(f, size=(y2 - y1, x2 - x1), mode="bilinear", align_corners=False)
    r = r[0].permute(1, 2, 0)
    a = (mask[y1 - ys:y2 - ys, x1 - xs:x2 - xs].float() / 255.0)[..., None]
    out = frame.clone()
    bg = frame[y1:y2, x1:x2].float()
    out[y1:y2, x1:x2] = (a * r + (1.0 - a) * bg).round().clamp(0, 255).to(torch.uint8)
    return out


def calibrate(q: Quant, unet_sd, unet_cfg, vae_sd, lat0: torch.Tensor,
              ctx0: torch.Tensor) -> None:
    """Static scales of the served route from its calibration inputs: the
    U-Net on the first session's first latents (t = 0) and the calibration
    context, the decoder on those latents' reference half."""
    q.calibrating = True
    try:
        t = torch.zeros(lat0.shape[0], device=lat0.device)
        unet(unet_sd, unet_cfg, lat0, t, ctx0, q)
        vae_decode(vae_sd, lat0[:, lat0.shape[1] // 2:], q)
    finally:
        q.calibrating = False


def step_faces(unet_sd, unet_cfg, vae_sd, lat: torch.Tensor, ctx: torch.Tensor,
               q: Optional[Quant] = None) -> torch.Tensor:
    """The served model step: (B, 8, 32, 32) latents, (B, 50, d) audio rows
    (positional encoding added here) -> (B, 256, 256, 3) uint8 BGR faces."""
    ctx = ctx + positional_encoding(ctx.shape[1], ctx.shape[2], ctx.device)
    t = torch.zeros(lat.shape[0], device=lat.device)
    return faces_u8(vae_decode(vae_sd, unet(unet_sd, unet_cfg, lat, t, ctx, q), q))


def f32_state(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.float() for k, v in sd.items()}


def calibration_context(whisper_sd, heads: int, n: int, device) -> torch.Tensor:
    """(n, 50, d): 1 s of N(0, 0.01) noise from ``numpy.random.default_rng(0)``
    through the encoder, the first n x 10 positions' states in window rows,
    plus the positional encoding; the served route's calibration context."""
    wav = np.random.default_rng(0).standard_normal(16000) * 0.1
    mel = log_mel(torch.from_numpy(wav.astype(np.float32)).to(device)[None])
    states = whisper_states(whisper_sd, mel, heads)[0]
    D = states.shape[-1]
    ctx = states.reshape(-1, D)[: n * 50].reshape(n, 50, D)
    return ctx + positional_encoding(50, D, device)


__all__ = ["Quant", "audio_context", "avatar_latents", "calibrate", "calibration_context",
           "f32_state", "log_mel", "paste", "positional_encoding", "step_faces", "unet",
           "vae_decode", "vae_encode", "whisper_states"]

