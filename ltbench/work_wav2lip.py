"""Work of the Wav2Lip-256 step, counted from the configuration's shapes.

``step_ops(cfg)`` lists every conv and transposed conv of one served frame
(the face encoder at 256 px, the audio encoder on one (80, 16) mel window,
the decoder and the output block) with its operations in the served
precision; ``mel_ops(cfg)`` the mel front-end's filterbank product for one
feature request (``2B + l + r`` chunks of 20 ms, float32). Operations count
a multiply-add as two: a conv 2 Ho Wo Cout Cin k^2, a transposed conv
2 Hi Wi Cin Cout k^2. BatchNorm is folded into the convs; elementwise passes
(bias, residual add, ReLU, sigmoid, the mask, the casts) and the FFT's
butterflies carry no operations here.

``paste_bytes(cfg, frames, distinct)`` is the least traffic of one fused
rect paste (kernel 1) over ``frames`` output frames whose ``distinct``
cycle frames are read: each distinct cycle frame read once and its box
(16 bytes), each output frame written once, each 256 px crop and its index
(4 bytes) read once.
"""

from __future__ import annotations

from typing import List, Tuple

from ltbench.work import Op

BF16 = "bfloat16"


def _pair(v) -> Tuple[int, int]:
    return (int(v[0]), int(v[1])) if isinstance(v, list) else (int(v), int(v))


def _layer(name: str, spec: list, hw: Tuple[int, int], prec: str) -> Tuple[Op, Tuple[int, int]]:
    cin, cout, k, s, p, kind = spec[:6]
    (sh, sw), (ph, pw) = _pair(s), _pair(p)
    h, w = hw
    if kind == "tconv":
        op = spec[6]
        out = ((h - 1) * sh - 2 * ph + k + op, (w - 1) * sw - 2 * pw + k + op)
        fl = 2.0 * h * w * cin * cout * k * k
    else:
        out = ((h + 2 * ph - k) // sh + 1, (w + 2 * pw - k) // sw + 1)
        fl = 2.0 * out[0] * out[1] * cout * cin * k * k
    return Op(name, prec, fl), out


def step_ops(cfg: dict) -> List[Op]:
    """Every conv of one frame of the served step."""
    prec = cfg["program"]["dtype"]
    ops: List[Op] = []
    hw = (cfg["img_size"], cfg["img_size"])
    for i, blk in enumerate(cfg["face_encoder"]):
        for j, spec in enumerate(blk):
            op, hw = _layer(f"face_encoder_blocks.{i}.{j}", spec, hw, prec)
            ops.append(op)
    hw = (cfg["mel"]["num_mels"], cfg["mel"]["mel_step_size"])
    for j, spec in enumerate(cfg["audio_encoder"]):
        op, hw = _layer(f"audio_encoder.{j}", spec, hw, prec)
        ops.append(op)
    for i, blk in enumerate(cfg["face_decoder"]):
        for j, spec in enumerate(blk):
            op, hw = _layer(f"face_decoder_blocks.{i}.{j}", spec, hw, prec)
            ops.append(op)
    for j, spec in enumerate(cfg["output_block"]):
        op, hw = _layer(f"output_block.{j}", spec, hw, prec)
        ops.append(op)
    return ops


def mel_ops(cfg: dict) -> List[Op]:
    """The filterbank product of one feature request (its spectrogram's
    columns x bins x mels), float32."""
    sv, mc = cfg["serving"], cfg["mel"]
    chunks = 2 * cfg["program"]["batch_size"] + sv["l"] + sv["r"]
    columns = 1 + chunks * mc["sample_rate"] // (2 * sv["fps"]) // mc["hop_size"]
    return [Op("mel.filterbank", "float32",
               2.0 * columns * (mc["n_fft"] // 2 + 1) * mc["num_mels"])]


def paste_bytes(cfg: dict, frames: float, distinct: float) -> float:
    H, W = cfg["avatar"]["frame_hw"]
    S = cfg["img_size"]
    return distinct * (H * W * 3 + 16) + frames * (H * W * 3 + S * S * 3 + 4)
