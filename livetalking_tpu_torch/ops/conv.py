"""int8 (and bf16) 3x3 convolutions of the SD-family int8 path (ports
livetalking_tpu/ops/pallas_conv.py).

Two wrappers of ``csrc/conv.cu``:

- ``conv3x3_q`` (kernel 4): a 3x3 stride-1 pad-1 conv of int8 NHWC
  activations with int8 weights, exact int32 sums, epilogue
  ``acc * scale[o] + bias[o]`` (+ residual) in f32, rounded to the output
  dtype. ``conv3x3_bf16`` is its bf16 twin (f32 sums, no scale).
- ``conv3x3_gnq`` (kernel 5): GroupNorm apply -> SiLU -> quantize with a
  static scale -> (nearest 2x upsample) -> int8 conv3x3 -> dequantize +
  bias (+ residual) -> bf16, and the per-(batch, channel) moments
  ``s1 = sum y``, ``s2 = sum y^2`` of the bf16 output, which the next
  GroupNorm takes instead of a statistics pass.

Weights are in the port's conv layout ``(O, kh, kw, C)`` int8: row ``o``
holds the ``kh*kw*C`` taps contiguously, tap ``(dy, dx)`` channel ``c`` at
``(dy*kw + dx)*C + c``. ``diffusion_blocks.quantize_conv`` lays them out
once. Activations are NHWC at every public function, as in the reference.

On CPU tensors each wrapper runs its plain version (``*_plain``, the same
arithmetic in plain PyTorch); on CUDA tensors it launches the kernel,
counted in ``<wrapper>.launches``, or raises. The int8 plain versions sum
exactly: float64 GEMMs of the int8 values (every sum is an integer below
2**53). No kernel here has a backward, as no ``pallas_call`` of the
reference has one: every wrapper raises (``refuse_grad``) when grad mode
is on and an input requires grad, instead of returning a result that is
cut off from the graph.

``int8_matmul`` is the exact int8 GEMM of the int8 sites the JAX package
leaves to plain XLA ops (1x1 shortcuts, stride-2 downsamplers, linears):
``torch._int_mm`` on the card, an exact float64 product on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

__all__ = ["conv3x3_q", "conv3x3_q_plain", "conv3x3_bf16", "conv3x3_bf16_plain",
           "conv3x3_gnq", "conv3x3_gnq_plain", "conv3x3_gnq_fits", "int8_matmul",
           "conv3x3_plan", "Conv3x3Plan", "CHANNEL_MULTIPLE", "BLOCK_M", "refuse_grad"]

# the kernels stage the K dimension 64 bytes at a time, one 3x3 tap at a
# time: int8 inputs need C % 64 == 0, bf16 inputs C % 32 == 0
CHANNEL_MULTIPLE = 64
# output pixels per block of kernel 4 (kernel 5 tiles 8 x 16 of them); the
# reference's shape rule for kernel 5 also asks H*W % BLOCK_M == 0
BLOCK_M = 128
_OUT = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
H100_SMS = 132  # streaming multiprocessors of an H100 SXM
_STAGE_BYTES = 64  # K bytes of one channel chunk of kernel 4's pipeline
_MIN_SPLIT_STAGES = 8  # a K split part walks at least this many tap chunks ...
_MAX_SPLITS = 6  # ... and a tile has at most this many parts


class Conv3x3Plan(NamedTuple):
    """How kernel 4 divides one conv: output tiles of ``BLOCK_M`` pixels, a
    ``box`` of (w, h, image) pixels, by ``bn`` channels. K is walked in
    ``stages``: with ``halo``, one 64-byte channel chunk of all nine taps
    (the tile's input halo is loaded once per chunk), else one tap's
    64-byte chunk; the stages are cut into ``splits`` ranges. A (tile,
    range) pair is a work unit. Persistent instances (BN = 256, or K by
    tap) run at most ``sms`` blocks that walk the units; the others (BN =
    128 over the halo, two blocks per SM) run one block per unit."""

    box: Tuple[int, int, int]
    halo: bool
    m_tiles: int
    bn: int
    n_tiles: int
    stages: int
    splits: int
    sms: int

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.splits

    @property
    def persistent(self) -> bool:
        return self.bn == 256 or not self.halo

    @property
    def grid(self) -> int:
        return min(self.units, self.sms) if self.persistent else self.units

    def k_ranges(self) -> List[Tuple[int, int]]:
        """The stages [begin, end) of each split part, as the kernel cuts them."""
        return [(s * self.stages // self.splits, (s + 1) * self.stages // self.splits)
                for s in range(self.splits)]


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would have to differentiate through kernel ``name``."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it under "
                           "torch.no_grad() or on tensors that do not require grad")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def conv3x3_plan(B: int, H: int, W: int, C: int, O: int, in_bytes: int = 1,
                 sms: int = H100_SMS) -> Conv3x3Plan:
    """Kernel 4's work division for x (B, H, W, C) -> O channels of
    ``in_bytes``-byte elements on a card of ``sms`` SMs.

    From 8 px wide up, a tile is 8 x 16 pixels (8 x 8 x 2 images at 8 px)
    and K runs by channel chunk over the tile's halo; narrower images take
    boxes of powers of two over whole images (4 x 4 x 8) and K by tap.
    Channel tiles are 256 wide where O % 256 == 0 and the tiles fill the
    card, else 128. When the tiles T do not fill the card, K is split into
    S = min(2 sms // T, 9 C bytes / 64 / 8, 6, stages) ranges of whole
    stages (``Conv3x3Plan.k_ranges``), about two units per SM at most; a
    split into two (T from 67 to 131) gained nothing on the card, so S < 3
    means no split."""
    halo = W >= 8
    if halo:
        bw, bh = 8, (16 if H > 8 else 8)
    else:
        bw = 1 << max(W - 1, 0).bit_length()
        bh = min(1 << max(H - 1, 0).bit_length(), BLOCK_M // bw)
    bb = BLOCK_M // (bw * bh)
    m_tiles = _cdiv(W, bw) * _cdiv(H, bh) * _cdiv(B, bb)
    bn = 256 if O % 256 == 0 and m_tiles * (O // 256) >= sms else 128
    n_tiles = _cdiv(O, bn)
    chunks = C * in_bytes // _STAGE_BYTES
    stages = chunks if halo else 9 * chunks
    tiles = m_tiles * n_tiles
    splits = 1
    if tiles < sms and 2 * sms // tiles >= 3:
        splits = max(1, min(2 * sms // tiles, 9 * chunks // _MIN_SPLIT_STAGES, _MAX_SPLITS,
                            stages))
    return Conv3x3Plan((bw, bh, bb), halo, m_tiles, bn, n_tiles, stages, splits, sms)


def _conv_exact(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact 3x3 pad-1 conv of int8 NHWC ``xq`` with ``wq`` (O, 3, 3, C'):
    nine float64 GEMMs of the shifted int8 values, (B, H, W, O) float64.
    Every partial sum is an integer below 2**53, so any summation order
    is exact; a library conv could pick an FFT or Winograd algorithm,
    which is not. Weight channels beyond x's (``quantize_conv``'s zero
    padding) meet zeros."""
    B, H, W, c = xq.shape
    C = wq.shape[-1]
    xp = F.pad(xq.to(torch.float64), (0, C - c, 1, 1, 1, 1))
    w = wq.to(torch.float64)
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + H, dx:dx + W].reshape(-1, C) @ w[:, dy, dx].t()
            acc = tap if acc is None else acc.add_(tap)
    return acc.reshape(B, H, W, -1)


def conv3x3_q_plain(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, residual: Optional[torch.Tensor] = None,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of kernel 4: y = conv(xq, wq) * scale[o] + bias[o]
    (+ residual), f32, rounded to ``out_dtype``. The float64 sums convert
    to f32 as int32 sums do (round to nearest even)."""
    y = _conv_exact(xq, wq).float() * scale + bias
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def conv3x3_bf16_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       residual: Optional[torch.Tensor] = None,
                       out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version of the bf16 twin: the f32 conv of the bf16 values and
    weights ``w`` (O, 3, 3, C), + bias (+ residual), rounded to
    ``out_dtype``. TF32 is off: it would round the inputs."""
    xf = x.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wf = w.to(torch.bfloat16).float().permute(0, 3, 1, 2)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(xf, wf, padding=1).permute(0, 2, 3, 1) + bias.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def _upsample2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def conv3x3_gnq_plain(x: torch.Tensor, gn_scale: Optional[torch.Tensor],
                      gn_shift: Optional[torch.Tensor], act_scale: torch.Tensor,
                      wq: torch.Tensor, out_scale: torch.Tensor, bias: torch.Tensor,
                      residual: Optional[torch.Tensor] = None, *,
                      upsample: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of kernel 5, a straight-line replica of the reference's
    ``_gnq_reference`` (tests/test_pallas_conv.py): GN apply and SiLU as
    ``a * sigmoid(a)`` in f32, quantize by dividing by the act scale and
    rounding half to even, zero padding in activation space (the conv pads
    the int8 activations), moments of the bf16-rounded output."""
    if upsample:
        x = _upsample2x(x)
    a = x.float()
    if gn_scale is not None:
        a = a * gn_scale[:, None, None, :] + gn_shift[:, None, None, :]
        a = a * torch.sigmoid(a)
    aq = torch.round(a / act_scale).clamp(-127, 127).to(torch.int8)
    y = _conv_exact(aq, wq).float() * out_scale + bias
    if residual is not None:
        y = y + residual.float()
    yb = y.to(torch.bfloat16)
    yf = yb.float()
    return yb, yf.sum(dim=(1, 2)), (yf * yf).sum(dim=(1, 2))


def conv3x3_gnq_fits(H: int, W: int, C: int, O: int, min_h: int = 64,
                     upsample: bool = False) -> bool:
    """The port's shape rule for kernel 5; H, W are the OUTPUT resolution
    (twice the input's with ``upsample``). Whole 64-channel K steps and
    output tiles, blocks of ``BLOCK_M`` pixels inside one image, and the
    reference's floor ``min_h`` on the resolution (the chain starts where
    the maps are large)."""
    if C % CHANNEL_MULTIPLE or O % CHANNEL_MULTIPLE or H < min_h or W < min_h:
        return False
    if (H * W) % BLOCK_M:
        return False
    return not (upsample and (H % 2 or W % 2))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

_launch_lock = threading.Lock()


@functools.cache
def _library():
    from livetalking_tpu_torch.ops import _build

    lib = _build.library("conv")
    lib.conv3x3_launch.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 15
                                   + [ctypes.c_void_p])
    lib.conv3x3_launch.restype = ctypes.c_int
    lib.conv3x3_gnq_launch.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                                       + [ctypes.c_void_p])
    lib.conv3x3_gnq_launch.restype = ctypes.c_int
    lib.conv_block_m.restype = ctypes.c_int
    lib.conv3x3_gnq_tiles.argtypes = [ctypes.c_int] * 2
    lib.conv3x3_gnq_tiles.restype = ctypes.c_int
    lib.conv3x3_gnq_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.conv3x3_gnq_smem_bytes.restype = ctypes.c_int
    if lib.conv_block_m() != BLOCK_M:
        raise RuntimeError(f"csrc/conv.cu tiles {lib.conv_block_m()} pixels, "
                           f"ops/conv.py expects {BLOCK_M}")
    return lib


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, dev: torch.device, dtype: torch.dtype,
           shape: tuple) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, not {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, want {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.dim() == 4 and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernels load 16 bytes)")


def _stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current stream, read without building a
    ``torch.cuda.Stream`` (which costs a few microseconds a call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _on(dev: torch.device):
    """``torch.cuda.device(dev)``, skipped when ``dev`` is already current."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_split_buffers = {}  # (device index, stream) -> (tile counters, partials workspace)


def _split_buffers_for(dev: torch.device, stream: int, tiles: int,
                       ws_bytes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 4's split-K buffers for launches on ``stream``: int32 tile
    counters, zero between launches (the last part of a tile resets its
    counter), and the partial sums' workspace. Launches on one stream run
    in order, so one pair per stream serves every launch on it; a larger
    launch replaces them (the caching allocator hands the old memory out
    again only after the stream's earlier work)."""
    key = (dev.index, stream)
    counters, ws = _split_buffers.get(key, (None, None))
    if counters is not None and counters.numel() >= tiles and ws.numel() >= ws_bytes:
        return counters, ws
    with _launch_lock:
        counters, ws = _split_buffers.get(key, (None, None))
        if counters is None or counters.numel() < tiles:
            counters = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=dev)
        if ws is None or ws.numel() < ws_bytes:
            ws = torch.empty(max(ws_bytes, 1 << 24), dtype=torch.uint8, device=dev)
        _split_buffers[key] = (counters, ws)
    return counters, ws


def _launch_conv3x3(x, w, scale, bias, residual, out_dtype, counter,
                    splits: Optional[int] = None) -> torch.Tensor:
    """Kernel 4 on CUDA tensors, tiled by ``conv3x3_plan`` (``splits``
    overrides its K split)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"conv3x3 kernel: input on {dev}, not CUDA")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1:3] != (3, 3):
        raise ValueError(f"conv3x3 kernel: x {tuple(x.shape)}, w {tuple(w.shape)}; "
                         "want (B, H, W, C) and (O, 3, 3, C)")
    B, H, W, C = x.shape
    O = w.shape[0]
    int8 = x.dtype == torch.int8
    if not int8 and x.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3 kernel: input dtype {x.dtype}, want int8 or bfloat16")
    mult = CHANNEL_MULTIPLE if int8 else CHANNEL_MULTIPLE // 2
    if C % mult:
        raise ValueError(f"conv3x3 kernel: C={C} is not a multiple of {mult}")
    if out_dtype not in _OUT:
        raise ValueError(f"conv3x3 kernel: output dtype {out_dtype}, want float32 or bfloat16")
    _check("x", x, dev, x.dtype, (B, H, W, C))
    _check("w", w, dev, x.dtype, (O, 3, 3, C))
    if scale is not None:
        _check("scale", scale, dev, torch.float32, (O,))
    _check("bias", bias, dev, torch.float32, (O,))
    if residual is not None:
        _check("residual", residual, dev, out_dtype, (B, H, W, O))
    y = x.new_empty((B, H, W, O), dtype=out_dtype)
    if y.numel() == 0:
        return y
    plan = conv3x3_plan(B, H, W, C, O, 1 if int8 else 2, _sm_count(dev.index))
    if splits is not None:
        plan = plan._replace(splits=splits)
    stream = _stream(dev)
    ws = counters = None
    if plan.splits > 1:  # int32 (f32) partial tiles
        counters, ws = _split_buffers_for(dev, stream, plan.tiles,
                                          plan.units * BLOCK_M * plan.bn * 4)
    with _on(dev):
        err = _library().conv3x3_launch(
            x.data_ptr(), w.data_ptr(), _ptr(scale), bias.data_ptr(), _ptr(residual),
            y.data_ptr(), _ptr(ws), _ptr(counters), B, H, W, C, O, int(not int8),
            _OUT[out_dtype], int(residual is not None), *plan.box, int(plan.halo), plan.bn,
            plan.splits, plan.grid, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: error {err} (a cudaError_t, or a "
                           "negated CUresult of the tensor-map encode)")
    with _launch_lock:
        counter.launches += 1
    return y


def conv3x3_q(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              residual: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 3x3 stride-1 pad-1 conv (kernel 4): xq (B, H, W, C) int8, wq
    (O, 3, 3, C) int8, scale and bias (O,) f32 (scale folds the activation
    and the per-channel weight scale) -> (B, H, W, O) ``out_dtype``.

    CPU tensors run ``conv3x3_q_plain``; CUDA tensors launch the kernel of
    ``csrc/conv.cu`` (counted in ``conv3x3_q.launches``) or raise."""
    refuse_grad("conv3x3_q", xq, wq, scale, bias, residual)
    if xq.device.type == "cpu":
        return conv3x3_q_plain(xq, wq, scale, bias, residual, out_dtype)
    return _launch_conv3x3(xq, wq, scale, bias, residual, out_dtype, conv3x3_q)


conv3x3_q.launches = 0


def conv3x3_bf16(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 residual: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """bf16 twin of ``conv3x3_q`` (f32 sums): y = conv(x, w) + bias
    (+ residual). CPU tensors run ``conv3x3_bf16_plain``; CUDA tensors
    launch the kernel (counted in ``conv3x3_bf16.launches``) or raise."""
    refuse_grad("conv3x3_bf16", x, w, bias, residual)
    if x.device.type == "cpu":
        return conv3x3_bf16_plain(x, w, bias, residual, out_dtype)
    return _launch_conv3x3(x, w, None, bias, residual, out_dtype, conv3x3_bf16)


conv3x3_bf16.launches = 0


def conv3x3_gnq(x: torch.Tensor, gn_scale: Optional[torch.Tensor],
                gn_shift: Optional[torch.Tensor], act_scale: torch.Tensor,
                wq: torch.Tensor, out_scale: torch.Tensor, bias: torch.Tensor,
                residual: Optional[torch.Tensor] = None, *, upsample: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused GN apply + SiLU + quantize + conv3x3 + dequant (+ residual)
    with a moment epilogue (kernel 5).

    x (B, H, W, C) bf16 (half the output resolution with ``upsample``);
    gn_scale/gn_shift (B, C) f32, or None for a quantize-only prologue (the
    upsampler convs, whose input has no norm); act_scale a 0-d f32 tensor
    (the calibrated static scale); wq (O, 3, 3, C) int8; out_scale
    (= act_scale * weight scale) and bias (O,) f32; residual (B, H', W', O)
    bf16 or None. Returns y (B, H', W', O) bf16 and s1, s2 (B, O) f32.

    CPU tensors run ``conv3x3_gnq_plain``; CUDA tensors launch the kernel
    (counted in ``conv3x3_gnq.launches``) or raise. The kernel writes
    per-tile partial moments (no atomics); they are summed here, so the
    result does not depend on the order blocks run in."""
    refuse_grad("conv3x3_gnq", x, gn_scale, gn_shift, act_scale, wq, out_scale, bias, residual)
    if x.device.type == "cpu":
        return conv3x3_gnq_plain(x, gn_scale, gn_shift, act_scale, wq, out_scale, bias,
                                 residual, upsample=upsample)
    dev = x.device
    if dev.type != "cuda" or x.dim() != 4:
        raise ValueError(f"conv3x3_gnq kernel: x {tuple(x.shape)} on {dev}; want a "
                         "(B, H, W, C) CUDA tensor")
    B, Hs, Ws, C = x.shape
    O = wq.shape[0]
    H, W = (2 * Hs, 2 * Ws) if upsample else (Hs, Ws)
    if not conv3x3_gnq_fits(H, W, C, O, min_h=1, upsample=upsample):
        raise ValueError(f"conv3x3_gnq kernel: output {H}x{W}, C={C}, O={O}: want C and O "
                         f"multiples of {CHANNEL_MULTIPLE} and H*W a multiple of {BLOCK_M}")
    _check("x", x, dev, torch.bfloat16, (B, Hs, Ws, C))
    _check("wq", wq, dev, torch.int8, (O, 3, 3, C))
    _check("act_scale", act_scale, dev, torch.float32, ())
    _check("out_scale", out_scale, dev, torch.float32, (O,))
    _check("bias", bias, dev, torch.float32, (O,))
    if (gn_scale is None) != (gn_shift is None):
        raise ValueError("conv3x3_gnq kernel: give both GroupNorm scale and shift, or neither")
    if gn_scale is not None:
        _check("gn_scale", gn_scale, dev, torch.float32, (B, C))
        _check("gn_shift", gn_shift, dev, torch.float32, (B, C))
    if residual is not None:
        _check("residual", residual, dev, torch.bfloat16, (B, H, W, O))
    lib = _library()
    smem = lib.conv3x3_gnq_smem_bytes(C, O, int(upsample))
    if smem > _SMEM_LIMIT or B > 65535:
        raise ValueError(f"conv3x3_gnq kernel: C={C} needs {smem} bytes of shared memory "
                         f"(at most {_SMEM_LIMIT}), B={B} (at most 65535)")
    tiles = lib.conv3x3_gnq_tiles(H, W)
    y = torch.empty((B, H, W, O), dtype=torch.bfloat16, device=dev)
    part = torch.empty((2, B, tiles, O), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.conv3x3_gnq_launch(
            x.data_ptr(), _ptr(gn_scale), _ptr(gn_shift), act_scale.data_ptr(),
            wq.data_ptr(), out_scale.data_ptr(), bias.data_ptr(), _ptr(residual),
            y.data_ptr(), part.data_ptr(), B, H, W, C, O, int(upsample),
            int(gn_scale is not None), int(residual is not None), tiles, _stream(dev))
    if err != 0:
        raise RuntimeError(f"conv3x3_gnq kernel launch failed: cudaError {err}")
    with _launch_lock:
        conv3x3_gnq.launches += 1
    s = part.sum(dim=2)
    return y, s[0], s[1]


conv3x3_gnq.launches = 0


# ---------------------------------------------------------------------------
# exact int8 GEMM for the sites the reference leaves to XLA
# ---------------------------------------------------------------------------

def int8_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ w (N, K) int8 transposed -> (M, N) int32, exact.

    The card runs ``torch._int_mm`` (a library GEMM, as the reference
    leaves these products to XLA). It takes more than 16 rows and K, N in
    multiples of 8: rows are padded with zeros here, and a K or N it cannot
    take raises (every int8 linear and 1x1/stride-2 conv of MuseTalk's
    U-Net has K, N multiples of 16). The CPU computes an exact float64
    product (every sum is an integer below 2**53)."""
    if a.device.type == "cpu":
        return (a.double() @ w.double().t()).to(torch.int32)
    M, K = a.shape
    N = w.shape[0]
    if K % 8 or N % 8:
        raise ValueError(f"int8_matmul on CUDA: K={K}, N={N} must be multiples of 8")
    a = a.contiguous()
    if M <= 16:
        a = F.pad(a, (0, 0, 0, 32 - M))
    return torch._int_mm(a, w.t())[:M]
