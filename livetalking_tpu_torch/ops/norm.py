"""GroupNorm, and GroupNorm followed by SiLU, of NHWC activations: the
wrapper of ``csrc/norm.cu`` (kernel 6) and its plain version.

``group_norm(x, gamma, beta, groups, eps, silu=False)`` normalizes x
(B, H, W, C) per sample and group over (H, W, C/groups) with the
reference's arithmetic (``group_norm_plain``): per-channel float32 spatial
moments, combined into group moments, variance E[x^2] - E[x]^2 clamped at
0 before the rsqrt, one per-(B, C) scale and shift (``affine_from_moments``),
y = x * scale + shift rounded to x's dtype; with ``silu``, then
SiLU in float32 rounded to x's dtype again.

CPU tensors run the plain version. A CUDA tensor launches the kernel pair
(a moments launch, then the apply launch), counted once per call in
``group_norm.launches``, or raises: the kernel takes bf16 x whose shape
``group_norm_fits``, and a CUDA tensor never falls back to the plain
version. The kernel has no backward: it raises
(``ops.conv.refuse_grad``) when grad mode is on and an input requires grad.
``routes_to_kernel`` is the model step's choice between the two.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple, Tuple

import torch
from torch.nn import functional as F

from livetalking_tpu_torch.ops.conv import H100_SMS, _on, _sm_count, _stream, refuse_grad

__all__ = ["group_norm", "group_norm_plain", "affine_from_moments", "group_norm_fits",
           "group_norm_plan", "routes_to_kernel", "NormPlan", "MAX_CHANNELS", "MAX_GROUPS"]

MAX_CHANNELS = 4096  # the moments kernel keeps 2C float sums in shared memory ...
MAX_GROUPS = 512     # ... and two per group
MAX_THREADS = 512    # threads a block: (C / 8) channel vectors x rows
_MIN_PASSES = 8      # a thread walks at least about this many pixel rows,
_BLOCKS_PER_SM = 16  # a launch has about this many blocks per SM, and a block
_MIN_PIXELS = 32     # at least this many pixels (its 2C partial sums are
                     # then at most 1/16 of the bytes it reads)


class NormPlan(NamedTuple):
    """How both launches divide one (B, H W, C) tensor: ``threads`` =
    (C / 8) x ``rows`` a block (a thread owns 8 channels of every
    ``rows``-th pixel of its range), ``blocks`` blocks a sample, each over
    H W / ``blocks`` pixels."""

    threads: int
    rows: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def group_norm_fits(shape: Tuple[int, ...], groups: int, dtype: torch.dtype) -> bool:
    """True when the kernel takes x of ``shape`` and ``dtype``: bf16
    (B, H, W, C), 1 <= B <= 65535, C a multiple of 8 (one 16-byte vector)
    and of ``groups``, at most ``MAX_CHANNELS`` channels and ``MAX_GROUPS``
    groups."""
    if dtype != torch.bfloat16 or len(shape) != 4:
        return False
    B, H, W, C = shape
    return (1 <= B <= 65535 and H * W >= 1 and 1 <= groups <= MAX_GROUPS
            and 8 <= C <= MAX_CHANNELS and C % 8 == 0 and C % groups == 0)


@functools.lru_cache(maxsize=1024)
def group_norm_plan(B: int, HW: int, C: int, sms: int = H100_SMS) -> NormPlan:
    """The division of a (B, ``HW``, C) tensor on a card of ``sms`` SMs: as
    many whole pixel rows of C / 8 threads as fit ``MAX_THREADS``; as many
    blocks a sample as give the launch about ``_BLOCKS_PER_SM`` blocks an
    SM, but no more than leave each thread ``_MIN_PASSES`` rows and each
    block ``_MIN_PIXELS`` pixels."""
    vectors = C // 8
    rows = max(1, MAX_THREADS // vectors)
    passes = _cdiv(HW, rows)
    blocks = max(1, min(_cdiv(passes, _MIN_PASSES), _cdiv(_BLOCKS_PER_SM * sms, B),
                        HW // _MIN_PIXELS))
    return NormPlan(vectors * rows, rows, blocks)


def routes_to_kernel(device_type: str, dtype: torch.dtype, records_grad: bool) -> bool:
    """The model step's choice: the kernel for a CUDA bf16 tensor when no
    gradient is recorded; the plain version for everything else (the CPU,
    float32 parity decodes and avatar encodes, training under autograd). A
    CUDA bf16 tensor whose shape the kernel cannot take is routed to it all
    the same, and raises there."""
    return device_type == "cuda" and dtype == torch.bfloat16 and not records_grad


def affine_from_moments(s1: torch.Tensor, s2: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, hw: int, groups: int, eps: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm's per-(B, C) float32 scale and shift from per-channel
    spatial moments s1 = sum x, s2 = sum x^2 ((B, C) f32) over ``hw``
    pixels."""
    B, C = s1.shape
    n = hw * (C // groups)
    g1 = s1.reshape(B, groups, C // groups).sum(-1)
    g2 = s2.reshape(B, groups, C // groups).sum(-1)
    mu = g1 / n
    var = (g2 / n - mu * mu).clamp(min=0.0)
    inv = torch.rsqrt(var + eps)
    mu_c = mu.repeat_interleave(C // groups, dim=-1)
    inv_c = inv.repeat_interleave(C // groups, dim=-1)
    scale = inv_c * gamma.float()[None]
    shift = beta.float()[None] - mu_c * scale
    return scale, shift


def group_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     groups: int = 32, eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """Plain version: x (B, H, W, C) in any float dtype, the reference's
    arithmetic (module docstring), the result in x's dtype."""
    B, H, W, C = x.shape
    xf = x.float()
    s1 = xf.sum(dim=(1, 2))                      # (B, C)
    s2 = (xf * xf).sum(dim=(1, 2))               # (B, C)
    scale, shift = affine_from_moments(s1, s2, gamma, beta, H * W, groups, eps)
    y = (xf * scale[:, None, None, :] + shift[:, None, None, :]).to(x.dtype)
    if silu:
        y = F.silu(y.float()).to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    from livetalking_tpu_torch.ops import _build

    lib = _build.library("norm")
    lib.group_norm_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                                      + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                      + [ctypes.c_float] + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])
    lib.group_norm_launch.restype = ctypes.c_int
    lib.group_norm_max_threads.restype = ctypes.c_int
    if lib.group_norm_max_threads() != MAX_THREADS:
        raise RuntimeError(f"csrc/norm.cu takes {lib.group_norm_max_threads()} threads a "
                           f"block, ops/norm.py plans {MAX_THREADS}")
    return lib


_launch_lock = threading.Lock()
# Per host thread, (device index, stream) -> (tickets, float scratch). The
# moments launch leaves the scale and shift in the scratch for the apply
# launch that follows it on the stream, so two threads launching on one
# stream must not share it.
_scratch = threading.local()


def _scratch_for(dev: torch.device, stream: int, B: int, floats: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The calling thread's scratch for launches on ``stream``: ``B`` int32
    tickets, zero between launches (each launch resets the ones it used),
    and ``floats`` float32 (partials, scale, shift). A larger launch
    replaces them (the caching allocator hands the old memory out again
    only after the stream's earlier work)."""
    cache = getattr(_scratch, "buffers", None)
    if cache is None:
        cache = _scratch.buffers = {}
    key = (dev.index, stream)
    tickets, buf = cache.get(key, (None, None))
    if tickets is None or tickets.numel() < B:
        tickets = torch.zeros(max(B, 256), dtype=torch.int32, device=dev)
    if buf is None or buf.numel() < floats:
        buf = torch.empty(max(floats, 1 << 20), dtype=torch.float32, device=dev)
    cache[key] = (tickets, buf)
    return tickets, buf


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int, eps: float,
            silu: bool) -> torch.Tensor:
    dev = x.device
    if not group_norm_fits(tuple(x.shape), groups, x.dtype):
        raise ValueError(f"group_norm kernel: x {tuple(x.shape)} {x.dtype}, groups={groups}: "
                         f"want bfloat16 (B, H, W, C), C a multiple of 8 and of groups, "
                         f"at most {MAX_CHANNELS} channels and {MAX_GROUPS} groups, "
                         f"1 <= B <= 65535")
    if dev.type != "cuda":
        raise ValueError(f"group_norm kernel: input on {dev}, not CUDA")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm kernel: x must be contiguous and start on a 16-byte "
                         "boundary (the kernels load 16 bytes)")
    B, H, W, C = x.shape
    for name, t in (("gamma", gamma), ("beta", beta)):
        if (t.device != dev or t.shape != (C,) or not t.is_contiguous()
                or t.dtype != gamma.dtype or t.dtype not in (torch.bfloat16, torch.float32)):
            raise ValueError(f"group_norm kernel: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}; want ({C},) bfloat16 or float32 on {dev}, as the other")
    plan = group_norm_plan(B, H * W, C, _sm_count(dev.index))
    stream = _stream(dev)
    n_part = B * plan.blocks * 2 * C
    tickets, buf = _scratch_for(dev, stream, B, n_part + 2 * B * C)
    scale = buf[n_part:n_part + B * C]
    shift = buf[n_part + B * C:n_part + 2 * B * C]
    y = torch.empty_like(x)
    with _on(dev):
        err = _library().group_norm_launch(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), int(gamma.dtype == torch.bfloat16),
            y.data_ptr(), buf.data_ptr(), tickets.data_ptr(), scale.data_ptr(),
            shift.data_ptr(), B, H * W, C, groups, eps, int(silu), plan.threads, plan.blocks,
            stream)
    if err != 0:
        raise RuntimeError(f"group_norm kernel launch failed: cudaError {err}")
    with _launch_lock:
        group_norm.launches += 1
    return y


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, groups: int = 32,
               eps: float = 1e-6, silu: bool = False) -> torch.Tensor:
    """GroupNorm (then SiLU with ``silu``) of x (B, H, W, C); gamma, beta
    (C,). CPU tensors run ``group_norm_plain``; CUDA tensors launch the
    kernel pair of ``csrc/norm.cu`` (counted once in
    ``group_norm.launches``) or raise."""
    refuse_grad("group_norm", x, gamma, beta)
    if x.device.type == "cpu":
        return group_norm_plain(x, gamma, beta, groups, eps, silu)
    return _launch(x, gamma, beta, groups, eps, silu)


group_norm.launches = 0
