"""Dense non-causal attention for the SD-family self-attention sites
(ports livetalking_tpu/ops/pallas_attention.py).

MuseTalk's latent U-Net runs self-attention over T = H*W latent tokens
(1024, 256, 64 and 16 at its four levels, 8 heads) and the VAE mid-blocks
over 1024 tokens in one 512-wide head. ``attention`` is the wrapper of
``csrc/attention.cu``: bf16 runs on the tensor cores in two passes over
the key tiles (row max and sum, then the probabilities divided by the
exact sum and rounded before the product with v), f32 on the CUDA cores
with full score rows in shared memory; the softmax is exact. On CPU tensors
it runs ``attention_plain``, the same arithmetic in plain PyTorch; on CUDA
tensors it launches the kernel (counted in ``attention.launches``) or
raises.

``attention`` is differentiable: a ``torch.autograd.Function`` whose
forward is the kernel (or ``attention_plain`` on the CPU) and whose
backward is the reference's custom VJP (pallas_attention.py:122-133) in
plain PyTorch, on both devices. The reference's backward is XLA, not a
kernel, so there is no backward kernel here either: it recomputes the f32
scores and the unrounded f32 softmax ``a`` from the saved q, k, v, then
``dv = aT do``, ``da = do vT``, ``ds = a (da - sum(da a))``,
``dq = ds k s``, ``dk = dsT q s``, all in f32, each cast to its input's
dtype.

Layout (B, H, T, D) for q, k, v and the output. Numerics as the reference:
f32 scores and softmax, probabilities rounded to v's dtype, f32 sums for
the product with v, output in v's dtype. The reference's TPU sizing (a
T >= 512 gate, 128-lane head-dim padding) has no counterpart here: the
bf16 kernels run at every T and every D <= 512; the f32 kernel's T is
bounded by the shared memory its score rows take (the wrapper raises).
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

__all__ = ["attention", "attention_plain", "attention_backward"]

MAX_HEAD_DIM = 512
_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _acc(t: torch.Tensor) -> torch.dtype:
    """The sums' dtype: f32 (f64 for f64 inputs, which gradcheck takes)."""
    return torch.promote_types(t.dtype, torch.float32)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (B, H, T, D) x3 -> (B, H, T, D)."""
    f = _acc(q)
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * sm_scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    a = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return torch.matmul(a.to(f), v.to(f)).to(v.dtype)


_launch_lock = threading.Lock()


@functools.cache
def _library():
    from livetalking_tpu_torch.ops import _build

    lib = _build.library("attention")
    lib.attention_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    lib.attention_launch.restype = ctypes.c_int
    lib.attention_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.attention_smem_bytes.restype = ctypes.c_int
    return lib


def _check_kernel_args(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"attention kernel: {name} is on {t.device}, not CUDA")
        if t.device != q.device:
            raise ValueError(f"attention kernel: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"attention kernel: {name} must be contiguous")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"attention kernel: dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}; "
                             "want one of float32, bfloat16")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"attention kernel: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want one (B, H, T, D)")
    B, H, T, D = q.shape
    if not 0 < D <= MAX_HEAD_DIM or B * H > 65535:
        raise ValueError(f"attention kernel: head dim {D} (at most {MAX_HEAD_DIM}) "
                         f"or {B * H} batch*heads (at most 65535)")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float) -> torch.Tensor:
    """The kernel on CUDA tensors (counted), ``attention_plain`` on CPU ones."""
    if q.device.type == k.device.type == v.device.type == "cpu":
        return attention_plain(q, k, v, sm_scale)
    _check_kernel_args(q, k, v)
    B, H, T, D = q.shape
    lib = _library()
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))  # o is a fresh allocation
    smem = lib.attention_smem_bytes(T, D, _DTYPES[q.dtype], int(aligned))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"attention kernel: T={T}, D={D} needs {smem} bytes of shared "
                         f"memory, more than {_SMEM_LIMIT}")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                   B * H, T, D, float(sm_scale), _DTYPES[q.dtype],
                                   torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")
    with _launch_lock:
        attention.launches += 1
    return o


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
                       sm_scale: float):
    """The reference's VJP of the kernel in plain PyTorch: (dq, dk, dv)."""
    f = _acc(q)
    qf, kf, vf, dof = q.to(f), k.to(f), v.to(f), do.to(f)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    a = torch.softmax(s, dim=-1)
    dv = torch.matmul(a.transpose(-1, -2), dof)
    da = torch.matmul(dof, vf.transpose(-1, -2))
    ds = a * (da - (da * a).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * sm_scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.sm_scale = sm_scale
        return _forward(q, k, v, sm_scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*attention_backward(q, k, v, do, ctx.sm_scale), None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> torch.Tensor:
    """Dense non-causal attention, (B, H, T, D) x3 -> (B, H, T, D).

    The wrapper of ``csrc/attention.cu``. CPU tensors run
    ``attention_plain``; CUDA tensors launch the kernel on the current
    stream (counted in ``attention.launches``); anything else raises.
    Differentiable on both devices through ``attention_backward``."""
    return _Attention.apply(q, k, v, float(sm_scale))


attention.launches = 0
