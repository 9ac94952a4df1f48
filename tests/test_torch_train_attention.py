"""Kernel 3 differentiated, and the other kernels' refusal to be.

``ops/attention.py::attention`` is a ``torch.autograd.Function``: its
backward is the JAX package's custom VJP of ``_attn_kernel`` written in
PyTorch. On the CPU the same Function runs (forward: the plain version),
so these tests hold the backward the card runs. Bars: against
``jax.vjp`` of ``vmem_attention(interpret=True)`` (the Pallas kernel in
interpret mode with its custom VJP), f32 max difference <= 1e-5 x
max|grad|, bf16 at most 1 bf16 ulp apart; ``gradcheck`` in float64.
The paste and conv kernel wrappers raise under grad mode on an input that
requires grad, as ``jax.grad`` through their ``pallas_call`` fails.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.ops import pallas_attention as jpa
from livetalking_tpu_torch.models import diffusion_blocks as tdb
from livetalking_tpu_torch.ops import attention as tpa
from livetalking_tpu_torch.ops import blend, conv
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

SHAPES = [(2, 2, 64, 40), (1, 1, 64, 64)]


def _inputs(shape, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(4)]  # q, k, v, do


def _jax_grads(q, k, v, do, scale, dtype):
    jd = getattr(jnp, dtype)
    _, vjp = jax.vjp(lambda a, b, c: jpa.vmem_attention(a, b, c, scale, interpret=True),
                     *(jnp.asarray(t, jd) for t in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do, jd))]


def _torch_grads(q, k, v, do, scale, dtype):
    td = getattr(torch, dtype)
    ts = [torch.from_numpy(t).to(td).requires_grad_(True) for t in (q, k, v)]
    out = tpa.attention(*ts, scale)
    out.backward(torch.from_numpy(do).to(td))
    return [t.grad for t in ts]


def _bf16_ordinal(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns -> integers whose differences count ulps."""
    b = bits.astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


@pytest.mark.parametrize("shape", SHAPES)
def test_f32_gradient_matches_jax_vjp(shape):
    q, k, v, do = _inputs(shape, 0)
    scale = shape[-1] ** -0.5
    want = _jax_grads(q, k, v, do, scale, "float32")
    got = _torch_grads(q, k, v, do, scale, "float32")
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * np.abs(w).max(), (name, err, np.abs(w).max())


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_gradient_within_one_ulp_of_jax_vjp(shape):
    q, k, v, do = _inputs(shape, 1)
    scale = shape[-1] ** -0.5
    want = _jax_grads(q, k, v, do, scale, "bfloat16")
    got = _torch_grads(q, k, v, do, scale, "bfloat16")
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        gb = _bf16_ordinal(g.view(torch.int16).numpy())
        wb = _bf16_ordinal(w.view(np.int16))
        assert np.abs(gb - wb).max() <= 1, name


def test_gradcheck_in_float64():
    r = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 2, 12, 8))).requires_grad_(True)
               for _ in range(3))
    assert torch.autograd.gradcheck(lambda a, b, c: tpa.attention(a, b, c, 0.35), (q, k, v))


def test_forward_counts_no_launch_on_the_cpu_and_keeps_the_graph():
    q, k, v, _ = (torch.from_numpy(t).requires_grad_(True) for t in _inputs((1, 2, 16, 8), 3))
    before = tpa.attention.launches
    out = tpa.attention(q, k, v, 0.3)
    assert out.grad_fn is not None and tpa.attention.launches == before
    torch.testing.assert_close(out, tpa.attention_plain(q, k, v, 0.3), rtol=0, atol=0)
    with torch.inference_mode():
        assert tpa.attention(q.detach(), k.detach(), v.detach(), 0.3).grad_fn is None


def test_self_attention_site_gradient_matches_plain_autograd():
    """Through ``diffusion_blocks.attention`` (a U-Net self-attention site)
    the Function's gradients equal autograd's through the plain version."""
    r = np.random.default_rng(4)
    C, heads = 32, 4
    p = {n: {"w": torch.from_numpy(r.standard_normal((C, C)).astype(np.float32) * 0.2),
             "b": None} for n in "qkv"}
    p["o"] = {"w": torch.from_numpy(r.standard_normal((C, C)).astype(np.float32) * 0.2),
              "b": torch.zeros(C)}
    x = torch.from_numpy(r.standard_normal((2, 16, C)).astype(np.float32))

    def grads(kernel):
        tdb_attention = tdb.attention_kernel
        tdb.attention_kernel = kernel
        try:
            xs = x.clone().requires_grad_(True)
            tdb.attention(p, xs, None, heads).square().sum().backward()
            return xs.grad
        finally:
            tdb.attention_kernel = tdb_attention

    torch.testing.assert_close(grads(tpa.attention), grads(tpa.attention_plain),
                               rtol=1e-5, atol=1e-6)


def _paste_calls(pred):
    frames = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    idxs = torch.zeros(1, dtype=torch.int64)
    boxes = torch.tensor([[8, 40, 8, 40]] * 2, dtype=torch.int32)
    origins = torch.zeros((2, 2), dtype=torch.int32)
    scalars = torch.tensor([[0, 0, 32, 32]] * 2, dtype=torch.int32)
    masks = torch.zeros((2, 8, 64), dtype=torch.uint8)
    out = frames[:1].clone()
    return {
        "paste_rect": lambda: blend.paste_rect(pred, frames, idxs, boxes, Ho=8, Wo=64),
        "paste_masked": lambda: blend.paste_masked(pred, frames, idxs, origins, scalars, masks,
                                                   Ho=8, Wo=64),
        "blend_rect_": lambda: blend.blend_rect_(pred, out, boxes[:1], Ho=8, Wo=64),
        "blend_masked_": lambda: blend.blend_masked_(pred, out, idxs, origins, scalars, masks,
                                                     Ho=8, Wo=64),
        "make_resize_paste_fn": lambda: blend.make_resize_paste_fn(16, 8, 64, 64, 64)(
            pred, frames, idxs, boxes),
    }


@pytest.mark.parametrize("name", ["paste_rect", "paste_masked", "blend_rect_", "blend_masked_",
                                  "make_resize_paste_fn"])
def test_paste_wrappers_refuse_to_differentiate(name):
    pred = torch.rand((1, 16, 16, 3), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _paste_calls(pred)[name]()


def _conv_calls():
    """Each conv wrapper on CPU inputs of which some require grad."""
    x = torch.randn((1, 8, 8, 64), requires_grad=True)
    xq = torch.zeros((1, 8, 8, 64), dtype=torch.int8)
    w = torch.randn((64, 3, 3, 64), requires_grad=True)
    wq = torch.zeros((64, 3, 3, 64), dtype=torch.int8)
    scale = torch.ones(64, requires_grad=True)
    bias = torch.zeros(64)
    return {
        "conv3x3_q": lambda: conv.conv3x3_q(xq, wq, scale, bias, out_dtype=torch.float32),
        "conv3x3_bf16": lambda: conv.conv3x3_bf16(x, w, bias),
        "conv3x3_gnq": lambda: conv.conv3x3_gnq(x, None, None, torch.tensor(0.1), wq,
                                                scale, bias),
    }


@pytest.mark.parametrize("name", ["conv3x3_q", "conv3x3_bf16", "conv3x3_gnq"])
def test_conv_wrappers_refuse_to_differentiate(name):
    with pytest.raises(RuntimeError, match="no backward"):
        _conv_calls()[name]()
    with torch.no_grad():  # grad mode off: the plain version runs
        _conv_calls()[name]()
