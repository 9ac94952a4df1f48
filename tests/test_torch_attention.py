"""The attention kernel's wrapper and plain version (ops/attention.py)
against the JAX package's ``vmem_attention`` on the CPU.

On the CPU the wrapper runs the plain version; the JAX side runs its Pallas
kernel in interpret mode, as tests/test_pallas_attention.py does, and its
XLA twin. Bars are that file's: f32 atol 2e-5, bf16 atol 2e-2. The kernel
itself is held against the plain version on the card by
tests/test_torch_kernels.py (skipped without a CUDA device) and by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from livetalking_tpu.ops import pallas_attention as jpa
from livetalking_tpu_torch.models import diffusion_blocks as tdb
from livetalking_tpu_torch.ops import attention as tpa
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 2, 512, 40), (1, 1, 512, 64)])
def test_plain_matches_jax_kernel_in_interpret_mode(rng, shape, dtype):
    q, k, v = _qkv(rng, shape)
    scale = shape[-1] ** -0.5
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jpa.vmem_attention(*(jnp.asarray(t, jd) for t in (q, k, v)), scale,
                                         interpret=True).astype(jnp.float32))
    before = tpa.attention.launches
    got = tpa.attention(*(torch.from_numpy(t).to(td) for t in (q, k, v)), scale)
    assert got.dtype == td and tuple(got.shape) == shape
    assert tpa.attention.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL[dtype])


@pytest.mark.parametrize("shape", [(2, 8, 16, 160), (2, 8, 64, 20), (1, 1, 100, 24)])
def test_plain_matches_jax_twin_at_short_sequences(rng, shape):
    """Below the reference's T >= 512 gate the JAX package takes its XLA
    twin; the port runs one path at every T."""
    q, k, v = _qkv(rng, shape)
    want = np.asarray(jpa.attention_xla(*(jnp.asarray(t) for t in (q, k, v)), 0.3))
    got = tpa.attention_plain(*(torch.from_numpy(t) for t in (q, k, v)), 0.3).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL["float32"])


def test_probabilities_round_to_v_dtype_before_the_product(rng):
    """bf16: the probabilities are rounded to bf16 before the f32-summed
    product with v, as the TPU kernel does."""
    q, k, v = (torch.from_numpy(t).bfloat16() for t in _qkv(rng, (1, 1, 64, 16)))
    got = tpa.attention_plain(q, k, v, 0.25)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * 0.25
    p = torch.exp(s - s.amax(-1, keepdim=True))
    a = p / p.sum(-1, keepdim=True)
    want = torch.matmul(a.bfloat16().float(), v.float()).bfloat16()
    assert torch.equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    meta = torch.empty((1, 1, 16, 8), device="meta")
    before = tpa.attention.launches
    with pytest.raises(ValueError):  # not CUDA
        tpa.attention(meta, meta, meta, 1.0)
    with pytest.raises(ValueError):  # mixed devices
        tpa.attention(torch.zeros(1, 1, 16, 8), meta, meta, 1.0)
    assert tpa.attention.launches == before


def test_self_attention_goes_through_the_wrapper(rng, monkeypatch):
    """``diffusion_blocks.attention`` sends self-attention (ctx None) to the
    kernel's wrapper and keeps cross-attention's own matmuls; the VAE's
    ``spatial_attention`` uses the wrapper too."""
    calls = []

    def spy(q, k, v, scale):
        calls.append(tuple(q.shape))
        return tpa.attention_plain(q, k, v, scale)

    monkeypatch.setattr(tdb, "attention_kernel", spy)
    C, heads = 32, 2
    lin = lambda i, o: {"w": torch.randn(o, i) * 0.1, "b": None}  # noqa: E731
    p = {"q": lin(C, C), "k": lin(C, C), "v": lin(C, C),
         "o": {"w": torch.randn(C, C) * 0.1, "b": torch.zeros(C)}}
    x = torch.from_numpy(rng.standard_normal((2, 16, C)).astype(np.float32))
    tdb.attention(p, x, None, heads)
    assert calls == [(2, heads, 16, C // heads)]
    pc = dict(p, k=lin(24, C), v=lin(24, C))
    tdb.attention(pc, x, torch.randn(2, 5, 24), heads)
    assert len(calls) == 1
    sp = {"group_norm": {"g": torch.ones(C), "b": torch.zeros(C)},
          "q": lin(C, C), "k": lin(C, C), "v": lin(C, C),
          "o": {"w": torch.randn(C, C) * 0.1, "b": torch.zeros(C)}}
    tdb.spatial_attention(sp, torch.randn(2, 4, 4, C))
    assert calls[-1] == (2, 1, 16, C)
