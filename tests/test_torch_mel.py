"""Mel front-end of the PyTorch port against the JAX package's.

The same PCM, made from a seed with numpy, goes through
``livetalking_tpu.ops.mel`` and ``livetalking_tpu_torch.ops.mel``; the port
runs on the CPU. Bar: atol 2e-3, the JAX package's own bar for its mel
against a float64 numpy oracle (tests/test_mel.py).
"""

import numpy as np
import pytest
import torch

from livetalking_tpu.ops import mel as jmel
from livetalking_tpu_torch.ops import mel as tmel

ATOL = 2e-3


def _pcm(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 440 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)


def test_filterbank_and_window_are_the_reference_copies():
    np.testing.assert_array_equal(tmel.mel_filterbank(), jmel.mel_filterbank())
    np.testing.assert_array_equal(tmel._periodic_hann(800), jmel._periodic_hann(800))


@pytest.mark.parametrize("n_samples", [16640, 7680])
def test_melspectrogram_matches_jax(n_samples):
    wav = _pcm(n_samples)
    want = np.asarray(jmel.melspectrogram(wav))
    got = tmel.melspectrogram(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (80, 1 + n_samples // 200)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_mel_chunks_fn_matches_jax():
    B, l, r, fps = 2, 10, 10, 25
    wav = _pcm((2 * B + l + r) * 320, seed=1)
    want = np.asarray(jmel.make_mel_chunks_fn(B, l, r, fps)(wav))
    got = tmel.make_mel_chunks_fn(B, l, r, fps, device="cpu")(wav)
    assert got.device.type == "cpu" and tuple(got.shape) == want.shape == (B, 80, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_mel_chunks_fn_rejects_wrong_window():
    fn = tmel.make_mel_chunks_fn(2, 10, 10, 25, device="cpu")
    with pytest.raises(ValueError):
        fn(np.zeros(100, np.float32))


@pytest.mark.parametrize("B,l,r", [(2, 10, 10), (16, 10, 10), (4, 0, 0), (8, 4, 2)])
def test_mel_chunk_starts_equal(B, l, r):
    n = 2 * B + l + r
    np.testing.assert_array_equal(tmel.mel_chunk_starts(B, n, l, r, 25),
                                  jmel.mel_chunk_starts(B, n, l, r, 25))
