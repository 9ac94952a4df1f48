"""The port's training data (``train/data.py``) against the JAX package's on
the CPU: batches of every family from the same ``np.random.RandomState``
seed byte for byte (indices, faces, masks, features) with the sync mel
windows at the mel front-end's bar (atol 2e-3, tests/test_torch_mel.py);
the whole-utterance mel, Whisper and HuBERT windows at the bars of
tests/test_torch_mel.py, test_torch_whisper.py and test_torch_hubert.py
(2e-3, 2e-4, 2e-4) on tiny configs; ``load_faces`` of a genavatar-format
directory byte for byte.
"""

import os
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.models import hubert as jh
from livetalking_tpu.models import whisper_encoder as jwe
from livetalking_tpu.train import data as jd
from livetalking_tpu_torch.models import hubert as th
from livetalking_tpu_torch.models import whisper_encoder as twe
from livetalking_tpu_torch.train import data as td
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

MEL_ATOL, ENC_ATOL = 2e-3, 2e-4
HUB = dict(conv_dim=(32, 32), conv_kernel=(10, 4), conv_stride=(5, 4), hidden_size=16,
           num_layers=1, num_heads=2, intermediate_size=32, num_conv_pos_embeddings=8,
           num_conv_pos_embedding_groups=2)
WHI = dict(d_model=32, num_layers=1, num_heads=2, ffn=64)


def _audio(seconds=1.2, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.randn(t.shape[0])).astype(np.float32)


def test_mel_windows_match_jax():
    a = _audio()
    got, want = td.mel_windows(a), jd.mel_windows(a)
    assert got.shape == want.shape == (30, 80, 16)
    np.testing.assert_allclose(got, want, atol=MEL_ATOL, rtol=0)
    starts = np.array([0, 7, 20])
    np.testing.assert_allclose(td.sync_mel_windows(a, starts), jd.sync_mel_windows(a, starts),
                               atol=MEL_ATOL, rtol=0)
    g16, w16 = td.sync_mel16_windows(a, starts), jd.sync_mel16_windows(a, starts)
    assert g16.shape == w16.shape == (3, 80, 52, 1)
    np.testing.assert_allclose(g16, w16, atol=MEL_ATOL, rtol=0)
    assert td.n_video_frames(16000) == jd.n_video_frames(16000) == 25


def test_whisper_windows_match_jax():
    jcfg, tcfg = jwe.WhisperConfig(**WHI), twe.WhisperConfig(**WHI)
    jp = jax.jit(lambda k: jwe.init_params(k, jcfg, dtype=jnp.float32))(jax.random.PRNGKey(0))
    tp = twe.params_from_jax(jax.tree.map(np.asarray, jp))
    a = _audio(0.4)
    got, want = td.whisper_windows(a, tp, tcfg), jd.whisper_windows(a, jp, jcfg)
    assert got.shape == want.shape == (10, 10 * (WHI["num_layers"] + 1), WHI["d_model"])
    np.testing.assert_allclose(got, want, atol=ENC_ATOL, rtol=0)


def test_hubert_windows_match_jax():
    jcfg, tcfg = jh.HubertConfig(**HUB), th.HubertConfig(**HUB)
    jp = jax.jit(lambda k: jh.init_params(k, jcfg, dtype=jnp.float32))(jax.random.PRNGKey(0))
    tp = th.params_from_jax(jax.tree.map(np.asarray, jp))
    a = _audio(0.4)
    got, want = td.hubert_windows(a, tp, tcfg), jd.hubert_windows(a, jp, jcfg)
    assert got.shape == want.shape == (10, 4, 4, 16)
    np.testing.assert_allclose(got, want, atol=ENC_ATOL, rtol=0)


@pytest.mark.parametrize("family,feat_shape,clip_len", [
    ("wav2lip", (30, 80, 16), 1), ("wav2lip", (30, 80, 16), 5),
    ("musetalk", (30, 50, 8), 1), ("musetalk", (30, 50, 8), 16),
    ("ultralight", (30, 8, 8, 16), 1), ("ultralight", (30, 8, 8, 16), 5)])
def test_clip_batches_byte_equal(family, feat_shape, clip_len):
    r = np.random.RandomState(0)
    S = 160 if family == "ultralight" else 64
    faces = r.randint(0, 255, (30, S, S, 3), dtype=np.uint8)
    feats = r.standard_normal(feat_shape).astype(np.float32)
    audio = _audio() if clip_len > 1 else None
    B = 16 if clip_len == 16 else 10
    jit_ = jd.clip_batches(family, faces, feats, B, np.random.RandomState(3), clip_len=clip_len,
                           audio=audio)
    tit = td.clip_batches(family, faces, feats, B, np.random.RandomState(3), clip_len=clip_len,
                          audio=audio)
    for _ in range(2):
        want, got = next(jit_), next(tit)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            if k.startswith("sync_mel"):
                np.testing.assert_allclose(got[k], want[k], atol=MEL_ATOL, rtol=0)
            else:
                assert np.array_equal(got[k], want[k]), k


def test_clip_batches_reject_a_partial_clip():
    faces = np.zeros((10, 8, 8, 3), np.uint8)
    feats = np.zeros((10, 80, 16), np.float32)
    with pytest.raises(ValueError, match="multiple of clip_len"):
        next(td.clip_batches("wav2lip", faces, feats, 7, np.random.RandomState(0), clip_len=5))
    with pytest.raises(ValueError, match="aligned frames"):
        next(td.clip_batches("wav2lip", faces[:3], feats, 5, np.random.RandomState(0),
                             clip_len=5))


@pytest.mark.parametrize("family", ["wav2lip", "ultralight", "musetalk"])
def test_load_faces_byte_equal(tmp_path, family):
    r = np.random.RandomState(1)
    for sub, size in (("face_imgs", 256 if family == "wav2lip" else 168), ("full_imgs", 96)):
        os.makedirs(tmp_path / sub)
        for i in range(3):
            cv2.imwrite(str(tmp_path / sub / f"{i}.png"),
                        r.randint(0, 255, (size, size, 3), dtype=np.uint8))
    with open(tmp_path / "coords.pkl", "wb") as f:
        pickle.dump([(10, 12, 70, 80)] * 3, f)  # (x1, y1, x2, y2)
    got, want = td.load_faces(str(tmp_path), family), jd.load_faces(str(tmp_path), family)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_masks_match_jax():
    x = np.random.RandomState(2).rand(2, 160, 160, 3).astype(np.float32)
    assert np.array_equal(td.mask_wav2lip(x), jd._mask_wav2lip(x))
    assert np.array_equal(td.mask_ultralight(x), jd._mask_ultralight(x))
    assert torch.equal(torch.from_numpy(td.mask_wav2lip(x)),
                       torch.from_numpy(x).masked_fill(
                           (torch.arange(160) >= 80)[None, :, None, None], 0.0))
