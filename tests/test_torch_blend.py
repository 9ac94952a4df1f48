"""Paste-back of the PyTorch port (ops/blend.py) against the JAX package's.

On the CPU the wrapper of the CUDA kernel runs its plain PyTorch version.
Checks: the plain version against the JAX XLA twin ``resize_paste_xla``
(1 LSB, the JAX package's bar between its kernel and its twin), against
cv2's INTER_LINEAR resize + rect paste (2 LSB: cv2 resizes in 11-bit fixed
point), pixels outside the bbox byte-identical, ``bucket_shape`` equal.
The kernel itself is checked against the plain version on the card by
tests/test_torch_kernels.py (skipped without a CUDA device) and by
chip_smoke.py.
"""

import cv2
import numpy as np
import pytest
import torch

from livetalking_tpu.ops import pallas_blend as pb
from livetalking_tpu_torch.ops import blend as tb

S = 256


def _inputs(seed=7, n_frames=3, H=480, W=640, B=4):
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_frames, H, W, 3), dtype=np.uint8)
    boxes = []
    for _ in range(n_frames):
        h, w = int(rng.integers(80, 300)), int(rng.integers(80, 300))
        y1, x1 = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
        boxes.append((y1, y1 + h, x1, x1 + w))
    boxes = np.asarray(boxes, dtype=np.int32)
    pred = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    idxs = rng.integers(0, n_frames, (B,)).astype(np.int64)
    return frames, boxes, pred, idxs


def _port(pred, frames, idxs, boxes, feather):
    H, W = frames.shape[1:3]
    Ho, Wo = tb.bucket_shape(boxes)
    fn = tb.make_resize_paste_fn(S, Ho, Wo, H, W, feather=feather)
    return fn(torch.from_numpy(pred), torch.from_numpy(frames), torch.from_numpy(idxs),
              torch.from_numpy(boxes)).numpy()


@pytest.mark.parametrize("feather", [0, 9])
def test_plain_matches_xla_twin(feather):
    frames, boxes, pred, idxs = _inputs()
    H, W = frames.shape[1:3]
    Ho, Wo = pb.bucket_shape(boxes)
    want = np.asarray(pb.resize_paste_xla(pred, frames, idxs.astype(np.int32), boxes,
                                          S=S, Ho=Ho, Wo=Wo, H=H, W=W, feather=feather))
    got = _port(pred, frames, idxs, boxes, feather)
    assert got.shape == want.shape == (len(idxs), H, W, 3)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_plain_matches_cv2_rect_paste_and_leaves_outside_untouched():
    frames, boxes, pred, idxs = _inputs(seed=8)
    out = _port(pred, frames, idxs, boxes, 0)
    for b, i in enumerate(idxs):
        y1, y2, x1, x2 = boxes[i]
        ref = frames[i].copy()
        ref[y1:y2, x1:x2] = cv2.resize(pred[b], (x2 - x1, y2 - y1), interpolation=cv2.INTER_LINEAR)
        diff = np.abs(out[b].astype(np.int32) - ref.astype(np.int32))
        assert diff.max() <= 2, diff.max()
        assert float(diff.mean()) < 0.2
        outside = np.ones(frames.shape[1:3], bool)
        outside[y1:y2, x1:x2] = False
        assert np.array_equal(out[b][outside], frames[i][outside])


def test_feathered_blend_leaves_outside_untouched_and_ramps():
    H = W = 256
    frames = np.zeros((1, H, W, 3), np.uint8)
    pred = np.full((1, S, S, 3), 200, np.uint8)
    boxes = np.asarray([[64, 192, 64, 192]], np.int32)
    g = _port(pred, frames, np.zeros(1, np.int64), boxes, 16)[0, :, :, 0].astype(np.int32)
    assert g[128, 128] == 200
    assert 0 < g[64, 128] < 200
    assert g[63, 128] == 0 and g[:64].max() == 0 and g[192:].max() == 0
    assert g[64, 128] < g[79, 128] <= 200


@pytest.mark.parametrize("coords", [
    [(0, 100, 0, 100)],
    [(0, 8, 0, 128)],
    [(10, 300, 5, 200), (0, 64, 0, 400)],
    [(120, 360, 200, 440)],
])
def test_bucket_shape_matches_jax(coords):
    assert tb.bucket_shape(coords) == pb.bucket_shape(coords)


def test_bucket_exceeding_frame_raises():
    with pytest.raises(ValueError):
        tb.make_resize_paste_fn(S, 512, 512, 256, 256)
    z = torch.zeros
    with pytest.raises(ValueError):
        tb.resize_paste_plain(z((1, S, S, 3), dtype=torch.uint8), z((1, 256, 256, 3), dtype=torch.uint8),
                              z(1, dtype=torch.long), z((1, 4), dtype=torch.int32),
                              S=S, Ho=512, Wo=512, H=256, W=256)


def test_device_paste_back_on_cpu_matches_plain():
    frames, boxes, pred, idxs = _inputs(seed=9, B=2)
    H, W = frames.shape[1:3]
    dp = tb.DevicePasteBack(frames, [tuple(b) for b in boxes], S, device="cpu")
    assert dp.available
    got = dp.paste_batch(torch.from_numpy(pred), idxs)
    want = tb.resize_paste_plain(torch.from_numpy(pred), torch.from_numpy(frames),
                                 torch.from_numpy(idxs), torch.from_numpy(boxes),
                                 S=S, Ho=dp.Ho, Wo=dp.Wo, H=H, W=W).numpy()
    assert np.array_equal(got, want)


def test_wrapper_never_runs_plain_on_a_non_cpu_tensor():
    before = tb.blend_rect_.launches
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        tb.blend_rect_(torch.empty((2, S, S, 3), dtype=torch.uint8, **meta),
                       torch.empty((2, 480, 640, 3), dtype=torch.uint8, **meta),
                       torch.empty((2, 4), dtype=torch.int32, **meta), Ho=240, Wo=256)
    assert tb.blend_rect_.launches == before

