"""Paste-back of the PyTorch port (ops/blend.py) against the JAX package's:
the rect path (Wav2Lip) and the masked path (MuseTalk).

On the CPU the wrapper of the CUDA kernel runs its plain PyTorch version.
Checks: the plain version against the JAX XLA twin ``resize_paste_xla``
(1 LSB, the JAX package's bar between its kernel and its twin), against
cv2's INTER_LINEAR resize + rect paste (2 LSB: cv2 resizes in 11-bit fixed
point), pixels outside the bbox byte-identical, ``bucket_shape`` equal.
The masked path: its planes equal ``prepare_masked_paste_data``'s, and its
plain version is within 1 LSB of ``make_masked_paste_fn`` run through the
XLA twin and through the Pallas kernel in interpret mode, byte-identical
outside the face bbox. The entries ``paste_rect`` and ``paste_masked``
(frames by index in, new frames out) run their plain versions on CPU
tensors and agree with the JAX package's steps, repeated indices
included; on any other device they launch the kernel or raise. The kernel
itself is checked against the plain versions on the card by
tests/test_torch_kernels.py (skipped without a CUDA device) and by
chip_smoke.py.
"""

import cv2
import numpy as np
import pytest
import torch

from livetalking_tpu.ops import pallas_blend as pb
from livetalking_tpu_torch.ops import blend as tb
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

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


@pytest.mark.parametrize("feather", [0, 9])
def test_paste_rect_on_cpu_matches_jax(feather):
    """``paste_rect`` (fused entry) against the JAX step through its XLA
    twin, with repeated and unordered indices (int32 and int64)."""
    frames, boxes, pred, _ = _inputs(seed=13, n_frames=4, B=6)
    idxs = np.asarray([3, 1, 3, 0, 1, 3], np.int32)
    H, W = frames.shape[1:3]
    Ho, Wo = pb.bucket_shape(boxes)
    want = np.asarray(pb.make_resize_paste_fn(S, Ho, Wo, H, W, feather=feather,
                                              use_pallas=False)(pred, frames, idxs, boxes))
    for ix in (idxs, idxs.astype(np.int64)):
        before = tb.blend_rect_.launches
        got = tb.paste_rect(torch.from_numpy(pred), torch.from_numpy(frames),
                            torch.from_numpy(ix), torch.from_numpy(boxes), Ho=Ho, Wo=Wo,
                            feather=feather).numpy()
        assert tb.blend_rect_.launches == before  # CPU tensors: the plain version
        assert got.shape == want.shape == (len(idxs), H, W, 3)
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    for b, i in enumerate(idxs):
        y1, y2, x1, x2 = boxes[i]
        outside = np.ones((H, W), bool)
        outside[y1:y2, x1:x2] = False
        assert np.array_equal(got[b][outside], frames[i][outside])


def test_wrapper_never_runs_plain_on_a_non_cpu_tensor():
    before = tb.blend_rect_.launches
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        tb.blend_rect_(torch.empty((2, S, S, 3), dtype=torch.uint8, **meta),
                       torch.empty((2, 480, 640, 3), dtype=torch.uint8, **meta),
                       torch.empty((2, 4), dtype=torch.int32, **meta), Ho=240, Wo=256)
    assert tb.blend_rect_.launches == before


def test_paste_rect_never_runs_plain_on_a_non_cpu_tensor():
    m = dict(device="meta")
    args = [torch.empty((2, S, S, 3), dtype=torch.uint8, **m),
            torch.empty((3, 480, 640, 3), dtype=torch.uint8, **m),
            torch.empty((2,), dtype=torch.int32, **m), torch.empty((3, 4), dtype=torch.int32, **m)]
    before = tb.blend_rect_.launches
    with pytest.raises(ValueError):
        tb.paste_rect(*args, Ho=240, Wo=256)
    with pytest.raises(ValueError):
        tb.make_resize_paste_fn(S, 240, 256, 480, 640)(*args)
    args[2] = torch.zeros((2,), dtype=torch.int32)  # mixed devices
    with pytest.raises(ValueError):
        tb.paste_rect(*args, Ho=240, Wo=256)
    assert tb.blend_rect_.launches == before


# -- masked path (MuseTalk) ---------------------------------------------------

def _masked_inputs(seed, B=4, N=4, H=480, W=640):
    """Face boxes jittered around the synthetic avatar's, crop boxes = face
    box + 10%, masks: the blurred ellipse plus uint8 noise inside it."""
    from livetalking_tpu_torch.utils import synthetic

    rng = np.random.default_rng(seed)
    a = synthetic.musetalk_avatar_arrays(n_frames=1, frame_hw=(H, W), seed=seed)
    (x1, y1, x2, y2), (xs, ys, xe, ye) = a["coords"][0], a["mask_coords"][0]
    faces, crops, masks = [], [], []
    for _ in range(N):
        dx, dy = (int(v) for v in rng.integers(-60, 61, 2))
        faces.append((x1 + dx, y1 + dy, x2 + dx, y2 + dy))
        crops.append((xs + dx, ys + dy, xe + dx, ye + dy))
        noise = rng.integers(0, 40, a["masks"][0].shape)
        masks.append(np.clip(a["masks"][0].astype(int) - noise, 0, 255).astype(np.uint8))
    frames = rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)
    pred = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    idxs = rng.integers(0, N, (B,)).astype(np.int32)
    return faces, crops, masks, frames, pred, idxs


def _bucket(crops):
    return tb.bucket_shape([(ys, ye, xs, xe) for (xs, ys, xe, ye) in crops])


@pytest.mark.parametrize("bgr", [False, True])
def test_masked_planes_match_jax(bgr):
    faces, crops, masks, frames, _, _ = _masked_inputs(10)
    if bgr:  # masks as read back from PNG: BGR, and one of another size
        masks = [cv2.cvtColor(m, cv2.COLOR_GRAY2BGR) for m in masks]
        masks[1] = cv2.resize(masks[1], (100, 90))
    Ho, Wo = _bucket(crops)
    assert (Ho, Wo) == pb.bucket_shape([(ys, ye, xs, xe) for (xs, ys, xe, ye) in crops])
    got = tb.prepare_masked_paste_data(faces, crops, masks, Ho, Wo, 480, 640)
    want = pb.prepare_masked_paste_data(faces, crops, masks, Ho, Wo, 480, 640)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tb.prepare_masked_paste_data(faces, crops, masks, Ho - 8, Wo, 480, 640)


@pytest.mark.parametrize("jax_kw", [dict(use_pallas=False), dict(use_pallas=True, interpret=True)],
                         ids=["xla_twin", "pallas_interpret"])
def test_masked_plain_matches_jax(jax_kw):
    faces, crops, masks, frames, pred, idxs = _masked_inputs(11)
    H, W = frames.shape[1:3]
    Ho, Wo = _bucket(crops)
    planes = tb.prepare_masked_paste_data(faces, crops, masks, Ho, Wo, H, W)
    before = tb.blend_masked_.launches
    got = tb.make_masked_paste_fn(S, Ho, Wo, H, W)(
        torch.from_numpy(pred), torch.from_numpy(frames), torch.from_numpy(idxs),
        *(torch.from_numpy(p) for p in planes)).numpy()
    assert tb.blend_masked_.launches == before  # CPU tensors: the plain version
    want = np.asarray(pb.make_masked_paste_fn(S, Ho, Wo, H, W, **jax_kw)(
        pred, frames, idxs, *planes))
    assert got.shape == want.shape == (len(idxs), H, W, 3)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    for b, i in enumerate(idxs):
        x1, y1, x2, y2 = faces[i]
        outside = np.ones((H, W), bool)
        outside[y1:y2, x1:x2] = False
        assert np.array_equal(got[b][outside], frames[i][outside])
        assert not np.array_equal(got[b][y1:y2, x1:x2], frames[i][y1:y2, x1:x2])


def test_paste_masked_on_cpu_matches_jax():
    """``paste_masked`` (fused entry) against the JAX step through its XLA
    twin, with repeated and unordered indices (int32 and int64)."""
    faces, crops, masks, frames, pred, _ = _masked_inputs(14, B=5)
    idxs = np.asarray([2, 0, 2, 3, 0], np.int32)
    H, W = frames.shape[1:3]
    Ho, Wo = _bucket(crops)
    planes = tb.prepare_masked_paste_data(faces, crops, masks, Ho, Wo, H, W)
    want = np.asarray(pb.make_masked_paste_fn(S, Ho, Wo, H, W, use_pallas=False)(
        pred, frames, idxs, *planes))
    for ix in (idxs, idxs.astype(np.int64)):
        before = tb.blend_masked_.launches
        got = tb.paste_masked(torch.from_numpy(pred), torch.from_numpy(frames),
                              torch.from_numpy(ix), *(torch.from_numpy(p) for p in planes),
                              Ho=Ho, Wo=Wo).numpy()
        assert tb.blend_masked_.launches == before  # CPU tensors: the plain version
        assert got.shape == want.shape == (len(idxs), H, W, 3)
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    for b, i in enumerate(idxs):
        x1, y1, x2, y2 = faces[i]
        outside = np.ones((H, W), bool)
        outside[y1:y2, x1:x2] = False
        assert np.array_equal(got[b][outside], frames[i][outside])


def test_masked_device_paste_back_on_cpu_matches_jax():
    faces, crops, masks, frames, pred, idxs = _masked_inputs(12, B=2)
    mine = tb.MaskedDevicePasteBack(frames, faces, crops, masks, S, device="cpu")
    ref = pb.MaskedDevicePasteBack(frames, faces, crops, masks, S, use_pallas=False)
    assert mine.available and (mine.Ho, mine.Wo) == (ref.Ho, ref.Wo)
    got = mine.paste_batch(torch.from_numpy(pred), idxs)
    want = ref.paste_batch(pred, idxs)
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1


def test_masked_wrapper_never_runs_plain_on_a_non_cpu_tensor():
    before = tb.blend_masked_.launches
    m = dict(device="meta")
    args = [torch.empty((2, S, S, 3), dtype=torch.uint8, **m),
            torch.empty((2, 480, 640, 3), dtype=torch.uint8, **m),
            torch.empty((2,), dtype=torch.int32, **m), torch.empty((4, 2), dtype=torch.int32, **m),
            torch.empty((4, 4), dtype=torch.int32, **m),
            torch.empty((4, 288, 384), dtype=torch.uint8, **m)]
    with pytest.raises(ValueError):
        tb.blend_masked_(*args, Ho=288, Wo=384)
    args[0] = torch.zeros((2, S, S, 3), dtype=torch.uint8)  # mixed devices
    with pytest.raises(ValueError):
        tb.blend_masked_(*args, Ho=288, Wo=384)
    assert tb.blend_masked_.launches == before


def test_paste_masked_never_runs_plain_on_a_non_cpu_tensor():
    m = dict(device="meta")
    args = [torch.empty((2, S, S, 3), dtype=torch.uint8, **m),
            torch.empty((4, 480, 640, 3), dtype=torch.uint8, **m),
            torch.empty((2,), dtype=torch.int32, **m), torch.empty((4, 2), dtype=torch.int32, **m),
            torch.empty((4, 4), dtype=torch.int32, **m),
            torch.empty((4, 288, 384), dtype=torch.uint8, **m)]
    before = tb.blend_masked_.launches
    with pytest.raises(ValueError):
        tb.paste_masked(*args, Ho=288, Wo=384)
    with pytest.raises(ValueError):
        tb.make_masked_paste_fn(S, 288, 384, 480, 640)(*args)
    args[5] = torch.zeros((4, 288, 384), dtype=torch.uint8)  # mixed devices
    with pytest.raises(ValueError):
        tb.paste_masked(*args, Ho=288, Wo=384)
    assert tb.blend_masked_.launches == before
