"""The port's CUDA paths on the card: each kernel (rect and masked
paste-back, fused and in place, at S = 256 and Ultralight's 168, and in
the Ultralight super-batch step; attention, the int8 3x3 conv and its
bf16 twin, the fused GroupNorm-SiLU-quantize conv, GroupNorm and
GroupNorm -> SiLU) against its plain PyTorch version, the exact int8 GEMM,
and the scheduler's pinned device->host ring.

Every test here needs a CUDA device and skips without one. The file
imports nothing of JAX, so on a host without JAX it runs as

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from livetalking_tpu_torch.engine.scheduler import AvatarStore, BatchScheduler
from livetalking_tpu_torch.ops import attention, blend, conv, norm

S, H, W = 256, 480, 640


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("feather", [0, 9])
@pytest.mark.parametrize("B", [16, 128])
def test_blend_kernel_matches_plain(cuda, B, feather):
    rng = np.random.default_rng(B + feather)
    N = 6
    frames = torch.from_numpy(rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(cuda)
    boxes_np = []
    for _ in range(N):
        h, w = int(rng.integers(80, 300)), int(rng.integers(80, 300))
        y1, x1 = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
        boxes_np.append((y1, y1 + h, x1, x1 + w))
    boxes = torch.tensor(boxes_np, dtype=torch.int32, device=cuda)
    Ho, Wo = blend.bucket_shape(boxes_np)
    pred = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)).to(cuda)
    idxs = torch.from_numpy(rng.integers(0, N, (B,))).to(cuda)
    before = blend.blend_rect_.launches
    got = blend.make_resize_paste_fn(S, Ho, Wo, H, W, feather=feather)(pred, frames, idxs, boxes)
    want = blend.resize_paste_plain(pred, frames, idxs, boxes, S=S, Ho=Ho, Wo=Wo, H=H, W=W,
                                    feather=feather)
    torch.cuda.synchronize()
    assert blend.blend_rect_.launches == before + 1
    assert int((got.int() - want.int()).abs().max()) <= 1
    picked = frames.index_select(0, idxs)
    for b, i in enumerate(idxs.tolist()):
        y1, y2, x1, x2 = boxes_np[i]
        outside = torch.ones((H, W), dtype=torch.bool, device=cuda)
        outside[y1:y2, x1:x2] = False
        assert torch.equal(got[b][outside], picked[b][outside])


@pytest.mark.cuda
def test_blend_kernel_rejects_what_it_does_not_take(cuda):
    pred = torch.zeros((2, S, S, 3), dtype=torch.uint8, device=cuda)
    out = torch.zeros((2, H, W, 3), dtype=torch.uint8, device=cuda)
    boxes = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        blend.blend_rect_(pred, out, boxes.long(), Ho=240, Wo=256)
    with pytest.raises(ValueError):
        blend.blend_rect_(pred, out[:, ::2], boxes, Ho=240, Wo=256)
    with pytest.raises(ValueError):
        blend.blend_rect_(pred, out, boxes.cpu(), Ho=240, Wo=256)
    with pytest.raises(ValueError):
        blend.blend_rect_(pred, out, boxes, Ho=512, Wo=256)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 128])
def test_masked_blend_kernel_matches_plain(cuda, B):
    rng = np.random.default_rng(B)
    N = 6
    faces, crops, masks = [], [], []
    for _ in range(N):
        x1, y1 = int(rng.integers(60, 300)), int(rng.integers(40, 150))
        h, w = int(rng.integers(150, 260)), int(rng.integers(150, 260))
        my, mx = h // 10, w // 10
        faces.append((x1, y1, x1 + w, y1 + h))
        crops.append((x1 - mx, y1 - my, x1 + w + mx, y1 + h + my))
        masks.append(rng.integers(0, 256, (h + 2 * my, w + 2 * mx), dtype=np.uint8))
    Ho, Wo = blend.bucket_shape([(ys, ye, xs, xe) for (xs, ys, xe, ye) in crops])
    planes = [torch.from_numpy(p).to(cuda)
              for p in blend.prepare_masked_paste_data(faces, crops, masks, Ho, Wo, H, W)]
    frames = torch.from_numpy(rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(cuda)
    pred = torch.from_numpy(rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)).to(cuda)
    idxs = torch.from_numpy(rng.integers(0, N, (B,)).astype(np.int32)).to(cuda)
    before = blend.blend_masked_.launches
    got = blend.make_masked_paste_fn(S, Ho, Wo, H, W)(pred, frames, idxs, *planes)
    want = blend.masked_paste_plain(pred, frames, idxs, *planes, S=S, Ho=Ho, Wo=Wo, H=H, W=W)
    torch.cuda.synchronize()
    assert blend.blend_masked_.launches == before + 1
    assert int((got.int() - want.int()).abs().max()) <= 1
    picked = frames.index_select(0, idxs)
    for b, i in enumerate(idxs.tolist()):
        x1, y1, x2, y2 = faces[i]
        outside = torch.ones((H, W), dtype=torch.bool, device=cuda)
        outside[y1:y2, x1:x2] = False
        assert torch.equal(got[b][outside], picked[b][outside])


# paste kernel cases: (frame H, W, cycle length N, placement of the boxes,
# crop size S); S = 168 is Ultralight's crop, whose 504-byte rows (516
# strided) are not a multiple of 16
PASTE_CASES = {
    "480x640": (480, 640, 6, "inside", S),
    "479x641": (479, 641, 5, "inside", S),  # H*W*3 % 16 != 0: rows off 16 bytes
    "edges": (480, 640, 8, "edges", S),     # boxes clamped at each frame edge
    "frame_bucket": (240, 256, 3, "frame", S),  # a bucket equal to the frame
    "1080p": (1080, 1920, 6, "inside", S),
    "S168": (480, 640, 6, "inside", 168),
    "S168_edges": (480, 640, 8, "edges", 168),
}
PASTE_RUNS = ([("480x640", B) for B in (1, 3, 16, 128)]
              + [("479x641", 3), ("479x641", 16), ("edges", 16), ("edges", 128),
                 ("frame_bucket", 3), ("1080p", 32)]
              + [("S168", B) for B in (1, 16, 128)] + [("S168_edges", 16), ("S168_edges", 128)])


def _paste_boxes(rng, H, W, N, place, lo=150, hi=260):
    """N (y1, y2, x1, x2) boxes: inside the frame, crossing each of its
    edges in turn (and two corners), or spanning the whole frame."""
    boxes = []
    for n in range(N):
        if place == "frame":
            boxes.append((0, H, 0, W) if n == 0 else (-5 * n, H - 5 * n, 3 * n, W - 5 * n))
            continue
        h, w = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
        y1, x1 = int(rng.integers(0, H - h + 1)), int(rng.integers(0, W - w + 1))
        if place == "edges":
            y1, x1 = [(-20, x1), (H - h + 20, x1), (y1, -20), (y1, W - w + 20), (-7, -9),
                      (H - h + 5, W - w + 3), (0, 0), (H - h, W - w)][n % 8]
        boxes.append((y1, y1 + h, x1, x1 + w))
    return boxes


def _outside_equal(got, picked, regions):
    """Every pixel outside each item's region (y1, y2, x1, x2) equals the
    gathered frame's, byte for byte."""
    H, W = got.shape[1:3]
    for b, (y1, y2, x1, x2) in enumerate(regions):
        keep = torch.ones((H, W), dtype=torch.bool, device=got.device)
        keep[max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0)] = False
        if not torch.equal(got[b][keep], picked[b][keep]):
            return False
    return True


@pytest.mark.cuda
@pytest.mark.parametrize("feather", [0, 9])
@pytest.mark.parametrize("case,B", PASTE_RUNS)
def test_paste_rect_kernel_matches_plain(cuda, case, B, feather):
    """Both forms of the rect kernel against the plain version: the fused
    entry (``paste_rect`` and the step of ``make_resize_paste_fn``, int64
    and int32 indices, a strided pred) and the in-place form on the
    gathered frames; within 1 LSB, byte-identical outside each bbox."""
    H, W, N, place, S = PASTE_CASES[case]
    rng = np.random.default_rng(B * 10 + feather + H)
    boxes_np = _paste_boxes(rng, H, W, N, place)
    Ho, Wo = (H, W) if place == "frame" else blend.bucket_shape(boxes_np)
    frames = torch.from_numpy(rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(cuda)
    boxes = torch.tensor(boxes_np, dtype=torch.int32, device=cuda)
    wide = torch.from_numpy(rng.integers(0, 256, (B, S, S + 4, 3), dtype=np.uint8)).to(cuda)
    pred = wide[:, :, 2:S + 2]  # rows 4 pixels apart: the kernel takes the strides
    idxs = torch.from_numpy(rng.integers(0, N, (B,))).to(cuda)  # repeated, unordered
    want = blend.resize_paste_plain(pred, frames, idxs, boxes, S=S, Ho=Ho, Wo=Wo, H=H, W=W,
                                    feather=feather)
    picked = frames.index_select(0, idxs)
    regions = [boxes_np[i] for i in idxs.tolist()]
    before = blend.blend_rect_.launches
    outs = [blend.paste_rect(pred, frames, idxs, boxes, Ho=Ho, Wo=Wo, feather=feather),
            blend.make_resize_paste_fn(S, Ho, Wo, H, W, feather=feather)(
                pred.contiguous(), frames, idxs.int(), boxes)]
    inplace = picked.clone()
    outs.append(blend.blend_rect_(pred, inplace, boxes.index_select(0, idxs), Ho=Ho, Wo=Wo,
                                  feather=feather))
    torch.cuda.synchronize()
    assert blend.blend_rect_.launches == before + 3
    for got in outs:
        assert got.shape == (B, H, W, 3) and got.dtype == torch.uint8
        assert int((got.int() - want.int()).abs().max()) <= 1
        assert _outside_equal(got, picked, regions)


def _masked_planes(rng, H, W, N, place):
    """Face boxes, crop boxes (face + 10% a side) and noisy masks, placed
    as ``_paste_boxes`` places boxes; the planes against their bucket."""
    faces, crops, masks = [], [], []
    lo, hi = (150, 260) if place != "frame" else (H // 2, H - 2 * (H // 10))
    for y1, y2, x1, x2 in _paste_boxes(rng, H, W, N, "inside" if place == "frame" else place,
                                       lo, hi):
        h, w = y2 - y1, x2 - x1
        my, mx = h // 10, w // 10
        ys, xs = min(max(y1 - my, 0), H - h - 2 * my), min(max(x1 - mx, 0), W - w - 2 * mx)
        faces.append((xs + mx, ys + my, xs + mx + w, ys + my + h))
        crops.append((xs, ys, xs + w + 2 * mx, ys + h + 2 * my))
        m = rng.integers(0, 256, (h + 2 * my, w + 2 * mx), dtype=np.uint8)
        m[m < 60] = 0
        masks.append(m)
    Ho, Wo = blend.bucket_shape([(ys, ye, xs, xe) for (xs, ys, xe, ye) in crops])
    if place == "frame":
        Ho, Wo = H, W
    return faces, blend.prepare_masked_paste_data(faces, crops, masks, Ho, Wo, H, W), Ho, Wo


@pytest.mark.cuda
@pytest.mark.parametrize("case,B", PASTE_RUNS)
def test_paste_masked_kernel_matches_plain(cuda, case, B):
    """Both forms of the masked kernel against the plain version, as
    above; byte-identical outside each face bbox."""
    H, W, N, place, S = PASTE_CASES[case]
    rng = np.random.default_rng(B + H)
    faces, planes_np, Ho, Wo = _masked_planes(rng, H, W, N, place)
    planes = [torch.from_numpy(p).to(cuda) for p in planes_np]
    frames = torch.from_numpy(rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(cuda)
    wide = torch.from_numpy(rng.integers(0, 256, (B, S + 1, S, 3), dtype=np.uint8)).to(cuda)
    pred = wide[:, 1:]  # a view one row in: the kernel takes the item stride
    idxs = torch.from_numpy(rng.integers(0, N, (B,)).astype(np.int32)).to(cuda)
    want = blend.masked_paste_plain(pred, frames, idxs, *planes, S=S, Ho=Ho, Wo=Wo, H=H, W=W)
    picked = frames.index_select(0, idxs)
    regions = [(y1, y2, x1, x2) for (x1, y1, x2, y2) in (faces[i] for i in idxs.tolist())]
    before = blend.blend_masked_.launches
    outs = [blend.paste_masked(pred, frames, idxs.long(), *planes, Ho=Ho, Wo=Wo),
            blend.make_masked_paste_fn(S, Ho, Wo, H, W)(pred.contiguous(), frames, idxs, *planes)]
    inplace = picked.clone()
    outs.append(blend.blend_masked_(pred, inplace, idxs, *planes, Ho=Ho, Wo=Wo))
    torch.cuda.synchronize()
    assert blend.blend_masked_.launches == before + 3
    for got in outs:
        assert got.shape == (B, H, W, 3) and got.dtype == torch.uint8
        assert int((got.int() - want.int()).abs().max()) <= 1
        assert _outside_equal(got, picked, regions)


@pytest.mark.cuda
def test_paste_entries_reject_what_they_do_not_take(cuda):
    pred = torch.zeros((2, S, S, 3), dtype=torch.uint8, device=cuda)
    frames = torch.zeros((3, H, W, 3), dtype=torch.uint8, device=cuda)
    idxs = torch.zeros((2,), dtype=torch.int32, device=cuda)
    boxes = torch.zeros((3, 4), dtype=torch.int32, device=cuda)
    org, sc = torch.zeros((3, 2), dtype=torch.int32, device=cuda), boxes.clone()
    masks = torch.zeros((3, 240, 256), dtype=torch.uint8, device=cuda)
    rect = blend.make_resize_paste_fn(S, 240, 256, H, W)
    masked = blend.make_masked_paste_fn(S, 240, 256, H, W)
    bad_rect = [(pred.float(), frames, idxs, boxes), (pred, frames, idxs.float(), boxes),
                (pred, frames, idxs, boxes.long()), (pred, frames.cpu(), idxs, boxes),
                (pred, frames, idxs.cpu(), boxes), (pred[:1], frames, idxs, boxes),
                (pred, frames[:, :, ::2], idxs, boxes), (pred, frames, idxs, boxes[:, :3]),
                (pred.transpose(1, 2), frames, idxs, boxes),
                (pred, frames, idxs, boxes.t().contiguous().t())]
    before = blend.blend_rect_.launches, blend.blend_masked_.launches
    for args in bad_rect:
        with pytest.raises(ValueError):
            rect(*args)
        with pytest.raises(ValueError):
            blend.paste_rect(*args, Ho=240, Wo=256)
    bad_masked = [(pred, frames, idxs, org.long(), sc, masks), (pred, frames, idxs, org, sc,
                                                                  masks[:, :, :128]),
                  (pred, frames, idxs, org, sc, masks.cpu()), (pred, frames, idxs[:1], org, sc,
                                                              masks),
                  (pred, frames.transpose(1, 2), idxs, org, sc, masks)]
    for args in bad_masked:
        with pytest.raises(ValueError):
            masked(*args)
    with pytest.raises(ValueError):
        blend.make_resize_paste_fn(S, 512, 256, H, W)  # bucket taller than the frame
    with pytest.raises(ValueError):
        blend.paste_rect(pred, frames, idxs, boxes, Ho=240, Wo=256, feather=-1)
    assert (blend.blend_rect_.launches, blend.blend_masked_.launches) == before


@pytest.mark.cuda
def test_paste_call_launches_one_kernel(cuda):
    """One paste call of each kind is one CUDA kernel on the card: no
    gather, cast or copy beside it (a torch.profiler window)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (4, H, W, 3), dtype=np.uint8)).to(cuda)
    pred = torch.from_numpy(rng.integers(0, 256, (16, S, S, 3), dtype=np.uint8)).to(cuda)
    idxs = torch.from_numpy(rng.integers(0, 4, (16,)).astype(np.int32)).to(cuda)
    boxes = torch.tensor([(120, 360, 200, 440)] * 4, dtype=torch.int32, device=cuda)
    faces, planes_np, Ho, Wo = _masked_planes(rng, H, W, 4, "inside")
    planes = [torch.from_numpy(p).to(cuda) for p in planes_np]
    rect = blend.make_resize_paste_fn(S, 240, 256, H, W)
    masked = blend.make_masked_paste_fn(S, Ho, Wo, H, W)
    for call in (lambda: rect(pred, frames, idxs, boxes),
                 lambda: masked(pred, frames, idxs, *planes)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(kernels) == 1, [e.name for e in kernels]
        assert "paste_kernel" in kernels[0].name


def _ultralight_step(cuda, n, B=16):
    """The Ultralight super-batch step with device paste (bf16, random
    weights, two synthetic avatars in a store on the card), its inputs, and
    its paste geometry."""
    from livetalking_tpu_torch.avatars import ultralight_avatar as ua
    from livetalking_tpu_torch.models import ultralight as ul
    from livetalking_tpu_torch.utils import synthetic

    arrays = [synthetic.ultralight_avatar_arrays(n_frames=8, seed=k) for k in range(2)]
    x1, y1, x2, y2 = arrays[0]["coords"][0]
    boxes = np.asarray([(y1, y2, x1, x2)] * 8, np.int32)
    Ho, Wo = blend.bucket_shape(boxes.tolist())
    spec = {"H": H, "W": W, "Ho": Ho, "Wo": Wo}
    store = AvatarStore(item_shape=(168, 168, 3), device=cuda)
    for k, a in enumerate(arrays):
        store.add(f"u{k}", a["crops"], aux={"ul_slot": np.full(8, k, np.int32),
                                             "pb_frames": np.stack(a["frames"]),
                                             "pb_boxes": boxes})
    ua.reset_shared_scheduler()
    ua._shared["stacked"] = ul.stack_params([ul.init_params(1 + k, torch.bfloat16, cuda)
                                             for k in range(2)])
    step = ua.make_step_factory(torch.bfloat16, store, B, spec)(n * B)
    rng = np.random.default_rng(n)
    idxs = torch.from_numpy((np.arange(n * B) % 16).astype(np.int32)).to(cuda)
    audio = torch.from_numpy(rng.standard_normal((n * B, 16, 32, 32)).astype(np.float32)).to(cuda)
    return step, store, idxs, audio, spec


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_ultralight_step_pastes_written_crops_with_one_kernel(cuda, n):
    """One Ultralight super-batch step (bf16, B=16 per session): the
    prediction written into each gathered 168 px crop as the step writes
    it, pasted by ONE launch of kernel 1 at S = 168, within 1 LSB of the
    plain paste of the same crops and byte-identical outside each box."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from livetalking_tpu_torch.avatars import ultralight_avatar as ua
    from livetalking_tpu_torch.models import ultralight as ul

    step, store, idxs, audio, spec = _ultralight_step(cuda, n)
    try:
        slots = store.aux["ul_slot"].index_select(0, idxs)[::16]
        pred = ul.make_grouped_infer_fn(n, 16, torch.bfloat16)(
            ua._shared["stacked"], store.buffer, idxs, slots, audio)
        crops = store.buffer.index_select(0, idxs)
        crops[:, 4:164, 4:164] = pred
        want = blend.resize_paste_plain(crops, store.aux["pb_frames"], idxs,
                                        store.aux["pb_boxes"], S=168, Ho=spec["Ho"],
                                        Wo=spec["Wo"], H=H, W=W)
        before = blend.blend_rect_.launches
        got = step(None, store.buffer, idxs, audio)
        torch.cuda.synchronize()
        assert blend.blend_rect_.launches == before + 1
        assert got.shape == (n * 16, H, W, 3) and got.dtype == torch.uint8
        assert int((got.int() - want.int()).abs().max()) <= 1
        picked = store.aux["pb_frames"].index_select(0, idxs)
        y1, y2, x1, x2 = store.aux["pb_boxes"][0].tolist()
        assert _outside_equal(got, picked, [(y1, y2, x1, x2)] * (n * 16))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(None, store.buffer, idxs, audio)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert sum("paste_kernel" in k for k in names) == 1, names
    finally:
        ua.reset_shared_scheduler()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(16, 8, 1024, 40), (16, 8, 256, 80), (16, 8, 64, 160),
                                   (16, 8, 16, 160), (16, 1, 1024, 512), (2, 3, 77, 33),
                                   (64, 8, 1024, 40), (128, 8, 1024, 40), (64, 1, 1024, 512),
                                   (128, 1, 1024, 512), (16, 8, 1016, 40)])
def test_attention_kernel_matches_plain(cuda, shape, dtype, atol):
    """The reference's bars, at the step's shapes, the engine's super-batch
    sizes (B=64, 128) and a half last key tile (T % 16 == 8). bf16 is also
    held per element to 2 bf16 ulps of the plain output plus 4e-3 (one
    flipped rounding of a probability near 0.5 times |v| ~ 1)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, device=cuda, generator=gen).to(dtype) for _ in range(3))
    scale = shape[-1] ** -0.5
    before = attention.attention.launches
    got = attention.attention(q, k, v, scale)
    want = attention.attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert attention.attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    d = (got.float() - want.float()).abs()
    assert float(d.max()) <= atol
    if dtype == torch.bfloat16:
        w = want.float()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
        assert bool((d <= 2 * ulp + 4e-3).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 3, 1000, 40), (3, 2, 72, 40), (2, 1, 1000, 512)])
def test_attention_kernel_ragged_tiles_match_plain(cuda, shape, dtype, atol):
    """T not a multiple of the bf16 kernels' query and key tiles (128 rows
    and 64 keys at D = 40, 64 rows and 16 keys at D = 512): the last query
    tile is partly past T and the last key tile's missing keys must weigh
    nothing. q and k have means +1 and -1, so every real score lies well
    below 0, the score of a zero-filled missing key: one that leaked into
    the softmax would dominate it. Same bars as above."""
    gen = torch.Generator(device=cuda).manual_seed(shape[2] + shape[3])
    q, k, v = (torch.randn(shape, device=cuda, generator=gen) for _ in range(3))
    q, k, v = (q + 1).to(dtype), (k - 1).to(dtype), v.to(dtype)
    scale = shape[-1] ** -0.5
    before = attention.attention.launches
    got = attention.attention(q, k, v, scale)
    want = attention.attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert attention.attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    d = (got.float() - want.float()).abs()
    assert float(d.max()) <= atol
    if dtype == torch.bfloat16:
        w = want.float()
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
        assert bool((d <= 2 * ulp + 4e-3).all())


@pytest.mark.cuda
def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 64, 32), device=cuda)
    with pytest.raises(ValueError):
        attention.attention(q, q.half(), q, 1.0)
    with pytest.raises(ValueError):
        attention.attention(q.transpose(2, 3), q, q, 1.0)
    with pytest.raises(ValueError):
        attention.attention(q, q.cpu(), q, 1.0)
    big = torch.zeros((1, 1, 8, 1024), device=cuda)
    with pytest.raises(ValueError):
        attention.attention(big, big, big, 1.0)  # head dim above 512
    long = torch.zeros((1, 1, 8192, 64), device=cuda)
    with pytest.raises(ValueError):
        attention.attention(long, long, long, 1.0)  # score rows beyond shared memory


def _ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want``."""
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    return float(((got.float() - w).abs() / ulp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,Hh,Ww,C,O", [(16, 32, 32, 64, 320), (16, 32, 32, 320, 4),
                                         (16, 8, 8, 2560, 1280), (16, 64, 64, 512, 512),
                                         (3, 5, 7, 128, 96)])
def test_conv3x3_q_kernel_matches_plain(cuda, B, Hh, Ww, C, O, out_dtype, residual):
    """Bit-equal: both sum the int8 products exactly and round the same
    f32 epilogue (MuseTalk's conv_in with C padded to 64, conv_out's O=4,
    the widest U-Net site, a decoder site, and a ragged pixel count)."""
    gen = torch.Generator(device=cuda).manual_seed(C + O)
    xq = torch.randint(-127, 128, (B, Hh, Ww, C), device=cuda, generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (O, 3, 3, C), device=cuda, generator=gen, dtype=torch.int8)
    scale = torch.rand(O, device=cuda, generator=gen) * 1.5e-4 + 5e-5
    bias = torch.randn(O, device=cuda, generator=gen)
    res = (torch.randn((B, Hh, Ww, O), device=cuda, generator=gen).to(out_dtype)
           if residual else None)
    before = conv.conv3x3_q.launches
    got = conv.conv3x3_q(xq, wq, scale, bias, residual=res, out_dtype=out_dtype)
    want = conv.conv3x3_q_plain(xq, wq, scale, bias, residual=res, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv.conv3x3_q.launches == before + 1
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(got, want), f"{_ulps(got, want)} bf16 ulps apart"


def _q_inputs(dev, B, Hh, Ww, C, O, residual=None):
    gen = torch.Generator(device=dev).manual_seed(B * 7 + Hh + C + O)
    xq = torch.randint(-127, 128, (B, Hh, Ww, C), device=dev, generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (O, 3, 3, C), device=dev, generator=gen, dtype=torch.int8)
    scale = torch.rand(O, device=dev, generator=gen) * 1.5e-4 + 5e-5
    bias = torch.randn(O, device=dev, generator=gen)
    res = (torch.randn((B, Hh, Ww, O), device=dev, generator=gen).to(residual)
           if residual is not None else None)
    return xq, wq, scale, bias, res


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("B,Hh,Ww,C,O", [(16, 4, 4, 2560, 1280), (16, 8, 8, 1280, 1280),
                                         (3, 5, 7, 128, 96), (3, 10, 12, 128, 96),
                                         (16, 8, 8, 320, 4)])
def test_conv3x3_q_kernel_split_k_matches_plain(cuda, B, Hh, Ww, C, O, residual, out_dtype):
    """Shapes whose tiles do not fill the card, so K is split across blocks
    and the last part of each tile sums the partials: the U-Net's 4x4 (K by
    tap) and 8x8 (K by chunk over the halo) sites, ragged pixel counts and
    channel tiles by tap (B=3, 5x7, O=96) and over the halo (B=3, 10x12),
    and O=4 (conv_out's width). Bit-equal, with and without the residual
    epilogue."""
    assert conv.conv3x3_plan(B, Hh, Ww, C, O).splits > 1
    xq, wq, scale, bias, res = _q_inputs(cuda, B, Hh, Ww, C, O, out_dtype if residual else None)
    before = conv.conv3x3_q.launches
    got = conv.conv3x3_q(xq, wq, scale, bias, residual=res, out_dtype=out_dtype)
    want = conv.conv3x3_q_plain(xq, wq, scale, bias, residual=res, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert conv.conv3x3_q.launches == before + 1
    assert torch.equal(got, want), f"{_ulps(got, want)} bf16 ulps apart"


@pytest.mark.cuda
@pytest.mark.parametrize("Ww,splits", [(4, 1), (4, 2), (4, 3), (4, 4), (4, 27), (16, 2),
                                       (16, 3)])
def test_conv3x3_q_kernel_forced_splits_match_plain(cuda, Ww, splits):
    """C=192 is 3 chunks a tap. At W=4 K runs by tap, 27 stages: 2 and 4
    parts end inside a tap, 3 on tap boundaries, 27 one stage each; at W=16
    it runs by chunk over the halo, 3 stages. Every split gives the same
    bits, and a second launch on the stream finds the tile counters reset."""
    B, Hh, C, O = 2, 16, 192, 64
    plan = conv.conv3x3_plan(B, Hh, Ww, C, O)._replace(splits=splits)
    assert plan.halo == (Ww >= 8) and plan.k_ranges()[-1][1] == plan.stages
    if not plan.halo and splits in (2, 4):
        assert any(e % 3 for _, e in plan.k_ranges()[:-1]), "a K range should end inside a tap"
    xq, wq, scale, bias, _ = _q_inputs(cuda, B, Hh, Ww, C, O)
    want = conv.conv3x3_q_plain(xq, wq, scale, bias)
    for _ in range(2):
        got = conv._launch_conv3x3(xq, wq, scale, bias, None, torch.bfloat16, conv.conv3x3_q,
                                   splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{_ulps(got, want)} bf16 ulps apart"


@pytest.mark.cuda
def test_conv3x3_bf16_kernel_split_k_matches_plain(cuda):
    """The bf16 twin at a 4x4 site, where K is split: its partials are
    summed in a fixed order, at the twin's bars (rtol = atol = 2e-2 on
    signed inputs, 1 bf16 ulp on positive ones); the same bits twice."""
    B, Hh, C, O = 16, 4, 1280, 1280
    assert conv.conv3x3_plan(B, Hh, Hh, C, O, in_bytes=2).splits > 1
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = (torch.randn((B, Hh, Hh, C), device=cuda, generator=gen) * 0.3).to(torch.bfloat16)
    w = (torch.randn((O, 3, 3, C), device=cuda, generator=gen) * 0.02).to(torch.bfloat16)
    bias = torch.randn(O, device=cuda, generator=gen)
    got = conv.conv3x3_bf16(x, w, bias)
    want = conv.conv3x3_bf16_plain(x, w, bias)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(conv.conv3x3_bf16(x, w, bias), got)
    xp, wp, bp = x.abs(), w.abs(), bias.abs()
    assert _ulps(conv.conv3x3_bf16(xp, wp, bp), conv.conv3x3_bf16_plain(xp, wp, bp)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hh,C,O", [(16, 32, 512, 512), (2, 16, 96, 64)])
def test_conv3x3_bf16_kernel_matches_plain(cuda, B, Hh, C, O):
    """The reference's bars (rtol = atol = 2e-2) on signed inputs, and 1
    bf16 ulp on positive inputs, where no sum cancels: the f32 sums run in
    another order than the plain conv's and may round the last bf16 bit the
    other way."""
    gen = torch.Generator(device=cuda).manual_seed(Hh)
    x = (torch.randn((B, Hh, Hh, C), device=cuda, generator=gen) * 0.3).to(torch.bfloat16)
    w = (torch.randn((O, 3, 3, C), device=cuda, generator=gen) * 0.02).to(torch.bfloat16)
    bias = torch.randn(O, device=cuda, generator=gen)
    before = conv.conv3x3_bf16.launches
    got = conv.conv3x3_bf16(x, w, bias)
    want = conv.conv3x3_bf16_plain(x, w, bias)
    torch.cuda.synchronize()
    assert conv.conv3x3_bf16.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    xp, wp, bp = x.abs(), w.abs(), bias.abs()
    assert _ulps(conv.conv3x3_bf16(xp, wp, bp), conv.conv3x3_bf16_plain(xp, wp, bp)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("gn,residual,upsample", [(True, False, False), (True, True, False),
                                                  (False, False, True), (True, False, True)])
@pytest.mark.parametrize("B,Hh,C,O", [(16, 64, 512, 512), (2, 16, 64, 128), (2, 16, 128, 64)])
def test_conv3x3_gnq_kernel_matches_plain(cuda, B, Hh, C, O, gn, residual, upsample):
    """tests/test_pallas_conv.py's bars: y within atol max(2e-2, 4 max
    out_scale) + rtol 1e-2, the moments within rtol 1e-3 + atol 1e-2 H W
    (expf and the division may round differently from PyTorch's and flip
    a quantized value next to a .5 step)."""
    gen = torch.Generator(device=cuda).manual_seed(Hh + C + O)
    Hs = Hh // 2 if upsample else Hh
    x = torch.randn((B, Hs, Hs, C), device=cuda, generator=gen).to(torch.bfloat16)
    gns = torch.rand((B, C), device=cuda, generator=gen) + 0.5 if gn else None
    gnb = torch.randn((B, C), device=cuda, generator=gen) * 0.2 if gn else None
    act = torch.tensor(0.011, device=cuda)
    wq = torch.randint(-127, 128, (O, 3, 3, C), device=cuda, generator=gen, dtype=torch.int8)
    osc = torch.rand(O, device=cuda, generator=gen) * 1.5e-4 + 5e-5
    bias = torch.randn(O, device=cuda, generator=gen) * 0.1
    res = (torch.randn((B, Hh, Hh, O), device=cuda, generator=gen).to(torch.bfloat16)
           if residual else None)
    args = (x, gns, gnb, act, wq, osc, bias, res)
    before = conv.conv3x3_gnq.launches
    y, s1, s2 = conv.conv3x3_gnq(*args, upsample=upsample)
    yr, s1r, s2r = conv.conv3x3_gnq_plain(*args, upsample=upsample)
    torch.cuda.synchronize()
    assert conv.conv3x3_gnq.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (B, Hh, Hh, O)
    torch.testing.assert_close(y.float(), yr.float(), rtol=1e-2,
                               atol=max(2e-2, 4 * float(osc.max())))
    for got, want in ((s1, s1r), (s2, s2r)):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-2 * Hh * Hh)


@pytest.mark.cuda
@pytest.mark.parametrize("gn,residual,upsample", [(True, True, False), (False, False, True),
                                                  (True, False, True)])
@pytest.mark.parametrize("B,Hh,Ww,C,O", [(3, 8, 16, 64, 64), (2, 16, 24, 128, 64),
                                         (2, 16, 8, 192, 192)])
def test_conv3x3_gnq_kernel_tile_edges_match_plain(cuda, B, Hh, Ww, C, O, gn, residual,
                                                  upsample):
    """The kernel's 8 x 16 output tiles at the image borders: one tile that
    is the whole 8 x 16 image and touches all four borders, tiles cut by
    the right edge (W = 24, and W = 8 below the tile's width), several
    images per launch, O = 64 and three 64-channel output tiles (O = 192),
    and the upsample mode's source-space halo. Same bars as above."""
    gen = torch.Generator(device=cuda).manual_seed(B + Hh + Ww + C + O)
    Hs, Ws = (Hh // 2, Ww // 2) if upsample else (Hh, Ww)
    x = torch.randn((B, Hs, Ws, C), device=cuda, generator=gen).to(torch.bfloat16)
    gns = torch.rand((B, C), device=cuda, generator=gen) + 0.5 if gn else None
    gnb = torch.randn((B, C), device=cuda, generator=gen) * 0.2 if gn else None
    act = torch.tensor(0.011, device=cuda)
    wq = torch.randint(-127, 128, (O, 3, 3, C), device=cuda, generator=gen, dtype=torch.int8)
    osc = torch.rand(O, device=cuda, generator=gen) * 1.5e-4 + 5e-5
    bias = torch.randn(O, device=cuda, generator=gen) * 0.1
    res = (torch.randn((B, Hh, Ww, O), device=cuda, generator=gen).to(torch.bfloat16)
           if residual else None)
    args = (x, gns, gnb, act, wq, osc, bias, res)
    before = conv.conv3x3_gnq.launches
    y, s1, s2 = conv.conv3x3_gnq(*args, upsample=upsample)
    yr, s1r, s2r = conv.conv3x3_gnq_plain(*args, upsample=upsample)
    torch.cuda.synchronize()
    assert conv.conv3x3_gnq.launches == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == (B, Hh, Ww, O)
    torch.testing.assert_close(y.float(), yr.float(), rtol=1e-2,
                               atol=max(2e-2, 4 * float(osc.max())))
    for got, want in ((s1, s1r), (s2, s2r)):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-2 * Hh * Ww)


@pytest.mark.cuda
def test_conv_kernels_reject_what_they_do_not_take(cuda):
    xq = torch.zeros((1, 8, 16, 64), dtype=torch.int8, device=cuda)
    wq = torch.zeros((64, 3, 3, 64), dtype=torch.int8, device=cuda)
    v = torch.zeros(64, device=cuda)
    act = torch.tensor(1.0, device=cuda)
    before = (conv.conv3x3_q.launches, conv.conv3x3_gnq.launches)
    with pytest.raises(ValueError):
        conv.conv3x3_q(xq[..., :32], wq[..., :32], v, v)  # C not a multiple of 64
    with pytest.raises(ValueError):
        conv.conv3x3_q(xq, wq, v.double(), v)
    with pytest.raises(ValueError):
        conv.conv3x3_q(xq, wq.cpu(), v, v)
    with pytest.raises(ValueError):
        conv.conv3x3_q(xq.transpose(1, 2), wq, v, v)
    xb = torch.zeros((1, 8, 12, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        conv.conv3x3_gnq(xb, None, None, act, wq, v, v)  # H*W not a multiple of 128
    with pytest.raises(ValueError):
        conv.conv3x3_gnq(xb[:, :, :8].contiguous().float(), None, None, act, wq, v, v)
    with pytest.raises(ValueError):
        conv.conv3x3_gnq(torch.zeros((1, 8, 16, 64), dtype=torch.bfloat16, device=cuda),
                         v[None], None, act, wq, v, v)  # scale without shift
    assert (conv.conv3x3_q.launches, conv.conv3x3_gnq.launches) == before


def unet_norm_sites():
    """(H, C, SiLU) of the U-Net's 61 GroupNorm sites in the bf16 MuseTalk
    step, in order: each resnet's two norms (with SiLU), each transformer's
    norm (without) and norm_out (with)."""
    out = []
    blocks, L = (320, 640, 1280, 1280), 2
    h, cin, skips = 32, 320, [320]
    for i, c in enumerate(blocks):
        for j in range(L):
            out += [(h, cin if j == 0 else c, True), (h, c, True)]
            out += [(h, c, False)] if i < 3 else []
            skips.append(c)
        cin = c
        if i < 3:
            skips.append(c)
            h //= 2
    out += [(h, 1280, True), (h, 1280, True), (h, 1280, False), (h, 1280, True),
            (h, 1280, True)]
    prev = 1280
    for i, c in enumerate(blocks[::-1]):
        for j in range(L + 1):
            out += [(h, prev + skips.pop(), True), (h, c, True)]
            out += [(h, c, False)] if i > 0 else []
            prev = c
        if i < 3:
            h *= 2
    return out + [(h, 320, True)]


def vae_decode_norm_sites():
    """(H, C, SiLU) of the VAE decoder's 30 GroupNorm sites, in order: the
    mid block's resnets (with SiLU) and attention (without), the up blocks'
    resnets and norm_out (with)."""
    out = [(32, 512, True)] * 2 + [(32, 512, False)] + [(32, 512, True)] * 2
    h, cin = 32, 512
    for i, c in enumerate((512, 512, 256, 128)):
        for j in range(3):
            out += [(h, cin if j == 0 else c, True), (h, c, True)]
            cin = c
        if i < 3:
            h *= 2
    return out + [(h, 128, True)]


# each distinct (H, C, SiLU) of the bf16 step's GroupNorm sites once
NORM_SITES = sorted(set(unet_norm_sites() + vae_decode_norm_sites()))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 128])
@pytest.mark.parametrize("H,C,silu", NORM_SITES)
def test_group_norm_kernel_matches_plain(cuda, H, C, silu, B):
    """Kernel 6 at every served site against the plain version. The kernel
    sums the moments in another order, so its scale and shift may differ
    from the plain version's in their last float32 bits, and a value next
    to a bf16 rounding step rounds the other way: at least 99.9% of the
    elements are within 1 bf16 ulp. Every normalized element (before SiLU)
    is within 1 ulp plus 2^-16 of the sizes of the affine's terms; SiLU's
    output is PyTorch's SiLU of the kernel's own normalized values, bit for
    bit (SiLU turns a 1-ulp step of its input into up to ~8 ulps of its
    output below -2.5). Two launches give the same bits; a call counts
    once. The bound is ``chip_smoke.norm_against_plain``'s, which the
    kernels line reads too."""
    import chip_smoke

    gen = torch.Generator(device=cuda).manual_seed(H * 7 + C + B)
    x = (torch.randn((B, H, H, C), device=cuda, generator=gen) * 1.5 + 0.3).to(torch.bfloat16)
    g = (torch.rand(C, device=cuda, generator=gen) + 0.5).to(torch.bfloat16)
    b = (torch.randn(C, device=cuda, generator=gen) * 0.3).to(torch.bfloat16)
    before = norm.group_norm.launches
    got = norm.group_norm(x, g, b, 32, 1e-5, silu=silu)
    assert torch.equal(got, norm.group_norm(x, g, b, 32, 1e-5, silu=silu))
    pre = norm.group_norm(x, g, b, 32, 1e-5) if silu else got
    torch.cuda.synchronize()
    assert norm.group_norm.launches == before + (3 if silu else 2)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    if silu:
        assert torch.equal(got, F.silu(pre.float()).to(torch.bfloat16))
    xf = x.float()
    s1, s2 = xf.sum(dim=(1, 2)), (xf * xf).sum(dim=(1, 2))
    del xf
    scale, shift = norm.affine_from_moments(s1, s2, g, b, H * H, 32, 1e-5)
    _, excess = chip_smoke.norm_against_plain(
        torch, pre, norm.group_norm_plain(x, g, b, 32, 1e-5), x, scale, shift, b)
    assert excess <= 0, excess
    del pre
    within_one, _ = chip_smoke.norm_against_plain(
        torch, got, norm.group_norm_plain(x, g, b, 32, 1e-5, silu=silu), x, scale, shift, b)
    assert within_one >= 0.999, within_one


@pytest.mark.cuda
def test_group_norm_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 8, 8, 64), dtype=torch.bfloat16, device=cuda)
    v = torch.ones(64, dtype=torch.bfloat16, device=cuda)
    before = norm.group_norm.launches
    with pytest.raises(ValueError):
        norm.group_norm(x.float(), v.float(), v.float())  # float32: the plain version's
    with pytest.raises(ValueError):
        norm.group_norm(x[..., :36].contiguous(), v[:36], v[:36], groups=4)  # C % 8
    with pytest.raises(ValueError):
        norm.group_norm(x.transpose(1, 2), v, v)  # not contiguous
    with pytest.raises(ValueError):
        norm.group_norm(x, v.cpu(), v)
    with pytest.raises(ValueError):
        norm.group_norm(x, v, v.float())  # gamma and beta of two dtypes
    with pytest.raises(RuntimeError):
        norm.group_norm(x.float().requires_grad_(True), v.float(), v.float())
    assert norm.group_norm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(8, 64, 64), (17, 64, 64), (4096, 2880, 320)])
def test_int8_matmul_is_exact_on_the_card(cuda, M, K, N):
    gen = torch.Generator(device=cuda).manual_seed(M)
    a = torch.randint(-127, 128, (M, K), device=cuda, generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (N, K), device=cuda, generator=gen, dtype=torch.int8)
    got = conv.int8_matmul(a, w)
    assert got.dtype == torch.int32 and got.shape == (M, N)
    assert torch.equal(got.cpu().long(), a.cpu().long() @ w.cpu().long().t())


@pytest.mark.cuda
def test_scheduler_pinned_ring_keeps_every_batch(cuda):
    """Many CUDA batches through the two-slot pinned ring: every request
    gets its own rows, and frames handed out earlier are not overwritten."""
    store = AvatarStore(item_shape=(1,), device=cuda)
    store.add("a", np.zeros((64, 1), np.uint8))

    def factory(n):
        def step(model, buffer, idxs, mel):
            return (idxs.view(-1, 1, 1, 1) * torch.ones((1, 8, 8, 3), device=cuda)).to(torch.uint8)
        return step

    sched = BatchScheduler(None, store, factory, batch_size=2, buckets=(1, 2))
    sched.start()
    try:
        futs = [sched.submit(np.array([k, k + 1]) % 64, torch.zeros(2, 1, device=cuda))
                for k in range(0, 40, 2)]
        results = [f.result(timeout=60) for f in futs]
    finally:
        sched.stop()
    for k, r in zip(range(0, 40, 2), results):
        assert r.shape == (2, 8, 8, 3)
        assert (r[0] == k % 64).all() and (r[1] == (k + 1) % 64).all()
    assert sched.requests_run == 20


@pytest.fixture
def cuda1():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a mesh rank's card other than cuda:0")
    return torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_kernels_launch_on_their_tensors_device_and_stream(cuda1, dtype, atol):
    """A rank of a device mesh owns ``cuda:k``, k > 0: kernel 3 (attention)
    and kernel 2 (masked paste) launch on their tensors' device and its
    current stream, whatever the current device is, and match their plain
    versions there."""
    torch.cuda.set_device(0)
    gen = torch.Generator(device=cuda1).manual_seed(1)
    q, k, v = (torch.randn((16, 8, 1024, 40), device=cuda1, generator=gen).to(dtype)
               for _ in range(3))
    rng = np.random.default_rng(7)
    H, W, N, place, S = PASTE_CASES["480x640"]
    _, planes_np, Ho, Wo = _masked_planes(rng, H, W, N, place)
    planes = [torch.from_numpy(p).to(cuda1) for p in planes_np]
    frames = torch.from_numpy(rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8)).to(cuda1)
    pred = torch.from_numpy(rng.integers(0, 256, (16, S, S, 3), dtype=np.uint8)).to(cuda1)
    idxs = torch.from_numpy(rng.integers(0, N, (16,)).astype(np.int32)).to(cuda1)
    launches = (attention.attention.launches, blend.blend_masked_.launches)
    side = torch.cuda.Stream(cuda1)
    side.wait_stream(torch.cuda.current_stream(cuda1))
    with torch.cuda.stream(side):
        got = attention.attention(q, k, v, 40 ** -0.5)
        pasted = blend.make_masked_paste_fn(S, Ho, Wo, H, W)(pred, frames, idxs, *planes)
    torch.cuda.synchronize(cuda1)
    assert (attention.attention.launches, blend.blend_masked_.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert got.device == cuda1 and pasted.device == cuda1
    want = attention.attention_plain(q, k, v, 40 ** -0.5)
    assert float((got.float() - want.float()).abs().max()) <= atol
    plain = blend.masked_paste_plain(pred, frames, idxs, *planes, S=S, Ho=Ho, Wo=Wo, H=H, W=W)
    assert int((pasted.int() - plain.int()).abs().max()) <= 1
