"""The port's CUDA paths on the card: each kernel against its plain
PyTorch version, and the scheduler's pinned device->host ring.

Every test here needs a CUDA device and skips without one. The file
imports nothing of JAX, so on a host without JAX it runs as

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from livetalking_tpu_torch.engine.scheduler import AvatarStore, BatchScheduler
from livetalking_tpu_torch.ops import blend

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
