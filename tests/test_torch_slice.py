"""The port's serving slice against the JAX package's, end to end on tensors.

The super-batch step the coalesced scheduler runs under
``--device_paste_back`` — Wav2Lip step, then paste-back over the store's
full-frame planes — is built by the port's ``make_step_factory`` and, on
the JAX side, composed exactly as livetalking_tpu/avatars/wav2lip_avatar.py
composes it (``make_infer_fn`` + ``make_resize_paste_fn``, the XLA twin on
the CPU). Same weights (``params_from_jax``), same two-avatar store, cycle
indices and mel, fp32 on the CPU.

Bars: 2 LSB for the composed step (1 for the uint8 step, 1 for the
blend). For PCM -> mel -> frames in one chain the mel front-ends differ by
up to ~1e-5 (float32 FFTs in another order) and the U-Net carries that to
the frames; measured at most 1 LSB on these inputs, so the chain keeps the
same 2 LSB bar.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.models import wav2lip as jw
from livetalking_tpu.ops import mel as jmel
from livetalking_tpu.ops import pallas_blend as pb
from livetalking_tpu_torch.avatars import wav2lip_avatar as tav
from livetalking_tpu_torch.engine.scheduler import AvatarStore
from livetalking_tpu_torch.ops import mel as tmel
from livetalking_tpu_torch.ops.blend import bucket_shape
from tests.test_torch_wav2lip import shared_weights

S, H, W = 256, 480, 640
BAR_LSB = 2


@pytest.fixture(scope="module")
def slice_inputs():
    rng = np.random.default_rng(11)
    avatars = []
    for n in (3, 4):
        frames = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
        faces = rng.integers(0, 256, (n, S, S, 3), dtype=np.uint8)
        boxes = []
        for _ in range(n):
            h, w = int(rng.integers(180, 241)), int(rng.integers(180, 241))
            y1, x1 = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
            boxes.append((y1, y1 + h, x1, x1 + w))
        avatars.append((frames, faces, np.asarray(boxes, np.int32)))
    params, net = shared_weights(seed=1)

    store = AvatarStore(S, device="cpu")
    for k, (frames, faces, boxes) in enumerate(avatars):
        store.add(f"a{k}", faces, aux={"pb_frames": frames, "pb_boxes": boxes})
    all_boxes = np.concatenate([a[2] for a in avatars])
    Ho, Wo = bucket_shape(all_boxes)
    spec = {"S": S, "H": H, "W": W, "Ho": Ho, "Wo": Wo}

    # the JAX composition of wav2lip_avatar.get_shared_scheduler
    j_buffer = jnp.asarray(np.concatenate([a[1] for a in avatars]))
    j_frames = jnp.asarray(np.concatenate([a[0] for a in avatars]))
    j_boxes = jnp.asarray(all_boxes)
    j_paste = pb.make_resize_paste_fn(S, Ho, Wo, H, W)

    def jax_step(n, idxs, mel):
        pred = jw.make_infer_fn(n, S, jnp.float32)(params, j_buffer, jnp.asarray(idxs), mel)
        return np.asarray(j_paste(pred, j_frames, jnp.asarray(idxs), j_boxes))

    def port_step(n, idxs, mel):
        step = tav.make_step_factory(torch.float32, store, spec)(n)
        return step(net, store.buffer, torch.from_numpy(idxs).long(),
                    torch.as_tensor(mel)).numpy()

    return jax_step, port_step


def test_composed_super_batch_step_matches_jax(slice_inputs):
    jax_step, port_step = slice_inputs
    rng = np.random.default_rng(12)
    idxs = np.array([1, 5], np.int32)  # one frame of each avatar (offsets 0, 3)
    mel = np.clip(rng.standard_normal((2, 80, 16)), -4, 4).astype(np.float32)
    want = jax_step(2, idxs, jnp.asarray(mel))
    got = port_step(2, idxs, mel)
    assert got.dtype == np.uint8 and got.shape == want.shape == (2, H, W, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= BAR_LSB


def test_pcm_to_frames_chain_matches_jax(slice_inputs):
    jax_step, port_step = slice_inputs
    B, l, r = 2, 10, 10
    n = (2 * B + l + r) * 320
    t = np.arange(n) / 16000.0
    pcm = (0.3 * np.sin(2 * np.pi * 330 * t)
           + 0.05 * np.random.default_rng(13).standard_normal(n)).astype(np.float32)
    idxs = np.array([2, 6], np.int32)
    want = jax_step(B, idxs, jmel.make_mel_chunks_fn(B, l, r, 25)(pcm))
    got = port_step(B, idxs, tmel.make_mel_chunks_fn(B, l, r, 25, device="cpu")(pcm))
    assert got.shape == want.shape == (B, H, W, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= BAR_LSB
