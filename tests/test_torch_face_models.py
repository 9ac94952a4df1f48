"""The port's face models (S3FD, BiSeNet, PFLD) against the JAX package
on the CPU, in f32.

Weights come from the port's seeded inits (laid out for the JAX package
by the inverse of ``params_from_jax``) or from random state dicts in the reference
checkpoint layouts (the recomposed torch modules of tests/test_s3fd.py and
tests/test_pfld.py, a BiSeNet state dict built here), through both
packages' converters. Each JAX function is compiled once per module.

Bars: S3FD class scores atol 1e-5 and box offsets atol 1e-4 per scale at
64x64, decoded boxes atol 1e-4, detections (count and boxes atol 1e-3)
equal; BiSeNet logits atol 2e-3 (logits reach about 100) and class maps
equal at 64 px; PFLD offsets atol 1e-5 and landmarks equal at 192 px;
the three converters give identical trees. The S3FD detector's chunking
and its out-of-memory retry are the port's own contract.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livetalking_tpu.models import bisenet as jb
from livetalking_tpu.models import pfld as jpf
from livetalking_tpu.models import s3fd as js
from livetalking_tpu_torch.models import bisenet as tb
from livetalking_tpu_torch.models import pfld as tpf
from livetalking_tpu_torch.models import s3fd as ts
from test_pfld import TorchPFLD, _randomize
from test_s3fd import TorchS3FD, _init
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

CLS_ATOL, REG_ATOL = 1e-5, 1e-4
BOX_ATOL = 1e-3
BISENET_ATOL = 2e-3
PFLD_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_layout(tree):
    """A port tree as the JAX package's (numpy, HWIO convs): builds the JAX
    side's weights without its eager seeded init."""
    if torch.is_tensor(tree):
        a = tree.numpy()
        return a.transpose(2, 3, 1, 0).copy() if a.ndim == 4 else a
    if isinstance(tree, list):
        return [_jax_layout(v) for v in tree]
    return {k: _jax_layout(v) for k, v in tree.items()}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_trees_equal(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


# --- S3FD --------------------------------------------------------------------


@pytest.fixture(scope="module")
def s3fd_pair():
    tp = ts.init_params(0)
    jp = _jax_layout(tp)
    _assert_trees_equal(ts.params_from_jax(jp), tp)
    return jp, tp


@pytest.fixture(scope="module")
def s3fd_frames():
    return np.random.default_rng(1).integers(0, 255, (2, 96, 130, 3), np.uint8)


@pytest.fixture(scope="module")
def s3fd_jax_detections(s3fd_pair, s3fd_frames):
    return js.S3FDDetector(s3fd_pair[0], score_thresh=0.0).detect_batch(s3fd_frames)


def test_s3fd_tower_matches_jax(s3fd_pair, rng):
    jp, tp = s3fd_pair
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32) * 30
    want = js.apply(jp, jnp.asarray(x))
    got = ts.apply(tp, torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 6
    for i, ((cw, rw), (cg, rg)) in enumerate(zip(want, got)):
        assert tuple(cg.shape) == cw.shape and tuple(rg.shape) == rw.shape
        np.testing.assert_allclose(cg.numpy(), np.asarray(cw), atol=CLS_ATOL, err_msg=f"cls {i}")
        np.testing.assert_allclose(rg.numpy(), np.asarray(rw), atol=REG_ATOL, err_msg=f"reg {i}")


def test_s3fd_decode_matches_jax(rng):
    cls = rng.random((2, 4, 5, 2)).astype(np.float32)
    reg = (rng.standard_normal((2, 4, 5, 4)) * 0.3).astype(np.float32)
    for stride in (4, 8, 128):
        want = np.asarray(js._decode_scale(jnp.asarray(cls), jnp.asarray(reg), stride))
        got = ts._decode_scale(torch.from_numpy(cls), torch.from_numpy(reg), stride).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_s3fd_nms_matches_jax(rng):
    boxes = rng.random((40, 5)).astype(np.float32) * [100, 100, 0, 0, 1]
    boxes[:, 2:4] = boxes[:, :2] + 20 + rng.random((40, 2)) * 30
    np.testing.assert_array_equal(ts.nms(boxes, 0.3), js.nms(boxes, 0.3))


def test_s3fd_detector_contract_and_detections_match_jax(s3fd_pair, s3fd_frames,
                                                         s3fd_jax_detections):
    """Frames padded to 128 multiples, per-frame (N, 5) arrays clipped to
    the frame; the same detections as the JAX package's detector."""
    det = ts.S3FDDetector(s3fd_pair[1], score_thresh=0.0, device="cpu")
    out = det.detect_batch(s3fd_frames)
    assert len(out) == 2
    for got, want in zip(out, s3fd_jax_detections):
        assert got.ndim == 2 and got.shape[1] == 5 and len(got) == len(want) > 0
        assert (got[:, [0, 1]] >= 0).all() and (got[:, 2] <= 130).all() and (got[:, 3] <= 96).all()
        np.testing.assert_allclose(got, want, atol=BOX_ATOL)


def test_s3fd_chunks_pad_the_tail(s3fd_pair, s3fd_frames, s3fd_jax_detections):
    """7 frames at max_batch 4: two chunks of 4, the tail zero-padded, and
    each frame's detections those of the unchunked run."""
    det = ts.S3FDDetector(s3fd_pair[1], score_thresh=0.0, max_batch=4, device="cpu")
    frames = np.concatenate([s3fd_frames] * 4)[:7]
    calls = []
    real = det._detect_chunk
    det._detect_chunk = lambda block: calls.append(block.shape[0]) or real(block)
    out = det.detect_batch(frames)
    assert calls == [4, 4] and len(out) == 7
    for k, got in enumerate(out):
        np.testing.assert_allclose(got, s3fd_jax_detections[k % 2], atol=BOX_ATOL)


def test_s3fd_out_of_memory_halves_the_odd_chunk(s3fd_pair, s3fd_frames, s3fd_jax_detections,
                                                 caplog):
    """A CUDA out-of-memory error at chunk 5 is logged with 5 (the chunk
    that failed) and retried at 2; any other error propagates."""
    det = ts.S3FDDetector(s3fd_pair[1], score_thresh=0.0, max_batch=5, device="cpu")
    frames = np.concatenate([s3fd_frames] * 3)[:5]
    calls = []
    real = det._detect_chunk

    def oom_at_5(block):
        calls.append(block.shape[0])
        if block.shape[0] == 5:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(block)

    det._detect_chunk = oom_at_5
    with caplog.at_level(logging.WARNING, logger="livetalking_tpu_torch"):
        out = det.detect_batch(frames)
    assert calls == [5, 2, 2, 2] and len(out) == 5
    assert "at batch 5 - retrying at 2" in caplog.text
    for k, got in enumerate(out):
        np.testing.assert_allclose(got, s3fd_jax_detections[k % 2], atol=BOX_ATOL)

    det._detect_chunk = lambda block: (_ for _ in ()).throw(RuntimeError("cuDNN error"))
    with pytest.raises(RuntimeError, match="cuDNN error"):
        det.detect_batch(frames)
    one = ts.S3FDDetector(s3fd_pair[1], max_batch=1, device="cpu")
    one._detect_chunk = lambda block: (_ for _ in ()).throw(torch.cuda.OutOfMemoryError("oom"))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        one.detect_batch(frames[:1])


def test_s3fd_converter_matches_the_jax_converter():
    sd = dict(_init(TorchS3FD(), seed=3).state_dict())
    want = ts.params_from_jax(_np_tree(js.convert_torch_state_dict(sd)))
    _assert_trees_equal(ts.convert_torch_state_dict(sd), want)


# --- BiSeNet -----------------------------------------------------------------


@pytest.fixture(scope="module")
def bisenet_pair():
    tp = tb.init_params(0)
    jp = _jax_layout(tp)
    _assert_trees_equal(tb.params_from_jax(jp), tp)
    return jp, tp


def test_bisenet_logits_and_class_map_match_jax(bisenet_pair):
    """64 px (and 66 px, an odd /32 ladder): logits within the bar; the
    parse function's class map (BGR uint8 in) equal."""
    jp, tp = bisenet_pair
    rng = np.random.default_rng(5)
    for n in (64, 66):
        x = rng.standard_normal((1, n, n, 3)).astype(np.float32)
        want = np.asarray(jb.apply(jp, jnp.asarray(x)))
        got = tb.apply(tp, torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (1, n, n, tb.N_CLASSES)
        np.testing.assert_allclose(got, want, atol=BISENET_ATOL)
    faces = rng.integers(0, 256, (2, 64, 64, 3), np.uint8)
    want = np.asarray(jb.make_parse_fn(64)(jp, jnp.asarray(faces)))
    got = tb.make_parse_fn(64)(tp, faces)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 64, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    for mode in ("raw", "jaw"):
        np.testing.assert_array_equal(tb.mouth_mask(got.numpy(), mode), jb.mouth_mask(want, mode))


def test_bisenet_stem_pool_is_same_padding():
    """The stem's 3x3/2 max-pool pads as SAME does: nothing before and one
    after on an even side, one on each side on an odd one."""
    x = torch.arange(2 * 6 * 7, dtype=torch.float32).reshape(1, 2, 6, 7)
    want = jax.lax.reduce_window(jnp.asarray(x.permute(0, 2, 3, 1).numpy()), -jnp.inf,
                                 jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME")
    got = tb._maxpool_same(x).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="shrinks"):
        tb._upsize(x, (3, 3))


def _bisenet_state_dict(seed=0):
    """A random face-parsing BiSeNet checkpoint in the reference key layout."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv_bn(prefix, cin, cout, k, bn_prefix):
        sd[prefix + ".weight"] = torch.randn((cout, cin, k, k), generator=g) / (cin * k * k) ** 0.5
        sd[bn_prefix + ".weight"] = 1 + 0.1 * torch.randn(cout, generator=g)
        sd[bn_prefix + ".bias"] = 0.1 * torch.randn(cout, generator=g)
        sd[bn_prefix + ".running_mean"] = 0.1 * torch.randn(cout, generator=g)
        sd[bn_prefix + ".running_var"] = 0.5 + torch.rand(cout, generator=g)

    def conv_b(prefix, cin, cout):
        sd[prefix + ".weight"] = torch.randn((cout, cin, 1, 1), generator=g) / cin ** 0.5
        sd[prefix + ".bias"] = 0.1 * torch.randn(cout, generator=g)

    rn = "cp.resnet"
    conv_bn(f"{rn}.conv1", 3, 64, 7, f"{rn}.bn1")
    for li, (cin, cout, down) in enumerate([(64, 64, False), (64, 128, True), (128, 256, True),
                                            (256, 512, True)], start=1):
        for bi in range(2):
            pref = f"{rn}.layer{li}.{bi}"
            conv_bn(f"{pref}.conv1", cin if bi == 0 else cout, cout, 3, f"{pref}.bn1")
            conv_bn(f"{pref}.conv2", cout, cout, 3, f"{pref}.bn2")
            if bi == 0 and down:
                conv_bn(f"{pref}.downsample.0", cin, cout, 1, f"{pref}.downsample.1")
    for arm, cin in (("arm16", 256), ("arm32", 512)):
        conv_bn(f"cp.{arm}.conv.conv", cin, 128, 3, f"cp.{arm}.conv.bn")
        conv_bn(f"cp.{arm}.conv_atten", 128, 128, 1, f"cp.{arm}.bn_atten")
    conv_bn("cp.conv_avg.conv", 512, 128, 1, "cp.conv_avg.bn")
    conv_bn("cp.conv_head32.conv", 128, 128, 3, "cp.conv_head32.bn")
    conv_bn("cp.conv_head16.conv", 128, 128, 3, "cp.conv_head16.bn")
    conv_bn("ffm.convblk.conv", 256, 256, 1, "ffm.convblk.bn")
    conv_b("ffm.conv1", 256, 64)
    conv_b("ffm.conv2", 64, 256)
    conv_bn("conv_out.conv.conv", 256, 256, 3, "conv_out.conv.bn")
    conv_b("conv_out.conv_out", 256, 19)
    return sd


def test_bisenet_converter_matches_the_jax_converter():
    sd = _bisenet_state_dict()
    want = tb.params_from_jax(_np_tree(jb.convert_torch_state_dict(sd)))
    got = tb.convert_torch_state_dict(sd)
    _assert_trees_equal(got, want)
    logits = tb.apply(got, torch.zeros((1, 3, 64, 64)))
    assert tuple(logits.shape) == (1, 19, 64, 64) and bool(torch.isfinite(logits).all())


# --- PFLD --------------------------------------------------------------------


@pytest.fixture(scope="module")
def pfld_pair():
    """The port's seeded init in both packages: one JAX compile of the
    forward for the module."""
    tp = tpf.init_params(0)
    jp = _jax_layout(tp)
    _assert_trees_equal(tpf.params_from_jax(jp), tp)
    return jp, tp, jax.jit(jpf.apply)


def test_pfld_converter_matches_the_jax_converter():
    """The reference-layout torch PFLD (every MobileOne branch, named
    children) through both converters; one block's fold; a block with no
    branches raises."""
    sd = {"pfld_backbone": dict(_randomize(TorchPFLD(), seed=1).eval().state_dict())}
    _assert_trees_equal(tpf.convert_torch_state_dict(sd),
                        tpf.params_from_jax(_np_tree(jpf.convert_torch_state_dict(sd))))
    one = {"blk." + k: v for k, v in _randomize(TorchPFLD().conv7, seed=2).state_dict().items()}
    want = jpf._fold_mobileone(one, "blk", 8, 16, 3, 1, jnp.float32)
    got = tpf._fold_mobileone(one, "blk", 8, 16, 3, 1)
    np.testing.assert_array_equal(got["w"].transpose(2, 3, 1, 0), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"], np.asarray(want["b"]))
    with pytest.raises(KeyError, match="unrecognized MobileOne"):
        tpf._fold_mobileone({}, "blk", 8, 16, 3, 1)


def test_pfld_offsets_and_landmarks_match_jax(pfld_pair, rng):
    jp, tp, jfn = pfld_pair
    x = rng.random((2, 192, 192, 3)).astype(np.float32)
    want = np.asarray(jfn(jp, jnp.asarray(x)))
    got = tpf.apply(tp, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == want.shape == (2, 2 * tpf.N_LANDMARKS)
    np.testing.assert_allclose(got, want, atol=PFLD_ATOL)

    mean = np.tile(np.asarray([0.5, 0.45], np.float32), tpf.N_LANDMARKS)
    frame = rng.integers(0, 255, (240, 320, 3), np.uint8)
    jlk = jpf.PFLDLandmarker(jp, mean)
    jlk._fn = jfn
    tlk = tpf.PFLDLandmarker(tp, mean, device="cpu")
    for box in ((100, 60, 220, 180), (-10, 150, 90, 260)):  # inside; over two edges
        lm = tlk.landmarks(frame, box)
        assert lm.shape == (tpf.N_LANDMARKS, 2) and lm.dtype == np.int32
        np.testing.assert_array_equal(lm, jlk.landmarks(frame, box))


def test_pfld_mean_face_file(tmp_path):
    mean = np.linspace(0, 1, 2 * tpf.N_LANDMARKS).astype(np.float32)
    path = tmp_path / "mean_face.txt"
    path.write_text(" ".join(f"{v:.6f}" for v in mean))
    np.testing.assert_array_equal(tpf.load_mean_face(str(path)), jpf.load_mean_face(str(path)))
    with pytest.raises(ValueError, match="mean face"):
        tpf.PFLDLandmarker(tpf.init_params(0), mean[:10], device="cpu")


def test_random_inits_run():
    """The port's own seeded inits (the zero-checkpoint path) give finite
    outputs of the contract's shapes."""
    assert isinstance(ts.init_params(0)["conv1_1"]["w"], torch.Tensor)
    logits = tb.apply(tb.init_params(0), torch.zeros((1, 3, 32, 32)))
    assert tuple(logits.shape) == (1, 19, 32, 32) and bool(torch.isfinite(logits).all())
    off = tpf.apply(tpf.init_params(0), torch.rand((1, 3, 192, 192)))
    assert tuple(off.shape) == (1, 220) and bool(torch.isfinite(off).all())
