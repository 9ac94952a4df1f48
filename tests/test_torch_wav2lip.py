"""Wav2Lip-256 of the PyTorch port against the JAX package's.

One random state dict in the reference checkpoint's layout (conv +
BatchNorm per layer, randomized running stats so folding is exercised) is
made with numpy. The JAX package converts it with its own
``convert_torch_state_dict``; its folded tree reaches the port through
``params_from_jax``. Both run fp32 on the CPU. Bars are the JAX package's
own (tests/test_wav2lip.py): atol 2e-4 for the forward pass, 1 LSB for the
uint8 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.models import wav2lip as jw
from livetalking_tpu_torch.models import layers as tl
from livetalking_tpu_torch.models import wav2lip as tw

FWD_ATOL = 2e-4
S = 256


def reference_state_dict(seed: int = 0) -> dict:
    """Random ``wav2lip.pth`` state_dict (reference key layout) in numpy:
    PyTorch-default-sized conv weights, BN with random running stats."""
    rng = np.random.default_rng(seed)
    sd = {}

    def layer(prefix, s):
        kh, kw = tl._pair(s.kernel)
        bound = 1.0 / np.sqrt(s.cin * kh * kw)
        shape = (s.cin, s.cout, kh, kw) if s.transpose else (s.cout, s.cin, kh, kw)
        conv = f"{prefix}.conv_block.0" if s.bn else prefix
        sd[f"{conv}.weight"] = rng.uniform(-bound, bound, shape).astype(np.float32)
        sd[f"{conv}.bias"] = rng.uniform(-bound, bound, s.cout).astype(np.float32)
        if s.bn:
            bn = f"{prefix}.conv_block.1"
            sd[f"{bn}.weight"] = rng.uniform(0.5, 1.5, s.cout).astype(np.float32)
            sd[f"{bn}.bias"] = rng.normal(0, 0.2, s.cout).astype(np.float32)
            sd[f"{bn}.running_mean"] = rng.normal(0, 0.5, s.cout).astype(np.float32)
            sd[f"{bn}.running_var"] = rng.uniform(0.5, 2.0, s.cout).astype(np.float32)

    for i, blk in enumerate(jw.FACE_ENCODER):
        for j, s in enumerate(blk):
            layer(f"face_encoder_blocks.{i}.{j}", s)
    for j, s in enumerate(jw.AUDIO_ENCODER):
        layer(f"audio_encoder.{j}", s)
    for i, blk in enumerate(jw.FACE_DECODER):
        for j, s in enumerate(blk):
            layer(f"face_decoder_blocks.{i}.{j}", s)
    for j, s in enumerate(jw.OUTPUT_BLOCK):
        layer(f"output_block.{j}", s)
    return sd


def shared_weights(seed: int = 0):
    """(JAX fp32 params, port fp32 module on the CPU) with the same weights."""
    params = jw.convert_torch_state_dict(reference_state_dict(seed), dtype=jnp.float32)
    net = tw.params_from_jax(jax.tree.map(np.asarray, params))
    return params, tw.prepare(net, "cpu", torch.float32)


@pytest.fixture(scope="module")
def weights():
    return shared_weights()


def _fields(table):
    return [_fields(t) if isinstance(t, list) else dataclasses.astuple(t) for t in table]


@pytest.mark.parametrize("name", ["FACE_ENCODER", "AUDIO_ENCODER", "FACE_DECODER", "OUTPUT_BLOCK"])
def test_tables_are_the_reference_tables(name):
    assert _fields(getattr(tw, name)) == _fields(getattr(jw, name))


def test_forward_matches_jax(weights):
    params, net = weights
    rng = np.random.default_rng(1)
    B = 2
    mel = rng.standard_normal((B, 80, 16, 1)).astype(np.float32)
    face = rng.random((B, S, S, 6)).astype(np.float32)
    want = np.asarray(jw.apply(params, jnp.asarray(mel), jnp.asarray(face)))
    with torch.inference_mode():
        got = net(torch.from_numpy(mel), torch.from_numpy(face)).numpy()
    assert got.shape == want.shape == (B, S, S, 3)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


def test_infer_step_matches_jax(weights):
    params, net = weights
    rng = np.random.default_rng(2)
    N, B = 5, 2
    cycle = rng.integers(0, 256, (N, S, S, 3), dtype=np.uint8)
    idxs = np.array([4, 1], np.int32)
    mel = rng.standard_normal((B, 80, 16)).astype(np.float32)
    want = np.asarray(jw.make_infer_fn(B, S, dtype=jnp.float32)(
        params, jnp.asarray(cycle), jnp.asarray(idxs), jnp.asarray(mel)))
    got = tw.make_infer_fn(B, S, dtype=torch.float32)(
        net, torch.from_numpy(cycle), torch.from_numpy(idxs), torch.from_numpy(mel))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (B, S, S, 3)
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_step_rejects_wrong_batch(weights):
    _, net = weights
    step = tw.make_infer_fn(2, S, dtype=torch.float32)
    with pytest.raises(ValueError):
        step(net, torch.zeros((1, S, S, 3), dtype=torch.uint8), torch.zeros(3, dtype=torch.long),
             torch.zeros((3, 80, 16)))


class _RecordingSD(dict):
    """A state dict that records every key the converter reads."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self.read.add(k)
        return super().get(k, default)


def test_convert_state_dict_matches_jax_and_reads_every_key(weights, monkeypatch):
    params, net = weights
    sd = reference_state_dict()
    recorded = []
    convert_layer = tw._convert_layer

    def recording_convert_layer(d, prefix, spec):
        rec = _RecordingSD(d)
        recorded.append(rec)
        return convert_layer(rec, prefix, spec)

    monkeypatch.setattr(tw, "_convert_layer", recording_convert_layer)
    got = tw.convert_torch_state_dict({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()})
    read = set().union(*(r.read for r in recorded))
    assert read == set(sd), sorted(set(sd) - read)[:5]
    for (name, a), b in zip(got.state_dict().items(), net.state_dict().values()):
        torch.testing.assert_close(a, b.to(a.dtype), rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("transpose", [False, True])
def test_hwio_layouts_round_trip(transpose):
    w = np.random.default_rng(3).standard_normal((4, 5, 3, 2)).astype(np.float32)
    if transpose:
        np.testing.assert_array_equal(tl.hwio_to_torch_tconv(tl.torch_tconv_to_hwio(w)), w)
    else:
        np.testing.assert_array_equal(tl.hwio_to_torch_conv(tl.torch_conv_to_hwio(w)), w)


def test_init_model_shapes_and_range():
    net = tw.init_model(seed=0)
    assert 45e6 < tw.count_params(net) < 60e6
    with torch.inference_mode():
        out = net(torch.zeros(1, 80, 16, 1), torch.zeros(1, S, S, 6))
    assert tuple(out.shape) == (1, S, S, 3)
    assert bool(((out >= 0) & (out <= 1)).all())
    # seeded: the same seed gives the same weights
    a = next(iter(net.parameters()))
    b = next(iter(tw.init_model(seed=0).parameters()))
    assert torch.equal(a, b)
