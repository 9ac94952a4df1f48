"""The port's Whisper front end against the JAX package on the CPU: the
log-mel spectrogram (30 s window and the short serving window), the
encoder's stacked hidden states, the HF-layout converter, the feature
window gather, the batched encode the feature coalescer runs, and the
port's own ``FeatureCoalescer``.

Inputs come from numpy with a seed; both encoders get the same weights
through ``params_from_jax``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livetalking_tpu.audio_features import base as jbase
from livetalking_tpu.audio_features import whisper_features as jwf
from livetalking_tpu.models import whisper_encoder as jwe
from livetalking_tpu.ops import whisper_mel as jwm
from livetalking_tpu_torch.audio_features import base as tbase
from livetalking_tpu_torch.audio_features import whisper_features as twf
from livetalking_tpu_torch.engine.feature_coalescer import FeatureCoalescer
from livetalking_tpu_torch.models import whisper_encoder as twe
from livetalking_tpu_torch.ops import whisper_mel as twm
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

MEL_ATOL = 2e-5   # f32 STFT + filterbank in two libraries' summation orders
ENC_ATOL = 2e-4   # tests/test_whisper.py's bar for the encoder against HF

SMALL = dict(d_model=64, num_layers=2, num_heads=2, ffn=128, max_positions=100)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _wav(rng, n):
    t = np.arange(n) / 16000
    return (0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """Whisper-tiny at its published widths, f32, the same weights on both
    sides."""
    jp = jwe.init_params(jax.random.PRNGKey(0), jwe.TINY, jnp.float32)
    return jp, twe.params_from_jax(_np_tree(jp))


@pytest.mark.parametrize("n_samples", [None, 16640])
def test_log_mel_matches_jax(rng, n_samples):
    wav = _wav(rng, 16000)
    kw = {} if n_samples is None else {"n_samples": n_samples}
    want = np.asarray(jwm.log_mel_spectrogram(jnp.asarray(wav), **kw))
    got = twm.log_mel_spectrogram(torch.from_numpy(wav), **kw).numpy()
    assert got.shape == want.shape == (80, (n_samples or 480000) // 160)
    np.testing.assert_allclose(got, want, atol=MEL_ATOL)


def test_log_mel_batch_rows_equal_single(rng):
    wavs = np.stack([_wav(rng, 6400), _wav(rng, 6400) * 0.5])
    batch = twm.log_mel_spectrogram(torch.from_numpy(wavs), n_samples=6400)
    for i in range(2):
        assert torch.equal(batch[i], twm.log_mel_spectrogram(torch.from_numpy(wavs[i]),
                                                             n_samples=6400))
    with pytest.raises(ValueError):
        twm.log_mel_spectrogram(torch.zeros(7000), n_samples=6400)


def test_encoder_stacked_states_match_jax(tiny, rng):
    jp, tp = tiny
    mel = rng.standard_normal((2, 80, 200)).astype(np.float32)
    want = np.asarray(jwe.apply_stacked(jp, jwe.TINY, jnp.asarray(mel)))
    got = twe.apply_stacked(tp, twe.TINY, torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 100, 5, 384)
    np.testing.assert_allclose(got, want, atol=ENC_ATOL)


def test_hf_state_dict_converter_matches_jax(rng):
    """One HF-layout state dict (``model.encoder.`` keys, conv1d (O, I, K),
    linears (out, in)) through both converters."""
    cfg_j, cfg_t = jwe.WhisperConfig(**SMALL), twe.WhisperConfig(**SMALL)
    D, F = SMALL["d_model"], SMALL["ffn"]

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1)

    sd = {"model.encoder.conv1.weight": r(D, 80, 3), "model.encoder.conv1.bias": r(D),
          "model.encoder.conv2.weight": r(D, D, 3), "model.encoder.conv2.bias": r(D),
          "model.encoder.embed_positions.weight": r(100, D),
          "model.encoder.layer_norm.weight": 1 + r(D), "model.encoder.layer_norm.bias": r(D),
          "model.decoder.layer_norm.weight": r(D)}  # other prefixes are ignored
    for i in range(SMALL["num_layers"]):
        b = f"model.encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{b}.self_attn.{name}.weight"] = r(D, D)
            if name != "k_proj":
                sd[f"{b}.self_attn.{name}.bias"] = r(D)
        for name in ("self_attn_layer_norm", "final_layer_norm"):
            sd[f"{b}.{name}.weight"] = 1 + r(D)
            sd[f"{b}.{name}.bias"] = r(D)
        sd[f"{b}.fc1.weight"], sd[f"{b}.fc1.bias"] = r(F, D), r(F)
        sd[f"{b}.fc2.weight"], sd[f"{b}.fc2.bias"] = r(D, F), r(D)
    jp = jwe.convert_torch_state_dict(sd, cfg_j, dtype=jnp.float32)
    tp = twe.convert_torch_state_dict(sd, cfg_t, dtype=torch.float32)
    mel = rng.standard_normal((1, 80, 160)).astype(np.float32)
    want = np.asarray(jwe.apply_stacked(jp, cfg_j, jnp.asarray(mel)))
    got = twe.apply_stacked(tp, cfg_t, torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, atol=ENC_ATOL)


@pytest.mark.parametrize("batch,start,feat_len", [(16, 5, 1500), (2, 5, 12), (4, 0, 7)])
def test_clamp_window_indices_match_jax(batch, start, feat_len):
    args = (batch, feat_len, (0, 5), start, 2.0)
    np.testing.assert_array_equal(tbase.clamp_window_indices(*args),
                                  jbase.clamp_window_indices(*args))


@pytest.mark.parametrize("short", [True, False])
def test_batched_encode_matches_jax_and_rows_equal_solo(tiny, rng, short):
    """The coalescer's batched encode: each row equals the same window
    encoded alone, exactly, and the batch agrees with the JAX package's
    batched encode."""
    jp, tp = tiny
    B, l, r = 2, 10, 10
    tf, n = twf.make_batched_encode_factory(tp, twe.TINY, B, l, r, short_window=short,
                                            device="cpu")
    jf, jn = jwf.make_batched_encode_factory(jp, jwe.TINY, B, l, r, short_window=short)
    assert n == jn == (2 * B + l + r) * 320
    wavs = np.stack([_wav(rng, n), 0.5 * _wav(rng, n)])
    got = tf(2)(wavs)
    assert tuple(got.shape) == (2, B, 50, 384) and got.dtype == torch.float32
    for i in range(2):
        assert torch.equal(got[i], tf(1)(wavs[i:i + 1])[0])
    np.testing.assert_allclose(got.numpy(), np.asarray(jf(2)(wavs)), atol=ENC_ATOL)


def test_whisper_features_solo_rows_equal_coalesced(tiny, rng):
    """A session's own encode (``WhisperFeatures._fn``) equals its row of
    the batched encode."""
    from livetalking_tpu_torch.config import default_opt

    _, tp = tiny
    opt = default_opt(batch_size=2, device="cpu", whisper_short_window=True)
    feats = twf.WhisperFeatures(opt, None, whisper_params=tp, whisper_cfg=twe.TINY)
    factory, n = twf.make_batched_encode_factory(tp, twe.TINY, 2, opt.l, opt.r,
                                                 short_window=True, device="cpu")
    wav = _wav(rng, n)
    assert torch.equal(feats._fn(wav), factory(1)(wav[None])[0])
    assert tuple(feats._zero.shape) == (2, 50, 384)


def test_feature_coalescer_batches_and_returns_each_row():
    calls = []

    def factory(k):
        def fn(wavs):
            calls.append(wavs.shape[0])
            return torch.from_numpy(wavs[:, :1] * 10)
        return fn

    fc = FeatureCoalescer(factory, 4, buckets=(1, 2, 4))
    futs = [fc.submit(np.full(4, i, np.float32)) for i in range(3)]
    fc.start()
    try:
        rows = [f.result(timeout=30) for f in futs]
        assert fc.encode(np.full(4, 7, np.float32), timeout=30).item() == 70
    finally:
        fc.stop()
    assert [r.item() for r in rows] == [0, 10, 20]
    assert calls[0] == 4  # three queued requests padded into the 4 bucket
    assert fc.requests_run == 4 and fc.batches_run == 2
    with pytest.raises(ValueError):
        fc.submit(np.zeros(5, np.float32))
    with pytest.raises(RuntimeError):
        fc.submit(np.zeros(4, np.float32))
