"""The training-only nets of the port against the JAX package's on the
CPU, in f32: the generic SyncNet, the Wav2Lip quality discriminator, the
multi-scale patch discriminator and MuseTalk's sync expert (outputs and
losses atol 1e-5), with weights carried over by ``params_from_jax``, and
the MuseTalk expert's converter of the reference checkpoint layout (with
and without the ``module.`` prefix) against the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.models import multiscale_disc as jmd
from livetalking_tpu.models import musetalk_syncnet as jms
from livetalking_tpu.models import syncnet as jsn
from livetalking_tpu.models import wav2lip_disc as jwd
from livetalking_tpu_torch.models import multiscale_disc as tmd
from livetalking_tpu_torch.models import musetalk_syncnet as tms
from livetalking_tpu_torch.models import syncnet as tsn
from livetalking_tpu_torch.models import wav2lip_disc as twd
from test_musetalk_syncnet import TINY, TSyncNet, _init
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

ATOL = 1e-5
TCFG = tms.SyncNetConfig.from_dict({
    "audio_encoder": {"in_channels": 1, "block_out_channels": [32, 64],
                      "downsample_factors": [2, [2, 3]], "attn_blocks": [0, 1]},
    "visual_encoder": {"in_channels": 6, "block_out_channels": [32, 64],
                       "downsample_factors": [[1, 2], 2], "attn_blocks": [1, 0]}})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _init_np(fn, seed, *static):
    """The JAX package's init, compiled once (eager init compiles every op)."""
    return _np(jax.jit(fn, static_argnums=tuple(range(1, 1 + len(static))))(
        jax.random.PRNGKey(seed), *static))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def test_syncnet_embeddings_losses_and_probability(rng):
    jp = _init_np(jsn.init_params, 0, 64)
    tp = tsn.params_from_jax(jp)
    faces = rng.random((3, 32, 64, 15)).astype(np.float32)
    mels = rng.standard_normal((3, 80, 16, 1)).astype(np.float32)
    labels = np.array([1.0, 0.0, 1.0], np.float32)
    jv, ja = jax.jit(jsn.apply)(jp, jnp.asarray(faces), jnp.asarray(mels))
    tv, ta = tp(_t(faces), _t(mels))
    assert tv.shape == (3, tsn.EMBED) and ta.shape == (3, tsn.EMBED)
    _close(tv, jv)
    _close(ta, ja)
    _close(tsn.cosine_bce_loss(tv, ta, _t(labels)), jsn.cosine_bce_loss(jv, ja, labels))
    _close(tsn.sync_probability(tp, _t(faces), _t(mels)),
           jsn.sync_probability(jp, jnp.asarray(faces), jnp.asarray(mels)))


def test_wav2lip_disc_logits_and_bce(rng):
    jp = _init_np(jwd.init_params, 1, 64)
    tp = twd.params_from_jax(jp)
    faces = rng.random((2, 64, 64, 3)).astype(np.float32)
    jl = jax.jit(jwd.apply)(jp, jnp.asarray(faces))
    tl = tp(_t(faces))
    assert tl.shape == (2,)
    _close(tl, jl)
    for target in (0.0, 1.0):
        _close(twd.bce_logits(tl, target), jwd.bce_logits(jl, target))


def test_multiscale_disc_outputs_and_losses(rng):
    jp = _init_np(jmd.init_params, 2)
    tp = tmd.params_from_jax(jp)
    real = rng.random((2, 32, 32, 3)).astype(np.float32)
    fake = rng.random((2, 32, 32, 3)).astype(np.float32)
    jo = jmd.apply(jp, jnp.asarray(real))
    to = tp(_t(real))
    assert [tuple(o.shape) for o in to] == [(2, 2, 2, 1), (2, 1, 1, 1)]
    for a, b in zip(to, jo):
        _close(a, b)
    _close(tmd.gen_loss(tp, _t(fake)), jmd.gen_loss(jp, jnp.asarray(fake)))
    _close(tmd.disc_loss(tp, _t(real), _t(fake)),
           jmd.disc_loss(jp, jnp.asarray(real), jnp.asarray(fake)))
    _close(tmd._downsample(_t(real), 4), jmd._downsample(jnp.asarray(real), 4))


def test_musetalk_syncnet_forward_and_loss(rng):
    jp = _init_np(jms.init_params, 3, TINY)
    tp = tms.params_from_jax(jp)
    faces = rng.random((2, 8, 8, 6)).astype(np.float32)
    audio = rng.standard_normal((2, 8, 12, 1)).astype(np.float32)
    jv, ja = jax.jit(jms.apply, static_argnums=3)(jp, jnp.asarray(faces), jnp.asarray(audio),
                                                  TINY)
    tv, ta = tms.apply(tp, _t(faces), _t(audio), TCFG)
    _close(tv, jv)
    _close(ta, ja)
    labels = np.array([1.0, 0.0], np.float32)  # TINY's towers end at different widths
    _close(tms.cosine_bce_loss(tv, tv.flip(0), _t(labels)),
           jms.cosine_bce_loss(jv, jv[::-1], labels))


def test_config_from_dict_matches_the_reference():
    assert TCFG == tms.SyncNetConfig(
        audio=tms.EncoderConfig(*(getattr(TINY.audio, f) for f in
                                  ("in_channels", "block_out", "downsample_factors",
                                   "attn_blocks"))),
        visual=tms.EncoderConfig(*(getattr(TINY.visual, f) for f in
                                   ("in_channels", "block_out", "downsample_factors",
                                    "attn_blocks"))))


@pytest.mark.parametrize("layout", ["state_dict", "module_prefix"])
def test_musetalk_syncnet_converter_matches_jax(rng, layout):
    m = _init(TSyncNet(TINY), seed=5).eval()
    sd = dict(m.state_dict())
    sd = ({"state_dict": sd} if layout == "state_dict"
          else {"module." + k: v for k, v in sd.items()})
    jp = jms.convert_torch_state_dict(sd, TINY, dtype=jnp.float32)
    tp = tms.convert_torch_state_dict(sd, TCFG)
    assert len(tp["audio_encoder"]["down_blocks"]) == 3
    assert len(tp["visual_encoder"]["down_blocks"]) == 3
    faces = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)
    audio = rng.standard_normal((2, 8, 12, 1)).astype(np.float32)
    jv, ja = jax.jit(jms.apply, static_argnums=3)(jp, jnp.asarray(faces), jnp.asarray(audio),
                                                  TINY)
    tv, ta = tms.apply(tp, _t(faces), _t(audio), TCFG)
    _close(tv, jv)
    _close(ta, ja)


def test_musetalk_default_config_reduces_to_one_cell():
    """MUSETALK: the 16-frame lower-half window and the 52-column mel both
    end at one spatial cell, so the embeddings have one width."""
    tp = tms.init_params(0)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        v, a = tms.apply(tp, torch.rand((1, 128, 256, 48), generator=g),
                         torch.randn((1, 80, 52, 1), generator=g))
    assert v.shape == a.shape == (1, 1024)
    torch.testing.assert_close(v.norm(dim=-1), torch.ones(1))
