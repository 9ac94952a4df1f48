"""HuBERT and its feature extractor in the PyTorch port against the JAX
package's.

Random weights come from the JAX package's ``init_params`` and reach the
port through ``params_from_jax``; the converters read one random state
dict with ``HubertModel``'s keys, made with numpy, in both weight-norm
layouts of the positional conv. Everything runs in f32 on the CPU. The bar
is the JAX package's own (tests/test_hubert.py): atol 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.audio_features.hubert_features import HubertFeatures as JaxFeatures
from livetalking_tpu.avatars.ultralight_avatar import TINY_HUBERT as JAX_TINY
from livetalking_tpu.config import default_opt as jax_opt
from livetalking_tpu.models import hubert as jh
from livetalking_tpu_torch.audio_features.hubert_features import HubertFeatures
from livetalking_tpu_torch.avatars.ultralight_avatar import TINY_HUBERT
from livetalking_tpu_torch.config import default_opt
from livetalking_tpu_torch.models import hubert as th
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

ATOL = 2e-4
CONFIGS = {
    "tiny-stableLN": TINY_HUBERT,  # the serving config without weights: 2 pre-LN layers
    # BASE's layout (group norm, no conv bias, post-LN), 2 narrow layers
    "base2-postLN": dataclasses.replace(th.BASE, num_layers=2, conv_dim=(64,) * 7,
                                        hidden_size=256, num_heads=4, intermediate_size=512),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_cfg(cfg):
    return jh.HubertConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(jh.apply, static_argnums=(1,))


def test_tiny_config_and_lengths_match_the_reference():
    assert dataclasses.asdict(TINY_HUBERT) == dataclasses.asdict(JAX_TINY)
    for ours, theirs in ((th.LARGE, jh.LARGE), (th.BASE, jh.BASE)):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for T in (16640, 16000, 32000, 7680):
        assert th.LARGE.out_length(T) == jh.LARGE.out_length(T) == (T - 80) // 320
    assert th.LARGE.receptive_field == 400 and th.LARGE.total_stride == 320


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_hubert_matches_jax(name, jax_apply):
    cfg = CONFIGS[name]
    jp = jh.init_params(jax.random.PRNGKey(3), _jax_cfg(cfg), jnp.float32)
    tp = th.params_from_jax(_np_tree(jp))
    wav = np.random.default_rng(0).standard_normal((2, 3200)).astype(np.float32) * 0.3
    want = np.asarray(jax_apply(jp, _jax_cfg(cfg), jnp.asarray(wav)))
    got = th.apply(tp, cfg, torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, cfg.out_length(3200), cfg.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL)


SMALL = th.HubertConfig(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
                        hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
                        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _state_dict(cfg, layout: str, seed: int = 0) -> dict:
    """A random ``HubertModel`` state dict of ``cfg`` with numpy values; the
    positional conv's weight norm in the old (weight_g/weight_v) or the
    new (parametrizations) layout."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, *shape, scale=0.1):
        sd[key] = (rng.standard_normal(shape) * scale).astype(np.float32)

    cin = 1
    for i, (d, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        base = f"feature_extractor.conv_layers.{i}"
        put(f"{base}.conv.weight", d, cin, k, scale=1 / np.sqrt(k * cin))
        if cfg.conv_bias:
            put(f"{base}.conv.bias", d)
        if cfg.feat_extract_norm == "layer" or i == 0:
            put(f"{base}.layer_norm.weight", d)
            put(f"{base}.layer_norm.bias", d)
        cin = d
    D, K, G = cfg.hidden_size, cfg.num_conv_pos_embeddings, cfg.num_conv_pos_embedding_groups
    pcw = "encoder.pos_conv_embed.conv"
    g_key, v_key = ((f"{pcw}.weight_g", f"{pcw}.weight_v") if layout == "weight_g" else
                    (f"{pcw}.parametrizations.weight.original0",
                     f"{pcw}.parametrizations.weight.original1"))
    put(g_key, 1, 1, K, scale=1.0)
    put(v_key, D, D // G, K)
    put(f"{pcw}.bias", D)
    for name, i, o in (("feature_projection.projection", cfg.conv_dim[-1], D),):
        put(f"{name}.weight", o, i)
        put(f"{name}.bias", o)
    for name, d in (("feature_projection.layer_norm", cfg.conv_dim[-1]),
                    ("encoder.layer_norm", D)):
        put(f"{name}.weight", d)
        put(f"{name}.bias", d)
    for n in range(cfg.num_layers):
        base = f"encoder.layers.{n}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            put(f"{base}.attention.{proj}.weight", D, D)
            put(f"{base}.attention.{proj}.bias", D)
        for ln in ("layer_norm", "final_layer_norm"):
            put(f"{base}.{ln}.weight", D)
            put(f"{base}.{ln}.bias", D)
        put(f"{base}.feed_forward.intermediate_dense.weight", cfg.intermediate_size, D)
        put(f"{base}.feed_forward.intermediate_dense.bias", cfg.intermediate_size)
        put(f"{base}.feed_forward.output_dense.weight", D, cfg.intermediate_size)
        put(f"{base}.feed_forward.output_dense.bias", D)
    return sd


@pytest.mark.parametrize("layout", ["weight_g", "parametrizations"])
def test_converter_matches_jax(layout):
    """Leaf for leaf equal to the JAX converter's tree (which
    ``params_from_jax`` lays out as the port does); a ``HubertForCTC``
    checkpoint's ``hubert.`` prefix gives the same tree."""
    sd = _state_dict(SMALL, layout)
    want = th.params_from_jax(_np_tree(jh.convert_torch_state_dict(sd, _jax_cfg(SMALL),
                                                                   jnp.float32)))
    got = th.convert_torch_state_dict(sd, SMALL, torch.float32)
    prefixed = th.convert_torch_state_dict(
        {**{f"hubert.{k}": torch.from_numpy(v) for k, v in sd.items()},
         "lm_head.weight": torch.zeros(3, 3)}, SMALL, torch.float32)
    for tree in (got, prefixed):
        flat_w, flat_g = jax.tree.leaves(want), jax.tree.leaves(tree)
        assert len(flat_w) == len(flat_g) and jax.tree.structure(want) == jax.tree.structure(tree)
        for a, b in zip(flat_w, flat_g):
            assert a.shape == b.shape and torch.equal(a, b)


@pytest.fixture(scope="module")
def features():
    """The JAX package's and the port's extractors at B=2 (l = r = 10) on
    one TINY_HUBERT tree."""
    jp = jh.init_params(jax.random.PRNGKey(5), JAX_TINY, jnp.float32)
    tp = th.params_from_jax(_np_tree(jp))
    kw = dict(batch_size=2, tts="dummy", transport="queue")
    jf = JaxFeatures(jax_opt(**kw), hubert_params=jp, hubert_cfg=JAX_TINY)
    tf = HubertFeatures(default_opt(device="cpu", **kw), hubert_params=tp,
                        hubert_cfg=TINY_HUBERT)
    return jf, tf


def test_feature_windows_match_jax(features):
    jf, tf = features
    assert tf._n_samples == jf._n_samples == (2 * 2 + 20) * 320
    wav = np.random.default_rng(1).standard_normal(tf._n_samples).astype(np.float32) * 0.2
    want = np.asarray(jf._fn(wav))
    got = tf._fn(wav)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 16, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_silence_skips_the_network(features):
    """Two all-silent steps in a row give the zero block without running
    HuBERT; a step with speech runs it."""
    _, tf = features
    calls = []
    tf._fn = lambda wav: calls.append(wav) or torch.ones((2, 16, 32, 32))
    tf.warm_up()
    tf.last_is_silence = True
    tf.run_step()  # the queue is empty: silence is synthesized
    silent, _rid, _queued = tf.feat_queue.get_nowait()
    assert silent is tf._zero and not calls and float(silent.abs().sum()) == 0.0
    for _ in range(4):
        tf.put_audio_frame(np.full(320, 0.1, np.float32))
    tf.run_step()
    assert len(calls) == 1 and float(tf.feat_queue.get_nowait()[0].sum()) > 0
