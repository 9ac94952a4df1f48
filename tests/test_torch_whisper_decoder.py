"""The port's Whisper decoder against the JAX package on the CPU, in f32.

A narrow decoder (d_model 64, 2 layers, 4 heads, FFN 128) with the real
vocabulary (51,865) and special ids; weights from the JAX package's
seeded init, carried over by ``params_from_jax``; inputs from numpy
seeds. Bars: ``decode_step`` logits and KV caches atol 1e-4; greedy token
ids identical to ``make_greedy_decode`` at T = 0 (the n-gram guard
included); T > 0 held to its contract only (text tokens and EOT, the same
seed gives the same tokens), since the port's noise is not
``jax.random``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livetalking_tpu.models import whisper_decoder as jd
from livetalking_tpu_torch.models import whisper_decoder as td

LOGIT_ATOL = 1e-4
NARROW = dict(d_model=64, num_layers=2, num_heads=4, ffn=128)
JCFG = jd.WhisperDecoderConfig(**NARROW)
TCFG = td.WhisperDecoderConfig(**NARROW)
PROMPT = np.array([[JCFG.sot, JCFG.lang_en, JCFG.task_transcribe, JCFG.no_timestamps]] * 2,
                  np.int32)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One intra-op thread for the module: the decode loops are many small
    ops, whose parallel sections spin against the other test workers'
    threads (2.7x slower under a loaded host); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a, np.float32), tree,
                        is_leaf=lambda a: a is None)


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
        assert (a[k] is None) == (b[k] is None), k
        if a[k] is not None:
            assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def weights():
    jp = jd.init_params(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, td.params_from_jax(_np_tree(jp))


@pytest.fixture(scope="module")
def enc():
    return np.random.default_rng(1).standard_normal((2, 20, 64)).astype(np.float32)


def _greedy_pair(jp, tp, enc, max_new, **kw):
    want, wn = jd.make_greedy_decode(jp, JCFG, max_new=max_new, dtype=jnp.float32, **kw)(
        jnp.asarray(enc), jnp.asarray(PROMPT))
    got, gn = td.make_greedy_decode(tp, TCFG, max_new=max_new, dtype=torch.float32, **kw)(
        torch.from_numpy(enc), torch.from_numpy(PROMPT))
    return (np.asarray(want), np.asarray(wn)), (got.numpy(), gn.numpy())


def _hf_state_dict(prefix):
    """A random HF ``WhisperDecoder`` state dict (numpy), keys under ``prefix``."""
    rng = np.random.default_rng(2)
    D, F, V = TCFG.d_model, TCFG.ffn, TCFG.vocab_size
    sd = {"embed_tokens.weight": rng.standard_normal((V, D)) * 0.02,
          "embed_positions.weight": rng.standard_normal((TCFG.max_target_positions, D)) * 0.02,
          "layer_norm.weight": 1 + 0.1 * rng.standard_normal(D),
          "layer_norm.bias": 0.1 * rng.standard_normal(D)}
    for i in range(TCFG.num_layers):
        b = f"layers.{i}"
        for att in ("self_attn", "encoder_attn"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"{b}.{att}.{proj}.weight"] = rng.standard_normal((D, D)) / 8
                if proj != "k_proj":
                    sd[f"{b}.{att}.{proj}.bias"] = 0.1 * rng.standard_normal(D)
        for ln in ("self_attn_layer_norm", "encoder_attn_layer_norm", "final_layer_norm"):
            sd[f"{b}.{ln}.weight"] = 1 + 0.1 * rng.standard_normal(D)
            sd[f"{b}.{ln}.bias"] = 0.1 * rng.standard_normal(D)
        sd[f"{b}.fc1.weight"] = rng.standard_normal((F, D)) / 8
        sd[f"{b}.fc1.bias"] = 0.1 * rng.standard_normal(F)
        sd[f"{b}.fc2.weight"] = rng.standard_normal((D, F)) / 11
        sd[f"{b}.fc2.bias"] = 0.1 * rng.standard_normal(D)
    return {prefix + k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("prefix", ["decoder.", "model.decoder."])
def test_converter_matches_the_jax_converter(prefix):
    """One HF-layout state dict (with an encoder key beside it) through
    both converters gives the same tree."""
    sd = _hf_state_dict(prefix)
    sd[prefix.replace("decoder", "encoder") + "conv1.weight"] = np.zeros((1,), np.float32)
    want = td.params_from_jax(_np_tree(jd.convert_torch_state_dict(sd, JCFG, jnp.float32)))
    _assert_trees_equal(td.convert_torch_state_dict(sd, TCFG, torch.float32), want)


def test_decode_step_logits_and_caches_match_jax(weights, enc):
    jp, tp = weights
    tokens = np.random.default_rng(3).integers(0, JCFG.eot, (2, 6)).astype(np.int32)
    T = tokens.shape[1]
    jkv = jd.precompute_cross_kv(jp, JCFG, jnp.asarray(enc))
    tkv = td.precompute_cross_kv(tp, TCFG, torch.from_numpy(enc))
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=LOGIT_ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=LOGIT_ATOL)
    H, hd = JCFG.num_heads, JCFG.d_model // JCFG.num_heads
    jc = [(jnp.zeros((2, H, T, hd)), jnp.zeros((2, H, T, hd))) for _ in range(JCFG.num_layers)]
    tc = td.empty_caches(TCFG, 2, T, torch.float32, "cpu")
    for i in range(T):
        want, jc = jd.decode_step(jp, JCFG, jnp.asarray(tokens[:, i]), jnp.int32(i), jc, jkv)
        got, tc = td.decode_step(tp, TCFG, torch.from_numpy(tokens[:, i]).long(), i, tc, tkv)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, JCFG.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    for (jk, jv), (tk, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=LOGIT_ATOL)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=LOGIT_ATOL)


@pytest.mark.parametrize("kw", [{}, {"no_repeat_ngram": 2}, {"repetition_penalty": 1.3}],
                         ids=["trigram", "bigram", "penalty"])
def test_greedy_ids_match_jax(weights, enc, kw):
    """24 tokens a row, no EOT on these weights: the n-gram guard bans
    along the way (row 1 repeats bigrams under the trigram guard), with and
    without the repetition penalty, and the ids stay identical."""
    jp, tp = weights
    (want, wn), (got, gn) = _greedy_pair(jp, tp, enc, 24, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gn, wn)


@pytest.fixture(scope="module")
def eot_weights(weights, enc):
    """EOT's embedding row set to 1.5x the row of the token row 0 emits at
    step 5: EOT outscores that token there at the latest, so row 0 stops by
    step 5."""
    jp, tp = weights
    (ids, _), _ = _greedy_pair(jp, tp, enc, 8)
    jp = dict(jp, tok_emb=jp["tok_emb"].at[JCFG.eot].set(1.5 * jp["tok_emb"][int(ids[0, 5])]))
    return jp, td.params_from_jax(_np_tree(jp))


def test_greedy_stops_at_eot_and_is_prefix_consistent(eot_weights, enc):
    """Ids equal the JAX package's, row 0 stops by step 5, after EOT every
    id is EOT, and a shorter decode is a prefix of a longer one."""
    jp, tp = eot_weights
    (want, wn), (got, gn) = _greedy_pair(jp, tp, enc, 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gn, wn)
    eots = np.flatnonzero(got[0] == JCFG.eot)
    assert 0 < len(eots) and eots[0] <= 5
    assert (got[0, eots[0]:] == JCFG.eot).all() and gn[0] == eots[0]
    assert ((got < JCFG.eot) | (got == JCFG.eot)).all()
    short, _ = td.make_greedy_decode(tp, TCFG, max_new=6, dtype=torch.float32)(
        torch.from_numpy(enc), torch.from_numpy(PROMPT))
    np.testing.assert_array_equal(short.numpy(), got[:, :6])


def test_ngram_guard_on_the_degenerate_loop():
    """All-zero weights make every logit 0, so greedy repeats one token
    forever (the JAX test's construction). With ``no_repeat_ngram=3``
    every trigram is distinct; both settings match the JAX package."""
    jp = jax.tree.map(lambda a: None if a is None else jnp.zeros_like(a),
                      jd.init_params(jax.random.PRNGKey(0), JCFG, jnp.float32),
                      is_leaf=lambda a: a is None)
    tp = td.params_from_jax(_np_tree(jp))
    enc = np.zeros((2, 6, 64), np.float32)
    (want, _), (got, n) = _greedy_pair(jp, tp, enc, 16, no_repeat_ngram=0)
    np.testing.assert_array_equal(got, want)
    assert (got == got[0, 0]).all() and (n == 16).all()
    (want, _), (got, n) = _greedy_pair(jp, tp, enc, 16, no_repeat_ngram=3)
    np.testing.assert_array_equal(got, want)
    for row in got:
        assert len({tuple(row[i:i + 3]) for i in range(len(row) - 2)}) == len(row) - 2


def test_temperature_contract(weights, enc):
    """T > 0: only text tokens and EOT; the same seed gives the same
    tokens, another seed other tokens; T = 0 stays deterministic."""
    _, tp = weights
    fn = td.make_greedy_decode(tp, TCFG, max_new=12, dtype=torch.float32)
    e, p = torch.from_numpy(enc), torch.from_numpy(PROMPT)
    a, _ = fn(e, p, temperature=0.8, seed=1)
    a2, _ = fn(e, p, temperature=0.8, seed=1)
    b, _ = fn(e, p, temperature=0.8, seed=2)
    torch.testing.assert_close(a, a2, rtol=0, atol=0)
    assert not torch.equal(a, b)
    for t in (a, b):
        assert bool(((t < TCFG.eot) | (t == TCFG.eot)).all())
    torch.testing.assert_close(fn(e, p)[0], fn(e, p)[0], rtol=0, atol=0)


def test_stop_check_period_changes_no_output(eot_weights, enc, monkeypatch):
    """The stop test's period only moves where the loop ends: the ids are
    the same whether it reads the stop flags every step or every 8."""
    _, tp = eot_weights
    e, p = torch.from_numpy(enc), torch.from_numpy(PROMPT)
    fn = td.make_greedy_decode(tp, TCFG, max_new=10, dtype=torch.float32)
    a, na = fn(e, p)
    monkeypatch.setattr(td, "STOP_CHECK_EVERY", 1)
    b, nb = fn(e, p)
    assert torch.equal(a, b) and torch.equal(na, nb)
