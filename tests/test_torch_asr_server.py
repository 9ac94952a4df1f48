"""The port's ``/api/asr`` endpoint and STT backend on the CPU.

Against a fake backend: the FunASR protocol round trip, short audio, an
odd byte count, single construction by the lazy loader, serialised
inference, and the route registered by ``setup_routes`` only when a
backend or Whisper weights exist. Against the JAX package: the textnorm
post-pass string-equal on every case of tests/test_textnorm.py and
tests/test_asr_server.py, ``compression_ratio`` equal, and
``WhisperTorchSTT`` built from parameters (the TINY encoder, a narrow
decoder, f32) on 2 s of audio giving the same language and token ids as
the JAX package's pieces (encode -> detect language -> greedy decode) on
the same weights.
"""

import asyncio
import json
import threading
import time
from threading import Thread

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from livetalking_tpu.models import whisper_decoder as jd
from livetalking_tpu.models import whisper_encoder as je
from livetalking_tpu.ops import whisper_mel as jmel
from livetalking_tpu.server import asr_server as jasr
from livetalking_tpu.server import textnorm as jtn
from livetalking_tpu_torch.models import whisper_decoder as td
from livetalking_tpu_torch.models import whisper_encoder as te
from livetalking_tpu_torch.server import asr_server
from livetalking_tpu_torch.server import textnorm as ttn
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

PORT = 18473
NARROW = dict(d_model=384, num_layers=2, num_heads=4, ffn=256)


class FakeSTT:
    def __init__(self, text="hello world", delay=0.0):
        self.text = text
        self.delay = delay
        self.calls = []
        self._busy = threading.Lock()
        self.overlapped = False

    def transcribe(self, audio, sample_rate, language="auto"):
        if not self._busy.acquire(blocking=False):
            self.overlapped = True
        try:
            self.calls.append((len(audio), sample_rate, language))
            if self.delay:
                time.sleep(self.delay)
            return self.text
        finally:
            self._busy.release()


class IdTokenizer:
    """Stand-in tokenizer: ids as words, special ids dropped."""

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{int(i)}" for i in ids if not skip_special_tokens or i < 50257)


@pytest.fixture
def fake_backend():
    backend = FakeSTT()
    asr_server.set_stt_backend(backend)
    yield backend
    asr_server.set_stt_backend(None)


@pytest.fixture(scope="module")
def asr_url():
    from aiohttp import web

    app = web.Application()
    app.router.add_get("/api/asr", asr_server.asr_websocket_handler)
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", PORT).start())
        loop.run_forever()

    Thread(target=run, daemon=True).start()
    time.sleep(0.5)
    yield f"ws://127.0.0.1:{PORT}/api/asr"
    loop.call_soon_threadsafe(loop.stop)


def _ws_roundtrip(url, pcm_bytes, config=None, n_chunks=4):
    """Drive the FunASR client protocol once; return the server's reply."""
    import aiohttp

    async def go():
        async with aiohttp.ClientSession() as sess:
            async with sess.ws_connect(url) as ws:
                cfg = {"chunk_size": [5, 10, 5], "wav_name": "test", "is_speaking": True,
                       "mode": "2pass", "itn": False}
                cfg.update(config or {})
                await ws.send_str(json.dumps(cfg))
                step = max(1, len(pcm_bytes) // n_chunks)
                for i in range(0, len(pcm_bytes), step):
                    await ws.send_bytes(pcm_bytes[i:i + step])
                await ws.send_str(json.dumps({"is_speaking": False}))
                msg = await asyncio.wait_for(ws.receive(), timeout=10)
                return json.loads(msg.data)

    return asyncio.run(go())


def test_protocol_roundtrip(asr_url, fake_backend):
    pcm = (np.sin(np.arange(16000) * 0.05) * 20000).astype(np.int16)
    reply = _ws_roundtrip(asr_url, pcm.tobytes())
    assert reply == {"text": "Hello world.", "mode": "2pass-offline", "is_final": True,
                     "timestamp": None}
    assert fake_backend.calls == [(16000, 16000, "auto")]


def test_protocol_short_audio_returns_empty(asr_url, fake_backend):
    reply = _ws_roundtrip(asr_url, b"\x00" * 100, config={"mode": "offline"}, n_chunks=1)
    assert reply == {"text": "", "mode": "offline", "is_final": True, "timestamp": None}
    assert fake_backend.calls == []


def test_protocol_odd_byte_count_dropped(asr_url, fake_backend):
    reply = _ws_roundtrip(asr_url, b"\x01" * 1601, n_chunks=1)
    assert reply["is_final"] is True
    assert fake_backend.calls[0][0] == 800  # 1600 bytes -> 800 samples


def test_lazy_loader_single_construction(monkeypatch):
    """Racing first requests construct exactly one backend, on the device
    the server set."""
    asr_server.set_stt_backend(None)
    constructed = []
    release = threading.Event()

    class SlowSTT:
        @classmethod
        def from_pretrained(cls, models_dir="./models", device="cuda"):
            constructed.append(device)
            release.wait(timeout=5)
            return cls()

        def transcribe(self, audio, sr, language="auto"):
            return "x"

    monkeypatch.setattr(asr_server, "WhisperTorchSTT", SlowSTT)
    asr_server.set_stt_device("cpu")
    results = []
    threads = [threading.Thread(target=lambda: results.append(asr_server._load_stt()))
               for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    release.set()
    for t in threads:
        t.join(timeout=5)
    assert constructed == ["cpu"]
    assert len(results) == 4 and all(r is results[0] for r in results)
    asr_server.set_stt_backend(None)
    asr_server.set_stt_device("cuda")


def test_inference_serialized(fake_backend):
    fake_backend.delay = 0.1
    audio = np.zeros(1600, np.float32)
    threads = [threading.Thread(target=asr_server._run_inference, args=(audio, 16000, "auto"))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5)
    assert len(fake_backend.calls) == 3
    assert not fake_backend.overlapped


def test_setup_routes_registers_asr_only_with_a_backend(monkeypatch, tmp_path, fake_backend):
    """``/api/asr`` is registered when a backend is injected and left out
    when there is none and no Whisper weights; the avatar-task routes are
    registered either way."""
    from aiohttp import web

    from livetalking_tpu_torch.server.routes import setup_routes

    def paths():
        app = web.Application()
        setup_routes(app, web_root=str(tmp_path))
        return {r.resource.canonical for r in app.router.routes()}

    monkeypatch.setenv("LIVETALKING_MODELS_DIR", str(tmp_path))
    assert "/api/asr" in paths()
    asr_server.set_stt_backend(None)
    got = paths()
    assert "/api/asr" not in got
    assert {"/api/avatar/task", "/api/avatar/task/{task_id}", "/api/avatar/tasks"} <= got
    (tmp_path / "whisper").mkdir()
    assert "/api/asr" in paths()


def test_compression_ratio_matches_jax():
    texts = ["", "the cat " * 40, "speech recognition converts spoken language into text",
             "你好世界" * 10]
    for t in texts:
        assert asr_server.compression_ratio(t) == jasr.compression_ratio(t)
    assert asr_server.COMPRESSION_RATIO_THRESHOLD == jasr.COMPRESSION_RATIO_THRESHOLD
    assert asr_server.compression_ratio("the cat " * 40) > asr_server.COMPRESSION_RATIO_THRESHOLD


# every input of tests/test_textnorm.py and of test_asr_server.py's
# transcript fixtures, through each entry point
TEXTS = ["hello world", "  hello   world  ", "hello world.", "is it done?", "今天天气很好",
         "今天天气很好。", "first point. second point", "hello , world .", "twenty three",
         "three hundred and five", "one thousand two hundred", "it costs twenty dollars",
         "about fifty percent done", "one of the best", "twenty-five", "三百零五", "两万三千",
         "十五个人", "百分之三十", "一起去",
         "twenty five people joined the call and sent three hundred and five messages",
         "at three thirty today", "the meeting is at three thirty on march fifth",
         "we sold twenty five thousand units which is twelve percent more",
         "i was born in nineteen ninety eight", "it costs one hundred and twenty three dollars",
         "the meeting is at three thirty",
         "会议在三点开始 我们卖了两万五千件 增长了百分之十二"]
CASES = [(fn, t) for t in TEXTS
         for fn in ("restore_punctuation", "inverse_normalize", "postprocess", "postprocess_raw")]


@pytest.mark.parametrize("fn,text", CASES)
def test_textnorm_matches_jax(fn, text):
    if fn == "postprocess_raw":
        assert ttn.postprocess(text, itn=False) == jtn.postprocess(text, itn=False)
    else:
        assert getattr(ttn, fn)(text) == getattr(jtn, fn)(text)


def _np_tree(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a, np.float32), tree,
                        is_leaf=lambda a: a is None)


@pytest.fixture(scope="module")
def stt_pair():
    """The same weights in both packages: the TINY encoder (f32) and a
    narrow decoder with the real vocabulary."""
    jcfg = jd.WhisperDecoderConfig(**NARROW)
    jenc = je.init_params(jax.random.PRNGKey(0), je.TINY, jnp.float32)
    jdec = jd.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    stt = asr_server.WhisperTorchSTT(te.params_from_jax(_np_tree(jenc)),
                                     td.params_from_jax(_np_tree(jdec)), IdTokenizer(),
                                     te.TINY, td.WhisperDecoderConfig(**NARROW), max_new=16,
                                     dtype=torch.float32, device="cpu")
    return jcfg, jenc, jdec, stt


def test_stt_backend_matches_the_jax_pieces(stt_pair):
    """2 s of audio: encoder states atol 1e-3, then the same language token
    and the same greedy ids as WhisperJaxSTT's encode -> detect_lang ->
    decode on the JAX side; ``transcribe`` follows the temperature ladder
    from those ids."""
    jcfg, jenc, jdec, stt = stt_pair
    rng = np.random.default_rng(4)
    t = np.arange(32000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size))
    audio = audio.astype(np.float32)

    mel = jmel.log_mel_spectrogram(jnp.asarray(audio))[None]
    want_enc = je.apply_stacked(jenc, je.TINY, mel)[:, :, -1, :]
    got_enc = stt.encode(audio)
    assert tuple(got_enc.shape) == (1, 1500, 384)
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), atol=1e-3)

    # the JAX package's detect_lang (asr_server.py:104-120) on its own encoding
    cross = jd.precompute_cross_kv(jdec, jcfg, want_enc)
    hd = jcfg.d_model // jcfg.num_heads
    caches = [(jnp.zeros((1, jcfg.num_heads, 2, hd)),) * 2 for _ in range(jcfg.num_layers)]
    logits, _ = jd.decode_step(jdec, jcfg, jnp.asarray([jcfg.sot], jnp.int32), jnp.int32(0),
                               caches, cross)
    ids = jnp.arange(jcfg.vocab_size)
    is_lang = (ids >= jcfg.lang_en) & (ids < jcfg.task_transcribe - 1)
    want_lang = int(jnp.argmax(jnp.where(is_lang[None], logits, -jnp.inf), -1)[0])
    got_lang = stt.detect_language(got_enc)
    assert got_lang == want_lang and jcfg.lang_en <= got_lang < jcfg.task_transcribe - 1

    prompt = np.array([[jcfg.sot, want_lang, jcfg.task_transcribe, jcfg.no_timestamps]],
                      np.int32)
    want, wn = jd.make_greedy_decode(jdec, jcfg, max_new=16, dtype=jnp.float32)(
        want_enc, jnp.asarray(prompt))
    got, gn = stt.decode(got_enc, torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(gn[0]) == int(wn[0])

    # ``transcribe`` walks the temperature ladder while the text is a
    # repetition loop; these weights loop at T = 0 and retry
    texts = []
    for T in asr_server.TEMPERATURES:
        tok, n = stt.decode(got_enc, torch.from_numpy(prompt), temperature=T, seed=int(T * 10))
        texts.append(IdTokenizer().decode(tok[0, :int(n[0])].numpy()).strip())
        if asr_server.compression_ratio(texts[-1]) <= asr_server.COMPRESSION_RATIO_THRESHOLD:
            break
    assert texts[0] == IdTokenizer().decode(np.asarray(want)[0][: int(wn[0])])
    assert len(texts) > 1
    stt.encode = lambda a: got_enc  # the states checked above, not a second encode
    assert stt.transcribe(audio, 16000) == texts[-1]
