"""The port's TTS provider plugins against the JAX package's.

The HTTP plugins (GPT-SoVITS, CosyVoice, Fish, Tencent, XTTS, Omni) run
against one local aiohttp app speaking each provider's wire protocol
(``tests/test_tts_plugins.py``'s stand-ins, bound to a free port), Doubao
against a local websocket server speaking its binary framing. Edge, Azure,
IndexTTS2 and Qwen-TTS get fake SDK modules through ``sys.modules``. Each
provider's utterance goes through both packages' plugins: the emitted
320-sample frames must be bit-equal and the eventpoints equal (same
arithmetic on the same bytes). ``BaseTTS.stream_pcm16`` is also held
against the JAX package's on seeded byte streams cut at odd offsets. A
provider whose SDK is missing fails only its own module's import, so both
packages' ``_create_plugin`` return ``None``.
"""

import asyncio
import base64
import gzip
import importlib
import json
import struct
import sys
import threading
import types

import numpy as np
import pytest
from aiohttp import web

from livetalking_tpu.config import default_opt as jax_default_opt
from livetalking_tpu.tts.base import BaseTTS as JaxBaseTTS
from livetalking_tpu.tts.base import State as JaxState
from livetalking_tpu_torch.config import default_opt
from livetalking_tpu_torch.tts.base import BaseTTS, State
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401
from test_tts_plugins import FakeParent, _stream, _tone_pcm16, _wav_bytes

PKGS = ("livetalking_tpu", "livetalking_tpu_torch")
OPTS = {"livetalking_tpu": jax_default_opt, "livetalking_tpu_torch": default_opt}


@pytest.fixture(scope="module")
def server():
    """The providers' HTTP stand-ins on 127.0.0.1 at a free port."""
    app = web.Application()

    async def sovits(request):
        body = await request.json()
        assert body["media_type"] == "ogg" and body["streaming_mode"] is True
        seg = _wav_bytes(32000, _tone_pcm16(32000, 0.2))  # one decodable segment a chunk
        resp = web.StreamResponse(status=200)
        await resp.prepare(request)
        for _ in range(2):
            await resp.write(seg)
        await resp.write_eof()
        return resp

    async def cosy(request):
        return await _stream(request, _tone_pcm16(24000), 9600)

    async def fish(request):
        assert (await request.json())["streaming"] is True
        return await _stream(request, _tone_pcm16(44100), 17640)

    async def tencent(request):
        if (await request.json())["VoiceType"] == 999999:  # the error envelope
            err = json.dumps({"Response": {"Error": {"Code": "x", "Message": "bad voice"}}})
            return await _stream(request, err.encode(), 6400)
        return await _stream(request, _tone_pcm16(16000), 6400)

    async def clone_speaker(request):
        return web.json_response({"gpt_cond_latent": [0.0], "speaker_embedding": [0.0]})

    async def xtts(request):
        body = await request.json()
        assert "gpt_cond_latent" in body and body["text"]
        return await _stream(request, _tone_pcm16(24000), 4800)

    async def omni(request):
        assert (await request.json())["response_format"] == "pcm"
        return await _stream(request, _tone_pcm16(24000), 1920)

    app.router.add_post("/tts", sovits)
    app.router.add_route("GET", "/inference_zero_shot", cosy)
    app.router.add_post("/v1/tts", fish)
    app.router.add_post("/tencent_stream", tencent)
    app.router.add_post("/clone_speaker", clone_speaker)
    app.router.add_post("/tts_stream", xtts)
    app.router.add_post("/v1/audio/speech", omni)

    loop = asyncio.new_event_loop()
    ready = threading.Event()
    port = {}

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        port["n"] = site._server.sockets[0].getsockname()[1]
        ready.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert ready.wait(10)
    yield f"http://127.0.0.1:{port['n']}"
    loop.call_soon_threadsafe(loop.stop)
    t.join(10)


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("tts") / "ref.wav"
    path.write_bytes(_wav_bytes(16000, _tone_pcm16(16000, 0.1)))
    return str(path)


def _run(pkg, module, cls, msg, state=None, **opt_kw):
    """Frames (bytes) and eventpoints of one utterance through ``pkg``'s plugin."""
    mod = importlib.import_module(f"{pkg}.tts.{module}")
    parent = FakeParent()
    tts = getattr(mod, cls)(OPTS[pkg](**opt_kw), parent)
    if state is not None:
        tts.state = getattr(mod, "State")[state]
    tts.txt_to_audio(msg)
    for frame, _ in parent.frames:
        assert frame.shape == (320,) and frame.dtype == np.float32
    return tts, [(f.tobytes(), ev) for f, ev in parent.frames]


def _both(module, cls, msg=("hello", {}), **opt_kw):
    out = {p: _run(p, module, cls, msg, **opt_kw)[1] for p in PKGS}
    assert out["livetalking_tpu_torch"] == out["livetalking_tpu"]
    return out["livetalking_tpu_torch"]


def _statuses(frames):
    return [ev["status"] for _f, ev in frames if ev.get("status")]


def _energy(frames):
    return max(float(np.abs(np.frombuffer(f, np.float32)).max()) for f, _ in frames)


@pytest.mark.parametrize("module,cls,n_min,n_max", [
    ("sovits", "SovitsTTS", 20, 22),      # 2 x 0.2 s WAV segments at 32 kHz
    ("cosyvoice", "CosyVoiceTTS", 15, 16),  # 0.3 s at 24 kHz in 9600-byte chunks
    ("fish", "FishTTS", 15, 16),          # 0.3 s at 44.1 kHz
    ("xtts", "XTTS", 15, 16),             # 0.3 s at 24 kHz after /clone_speaker
    ("omnitts", "OmniTTS", 15, 16),       # 0.3 s at 24 kHz in 1920-byte chunks
])
def test_http_plugins_match_jax(server, ref_wav, module, cls, n_min, n_max):
    frames = _both(module, cls, ("hello", {"tts": {"speed": 1}}), TTS_SERVER=server,
                   REF_FILE=ref_wav, REF_TEXT="prompt")
    assert n_min <= len(frames) <= n_max
    assert _statuses(frames) == ["start", "end"] and _energy(frames) > 0.01
    assert frames[0][1] == {"status": "start", "text": "hello", "tts": {"speed": 1}}
    assert frames[-1] == (bytes(320 * 4), {"status": "end", "text": "hello",
                                           "tts": {"speed": 1}})


def test_tencent_ok_and_error_match_jax(server, monkeypatch):
    monkeypatch.setenv("TENCENT_APPID", "123")
    monkeypatch.setenv("TENCENT_SECRET_ID", "sid")
    monkeypatch.setenv("TENCENT_SECRET_KEY", "skey")
    kw = dict(REF_FILE="101001", tencent_endpoint=f"{server}/tencent_stream")
    frames = _both("tencent", "TencentTTS", **kw)
    assert len(frames) == 16 and _statuses(frames) == ["start", "end"]
    # the JSON error envelope: only the end frame
    frames = _both("tencent", "TencentTTS", ("hello", {"tts": {"ref_file": "999999"}}), **kw)
    assert _statuses(frames) == ["end"] and len(frames) == 1
    sigs = set()
    for p in PKGS:
        mod = importlib.import_module(f"{p}.tts.tencent")
        tts = mod.TencentTTS(OPTS[p](**kw), FakeParent())
        sigs.add(tts._signature({"b": 2, "a": "x", "Text": "hi"}))
    assert len(sigs) == 1  # the same HMAC-SHA1 over the sorted params


def test_pause_stops_emission_as_in_jax(server, ref_wav):
    out = {p: _run(p, "cosyvoice", "CosyVoiceTTS", ("hello", {}), state="PAUSE",
                   TTS_SERVER=server, REF_FILE=ref_wav, REF_TEXT="p")[1] for p in PKGS}
    assert out["livetalking_tpu_torch"] == out["livetalking_tpu"]
    assert _statuses(out["livetalking_tpu_torch"]) == ["end"]


def test_doubao_binary_protocol_matches_jax():
    import websockets

    pcm = _tone_pcm16(16000, 0.2)
    requests = []

    async def handler(ws):
        req = await ws.recv()
        assert req[:4] == b"\x11\x10\x11\x00"
        size = int.from_bytes(req[4:8], "big")
        body = json.loads(gzip.decompress(req[8:8 + size]))
        requests.append((body["request"]["text"], body["audio"]["voice_type"],
                         body["request"]["operation"], body["user"]["uid"]))
        await ws.send(b"\x11\xb0\x00\x00")  # an ACK without audio (flags 0)
        # two audio messages, the last with a negative sequence number; an
        # odd split so a sample straddles two messages
        half = len(pcm) // 2 + 1
        for seq, chunk in ((1, pcm[:half]), (-2, pcm[half:])):
            await ws.send(b"\x11\xb1\x00\x00" + struct.pack(">iI", seq, len(chunk)) + chunk)

    loop = asyncio.new_event_loop()
    ready = threading.Event()
    port = {}

    async def main():
        port["stop"] = loop.create_future()
        async with websockets.serve(handler, "127.0.0.1", 0) as srv:
            port["n"] = srv.sockets[0].getsockname()[1]
            ready.set()
            await port["stop"]

    t = threading.Thread(target=loop.run_until_complete, args=(main(),), daemon=True)
    t.start()
    assert ready.wait(10)
    try:
        frames = _both("doubao", "DoubaoTTS", ("hello doubao", {}), REF_FILE="voice-x",
                       doubao_url=f"ws://127.0.0.1:{port['n']}")
    finally:
        loop.call_soon_threadsafe(port["stop"].set_result, None)
        t.join(10)
        loop.close()
    assert len(frames) == 11 and _statuses(frames) == ["start", "end"]
    assert requests == [("hello doubao", "voice-x", "submit", "t")] * 2


@pytest.mark.parametrize("src_sr", [16000, 24000, 44100])
def test_stream_pcm16_matches_jax(src_sr):
    """Odd-byte carry, the per-chunk resample and the 20 ms remainder carry
    on a seeded stream cut at random (odd) offsets; PAUSE mid-stream stops
    the speech frames and leaves the end frame."""
    rng = np.random.default_rng(src_sr)
    data = (rng.standard_normal(int(src_sr * 0.37)) * 3000).astype("<i2").tobytes()
    cuts = np.sort(rng.choice(np.arange(1, len(data)), 9, replace=False))
    chunks = [data[a:b] for a, b in zip([0, *cuts], [*cuts, len(data)])]
    chunks.insert(3, b"")  # empty chunks are skipped
    assert any(len(c) % 2 for c in chunks)

    def run(base_cls, state_cls, opt_fn, pause_after=None):
        class Parent(FakeParent):
            def put_audio_frame(self, chunk, eventpoint=None):
                super().put_audio_frame(chunk, eventpoint)
                if pause_after is not None and len(self.frames) == pause_after:
                    tts.state = state_cls.PAUSE

        parent = Parent()
        tts = base_cls(opt_fn(), parent)
        tts.stream_pcm16(iter(chunks), src_sr, ("txt", {"k": 1}))
        return [(np.asarray(f).tobytes(), ev) for f, ev in parent.frames]

    for pause_after in (None, 5):
        jax = run(JaxBaseTTS, JaxState, jax_default_opt, pause_after)
        ours = run(BaseTTS, State, default_opt, pause_after)
        assert ours == jax
        if pause_after is None:  # 0.37 s: 18 whole frames (+-1 by the resample), then end
            assert abs(len(ours) - 19) <= 1
        else:
            assert len(ours) == 6
        assert _statuses(ours) == ["start", "end"]
        assert all(ev["k"] == 1 for _f, ev in ours)


# ---------------------------------------------------------------------------
# SDK plugins: fake modules through sys.modules
# ---------------------------------------------------------------------------

def _edge_module():
    mod = types.ModuleType("edge_tts")
    wav = _wav_bytes(24000, _tone_pcm16(24000, 0.33, 330.0))

    class Communicate:
        def __init__(self, text, voice):
            self.text, self.voice = text, voice

        async def stream(self):
            yield {"type": "WordBoundary", "offset": 0}
            for i in range(0, len(wav), 4001):
                yield {"type": "audio", "data": wav[i:i + 4001]}

    mod.Communicate = Communicate
    return {"edge_tts": mod}


def _azure_modules():
    speech = types.ModuleType("azure.cognitiveservices.speech")
    pcm = _tone_pcm16(16000, 0.25, 550.0)

    class SpeechConfig:
        def __init__(self, subscription=None, endpoint=None):
            self.endpoint = endpoint
            self.speech_synthesis_voice_name = None

        def set_speech_synthesis_output_format(self, fmt):
            self.fmt = fmt

    class _Signal:
        def __init__(self):
            self.callbacks = []

        def connect(self, cb):
            self.callbacks.append(cb)

    class SpeechSynthesizer:
        def __init__(self, speech_config=None, audio_config=None):
            self.synthesizing = _Signal()

        def speak_text(self, text):
            for i in range(0, len(pcm), 1000):  # not a multiple of 640 bytes
                evt = types.SimpleNamespace(result=types.SimpleNamespace(
                    reason="SynthesizingAudio", audio_data=pcm[i:i + 1000]))
                for cb in self.synthesizing.callbacks:
                    cb(evt)
            return types.SimpleNamespace(properties=types.SimpleNamespace(
                get_property=lambda prop: "12"))

    speech.SpeechConfig = SpeechConfig
    speech.SpeechSynthesizer = SpeechSynthesizer
    speech.SpeechSynthesisOutputFormat = types.SimpleNamespace(Raw16Khz16BitMonoPcm="raw16k")
    speech.ResultReason = types.SimpleNamespace(Canceled="Canceled")
    speech.PropertyId = types.SimpleNamespace(
        SpeechServiceResponse_SynthesisFirstByteLatencyMs="fb",
        SpeechServiceResponse_SynthesisFinishLatencyMs="fin")
    azure = types.ModuleType("azure")
    cognitive = types.ModuleType("azure.cognitiveservices")
    azure.cognitiveservices = cognitive
    cognitive.speech = speech
    return {"azure": azure, "azure.cognitiveservices": cognitive,
            "azure.cognitiveservices.speech": speech}


def _gradio_module(tmp_path):
    mod = types.ModuleType("gradio_client")
    calls = []

    class Client:
        def __init__(self, server):
            self.server = server

        def predict(self, prompt=None, text=None, api_name=None):
            calls.append((prompt, text, api_name))
            path = tmp_path / f"seg{len(calls)}.wav"
            path.write_bytes(_wav_bytes(22050, _tone_pcm16(22050, 0.05 * len(text), 250.0)))
            return {"value": str(path)} if len(calls) % 2 else str(path)

    mod.Client = Client
    mod.handle_file = lambda ref: f"file:{ref}"
    mod.calls = calls
    return {"gradio_client": mod}


def _dashscope_modules():
    dashscope = types.ModuleType("dashscope")
    audio = types.ModuleType("dashscope.audio")
    realtime = types.ModuleType("dashscope.audio.qwen_tts_realtime")
    pcm = _tone_pcm16(24000, 0.3, 700.0)

    class QwenTtsRealtimeCallback:
        pass

    class QwenTtsRealtime:
        def __init__(self, model=None, callback=None, voice=None):
            self.callback, self.text = callback, ""

        def connect(self):
            self.callback.on_open()

        def append_text(self, text):
            self.text += text

        def commit(self):
            for i in range(0, len(pcm), 2400):  # 50 ms deltas
                self.callback.on_event({"type": "response.audio.delta",
                                        "delta": base64.b64encode(pcm[i:i + 2400]).decode()})
            self.callback.on_event({"type": "response.done"})

        def close(self):
            self.callback.on_close(1000, "bye")

    realtime.QwenTtsRealtime = QwenTtsRealtime
    realtime.QwenTtsRealtimeCallback = QwenTtsRealtimeCallback
    dashscope.audio = audio
    audio.qwen_tts_realtime = realtime
    return {"dashscope": dashscope, "dashscope.audio": audio,
            "dashscope.audio.qwen_tts_realtime": realtime}


def _with_modules(fakes, module, fn):
    """Run ``fn()`` with ``fakes`` in ``sys.modules`` and both packages'
    ``tts.<module>`` imported fresh over them; everything restored after."""
    names = [*fakes, *(f"{p}.tts.{module}" for p in PKGS)]
    saved = {k: sys.modules.get(k) for k in names}
    sys.modules.update(fakes)
    for p in PKGS:
        sys.modules.pop(f"{p}.tts.{module}", None)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def test_edge_matches_jax():
    frames = _with_modules(_edge_module(), "edge", lambda: _both(
        "edge", "EdgeTTS", ("hello", {"tts": {"ref_file": "en-US-AvaNeural"}})))
    assert len(frames) == 16 and _statuses(frames) == ["start", "end"]
    assert _energy(frames) > 0.1


def test_azure_matches_jax(monkeypatch):
    monkeypatch.setenv("AZURE_SPEECH_KEY", "k")
    monkeypatch.setenv("AZURE_TTS_REGION", "eastasia")
    frames = _with_modules(_azure_modules(), "azure", lambda: _both(
        "azure", "AzureTTS", ("hello", {"tts": {"ref_file": "zh-CN-Other"}}), REF_FILE=""))
    assert len(frames) == 12 and _energy(frames) > 0.1  # 8000 samples, whole 20 ms frames


def test_indextts2_matches_jax(tmp_path):
    fakes = _gradio_module(tmp_path)
    text = "First sentence. Second one! Third?"
    frames = _with_modules(fakes, "indextts2", lambda: _both(
        "indextts2", "IndexTTS2", (text, {}), TTS_SERVER="http://gradio", REF_FILE="ref.wav"))
    assert _statuses(frames) == ["start", "end"] and frames[-1][0] == bytes(320 * 4)
    assert [c[1] for c in fakes["gradio_client"].calls] == [
        "First sentence.", " Second one!", " Third?"] * 2
    assert {c[0] for c in fakes["gradio_client"].calls} == {"file:ref.wav"}


def test_qwentts_matches_jax(monkeypatch):
    monkeypatch.setenv("DASHSCOPE_API_KEY", "k")

    def both():
        out = {}
        for p in PKGS:
            tts, out[p] = _run(p, "qwentts", "QwenTTS", ("hello", {"x": 2}), REF_FILE="Cherry")
            tts.stop_tts()
        assert out["livetalking_tpu_torch"] == out["livetalking_tpu"]
        return out["livetalking_tpu_torch"]

    frames = _with_modules(_dashscope_modules(), "qwentts", both)
    assert len(frames) == 16 and _statuses(frames) == ["start", "end"]
    assert all(ev.get("x") == 2 for _f, ev in frames)


@pytest.mark.parametrize("name,module,sdk", [
    ("edgetts", "edge", "edge_tts"),
    ("azuretts", "azure", "azure"),
    ("indextts2", "indextts2", "gradio_client"),
    ("qwentts", "qwentts", "dashscope"),
])
def test_missing_sdk_leaves_no_plugin(name, module, sdk):
    """A missing SDK fails the import of its own module only: both packages'
    ``_create_plugin`` log it and return ``None``."""
    from livetalking_tpu.avatars.base_avatar import BaseAvatar as JaxAvatar
    from livetalking_tpu.tts import TTS_MODULES as JAX_TTS
    from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar
    from livetalking_tpu_torch.tts import TTS_MODULES

    assert TTS_MODULES[name] == JAX_TTS[name].replace("livetalking_tpu.", "livetalking_tpu_torch.")

    def both():
        got = []
        for cls, table, opt_fn in ((JaxAvatar, JAX_TTS, jax_default_opt),
                                   (BaseAvatar, TTS_MODULES, default_opt)):
            avatar = cls.__new__(cls)
            avatar.opt = opt_fn(tts=name)
            got.append(avatar._create_plugin("tts", name, table))
        return got

    assert _with_modules({sdk: None}, module, both) == [None, None]
