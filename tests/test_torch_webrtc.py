"""The port's WebRTC bridge and signaling against the JAX package's.

``aiortc`` and PyAV are replaced by the ``types.ModuleType`` stand-ins of
``tests/test_webrtc.py`` (plus a fake ``RTCPeerConnection`` for the
signaling), injected through ``sys.modules`` before both packages'
``server.webrtc`` and ``server.rtc_manager`` are imported; ``sys.modules``
is restored after. The same frames and PCM, made from a numpy seed, go
through both packages' ``HumanPlayer``s: pts, time bases, payloads,
drop-oldest results, buffer sizes and eventpoint order must be equal
(exactly: no arithmetic). ``RTCManager.handle_offer`` and
``handle_rtcpush`` run in both packages: equal answers, H264 > VP8 > rtx,
and teardown on ``failed``. Without ``aiortc`` the port's app logs the JAX
package's warning and registers no ``/offer``. ``chip_smoke.py``'s WebRTC
loopback runs against the port's served app over a loopback stand-in of
the peer connection (a real CPU session behind ``/offer``).
"""

import asyncio
import logging
import sys
import time
import types
from pathlib import Path
from threading import Event

import numpy as np
import pytest

from livetalking_tpu.config import default_opt as jax_default_opt
from livetalking_tpu.server.session_manager import session_manager as jax_sessions
from livetalking_tpu.streamout.webrtc import WebRTCOutput as JaxWebRTCOutput
from livetalking_tpu_torch import app as appmod
from livetalking_tpu_torch.config import default_opt
from livetalking_tpu_torch.server.session_manager import session_manager as torch_sessions
from livetalking_tpu_torch.streamout.webrtc import WebRTCOutput
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401
from test_webrtc import FakeAudioFrame, FakeMediaStreamTrack, FakeVideoFrame

ROOT = Path(__file__).resolve().parent.parent
PKGS = ("livetalking_tpu", "livetalking_tpu_torch")
MIMES = ("video/VP8", "video/rtx", "video/H264", "video/VP9", "video/H264", "video/red")


class FakeSDP:
    def __init__(self, sdp=None, type=None):
        self.sdp, self.type = sdp, type


class FakeIceServer:
    def __init__(self, urls=None):
        self.urls = urls


class FakeConfiguration:
    def __init__(self, iceServers=None):
        self.iceServers = iceServers


class FakeTransceiver:
    def __init__(self, kind):
        self.kind = kind
        self.preferences = None

    def setCodecPreferences(self, codecs):
        self.preferences = [c.mimeType for c in codecs]


class FakePeerConnection:
    """Records what ``RTCManager`` asks of a peer connection."""

    def __init__(self, configuration=None):
        self.configuration = configuration
        self.handlers = {}
        self.tracks = []
        self.transceivers = []
        self.connectionState = "new"
        self.localDescription = self.remoteDescription = None
        self.closed = False

    def on(self, event):
        def decorator(fn):
            self.handlers[event] = fn
            return fn

        return decorator

    def addTrack(self, track):
        self.tracks.append(track)
        self.transceivers.append(FakeTransceiver(track.kind))

    def getTransceivers(self):
        return self.transceivers

    async def setRemoteDescription(self, desc):
        self.remoteDescription = desc

    async def createAnswer(self):
        return FakeSDP(f"answer to {self.remoteDescription.sdp}", "answer")

    async def createOffer(self):
        return FakeSDP("offer-sdp", "offer")

    async def setLocalDescription(self, desc):
        self.localDescription = desc

    async def close(self):
        self.closed = True
        self.connectionState = "closed"


class FakeRtpSender:
    @staticmethod
    def getCapabilities(kind):
        assert kind == "video"
        return types.SimpleNamespace(codecs=[types.SimpleNamespace(mimeType=m) for m in MIMES])


def _fake_media_modules():
    av_mod = types.ModuleType("av")
    av_mod.VideoFrame = FakeVideoFrame
    av_mod.AudioFrame = FakeAudioFrame
    aiortc_mod = types.ModuleType("aiortc")
    aiortc_mod.MediaStreamTrack = FakeMediaStreamTrack
    aiortc_mod.RTCConfiguration = FakeConfiguration
    aiortc_mod.RTCIceServer = FakeIceServer
    aiortc_mod.RTCPeerConnection = FakePeerConnection
    aiortc_mod.RTCSessionDescription = FakeSDP
    sender_mod = types.ModuleType("aiortc.rtcrtpsender")
    sender_mod.RTCRtpSender = FakeRtpSender
    aiortc_mod.rtcrtpsender = sender_mod
    return {"av": av_mod, "aiortc": aiortc_mod, "aiortc.rtcrtpsender": sender_mod}


_BRIDGE = [f"{p}.server.{m}" for p in PKGS for m in ("webrtc", "rtc_manager")]


@pytest.fixture(scope="module")
def mods():
    """{package: (server.webrtc, server.rtc_manager)} imported over the fakes."""
    import importlib

    fakes = _fake_media_modules()
    saved = {k: sys.modules.get(k) for k in [*fakes, *_BRIDGE]}
    sys.modules.update(fakes)
    for k in _BRIDGE:
        sys.modules.pop(k, None)
    try:
        yield {p: (importlib.import_module(f"{p}.server.webrtc"),
                   importlib.import_module(f"{p}.server.rtc_manager")) for p in PKGS}
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


OUTPUTS = {"livetalking_tpu": JaxWebRTCOutput, "livetalking_tpu_torch": WebRTCOutput}
SESSIONS = {"livetalking_tpu": jax_sessions, "livetalking_tpu_torch": torch_sessions}
OPTS = {"livetalking_tpu": jax_default_opt, "livetalking_tpu_torch": default_opt}


class FakeSession:
    """An avatar session whose output is the package's real WebRTC adapter;
    ``render`` optionally pushes frames the way the compose thread does."""

    def __init__(self, pkg, sessionid="t", on_render=None):
        self.sessionid = sessionid
        self.events = []
        self.render_started = Event()
        self.on_render = on_render
        self.output = OUTPUTS[pkg](opt=None, parent=self)

    def render(self, quit_event):
        self.render_started.set()
        if self.on_render is not None:
            self.on_render(self)
        quit_event.wait(5)

    def notify(self, eventpoint):
        self.events.append(eventpoint)


def _inputs():
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (105, 6, 8, 3), dtype=np.uint8)
    pcm = rng.integers(-8000, 8000, (6, 320)).astype(np.int16)
    events = [{"status": "start", "text": "hi"}, None, {}, {"status": "custom", "k": 1}, None,
              {"status": "end", "text": "hi"}]
    return frames, pcm, events


def _player_trace(webrtc_mod, pkg):
    """Everything observable of one HumanPlayer fed ``_inputs()``."""
    frames, pcm, events = _inputs()
    sess = FakeSession(pkg)
    before = sess.output.get_buffer_size()
    sess.output.push_video_frame(frames[0])  # not negotiated: dropped
    player = webrtc_mod.HumanPlayer(sess)

    async def scenario():
        player._start(player.video)  # bind the loop before the engine pushes
        for f in frames:
            sess.output.push_video_frame(f)
        for p, e in zip(pcm, events):
            sess.output.push_audio_frame(p, e)
        await asyncio.sleep(0)  # run the call_soon_threadsafe enqueues
        sizes = (sess.output.get_buffer_size(), player.get_buffer_size(),
                 player.audio.buffer_size())
        video = [await player.video.recv()]
        player.video._start_wall -= 100.0  # 100 s behind: resync, no sleep
        t0 = time.perf_counter()
        video.append(await player.video.recv())
        resync_s = time.perf_counter() - t0
        wall_err = abs(player.video._start_wall - (time.time() - 3600 / 90000))
        video.append(await player.video.recv())
        audio = [await player.audio.recv() for _ in range(len(pcm))]
        return sizes, video, audio, resync_s, wall_err

    sizes, video, audio, resync_s, wall_err = asyncio.run(scenario())
    assert sess.render_started.wait(5)
    player.stop()
    return {
        "before": before,
        "sizes": sizes,
        "video": [(f.pts, f.time_base, f.arr.tobytes()) for f in video],
        "audio": [(a.pts, a.time_base, a.planes[0].data, a.samples, a.sample_rate, a.format,
                   a.layout) for a in audio],
        "events": sess.events,
        "resync_fast": resync_s < 0.02 and wall_err < 0.5,
        "ended": (player.video.readyState, player.audio.readyState),
    }


def test_players_match_jax(mods):
    got = {p: _player_trace(mods[p][0], p) for p in PKGS}
    assert got["livetalking_tpu_torch"] == got["livetalking_tpu"]
    t = got["livetalking_tpu_torch"]
    frames, pcm, _ = _inputs()
    assert t["before"] == 0
    assert t["sizes"] == (100, 100, 6)  # 105 frames, 100 deep: the oldest 5 dropped
    assert [v[0] for v in t["video"]] == [0, 3600, 7200]  # 40 ms at 90 kHz
    assert t["video"][0][2] == frames[5].tobytes()
    assert all(str(v[1]) == "1/90000" for v in t["video"])
    assert [a[0] for a in t["audio"]] == [0, 320, 640, 960, 1280, 1600]
    assert [a[2] for a in t["audio"]] == [p.tobytes() for p in pcm]
    assert all(str(a[1]) == "1/16000" and a[4] == 16000 for a in t["audio"])
    # eventpoints fire when their frame is sent, truthy ones only, in order
    assert t["events"] == [{"status": "start", "text": "hi"}, {"status": "custom", "k": 1},
                           {"status": "end", "text": "hi"}]
    assert t["resync_fast"] and t["ended"] == ("ended", "ended")


def test_render_starts_on_first_recv(mods):
    webrtc_mod = mods["livetalking_tpu_torch"][0]
    frame = np.full((4, 4, 3), 7, np.uint8)
    sess = FakeSession("livetalking_tpu_torch",
                       on_render=lambda s: s.output.push_video_frame(frame))
    player = webrtc_mod.HumanPlayer(sess)
    assert sess.output._player is player
    time.sleep(0.05)
    assert not sess.render_started.is_set()  # nothing runs before a peer pulls media

    async def scenario():
        return await asyncio.wait_for(player.video.recv(), 5)

    got = asyncio.run(scenario())
    assert sess.render_started.is_set() and got.arr is frame and got.pts == 0
    player.stop()
    assert player._thread is None


class _Request:
    def __init__(self, body):
        self.body = body

    async def json(self):
        if isinstance(self.body, Exception):
            raise self.body
        return self.body


@pytest.fixture
def builders():
    """Both session managers build FakeSessions; restored after."""
    saved = {p: (SESSIONS[p].build_session_fn, SESSIONS[p].max_session) for p in PKGS}
    built = {p: [] for p in PKGS}
    for p in PKGS:
        def build(sid, params, p=p):
            built[p].append(FakeSession(p, sid))
            return built[p][-1]

        SESSIONS[p].init_builder(build)
        SESSIONS[p].set_max_session(4)
    yield built
    for p, (fn, n) in saved.items():
        SESSIONS[p].init_builder(fn)
        SESSIONS[p].set_max_session(n)


def _offer_trace(rtc_mod, pkg, built):
    import json

    manager = rtc_mod.RTCManager(OPTS[pkg](stun="stun:stun.example:3478"))

    async def scenario():
        resp = await manager.handle_offer(_Request({"sdp": "client-offer", "type": "offer"}))
        answer = json.loads(resp.text)
        (pc,) = manager.pcs
        sid = answer["sessionid"]
        live = SESSIONS[pkg].has_session(sid)
        player = built[pkg][-1].output._player
        pc.connectionState = "failed"
        await pc.handlers["connectionstatechange"]()
        error = json.loads((await manager.handle_offer(_Request(ValueError("bad body")))).text)
        return answer, pc, live, player, SESSIONS[pkg].has_session(sid), error

    answer, pc, live, player, still_there, error = asyncio.run(scenario())
    return {
        "keys": sorted(answer),
        "answer": (answer["sdp"], answer["type"]),
        "stun": pc.configuration.iceServers[0].urls,
        "tracks": [t.kind for t in pc.tracks],
        "codecs": {t.kind: t.preferences for t in pc.transceivers},
        "live_then_removed": (live, still_there),
        "torn_down": (pc.closed, len(manager.pcs), player.video.readyState,
                      player.audio.readyState, player._quit is None or player._quit.is_set()),
        "error": error,
    }


def test_handle_offer_matches_jax(mods, builders):
    got = {p: _offer_trace(mods[p][1], p, builders) for p in PKGS}
    assert got["livetalking_tpu_torch"] == got["livetalking_tpu"]
    t = got["livetalking_tpu_torch"]
    assert t["keys"] == ["sdp", "sessionid", "type"]
    assert t["answer"] == ("answer to client-offer", "answer")
    assert t["stun"] == ["stun:stun.example:3478"]
    assert t["tracks"] == ["audio", "video"]
    assert t["codecs"] == {"audio": None,
                           "video": ["video/H264", "video/H264", "video/VP8", "video/rtx"]}
    assert t["live_then_removed"] == (True, False)
    assert t["torn_down"] == (True, 0, "ended", "ended", True)
    assert t["error"] == {"code": -1, "msg": "bad body"}


def test_handle_rtcpush_matches_jax(mods, builders):
    from aiohttp import web
    from aiohttp.test_utils import TestServer

    posted = []

    async def whip(request):
        posted.append((request.headers["Content-Type"], await request.text()))
        return web.Response(text="whip-answer")

    async def scenario(rtc_mod, pkg):
        app = web.Application()
        app.router.add_post("/whip", whip)
        async with TestServer(app, host="127.0.0.1") as server:
            manager = rtc_mod.RTCManager(OPTS[pkg](stun=""))
            await manager.handle_rtcpush(str(server.make_url("/whip")), "push0")
            (pc,) = manager.pcs
            await manager.shutdown()
            return (pc.configuration, [t.kind for t in pc.tracks], pc.localDescription.sdp,
                    pc.remoteDescription.sdp, pc.remoteDescription.type, pc.closed,
                    len(manager.pcs), SESSIONS[pkg].has_session("push0"))

    got = {}
    for p in PKGS:
        got[p] = asyncio.run(scenario(mods[p][1], p))
        SESSIONS[p].remove_session("push0")
    assert got["livetalking_tpu_torch"] == got["livetalking_tpu"]
    assert got["livetalking_tpu_torch"] == (None, ["audio", "video"], "offer-sdp", "whip-answer",
                                            "answer", True, 0, True)
    assert posted == [("application/sdp", "offer-sdp")] * 2


def test_app_offer_route_follows_aiortc(mods, monkeypatch, caplog):
    """Without aiortc: the JAX package's warning and no /offer; with the
    stand-ins: /offer is registered with the manager's shutdown."""
    monkeypatch.setattr(appmod, "opt", default_opt(device="cpu", transport="webrtc"))
    caplog.set_level(logging.WARNING, logger="livetalking_tpu_torch")
    saved = {k: sys.modules.get(k) for k in ("aiortc", "livetalking_tpu_torch.server.rtc_manager",
                                             "livetalking_tpu_torch.server.webrtc")}
    try:
        sys.modules["aiortc"] = None  # import fails as where aiortc is absent
        sys.modules.pop("livetalking_tpu_torch.server.rtc_manager", None)
        sys.modules.pop("livetalking_tpu_torch.server.webrtc", None)
        web_app = appmod.build_web_app()
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    paths = {r.resource.canonical for r in web_app.router.routes()}
    assert "/offer" not in paths and "/record/{sessionid}" in paths
    warned = [r.getMessage() for r in caplog.records if "WebRTC unavailable" in r.getMessage()]
    jax_fmt = '"WebRTC unavailable (aiortc missing: %s) - /offer disabled"'
    assert jax_fmt in (ROOT / "livetalking_tpu" / "app.py").read_text()
    assert len(warned) == 1 and warned[0].startswith("WebRTC unavailable (aiortc missing: ")
    assert warned[0].endswith(") - /offer disabled")
    assert web_app["llm_response"] is not None

    web_app = appmod.build_web_app()  # the stand-ins are importable again
    offers = [r for r in web_app.router.routes() if r.resource.canonical == "/offer"]
    assert [r.method for r in offers] == ["POST"]
    assert isinstance(web_app["rtc_manager"], mods["livetalking_tpu_torch"][1].RTCManager)
    assert len(web_app.on_shutdown) == 1


class _RemoteTrack:
    """The client's view of a server track: each ``recv`` runs on the
    server's loop, as aiortc's RTP senders pull media there."""

    def __init__(self, track, loop):
        self.kind, self._track, self._loop = track.kind, track, loop

    async def recv(self):
        return await asyncio.wrap_future(
            asyncio.run_coroutine_threadsafe(self._track.recv(), self._loop))


class LoopbackPeerConnection(FakePeerConnection):
    """Both ends of an in-process call. The server's end (``RTCManager``)
    files its tracks under its answer; the client's end finds them by the
    answer's sdp, fires ``track`` for each, and on ``close`` hangs up the
    server's end (state ``closed``, its handler on its own loop)."""

    answers = {}

    def __init__(self, configuration=None):
        super().__init__(configuration)
        self.loop = asyncio.get_running_loop()
        self.peer = None

    def addTransceiver(self, kind, direction=None):
        self.transceivers.append(FakeTransceiver(kind))

    async def createAnswer(self):
        sdp = f"answer-{id(self)}"
        self.answers[sdp] = self
        return FakeSDP(sdp, "answer")

    async def setRemoteDescription(self, desc):
        self.remoteDescription = desc
        self.peer = self.answers.pop(desc.sdp, None)
        for track in self.peer.tracks if self.peer is not None else ():
            self.handlers["track"](_RemoteTrack(track, self.peer.loop))

    async def close(self):
        await super().close()
        if self.peer is not None:
            asyncio.run_coroutine_threadsafe(self.peer._hang_up(), self.peer.loop)

    async def _hang_up(self):
        self.connectionState = "closed"
        await self.handlers["connectionstatechange"]()


def test_smoke_webrtc_loopback_on_stand_ins(mods, builders, tmp_path, monkeypatch):
    """``chip_smoke.webrtc_loopback`` against the port's app on the CPU: a
    wav2lip session behind ``/offer`` (``--transport webrtc``, dummy TTS,
    synthetic avatar), the client pulls both tracks, then hangs up and the
    session is removed, as the smoke's phase checks on the card."""
    import chip_smoke
    from livetalking_tpu.utils.synthetic import make_synthetic_avatar

    rtc_mod = mods["livetalking_tpu_torch"][1]
    monkeypatch.setattr(sys.modules["aiortc"], "RTCPeerConnection", LoopbackPeerConnection)
    monkeypatch.setattr(rtc_mod, "RTCPeerConnection", LoopbackPeerConnection)
    for name in ("opt", "model", "_load_avatar"):
        monkeypatch.setattr(appmod, name, getattr(appmod, name))
    monkeypatch.setattr(appmod, "global_avatars", {})
    monkeypatch.setattr(torch_sessions, "capacity", torch_sessions.capacity)
    monkeypatch.setattr(torch_sessions, "capacity_policy", torch_sessions.capacity_policy)
    make_synthetic_avatar(str(tmp_path / "avatars" / "tloop"), n_frames=4)
    appmod.load_plugin_stack(default_opt(
        transport="webrtc", tts="dummy", batch_size=2, dtype="float32", device="cpu",
        avatar_id="tloop", data_dir=str(tmp_path), max_session=2, stun="",
        modelfile="__nonexistent__"))
    with chip_smoke.serve_app(appmod.build_web_app()) as base:
        rtc = chip_smoke.webrtc_loopback(base, n_video=25)
        deadline = time.time() + 15
        while torch_sessions.has_session(rtc["sessionid"]) and time.time() < deadline:
            time.sleep(0.05)
        assert not torch_sessions.has_session(rtc["sessionid"])
    assert rtc["video_fps"] > 0 and rtc["audio_frames"] > 0, rtc
    assert not LoopbackPeerConnection.answers
