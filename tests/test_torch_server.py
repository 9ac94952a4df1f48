"""HTTP surface of the port's aiohttp app, in the manner of tests/test_server.py.

Boots ``livetalking_tpu_torch.app`` in a thread on the CPU (queue transport,
dummy TTS, a synthetic avatar directory written by the reference package's
helper and read by the port's ``load_avatar``) and checks the envelope of
``/session``, ``/human`` echo, ``/is_speaking``, ``/interrupt_talk``,
``/api/admin/sessions``, ``/api/admin/metrics``, ``/record`` with ``GET
/record/{sessionid}`` and unknown sessions.
"""

import asyncio
import queue
import socket
import time
from threading import Event, Thread

import pytest
import requests

from livetalking_tpu.utils.synthetic import make_synthetic_avatar
from livetalking_tpu_torch import app as appmod
from livetalking_tpu_torch.config import default_opt
from livetalking_tpu_torch.server.session_manager import session_manager
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("data")
    make_synthetic_avatar(str(data_dir / "avatars" / "tsrv"), n_frames=4)
    port = _free_port()
    opt = default_opt(transport="queue", tts="dummy", batch_size=2, dtype="float32",
                      device="cpu", avatar_id="tsrv", data_dir=str(data_dir), max_session=2,
                      listenport=port, modelfile="__nonexistent__")
    appmod.load_plugin_stack(opt)
    web_app = appmod.build_web_app()
    loop = asyncio.new_event_loop()

    def run():
        from aiohttp import web

        asyncio.set_event_loop(loop)
        runner = web.AppRunner(web_app)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        loop.run_forever()

    t = Thread(target=run, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 15
    while time.time() < deadline:
        try:
            requests.get(base + "/api/admin/config", timeout=1)
            break
        except requests.ConnectionError:
            time.sleep(0.2)
    yield base
    for sid in list(appmod._render_threads):
        appmod.stop_render_thread(sid, timeout=10)
        session_manager.remove_session(sid)
    loop.call_soon_threadsafe(loop.stop)


@pytest.fixture(scope="module")
def sessionid(server):
    r = requests.post(server + "/session", json={}).json()
    assert r["code"] == 0, r
    return r["data"]["sessionid"]


def test_admin_config_and_sessions(server, sessionid):
    r = requests.get(server + "/api/admin/config").json()
    assert r["code"] == 0 and r["msg"] == "ok"
    assert r["data"]["config"]["model"] == "wav2lip" and r["data"]["config"]["device"] == "cpu"
    r = requests.get(server + "/api/admin/sessions").json()
    entry = next(s for s in r["data"]["sessions"] if s["sessionid"] == sessionid)
    assert entry["model"] == "wav2lip" and entry["batch_size"] == 2


def test_human_echo_and_is_speaking(server, sessionid):
    r = requests.post(server + "/human", json={
        "sessionid": sessionid, "type": "echo", "text": "hello over http",
    }).json()
    assert r["code"] == 0
    deadline = time.time() + 60
    speaking = False
    while time.time() < deadline and not speaking:
        speaking = requests.post(server + "/is_speaking",
                                 json={"sessionid": sessionid}).json()["data"]
        time.sleep(0.2)
    assert speaking
    sess = session_manager.get_session(sessionid)
    frame = sess.output.video_queue.get(timeout=30)
    assert frame.shape == (480, 640, 3)


def test_interrupt_talk(server, sessionid):
    requests.post(server + "/human", json={
        "sessionid": sessionid, "type": "echo", "text": "long text to interrupt " * 20,
    })
    r = requests.post(server + "/interrupt_talk", json={"sessionid": sessionid}).json()
    assert r["code"] == 0
    deadline = time.time() + 60
    while time.time() < deadline:
        r = requests.post(server + "/is_speaking", json={"sessionid": sessionid}).json()
        if not r["data"]:
            break
        time.sleep(0.2)
    assert r["code"] == 0 and not r["data"]


def test_unknown_session_error_envelope(server):
    for route in ("/human", "/is_speaking", "/interrupt_talk"):
        r = requests.post(server + route, json={"sessionid": "nope", "type": "echo",
                                                 "text": "x"}).json()
        assert r["code"] == -1 and "session not found" in r["msg"], route


def test_record_start_end_and_download(server, sessionid, tmp_path, monkeypatch):
    """``/record`` start_record, 0.5 s of frames, end_record: the session's native
    muxer writes ``data/record/<id>.mp4`` under the server's working
    directory, and ``GET /record/<id>`` serves those bytes; their audio is
    as long as the PCM the compose loop recorded (AAC pads up to one 1024-
    sample frame; a frame may straddle the start or the stop)."""
    from livetalking_tpu_torch import native

    if not native.available():
        pytest.skip("the native muxer cannot be built here (g++, pkg-config or ffmpeg libs)")
    monkeypatch.chdir(tmp_path)
    sess = session_manager.get_session(sessionid)
    recorded = []
    record_audio = sess.record_audio_data

    def spy(frame):
        with sess._record_lock:
            on = sess.recording
        record_audio(frame)
        if on:
            recorded.append(len(frame))

    monkeypatch.setattr(sess, "record_audio_data", spy)
    stop = Event()

    def drain():  # the queue transport has no consumer here: keep frames flowing
        while not stop.is_set():
            try:
                sess.output.video_queue.get(timeout=0.1)
            except queue.Empty:
                pass

    drainer = Thread(target=drain, daemon=True)
    drainer.start()
    try:
        r = requests.post(server + "/record", json={"sessionid": sessionid,
                                                     "type": "start_record"}).json()
        assert r == {"code": 0, "msg": "ok"} and sess.recording
        deadline = time.time() + 60
        while sum(recorded) < 8000 and time.time() < deadline:
            time.sleep(0.05)
        r = requests.post(server + "/record", json={"sessionid": sessionid,
                                                     "type": "end_record"}).json()
        assert r == {"code": 0, "msg": "ok"} and not sess.recording
    finally:
        stop.set()
        drainer.join(5)
    got = requests.get(f"{server}/record/{sessionid}", timeout=10)
    assert got.status_code == 200
    path = tmp_path / "data" / "record" / f"{sessionid}.mp4"
    assert got.content == path.read_bytes() and len(got.content) > 1000
    audio = native.decode_audio_bytes(got.content)
    assert abs(audio.shape[0] - sum(recorded)) <= 1024 + 640, (audio.shape, sum(recorded))


def test_record_download_of_an_unknown_session_is_404(server):
    r = requests.get(server + "/record/no-such-session", timeout=10)
    assert r.status_code == 404 and r.text == "Record not found"


def test_admin_metrics(server, sessionid):
    r = requests.get(server + "/api/admin/metrics", timeout=5).json()
    assert r["code"] == 0
    assert r["data"]["backend"] == "cpu" and r["data"]["sessions"] >= 1


def test_session_close_frees_the_slot(server, sessionid):
    r2 = requests.post(server + "/session", json={}).json()
    assert r2["code"] == 0
    r3 = requests.post(server + "/session", json={}).json()
    assert r3["code"] == -1 and "Maximum session" in r3["msg"]
    rc = requests.post(server + "/session/close",
                       json={"sessionid": r2["data"]["sessionid"]}).json()
    assert rc["code"] == 0 and not session_manager.has_session(r2["data"]["sessionid"])
