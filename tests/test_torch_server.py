"""HTTP surface of the port's aiohttp app, in the manner of tests/test_server.py.

Boots ``livetalking_tpu_torch.app`` in a thread on the CPU (queue transport,
dummy TTS, a synthetic avatar directory written by the reference package's
helper and read by the port's ``load_avatar``) and checks the envelope of
``/session``, ``/human`` echo, ``/is_speaking``, ``/interrupt_talk``,
``/api/admin/sessions``, ``/api/admin/metrics``, ``/record`` and unknown
sessions.
"""

import asyncio
import socket
import time
from threading import Thread

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


def test_record_answers_with_the_error_envelope(server, sessionid):
    r = requests.post(server + "/record", json={"sessionid": sessionid,
                                                 "type": "start_record"}).json()
    assert r["code"] == -1 and "muxer" in r["msg"]


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
