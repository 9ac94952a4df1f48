"""The port's avatar builds against the JAX package's on the CPU.

One 8-frame synthetic video goes through the wav2lip, MuseTalk and
Ultralight builds of both packages (explicit center boxes, the geometric
masks the MuseTalk build takes without face-parse weights); the avatar
directories must be the same: every file byte for byte (frames, crops,
masks, ``coords.pkl``, ``mask_coords.pkl``), and MuseTalk's latents
within the VAE encoder's bar (atol 2e-3, tests/test_torch_musetalk.py) on
a narrow VAE (the small channel ladder of tests/test_sd_converters.py).
Both packages run on this host, so ``cv2`` writes both. The built
avatars load in the port's plugins. Then the task manager (progress,
webhook over HTTP, statuses), the ``auto`` detector's refusal, the
ER-NeRF build against the JAX package's (frames and ``coords.pkl`` byte
for byte, the fitted ``ernerf.npz`` with the same keys and shapes and
values within 1e-3 relative L2, from the same initial field), and the
avatar routes' envelopes against the JAX package's routes.
"""

import asyncio
import filecmp
import http.server
import json
import os
import threading
import time

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu import genavatar as jg
from livetalking_tpu.genavatar.face import FaceDetector as JFaceDetector
from livetalking_tpu.models import sd_vae as jv
from livetalking_tpu_torch import genavatar as tg
from livetalking_tpu_torch.genavatar.face import FaceDetector, apply_pads, smooth_boxes
from livetalking_tpu_torch.models import sd_vae as tv
from livetalking_tpu_torch.server import task_manager as tm_mod
from test_sd_converters import TorchVAE, _init
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

VAE_ATOL = 2e-3
N_FRAMES = 8


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("vid") / "input.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (320, 240))
    for i in range(N_FRAMES):
        frame = np.full((240, 320, 3), 60, np.uint8)
        cv2.ellipse(frame, (160 + i, 120), (60, 80), 0, 0, 360, (90, 140, 200), -1)
        w.write(frame)
    w.release()
    return path


@pytest.fixture(scope="module")
def vae():
    sd = dict(_init(TorchVAE(), seed=4).state_dict())
    jp = jv.convert_torch_state_dict(sd, dtype=jnp.float32)
    return jp, tv.convert_torch_state_dict(sd, dtype=torch.float32)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_dirs(got, want, skip=()):
    names = _files(want)
    assert _files(got) == names and len(names) > 2 * N_FRAMES
    for name in names:
        if name not in skip:
            assert filecmp.cmp(os.path.join(got, name), os.path.join(want, name),
                               shallow=False), name


@pytest.fixture(scope="module")
def builds(video, vae, tmp_path_factory):
    """Both packages' builds of each family: {family: (port dir, JAX dir)}."""
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax", "port"))
    jvae, tvae = vae
    center_j = JFaceDetector("center")
    center_t = FaceDetector("center", device="cpu")
    out = {}
    for fam, jfn, tfn, kw in (
            ("wav2lip", jg.generate_wav2lip_avatar, tg.generate_wav2lip_avatar, {}),
            ("ultralight", jg.generate_ultralight_avatar, tg.generate_ultralight_avatar,
             {"models_dir": jdir}),
            ("musetalk", jg.generate_musetalk_avatar, tg.generate_musetalk_avatar,
             {"models_dir": jdir})):
        vk = {"vae_params": jvae} if fam == "musetalk" else {}
        want = jfn(video, fam, jdir, face_detector=center_j, **kw, **vk)
        if fam == "musetalk":
            vk = {"vae_params": tvae}
        got = tfn(video, fam, tdir, face_detector=center_t, device="cpu", **kw, **vk)
        out[fam] = (got, want)
    return out


@pytest.mark.parametrize("family", ["wav2lip", "ultralight", "musetalk"])
def test_avatar_directory_matches_jax(builds, family):
    got, want = builds[family]
    _assert_same_dirs(got, want, skip=("latents.pt",))
    if family == "musetalk":
        a = torch.load(os.path.join(got, "latents.pt"), weights_only=False)
        b = torch.load(os.path.join(want, "latents.pt"), weights_only=False)
        assert len(a) == len(b) == N_FRAMES
        for x, y in zip(a, b):
            assert tuple(x.shape) == tuple(y.shape) == (1, 8, 32, 32)
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=VAE_ATOL)


def test_built_avatars_load_in_the_port_plugins(builds):
    from livetalking_tpu_torch.avatars import musetalk_avatar, ultralight_avatar, wav2lip_avatar

    root = os.path.dirname(os.path.dirname(builds["wav2lip"][0]))
    a = wav2lip_avatar.load_avatar("wav2lip", root, device="cpu")
    assert len(a["frame_list_cycle"]) == N_FRAMES
    assert tuple(a["face_cycle_device"].shape) == (N_FRAMES, 256, 256, 3)
    a = ultralight_avatar.load_avatar("ultralight", root, device="cpu")
    assert a["crop_cycle_host"].shape == (N_FRAMES, 168, 168, 3)
    x1, y1, x2, y2 = a["coord_list_cycle"][0]
    assert x2 - x1 == y2 - y1
    a = musetalk_avatar.load_avatar("musetalk", root, device="cpu")
    assert a["latent_cycle_host"].shape == (N_FRAMES, 32, 32, 8)


def test_smooth_and_pads_match_jax():
    from livetalking_tpu.genavatar import face as jface

    rng = np.random.default_rng(2)
    boxes = [tuple(int(v) for v in b) for b in rng.integers(0, 200, (9, 4))]
    for w in (3, 5):
        assert smooth_boxes(boxes, w) == jface.smooth_boxes(boxes, w)
    for b in boxes:
        assert apply_pads(b, (150, 180), (5, 10, 3, 7)) == jface.apply_pads(b, (150, 180),
                                                                             (5, 10, 3, 7))


class _Hook(http.server.BaseHTTPRequestHandler):
    received = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        _Hook.received.append((self.headers["Content-Type"], json.loads(body)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture
def webhook():
    _Hook.received = []
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Hook)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{server.server_address[1]}/hook", _Hook.received
    server.shutdown()
    server.server_close()


def _wait(task, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline and task.status not in ("completed", "failed"):
        time.sleep(0.1)


def test_task_manager_lifecycle(video, tmp_path, webhook):
    """A wav2lip task on the CPU: progress to 100, the webhook POSTs JSON
    of ``to_dict()`` at every transition (running ... completed), get and
    delete; a webhook that cannot connect is logged and the task still
    completes."""
    url, received = webhook
    tm = tm_mod.TaskManager(device="cpu")
    task = tm.add_task("taskav", {"model": "wav2lip", "video_path": video,
                                  "data_dir": str(tmp_path), "notifyurl": url,
                                  "face_detector": "center"})
    _wait(task)
    assert task.status == "completed", task.message
    assert task.progress == 100
    deadline = time.time() + 10  # the last webhook POST follows the status change
    while time.time() < deadline and not (received and received[-1][1]["status"] == "completed"):
        time.sleep(0.05)
    assert os.path.exists(os.path.join(str(tmp_path), "avatars", "taskav", "coords.pkl"))
    statuses = [body["status"] for _, body in received]
    assert statuses[0] == "running" and statuses[-1] == "completed"
    assert [body["progress"] for _, body in received][-1] == 100
    assert {ct for ct, _ in received} == {"application/json"}
    assert set(received[-1][1]) == set(task.to_dict())
    assert tm.get_task(task.task_id) is task
    assert [t["task_id"] for t in tm.list_tasks()] == [task.task_id]
    assert tm.delete_task(task.task_id) and not tm.delete_task(task.task_id)

    dead = tm.add_task("deadhook", {"model": "wav2lip", "video_path": video,
                                    "data_dir": str(tmp_path),
                                    "notifyurl": "http://127.0.0.1:9/none",
                                    "face_detector": "center"})
    _wait(dead)
    assert dead.status == "completed", dead.message


def test_ernerf_build_fails_with_the_training_item(video, tmp_path, monkeypatch):
    """The ER-NeRF build, which raised until the training step was ported,
    against the JAX package's: the same directory, the fitted field within
    1e-3 relative L2 of the reference's from the same initial field (the
    port's seeded init replaced by the reference's), and the port's
    plugin loads it."""
    import jax

    from livetalking_tpu.models import ernerf as je
    from livetalking_tpu_torch.avatars import ernerf_avatar as tea
    from livetalking_tpu_torch.models import ernerf as te

    kw = dict(size=32, train_steps=3, batch=2)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jg.generate_ernerf_avatar(video, "nf", jdir, face_detector=JFaceDetector("center"),
                                     **kw)
    init = jax.tree.map(np.asarray, je.init_params(jax.random.PRNGKey(0),
                                                   audio_dim=tea.AUDIO_DIM))
    monkeypatch.setattr(te, "init_params", lambda *a, device="cpu", **k:
                        te.params_from_jax(init, device))
    got = tg.generate_ernerf_avatar(video, "nf", tdir, face_detector=FaceDetector(
        "center", device="cpu"), device="cpu", **kw)
    names = _files(want)
    assert _files(got) == names and len(names) == N_FRAMES + 2
    for name in names:
        if name != "ernerf.npz":
            assert filecmp.cmp(os.path.join(got, name), os.path.join(want, name),
                               shallow=False), name
    with np.load(os.path.join(want, "ernerf.npz")) as w, \
            np.load(os.path.join(got, "ernerf.npz")) as g:
        assert sorted(w.files) == sorted(g.files)
        for k in w.files:
            assert g[k].shape == w[k].shape, k
            err = np.linalg.norm(g[k] - w[k]) / max(np.linalg.norm(w[k]), 1e-12)
            assert err <= 1e-3, (k, err)
        assert not np.array_equal(g["planes"], init["planes"])  # the fit moved the field
        # no audio track: zero conditioning, which leaves the audio net as it was
        assert np.array_equal(g["audio1.w"], init["audio1"]["w"])
    avatar = tea.load_avatar("nf", tdir, device="cpu")
    assert avatar["nerf_params"] is not None and len(avatar["frame_list_cycle"]) == N_FRAMES


@pytest.fixture(scope="module")
def speech(tmp_path_factory):
    """A 16 kHz mono 16-bit WAV as long as the video."""
    import wave

    t = np.arange(int(16000 * N_FRAMES / 25)) / 16000.0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 523 * t)
    path = str(tmp_path_factory.mktemp("wav") / "speech.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype("<i2").tobytes())
    return path


def test_ernerf_build_with_audio_matches_jax(video, speech, tmp_path, monkeypatch):
    """The fit conditioned on audio: the port reads a separate WAV
    (``audio_path``), the JAX package the same file as its video's track
    (its decoder pointed at the WAV), with tiny HuBERT weights carried
    across. The fields agree within 1e-3 relative L2 and the audio net
    moved, which zero conditioning cannot do; a HuBERT failure raises
    instead of falling back to zero conditioning."""
    import jax

    from livetalking_tpu.models import ernerf as je
    from livetalking_tpu.models import hubert as jh
    from livetalking_tpu.utils import audio as jaudio
    from livetalking_tpu_torch.avatars import ernerf_avatar as tea
    from livetalking_tpu_torch.models import ernerf as te
    from livetalking_tpu_torch.models import hubert as th

    hub = dict(conv_dim=(32, 32), conv_kernel=(10, 4), conv_stride=(5, 4), hidden_size=16,
               num_layers=1, num_heads=2, intermediate_size=32, num_conv_pos_embeddings=8,
               num_conv_pos_embedding_groups=2)
    jcfg, tcfg = jh.HubertConfig(**hub), th.HubertConfig(**hub)
    jhp = jh.init_params(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    thp = th.params_from_jax(jax.tree.map(np.asarray, jhp))
    decode = jaudio.decode_audio
    monkeypatch.setattr(jaudio, "decode_audio", lambda src: decode(speech))
    kw = dict(size=32, train_steps=3, batch=2)
    want = jg.generate_ernerf_avatar(video, "nf", str(tmp_path / "jax"), hubert_params=jhp,
                                     hubert_cfg=jcfg, face_detector=JFaceDetector("center"),
                                     **kw)
    init = jax.tree.map(np.asarray, je.init_params(jax.random.PRNGKey(0),
                                                   audio_dim=tea.AUDIO_DIM))
    monkeypatch.setattr(te, "init_params", lambda *a, device="cpu", **k:
                        te.params_from_jax(init, device))
    port = dict(hubert_params=thp, hubert_cfg=tcfg, audio_path=speech, device="cpu",
                face_detector=FaceDetector("center", device="cpu"), **kw)
    got = tg.generate_ernerf_avatar(video, "nf", str(tmp_path / "port"), **port)
    with np.load(os.path.join(want, "ernerf.npz")) as w, \
            np.load(os.path.join(got, "ernerf.npz")) as g:
        assert sorted(w.files) == sorted(g.files)
        for k in w.files:
            err = np.linalg.norm(g[k] - w[k]) / max(np.linalg.norm(w[k]), 1e-12)
            assert err <= 1e-3, (k, err)
        assert not np.array_equal(g["audio1.w"], init["audio1"]["w"])
        assert not np.array_equal(w["audio1.w"], init["audio1"]["w"])

    def broken(*a, **k):
        raise RuntimeError("hubert failed")

    monkeypatch.setattr(th, "apply", broken)
    with pytest.raises(RuntimeError, match="hubert failed"):
        tg.generate_ernerf_avatar(video, "nf2", str(tmp_path / "port"), **port)


def test_task_manager_ernerf_and_musetalk_tasks(video, tmp_path):
    """An ER-NeRF task builds an avatar the port's plugin loads; a MuseTalk
    task with no model provider builds with the random VAE on its device."""
    from livetalking_tpu_torch.avatars import ernerf_avatar as tea

    tm = tm_mod.TaskManager(device="cpu")
    nf = tm.add_task("nf", {"model": "ernerf", "video_path": video, "data_dir": str(tmp_path),
                            "face_detector": "center", "size": 32, "train_steps": 2})
    _wait(nf)
    assert nf.status == "completed", nf.message
    assert tea.load_avatar("nf", str(tmp_path), device="cpu")["nerf_params"] is not None

    small = TorchVAE()
    _init(small, seed=5)
    tvae = tv.convert_torch_state_dict(dict(small.state_dict()), dtype=torch.float32)
    tm.model_provider = lambda: {"vae_params": tvae}
    mt = tm.add_task("mt", {"model": "musetalk", "video_path": video, "data_dir": str(tmp_path),
                            "face_detector": "center", "models_dir": str(tmp_path)})
    _wait(mt)
    assert mt.status == "completed", mt.message
    assert os.path.exists(os.path.join(str(tmp_path), "avatars", "mt", "latents.pt"))


def test_auto_detector_refuses_a_silent_center_fallback(tmp_path, monkeypatch):
    """With no s3fd.pth, no YuNet model and no Haar cascade, ``auto``
    raises and names the explicit ``center`` opt-in, as the JAX package's
    detector does; ``center`` itself still works."""
    from livetalking_tpu.genavatar.face import FaceDetector as JDet

    monkeypatch.setattr(cv2.data, "haarcascades", str(tmp_path))
    for make in (lambda: FaceDetector("auto", models_dir=str(tmp_path), device="cpu"),
                 lambda: JDet("auto", models_dir=str(tmp_path))):
        with pytest.raises(RuntimeError, match="center"):
            make()
    det = FaceDetector("center", models_dir=str(tmp_path), device="cpu")
    assert det.kind == "center"
    frame = np.zeros((64, 80, 3), np.uint8)
    assert det.detect(frame) == JDet("center").detect(frame) == (24, 16, 56, 48)


def test_avatar_routes_envelopes_match_jax(video, tmp_path, monkeypatch):
    """The same requests to the JAX package's and the port's avatar routes
    give the same envelopes (task ids aside); an accepted upload builds."""
    from aiohttp import FormData, web
    from aiohttp.test_utils import TestClient, TestServer

    from livetalking_tpu.server import avatar_routes as jroutes
    from livetalking_tpu.server import task_manager as jtm
    from livetalking_tpu_torch.server import avatar_routes as troutes

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(troutes, "task_manager", tm_mod.TaskManager(device="cpu"))
    monkeypatch.setattr(jroutes, "task_manager", jtm.TaskManager())
    with open(video, "rb") as f:
        video_bytes = f.read()

    async def drive(setup):
        app = web.Application()
        setup(app)
        replies = []
        async with TestClient(TestServer(app)) as client:
            async def call(method, path, form=None):
                r = await client.request(method, path, data=form)
                replies.append(await r.json())
                return replies[-1]

            await call("POST", "/api/avatar/task", FormData({"avatar_id": "x"}))
            bad = FormData({"avatar_id": "../x"})
            bad.add_field("file", b"\x00", filename="v.mp4")
            await call("POST", "/api/avatar/task", bad)
            await call("GET", "/api/avatar/task/nosuch")
            await call("DELETE", "/api/avatar/task/nosuch")
            ok = FormData({"avatar_id": "up", "model": "wav2lip", "face_detector": "center"})
            ok.add_field("file", video_bytes, filename="v.mp4")
            created = await call("POST", "/api/avatar/task", ok)
            tid = created["data"]["task_id"]
            for _ in range(600):
                st = await call("GET", f"/api/avatar/task/{tid}")
                if st["data"]["status"] in ("completed", "failed"):
                    break
                replies.pop()
                await asyncio.sleep(0.1)
            await call("GET", "/api/avatar/tasks")
            await call("DELETE", f"/api/avatar/task/{tid}")
        return replies

    want = asyncio.run(drive(jroutes.setup_avatar_routes))
    got = asyncio.run(drive(lambda app: troutes.setup_avatar_routes(app, "cpu")))

    def strip(r):
        r = json.loads(json.dumps(r))
        data = r.get("data") or {}
        for t in [data] + data.get("tasks", []):
            for k in ("task_id", "created_at", "updated_at"):
                t.pop(k, None)
        return r

    assert [strip(r) for r in got] == [strip(r) for r in want]
    assert got[0] == {"code": -1, "msg": "missing video file"}
    assert got[5]["data"]["status"] == "completed" and got[-1] == {"code": 0, "msg": "ok"}
    assert os.path.exists(os.path.join(str(tmp_path), "data", "avatars", "up", "coords.pkl"))
