"""The port's RTMP and virtual-camera transports and the session's recording,
against the JAX package's.

  - Virtual camera: a fake ``pyvirtualcam`` (and ``pyaudio``) through
    ``sys.modules``; the same BGR frames and PCM through both packages'
    ``VirtualCamOutput``: the same RGB frames reach the camera, the same
    bytes the speaker, the same eventpoints the session (exact); and
    ``chip_smoke.py``'s camera step over the same fake.
  - RTMP and recording logic: both packages' compose loops
    (``BaseAvatar.process_frames``) feed ``--transport rtmp`` and the
    recorder with the same frames and PCM over a fake muxer class: the same
    opens, frames and audio reach the muxers, eventpoints fire in the same
    order whatever the muxer's state, the pre-video audio buffer holds at
    most 500 frames (exact). The JAX package's native library is never
    loaded here (its own tests build it in place).
  - The real native muxer: the port's compose loop with ``--transport
    rtmp`` to a local ``.flv`` and recording to ``data/record/<id>.mp4``;
    the audio decoded from both is within 2% of the PCM the loop pushed
    (sample count and RMS) and keeps its tone.
"""

import os
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from livetalking_tpu.avatars.base_avatar import BaseAvatar as JaxAvatar
from livetalking_tpu.config import default_opt as jax_default_opt
from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar
from livetalking_tpu_torch.config import default_opt
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

PKGS = ("livetalking_tpu", "livetalking_tpu_torch")
AVATARS = {"livetalking_tpu": JaxAvatar, "livetalking_tpu_torch": BaseAvatar}
OPTS = {"livetalking_tpu": jax_default_opt, "livetalking_tpu_torch": default_opt}
H, W = 72, 96


def _av_inputs(n_ticks=12, seed=5):
    """Per tick: the cycle index, and two 20 ms audio frames (float, as the
    feature thread hands them over) with type and eventpoint; speech in the
    middle ticks, a start and an end eventpoint."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_ticks * 640) / 16000
    tone = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    ticks = []
    for k in range(n_ticks):
        speech = 2 <= k < n_ticks - 2
        frames = []
        for j in range(2):
            ev = {}
            if speech and k == 2 and j == 0:
                ev = {"status": "start", "text": "x"}
            elif speech and k == n_ticks - 3 and j == 1:
                ev = {"status": "end", "text": "x"}
            data = tone[(2 * k + j) * 320:(2 * k + j + 1) * 320] if speech \
                else (rng.standard_normal(320) * 1e-3).astype(np.float32)
            frames.append(types.SimpleNamespace(data=data, type=0 if speech else 1, userdata=ev))
        ticks.append((k % 4, frames))
    cycle = [rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for _ in range(4)]
    return ticks, cycle


def _compose(avatar, ticks, cycle, record_from=None, record_to=None):
    """Run ``avatar.process_frames`` over ``ticks`` in lockstep (idle frames
    for silence, the cycle frame for a speech tick without a model frame),
    starting the recorder before tick ``record_from`` and stopping it before
    tick ``record_to``; returns the PCM pushed per tick."""
    avatar.frame_list_cycle = cycle
    done = [0]
    record_audio = avatar.record_audio_data

    def counted(frame):  # the last call of each tick's compose
        record_audio(frame)
        done[0] += 1

    avatar.record_audio_data = counted
    pushed = []
    quit_event = threading.Event()
    t = threading.Thread(target=avatar.process_frames, args=(quit_event,), daemon=True)
    t.start()
    for k, (idx, frames) in enumerate(ticks):
        if k == record_from:
            avatar.start_recording()
        if k == record_to:
            avatar.stop_recording()
        item = (None, frames, idx)
        if type(avatar).__module__.startswith("livetalking_tpu_torch"):
            item += (None, None)  # the port's item adds a request id and an open span
        avatar.res_frame_queue.put(item)
        pushed.append(np.concatenate([(f.data * 32767).astype(np.int16) for f in frames]))
        deadline = time.time() + 10
        while done[0] < 2 * (k + 1) and time.time() < deadline:
            time.sleep(0.002)
        assert done[0] == 2 * (k + 1), f"tick {k} not composed"
    quit_event.set()
    t.join(10)
    assert not t.is_alive()
    return pushed


class FakeMuxer:
    log = []

    def __init__(self, url, width, height, fps=25, sample_rate=16000, fmt=""):
        self.url = os.path.basename(url)
        FakeMuxer.log.append(("open", self.url, width, height, fps))

    def write_video(self, frame):
        FakeMuxer.log.append(("video", self.url, frame.shape, int(frame.astype(np.int64).sum())))

    def write_audio(self, pcm):
        FakeMuxer.log.append(("audio", self.url, np.asarray(pcm, np.int16).tobytes()))

    def close(self):
        FakeMuxer.log.append(("close", self.url))


class _Events:
    def __init__(self):
        self.events = []

    def notify(self, ev):
        if ev and ev.get("status"):
            self.events.append(ev)


def test_rtmp_and_recording_logic_match_jax(tmp_path, monkeypatch):
    import livetalking_tpu.native as jax_native

    from livetalking_tpu_torch import native

    monkeypatch.chdir(tmp_path)
    for mod in (jax_native, native):
        monkeypatch.setattr(mod, "AVMuxer", FakeMuxer)
        monkeypatch.setattr(mod, "available", lambda: True)
    ticks, cycle = _av_inputs()
    got = {}
    for p in PKGS:
        FakeMuxer.log = []
        opt = OPTS[p](transport="rtmp", tts="dummy", sessionid=f"s_{p}", push_url="live.flv",
                      batch_size=2)
        avatar = AVATARS[p](opt)
        events = _Events()
        avatar.notify = events.notify
        _compose(avatar, ticks, cycle, record_from=3, record_to=9)
        got[p] = (FakeMuxer.log, events.events)
    jax_log, ours_log = got["livetalking_tpu"][0], got["livetalking_tpu_torch"][0]
    rename = [tuple(x.replace("s_livetalking_tpu", "s_x") if isinstance(x, str) else x
                    for x in entry) for entry in jax_log]
    ours = [tuple(x.replace("s_livetalking_tpu_torch", "s_x") if isinstance(x, str) else x
                  for x in entry) for entry in ours_log]
    assert ours == rename
    assert got["livetalking_tpu_torch"][1] == got["livetalking_tpu"][1]
    assert [e["status"] for e in got["livetalking_tpu_torch"][1]] == ["start", "end"]
    opens = [e for e in ours if e[0] == "open"]
    assert opens == [("open", "live.flv", W, H, 25), ("open", "s_x.mp4", W, H, 25)]
    rec_video = [e for e in ours if e[0] == "video" and e[1] == "s_x.mp4"]
    assert len(rec_video) == 6
    assert [e for e in ours if e[0] == "close"] == [("close", "s_x.mp4"), ("close", "live.flv")]


def test_rtmp_buffers_audio_until_video_and_fires_eventpoints(monkeypatch):
    """Before the first video frame: at most 500 audio frames wait (the
    oldest dropped); eventpoints fire although no muxer is open; a muxer
    that cannot open is retried on the next frame."""
    from livetalking_tpu.streamout.rtmp import RTMPOutput as JaxRTMP

    from livetalking_tpu_torch import native
    from livetalking_tpu_torch.streamout.rtmp import RTMPOutput

    import livetalking_tpu.native as jax_native

    class Failing(FakeMuxer):
        def __init__(self, *a, **kw):
            raise RuntimeError("no server")

    got = []
    for cls, mod, opt_fn in ((JaxRTMP, jax_native, jax_default_opt),
                             (RTMPOutput, native, default_opt)):
        monkeypatch.setattr(mod, "AVMuxer", Failing)
        events = _Events()
        out = cls(opt=opt_fn(push_url="rtmp://127.0.0.1/live/x"), parent=events)
        out.start()
        for i in range(600):
            out.push_audio_frame(np.full(320, i, np.int16),
                                 {"status": "start"} if i == 0 else None)
        out.push_video_frame(np.zeros((H, W, 3), np.uint8))  # the open fails: retried later
        monkeypatch.setattr(mod, "AVMuxer", FakeMuxer)
        FakeMuxer.log = []
        out.push_video_frame(np.zeros((H, W, 3), np.uint8))
        out.stop()
        got.append(([e[0] for e in FakeMuxer.log],
                    [int(np.frombuffer(e[2], np.int16)[0]) for e in FakeMuxer.log
                     if e[0] == "audio"], events.events))
    assert got[1] == got[0]
    kinds, audio_first, events = got[1]
    assert kinds[0] == "open" and kinds.count("audio") == 500
    assert audio_first == list(range(100, 600))  # the newest 500 kept
    assert events == [{"status": "start"}]


def _fake_virtualcam(sent, written):
    cam_mod = types.ModuleType("pyvirtualcam")

    class Camera:
        def __init__(self, width, height, fps):
            self.device = "/dev/video-fake"
            sent.append(("open", width, height, fps))

        def send(self, frame):
            sent.append(("frame", np.ascontiguousarray(frame).tobytes(), frame.shape))

        def sleep_until_next_frame(self):
            sent.append(("sleep",))

        def close(self):
            sent.append(("close",))

    cam_mod.Camera = Camera
    pa_mod = types.ModuleType("pyaudio")
    pa_mod.paInt16 = 8

    class _Stream:
        def write(self, data):
            written.append(data)

        def stop_stream(self):
            pass

        def close(self):
            pass

    class PyAudio:
        def open(self, format, channels, rate, output, output_device_index):
            written.append(("open", format, channels, rate, output, output_device_index))
            return _Stream()

        def terminate(self):
            pass

    pa_mod.PyAudio = PyAudio
    return {"pyvirtualcam": cam_mod, "pyaudio": pa_mod}


def test_virtualcam_matches_jax():
    import importlib

    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, (5, H, W, 3), dtype=np.uint8)
    pcm = rng.integers(-9000, 9000, (10, 320)).astype(np.int16)
    names = ["pyvirtualcam", "pyaudio", *(f"{p}.streamout.virtualcam" for p in PKGS)]
    saved = {k: sys.modules.get(k) for k in names}
    got = {}
    try:
        for p in PKGS:
            sent, written = [], []
            sys.modules.update(_fake_virtualcam(sent, written))
            sys.modules.pop(f"{p}.streamout.virtualcam", None)
            mod = importlib.import_module(f"{p}.streamout.virtualcam")
            events = _Events()
            out = mod.VirtualCamOutput(opt=OPTS[p](audio_output_device=3), parent=events)
            out.start()
            for k, f in enumerate(frames):
                out.push_video_frame(f)
                for j in range(2):
                    out.push_audio_frame(pcm[2 * k + j], {"status": "start"} if k + j == 0 else {})
            deadline = time.time() + 5
            while len(written) < 1 + len(pcm) and time.time() < deadline:
                time.sleep(0.01)
            out.stop()
            out._audio_thread.join(5)
            got[p] = (sent, written, events.events)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    assert got["livetalking_tpu_torch"] == got["livetalking_tpu"]
    sent, written, events = got["livetalking_tpu_torch"]
    assert sent[0] == ("open", W, H, 25) and sent[-1] == ("close",)
    assert [s[1] for s in sent if s[0] == "frame"] == [f[..., ::-1].tobytes() for f in frames]
    assert sent.count(("sleep",)) == len(frames)
    assert written[0] == ("open", 8, 1, 16000, True, 3)
    assert written[1:] == [p.tobytes() for p in pcm]
    assert events == [{"status": "start"}]


def test_smoke_virtualcam_rate_on_a_fake_camera():
    """``chip_smoke.virtualcam_rate`` sends its frames through the port's
    plugin, RGB, one paced frame each, and closes the camera."""
    import chip_smoke

    frame = np.random.default_rng(4).integers(0, 256, (H, W, 3), dtype=np.uint8)
    names = ("pyvirtualcam", "pyaudio", "livetalking_tpu_torch.streamout.virtualcam")
    saved = {k: sys.modules.get(k) for k in names}
    sent, written = [], []
    try:
        sys.modules.update(_fake_virtualcam(sent, written))
        sys.modules.pop(names[2], None)
        fps = chip_smoke.virtualcam_rate(default_opt(), frame, n=7)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    assert fps > 0
    assert sent[0] == ("open", W, H, 25) and sent[-1] == ("close",)
    assert [s[1] for s in sent if s[0] == "frame"] == [frame[..., ::-1].tobytes()] * 7
    assert sent.count(("sleep",)) == 7


def test_virtualcam_needs_pyvirtualcam():
    """Without ``pyvirtualcam`` the module fails to import, so the session
    has no output plugin (logged), as in the JAX package."""
    from livetalking_tpu_torch.streamout import OUTPUT_MODULES

    saved = {k: sys.modules.get(k) for k in ("pyvirtualcam",
                                             "livetalking_tpu_torch.streamout.virtualcam")}
    sys.modules["pyvirtualcam"] = None
    sys.modules.pop("livetalking_tpu_torch.streamout.virtualcam", None)
    try:
        avatar = BaseAvatar.__new__(BaseAvatar)
        avatar.opt = default_opt(transport="virtualcam")
        assert avatar._create_plugin("streamout", "virtualcam", OUTPUT_MODULES) is None
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _native_or_skip():
    from livetalking_tpu_torch import native

    if not (shutil.which("g++") and shutil.which("pkg-config")) or subprocess.run(
            ["pkg-config", "--exists", *native.FFMPEG_LIBS]).returncode != 0:
        pytest.skip("g++, pkg-config or the ffmpeg development libraries are missing")
    return native


def _rms(x):
    return float(np.sqrt(np.mean(np.square(x.astype(np.float64)))))


def test_compose_loop_streams_and_records_through_the_native_muxer(tmp_path, monkeypatch):
    """10 s of ticks, 8 s of them recorded: AAC adds a fixed priming frame
    (FLV keeps it) and pads the last frame, up to 2048 samples, which 2% of
    8 s covers. The transport's 25 fps pacing is skipped here (it sleeps in
    ``streamout.rtmp``; the muxer is what is under test)."""
    native = _native_or_skip()
    from livetalking_tpu_torch.streamout import rtmp

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(rtmp, "time", types.SimpleNamespace(perf_counter=time.perf_counter,
                                                            sleep=lambda s: None))
    ticks, cycle = _av_inputs(n_ticks=250, seed=6)
    flv = str(tmp_path / "live.flv")
    avatar = BaseAvatar(default_opt(transport="rtmp", tts="dummy", sessionid="rec7",
                                    push_url=flv, batch_size=2))
    pushed = _compose(avatar, ticks, cycle, record_from=25, record_to=225)
    want_all = np.concatenate(pushed).astype(np.float32) / 32767
    want_rec = np.concatenate(pushed[25:225]).astype(np.float32) / 32767
    for path, want in ((flv, want_all), (tmp_path / "data" / "record" / "rec7.mp4", want_rec)):
        with open(path, "rb") as f:
            got = native.decode_audio_bytes(f.read())
        assert abs(got.shape[0] - want.shape[0]) <= 0.02 * want.shape[0], (path, got.shape)
        assert abs(_rms(got) - _rms(want)) <= 0.02 * _rms(want), (path, _rms(got), _rms(want))
        spec = np.abs(np.fft.rfft(got))
        assert abs(np.fft.rfftfreq(len(got), 1 / 16000)[np.argmax(spec)] - 440) < 5
