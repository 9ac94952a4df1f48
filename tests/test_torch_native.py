"""The port's native A/V module (``livetalking_tpu_torch/native``):
``tests/test_native.py``'s five behaviours against the port (build, mux and
decode round trip, in-memory WAV decode, the RTMP transport writing a
local FLV, the session's native recording), plus where the library is
built and the audio decode fallback of ``utils/audio.py``.

The module builds ``avmux.cpp`` with ``g++`` against the ffmpeg libraries
found by ``pkg-config``; the tests skip only where one of those is
missing, and fail if the build fails where all are present.
"""

import io
import os
import shutil
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest

from livetalking_tpu_torch import native
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def toolchain():
    if not (shutil.which("g++") and shutil.which("pkg-config")):
        pytest.skip("g++ or pkg-config missing: the native module cannot be built")
    if subprocess.run(["pkg-config", "--exists", *native.FFMPEG_LIBS]).returncode != 0:
        pytest.skip("the ffmpeg development libraries are missing")
    native.get_lib()  # all present: a failed build fails the tests


def _tone(n: int, freq: float = 440.0, sr: int = 16000) -> np.ndarray:
    return (np.sin(2 * np.pi * freq * np.arange(n) / sr) * 16000).astype(np.int16)


def test_encoder_available():
    assert native.video_encoder_name() != "none"


def test_mux_decode_roundtrip(tmp_path):
    path = str(tmp_path / "out.mp4")
    m = native.AVMuxer(path, 160, 120, 25)
    tone = _tone(640)
    for i in range(25):
        m.write_video(np.full((120, 160, 3), (i * 9) % 255, np.uint8))
        m.write_audio(tone)
    m.close()
    assert os.path.getsize(path) > 1000

    with open(path, "rb") as f:
        audio = native.decode_audio_bytes(f.read())
    # 1 s = 16000 samples written = 15x1024 + 640: the fifo tail drain keeps
    # the final partial AAC frame (without it only 15360 survive)
    assert 15700 < audio.shape[0] <= 16600, audio.shape
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    freqs = np.fft.rfftfreq(len(audio), 1 / 16000)
    assert abs(freqs[np.argmax(spec)] - 440) < 30
    with pytest.raises(ValueError, match="muxer takes"):
        native.AVMuxer(str(tmp_path / "x.mp4"), 160, 120).write_video(np.zeros((2, 2, 3), np.uint8))


def test_decode_wav_bytes():
    buf = io.BytesIO()
    pcm = (np.sin(2 * np.pi * 220 * np.arange(24000) / 24000) * 16000).astype("<i2")
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(24000)
        w.writeframes(pcm.tobytes())
    audio = native.decode_audio_bytes(buf.getvalue(), 16000)
    assert abs(audio.shape[0] - 16000) < 50  # resampled 24k -> 16k
    with pytest.raises(ValueError, match="decode failed"):
        native.decode_audio_bytes(b"not audio at all" * 8)


def test_rtmp_plugin_writes_flv(tmp_path):
    """The RTMP transport against a local file URL (flv format, no server)."""
    from livetalking_tpu_torch.config import default_opt
    from livetalking_tpu_torch.streamout.rtmp import RTMPOutput

    flv = str(tmp_path / "stream.flv")
    out = RTMPOutput(opt=default_opt(push_url=flv, fps=25), parent=None)
    assert out.push_url == flv
    out.start()
    silence = np.zeros(320, np.int16)
    out.push_audio_frame(silence)  # audio before video is buffered
    assert len(out._pre_video_audio) == 1
    for _ in range(5):
        out.push_video_frame(np.zeros((120, 160, 3), np.uint8))
        out.push_audio_frame(silence)
        out.push_audio_frame(silence)
    assert out._pre_video_audio == []
    out.stop()
    assert os.path.getsize(flv) > 500


def test_engine_native_recording(tmp_path, monkeypatch):
    """BaseAvatar recording through the native muxer (no ffmpeg CLI)."""
    monkeypatch.chdir(tmp_path)
    from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar
    from livetalking_tpu_torch.config import default_opt

    session = BaseAvatar(default_opt(transport="null", tts="dummy", sessionid="rec1"))
    session.start_recording()
    assert session.recording
    silence = np.zeros(320, np.int16)
    for _ in range(25):
        session.record_video_data(np.zeros((120, 160, 3), np.uint8))
        session.record_audio_data(silence)
        session.record_audio_data(silence)
    session.stop_recording()
    out = tmp_path / "data" / "record" / "rec1.mp4"
    assert out.exists() and out.stat().st_size > 1000
    assert not session.recording and session._rec_muxer is None


def test_library_is_built_under_the_ignored_build_dir():
    """The port loads its own build from ``build/native/``, which git
    ignores, never the JAX package's ``livetalking_tpu/native/libltav.so``."""
    path = Path(native.get_lib()._name).resolve()
    assert path.name == "libltav.so"
    assert path.is_relative_to(ROOT / "build" / "native")
    assert not path.is_relative_to(ROOT / "livetalking_tpu")
    assert native.build() == path  # built once: a second call finds it
    r = subprocess.run(["git", "check-ignore", "-q", str(path.parent / "lock")], cwd=ROOT)
    assert r.returncode == 0, "build/native/ must be git-ignored"


def test_parallel_builds_never_load_a_partial_library(tmp_path, monkeypatch):
    """Fresh builds from several processes at once (xdist workers) each load
    a whole library: one compiles under the file lock, the others wait."""
    root = tmp_path / "native_build"
    code = ("import sys; from pathlib import Path; from livetalking_tpu_torch import native;"
            f"native.BUILD_ROOT = Path({str(root)!r});"
            "print(native.video_encoder_name())")
    env = dict(os.environ, LIVETALKING_LOG=os.devnull)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-500:] for o in outs]
    assert {o[0].strip() for o in outs} == {native.video_encoder_name()}
    (build,) = list(root.iterdir())
    assert sorted(p.name for p in build.iterdir()) == ["libltav.so", "lock"]


def test_compressed_audio_decodes_natively(tmp_path, monkeypatch):
    """``load_pcm16k`` of a non-WAV payload (AAC in mp4 here; edge-tts sends
    MP3) goes through the native decoder before any ffmpeg CLI."""
    from livetalking_tpu_torch.utils import audio

    path = str(tmp_path / "a.mp4")
    m = native.AVMuxer(path, 64, 48, 25)
    for _ in range(25):
        m.write_video(np.zeros((48, 64, 3), np.uint8))
        m.write_audio(_tone(640))
    m.close()
    data = Path(path).read_bytes()
    monkeypatch.setattr(audio.shutil, "which", lambda name: None)  # no CLI to fall back on
    got = audio.load_pcm16k(data)
    np.testing.assert_array_equal(got, native.decode_audio_bytes(data, 16000))
    assert got.dtype == np.float32 and 15700 < got.shape[0] <= 16600


def test_recording_without_native_needs_a_composed_frame(tmp_path, monkeypatch):
    """Where the native module is unavailable, recording falls back to the
    ffmpeg CLI pipes, which need the frame size: before any frame it is
    ignored (logged), as in the JAX package."""
    monkeypatch.chdir(tmp_path)
    from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar
    from livetalking_tpu_torch.config import default_opt

    monkeypatch.setattr(native, "available", lambda: False)
    session = BaseAvatar(default_opt(transport="null", tts="dummy", sessionid="rec2"))
    session.start_recording()
    assert not session.recording and session._rec_video_pipe is None
    session.record_video_data(np.zeros((120, 160, 3), np.uint8))  # not recording: no-op
    assert (session.width, session.height) == (160, 120)
    session.stop_recording()
    assert not (tmp_path / "data" / "record" / "rec2.mp4").exists()


def test_start_recording_builds_outside_the_record_lock(tmp_path, monkeypatch):
    """The first ``start_recording`` of a process may compile the native
    module; the compose thread's per-frame ``record_video_data`` and
    ``record_audio_data`` must not wait for it."""
    import threading
    import time

    monkeypatch.chdir(tmp_path)
    from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar
    from livetalking_tpu_torch.config import default_opt

    asked, release = threading.Event(), threading.Event()

    def slow_available():
        asked.set()
        release.wait(10)
        return True

    monkeypatch.setattr(native, "available", slow_available)
    session = BaseAvatar(default_opt(transport="null", tts="dummy", sessionid="rec3"))
    starter = threading.Thread(target=session.start_recording)
    starter.start()
    try:
        assert asked.wait(5)
        t0 = time.perf_counter()
        session.record_video_data(np.zeros((120, 160, 3), np.uint8))
        session.record_audio_data(np.zeros(320, np.int16))
        waited = time.perf_counter() - t0
    finally:
        release.set()
        starter.join(10)
    assert waited < 1.0 and not starter.is_alive()
    assert session.recording
    for _ in range(5):
        session.record_video_data(np.zeros((120, 160, 3), np.uint8))
        session.record_audio_data(np.zeros(320, np.int16))
    session.stop_recording()
    assert (tmp_path / "data" / "record" / "rec3.mp4").stat().st_size > 0


def test_a_failed_build_is_logged_once(monkeypatch, caplog):
    """Where the module cannot build, ``get_lib`` logs the reason once; the
    decoder's check on every non-WAV utterance adds no log line."""
    import logging

    from livetalking_tpu_torch.utils import audio

    calls = []

    def failing_build():
        calls.append(1)
        raise RuntimeError("pkg-config: libavformat not found")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "build", failing_build)
    monkeypatch.setattr(audio.shutil, "which", lambda name: None)
    caplog.set_level(logging.WARNING, logger="livetalking_tpu_torch")
    for _ in range(3):
        with pytest.raises(RuntimeError, match="no decoder available"):
            audio.load_pcm16k(b"ID3\x03\x00not a wav")
    assert not native.available()
    warned = [r.getMessage() for r in caplog.records if "avmux" in r.getMessage()]
    assert warned == ["native avmux unavailable: pkg-config: libavformat not found"]
    assert len(calls) == 1
