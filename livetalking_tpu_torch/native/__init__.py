"""ctypes binding + lazy build of the native A/V module ``avmux.cpp`` (ports
livetalking_tpu/native/__init__.py).

``libltav.so`` is built with ``g++`` against the system ffmpeg libraries
(``pkg-config`` flags of libavformat, libavcodec, libavutil, libswscale and
libswresample) at first use, into ``build/native/<hash>/`` at the
repository root (git-ignored), keyed by a hash of the source and the
flags. The build runs under an exclusive file lock and writes a temporary
name that is renamed into place, so parallel test workers and processes
never load a half-written library. Nothing is built at import.

API: ``available()``, ``AVMuxer`` (encode + mux BGR frames and 16 kHz PCM to
a file or an RTMP url), ``decode_audio_bytes`` (any container libavformat
can probe -> mono float32) and ``video_encoder_name()``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from livetalking_tpu_torch.utils.logger import logger

SRC = Path(__file__).resolve().parent / "avmux.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "native"
FFMPEG_LIBS = ["libavformat", "libavcodec", "libavutil", "libswscale", "libswresample"]
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[Exception] = None  # a failed build is not retried in this process


def _pkg_config(flag: str) -> list:
    return subprocess.check_output(["pkg-config", flag, *FFMPEG_LIBS], text=True).split()


def build() -> Path:
    """Compile avmux.cpp into ``build/native/<hash>/libltav.so`` unless it is
    already there (a changed source or changed flags give a new hash);
    returns its path. Raises when ``pkg-config``, the ffmpeg development
    files or ``g++`` are missing, or the compile fails (with the compiler's
    output)."""
    cflags, ldflags = _pkg_config("--cflags"), _pkg_config("--libs")
    h = hashlib.sha256(" ".join(CXX_FLAGS + cflags + ldflags).encode())
    h.update(SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libltav.so"
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the process dies too
        if lib.exists():
            return lib
        tmp = out_dir / f"libltav.so.{os.getpid()}.tmp"
        cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp), *cflags, *ldflags]
        logger.info("building native avmux: %s", " ".join(cmd))
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use. A failed build is logged
    once and raises, and raises the same error again on later calls without
    rebuilding or logging (the RTMP transport asks on every frame until its
    muxer opens; the decoder asks on every non-WAV utterance)."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.CalledProcessError) as e:
            logger.warning("native avmux unavailable: %s", e)
            _error = e
            raise
        lib.ltav_open.restype = ctypes.c_void_p
        lib.ltav_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_char_p, ctypes.c_int]
        lib.ltav_write_video.restype = ctypes.c_int
        lib.ltav_write_video.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.ltav_write_audio.restype = ctypes.c_int
        lib.ltav_write_audio.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.ltav_close.restype = ctypes.c_int
        lib.ltav_close.argtypes = [ctypes.c_void_p]
        lib.ltav_decode_audio.restype = ctypes.POINTER(ctypes.c_float)
        lib.ltav_decode_audio.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.c_char_p, ctypes.c_int]
        lib.ltav_free.restype = None
        lib.ltav_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.ltav_video_encoder_name.restype = ctypes.c_char_p
        lib.ltav_video_encoder_name.argtypes = []
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library loads (``get_lib`` logs why not, once)."""
    try:
        get_lib()
        return True
    except (OSError, RuntimeError, subprocess.CalledProcessError):  # toolchain or libs missing
        return False


class AVMuxer:
    """Encode+mux BGR frames and 16 kHz PCM to a file (mp4, flv, ...) or an
    RTMP url (flv)."""

    def __init__(self, url: str, width: int, height: int, fps: int = 25,
                 sample_rate: int = 16000, fmt: str = ""):
        if not fmt:
            fmt = "flv" if url.startswith("rtmp") else ""
        lib = get_lib()
        err = ctypes.create_string_buffer(512)
        self._lib = lib
        self._h = lib.ltav_open(url.encode(), fmt.encode(), width, height,
                                fps, sample_rate, err, len(err))
        if not self._h:
            raise RuntimeError(f"ltav_open failed: {err.value.decode()}")
        self.width, self.height = width, height

    def write_video(self, frame_bgr: np.ndarray) -> None:
        if frame_bgr.shape != (self.height, self.width, 3):
            raise ValueError(f"frame {frame_bgr.shape}, the muxer takes "
                             f"({self.height}, {self.width}, 3)")
        data = np.ascontiguousarray(frame_bgr, dtype=np.uint8)
        rc = self._lib.ltav_write_video(self._h, data.ctypes.data_as(ctypes.c_char_p))
        if rc < 0:
            raise RuntimeError(f"ltav_write_video rc={rc}")

    def write_audio(self, pcm16: np.ndarray) -> None:
        data = np.ascontiguousarray(pcm16, dtype=np.int16)
        rc = self._lib.ltav_write_audio(self._h, data.ctypes.data_as(ctypes.c_char_p),
                                        data.shape[0])
        if rc < 0:
            raise RuntimeError(f"ltav_write_audio rc={rc}")

    def close(self) -> None:
        if self._h:
            self._lib.ltav_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def decode_audio_bytes(data: bytes, target_sr: int = 16000) -> np.ndarray:
    """Decode any libavformat-probed container to mono f32 @ target_sr."""
    lib = get_lib()
    err = ctypes.create_string_buffer(512)
    n = ctypes.c_int(0)
    ptr = lib.ltav_decode_audio(data, len(data), target_sr, ctypes.byref(n),
                                err, len(err))
    if not ptr:
        raise ValueError(f"decode failed: {err.value.decode()}")
    try:
        return np.ctypeslib.as_array(ptr, shape=(n.value,)).copy()
    finally:
        lib.ltav_free(ptr)


def video_encoder_name() -> str:
    return get_lib().ltav_video_encoder_name().decode()
