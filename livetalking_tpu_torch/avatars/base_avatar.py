"""The per-session avatar runtime (ports livetalking_tpu/avatars/base_avatar.py).

  - ingest: ``put_msg_txt`` (text -> TTS), ``put_audio_frame`` (20 ms PCM),
    ``put_audio_file``/``put_audio_filepath`` (decode + chunk + start/end
    eventpoints);
  - custom "action choreography": idle video/audio loops keyed by
    ``audiotype``, switched by ``set_custom_state``;
  - per-session recording to ``data/record/<sessionid>.mp4``: the port's
    native muxer (one in-process h264 + aac mp4 muxer), or two ffmpeg-CLI
    pipes (raw BGR -> h264, s16le -> aac) muxed on stop where the native
    module cannot be built; a broken recorder disables itself and never
    stops the compose thread;
  - SSE fan-out via ``msgqueues`` / ``send_msg`` / ``notify``;
  - 4-thread pipeline per session: TTS -> feature ring buffer ->
    inference -> frame compose/output, linked by bounded queues, with
    back-pressure (sleep when the output backlog is >= 5 frames) and the
    all-silence fast path that skips the network entirely. Each feature
    batch's request id rides the queues to the compose thread, and spans
    (``utils/spans.py``, while a profiler runs) time the hand-offs:
    ``features.queue`` (closed by the inference thread's get),
    ``session.inflight`` (frames on the host until handed on),
    ``compose.queue`` (per frame, ``res_frame_queue``'s put to get) and
    ``compose.frame`` (the compose thread's work on a frame).

Device work lives in the subclasses: ``inference_batch`` receives the
device-resident feature batch from ``feat_queue``.
"""

from __future__ import annotations

import glob
import json
import os
import queue
import subprocess
import time
from collections import deque
from importlib import import_module
from queue import Queue
from threading import Event, Lock, Thread
from typing import Dict, List, Optional

import numpy as np

from livetalking_tpu_torch import native, registry
from livetalking_tpu_torch.audio_features.base import AudioFrameData
from livetalking_tpu_torch.streamout import OUTPUT_MODULES
from livetalking_tpu_torch.tts import TTS_MODULES
from livetalking_tpu_torch.utils import spans
from livetalking_tpu_torch.utils.audio import load_pcm16k
from livetalking_tpu_torch.utils.image import mirror_index, read_imgs
from livetalking_tpu_torch.utils.logger import logger

WATERMARK = "LiveTalking"


def record_path(sessionid: str) -> str:
    """Where a session's recording lands: ``data/record/<sessionid>.mp4``
    under the working directory (``GET /record/{sessionid}`` serves it)."""
    return os.path.join("data", "record", f"{sessionid}.mp4")


class BaseAvatar:
    def __init__(self, opt):
        self.opt = opt
        self.sample_rate = 16000
        self.chunk = self.sample_rate // (opt.fps * 2)  # 320 samples = 20 ms
        self.sessionid = getattr(opt, "sessionid", "0")

        # egress back-pressure threshold (frames; reference value 5):
        # the render loop throttles feature extraction when the
        # transport backlog reaches this — see --egress_buffer_frames
        self.egress_buffer_frames = max(
            1, int(getattr(opt, "egress_buffer_frames", 5) or 5))

        self.speaking = False
        self.recording = False
        self._rec_native = False
        self._rec_muxer = None
        self._rec_pending_audio: List[np.ndarray] = []
        self._rec_video_pipe = None
        self._rec_audio_pipe = None
        self._record_lock = Lock()  # writers (compose thread) vs start/stop (HTTP)
        self.width = self.height = 0

        # custom choreography state (audiotype 0 = normal, 1 = silence, >1 = custom)
        self.custom_audiotype = 0
        self.custom_img_cycle: Dict[int, list] = {}
        self.custom_audio_cycle: Dict[int, np.ndarray] = {}
        self.custom_audio_index: Dict[int, int] = {}
        self.custom_index: Dict[int, int] = {}
        self.msgqueues: List[Queue] = []
        self._load_custom()

        self.batch_size = opt.batch_size
        # (crop or None, its two audio frames, cycle index, request id,
        # open compose.queue span)
        self.res_frame_queue: Queue = Queue(self.batch_size * 2)

        self.tts = self._create_plugin("tts", opt.tts, TTS_MODULES)
        self.output = self._create_plugin("streamout", opt.transport, OUTPUT_MODULES)

        # set by subclass:
        self.asr = None
        self.frame_list_cycle: list = []

    def _create_plugin(self, category: str, name: str, modules: Dict[str, str]):
        if name not in modules:
            logger.error("%s plugin %s not found in module map", category, name)
            return None
        try:
            import_module(modules[name])
        except ImportError as e:
            logger.error("%s plugin %s unavailable (missing dep: %s)", category, name, e)
            return None
        return registry.create(category, name, opt=self.opt, parent=self)

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def put_msg_txt(self, msg: str, datainfo: Optional[dict] = None) -> None:
        if self.tts is not None:
            self.tts.put_msg_txt(msg, datainfo or {})

    def put_audio_frame(self, audio_chunk: np.ndarray, datainfo: Optional[dict] = None) -> None:
        if self.asr is not None:
            self.asr.put_audio_frame(audio_chunk, datainfo or {})

    def _put_pcm_stream(self, stream: np.ndarray, datainfo: dict) -> None:
        streamlen = stream.shape[0]
        idx = 0
        first = True
        while streamlen >= self.chunk:
            eventpoint = {}
            is_last = streamlen - self.chunk < self.chunk
            if first:
                eventpoint = {"status": "start"}
                first = False
                if is_last:
                    # one-chunk stream: keep 'start' here and carry 'end' on
                    # a trailing 20 ms of silence so subscribers see both
                    eventpoint.update(**datainfo)
                    self.put_audio_frame(stream[idx : idx + self.chunk], eventpoint)
                    tail = {"status": "end"}
                    tail.update(**datainfo)
                    self.put_audio_frame(np.zeros(self.chunk, np.float32), tail)
                    return
            if is_last:
                eventpoint = {"status": "end"}
            eventpoint.update(**datainfo)
            self.put_audio_frame(stream[idx : idx + self.chunk], eventpoint)
            streamlen -= self.chunk
            idx += self.chunk

    def put_audio_file(self, filebytes: bytes, datainfo: Optional[dict] = None) -> None:
        self._put_pcm_stream(load_pcm16k(filebytes), datainfo or {})

    def put_audio_filepath(self, filepath: str, datainfo: Optional[dict] = None) -> None:
        self._put_pcm_stream(load_pcm16k(filepath), datainfo or {})

    def flush_talk(self) -> None:
        """Interrupt: cancel queued + in-flight TTS, drop buffered audio."""
        if self.tts is not None:
            self.tts.flush_talk()
        if self.asr is not None:
            self.asr.flush_talk()
        self.custom_audiotype = 0

    def is_speaking(self) -> bool:
        return self.speaking

    # ------------------------------------------------------------------
    # custom choreography
    # ------------------------------------------------------------------
    def _load_custom(self) -> None:
        for item in getattr(self.opt, "customopt", None) or []:
            logger.info("custom choreography: %s", item)
            audiotype = item["audiotype"]
            imgs = sorted(
                glob.glob(os.path.join(item["imgpath"], "*.[jpJP][pnPN]*[gG]")),
                key=lambda p: int(os.path.splitext(os.path.basename(p))[0]),
            )
            self.custom_img_cycle[audiotype] = read_imgs(imgs)
            if item.get("audiopath"):
                self.custom_audio_cycle[audiotype] = load_pcm16k(item["audiopath"])
                self.custom_audio_index[audiotype] = 0
            self.custom_index[audiotype] = 0

    def init_customindex(self) -> None:
        self.custom_audiotype = 0
        for k in self.custom_audio_index:
            self.custom_audio_index[k] = 0
        for k in self.custom_index:
            self.custom_index[k] = 0

    def get_custom_audio_stream(self, audiotype: int) -> np.ndarray:
        idx = self.custom_audio_index[audiotype]
        stream = self.custom_audio_cycle[audiotype][idx : idx + self.chunk]
        self.custom_audio_index[audiotype] += self.chunk
        if self.custom_audio_index[audiotype] >= self.custom_audio_cycle[audiotype].shape[0]:
            self.custom_audiotype = 1  # exhausted -> fall back to silence
        return stream

    def set_custom_state(self, audiotype: int, reinit: bool = True) -> None:
        logger.info("set_custom_state: %s", audiotype)
        if self.custom_audio_index.get(audiotype) is None:
            return
        self.custom_audiotype = audiotype
        if reinit:
            self.custom_audio_index[audiotype] = 0
            self.custom_index[audiotype] = 0

    # ------------------------------------------------------------------
    # SSE fan-out
    # ------------------------------------------------------------------
    def add_msgqueue(self, q: Queue) -> None:
        self.msgqueues.append(q)

    def send_msg(self, msg: str) -> None:
        for q in self.msgqueues:
            q.put(msg)

    def notify(self, eventpoint: Optional[dict]) -> None:
        if eventpoint and eventpoint.get("status"):
            logger.info("notify:%s", eventpoint)
            self.send_msg(json.dumps(eventpoint))

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------
    def _record_path(self) -> str:
        path = record_path(self.sessionid)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def start_recording(self) -> None:
        """Start recording the composed stream. With the native muxer the
        file opens on the next video frame (it needs the frame size) and
        audio before it is buffered; the ffmpeg-CLI fallback needs a frame
        to have been composed already, and is ignored (logged) before."""
        # outside the lock: the first call may build the native module, and
        # the compose thread takes the lock for every frame
        rec_native = native.available()
        with self._record_lock:
            if self.recording:
                return
            self._rec_muxer = None
            self._rec_native = rec_native
            if self._rec_native:
                self._rec_pending_audio = []
                self.recording = True
                return
            if self.width == 0:
                logger.error("start_recording before the first frame (unknown "
                             "dims) requires the native muxer - ignoring")
                return
            vcmd = ["ffmpeg", "-y", "-an", "-f", "rawvideo", "-vcodec", "rawvideo",
                    "-pix_fmt", "bgr24", "-s", f"{self.width}x{self.height}",
                    "-r", str(self.opt.fps), "-i", "-", "-pix_fmt", "yuv420p",
                    "-vcodec", "h264", f"temp{self.sessionid}.mp4"]
            acmd = ["ffmpeg", "-y", "-vn", "-f", "s16le", "-ac", "1", "-ar", "16000",
                    "-i", "-", "-acodec", "aac", f"temp{self.sessionid}.aac"]
            self._rec_video_pipe = subprocess.Popen(vcmd, stdin=subprocess.PIPE)
            self._rec_audio_pipe = subprocess.Popen(acmd, stdin=subprocess.PIPE)
            self.recording = True

    def record_video_data(self, image: np.ndarray) -> None:
        if self.width == 0:
            self.height, self.width, _ = image.shape
        with self._record_lock:
            if not self.recording:
                return
            try:
                if self._rec_native:
                    if self._rec_muxer is None:
                        h, w = image.shape[:2]
                        self._rec_muxer = native.AVMuxer(self._record_path(), w, h, self.opt.fps)
                        for pcm in self._rec_pending_audio:
                            self._rec_muxer.write_audio(pcm)
                        self._rec_pending_audio = []
                    self._rec_muxer.write_video(image)
                else:
                    self._rec_video_pipe.stdin.write(image.tobytes())
            except Exception as e:
                # a broken recorder must never kill the compose thread
                logger.error("recording video write failed - disabling: %s", e)
                self.recording = False

    def record_audio_data(self, frame: np.ndarray) -> None:
        with self._record_lock:
            if not self.recording:
                return
            try:
                if self._rec_native:
                    if self._rec_muxer is None:
                        self._rec_pending_audio.append(np.asarray(frame, np.int16))
                    else:
                        self._rec_muxer.write_audio(frame)
                else:
                    self._rec_audio_pipe.stdin.write(frame.tobytes())
            except Exception as e:
                logger.error("recording audio write failed - disabling: %s", e)
                self.recording = False

    def stop_recording(self) -> None:
        """Finish the file: close the native muxer, or close both ffmpeg pipes
        and mux their outputs into ``data/record/<sessionid>.mp4``. Also
        closes what a recorder that disabled itself left open."""
        with self._record_lock:
            self.recording = False
            if self._rec_muxer is not None:
                self._rec_muxer.close()
                self._rec_muxer = None
            if self._rec_video_pipe is None:
                return
            video, audio = self._rec_video_pipe, self._rec_audio_pipe
            self._rec_video_pipe = self._rec_audio_pipe = None
        for proc in (video, audio):
            proc.stdin.close()
            proc.wait()
        subprocess.run(
            ["ffmpeg", "-y", "-i", f"temp{self.sessionid}.aac",
             "-i", f"temp{self.sessionid}.mp4", "-c:v", "copy", "-c:a", "copy",
             self._record_path()],
            check=False,
        )
        for tmp in (f"temp{self.sessionid}.aac", f"temp{self.sessionid}.mp4"):
            try:
                os.remove(tmp)
            except OSError as e:
                logger.error("error removing temp file %s: %s", tmp, e)

    # ------------------------------------------------------------------
    # render pipeline
    # ------------------------------------------------------------------
    def get_avatar_length(self) -> int:
        return len(self.frame_list_cycle) if self.frame_list_cycle else 1

    def inference_batch(self, index: int, audiofeat_batch) -> np.ndarray:
        """One model step: (start frame index, device feature batch) ->
        (B, S, S, 3) uint8 mouth-region frames. Implemented by plugins."""
        raise NotImplementedError

    def submit_batch(self, index: int, audiofeat_batch, rid=None):
        """Asynchronously submit one batch (``rid``: its request id);
        returns an opaque handle for ``resolve_batch``. Default: run
        ``inference_batch`` synchronously and hand back the finished frames
        (depth-1 pipeline). Plugins backed by the shared BatchScheduler
        override this pair so the session can keep ``--session_inflight``
        batches in flight, so its emission period is not the request
        round-trip latency; their handle's ``host_ns`` says when the frames
        reached the host."""
        return self.inference_batch(index, audiofeat_batch)

    def resolve_batch(self, handle) -> np.ndarray:
        """Block until a ``submit_batch`` handle's frames are ready."""
        return handle

    def paste_back_frame(self, pred_frame: np.ndarray, idx: int) -> np.ndarray:
        """Composite one predicted crop back into full frame ``idx``."""
        raise NotImplementedError

    def inference(self, quit_event) -> None:
        """Inference thread: consume feature batches, submit the device
        step (or skip it entirely on all-silence), emit per-frame results.

        Up to ``--session_inflight`` submitted batches ride in flight;
        results are emitted strictly in submission order with their own
        audio frames, so A/V pairing is unchanged — the pipeline only
        decouples the session's emission period from the per-request
        round-trip latency (glass-to-glass latency grows by at most
        inflight-1 batches)."""
        length = self.get_avatar_length()
        index = 0
        last_speaking = False
        depth = max(1, int(getattr(self.opt, "session_inflight", 2) or 1))
        # (handle | None, audio_frames, base_index, request id, the
        # perf_counter_ns instant a synchronous handle's frames were ready)
        pending: "deque" = deque()
        logger.info("start inference (inflight=%d)", depth)

        def emit_one() -> None:
            handle, afr, base_idx, rid, ready_ns = pending.popleft()
            pred = None
            if handle is not None:
                try:
                    pred = self.resolve_batch(handle)
                except Exception:
                    # a failed device step (wedged scheduler, bounded-wait
                    # timeout) must not kill the inference
                    # thread: degrade this batch to idle frames and keep
                    # the session alive (reference degradation model, cf.
                    # its paste-back skip / silence synthesis)
                    logger.exception(
                        "inference_batch failed: idle frames for this batch")
                    pred = None
            if pred is None:
                for i in range(self.batch_size):
                    idx = mirror_index(length, base_idx + i)
                    self.res_frame_queue.put((None, afr[i * 2 : i * 2 + 2], idx, rid,
                                              spans.begin("compose.queue", rid)))
            else:
                host_ns = getattr(handle, "host_ns", ready_ns)
                if host_ns is not None:
                    spans.record("session.inflight", host_ns, spans.now(), rid)
                for i in range(len(pred)):
                    self.res_frame_queue.put(
                        (pred[i], afr[i * 2 : i * 2 + 2], mirror_index(length, base_idx + i),
                         rid, spans.begin("compose.queue", rid))
                    )

        while not quit_event.is_set():
            try:
                audiofeat_batch, rid, queued = self.asr.feat_queue.get(block=True, timeout=1)
            except queue.Empty:
                while pending:  # starved: flush in-flight results
                    emit_one()
                continue
            spans.end(queued)

            audio_frames: List[AudioFrameData] = []
            is_all_silence = True
            for _ in range(self.batch_size * 2):
                af = self.asr.output_queue.get()
                if af.type == 0:
                    is_all_silence = False
                audio_frames.append(af)

            current_speaking = not is_all_silence
            if is_all_silence:
                pending.append((None, audio_frames, index, rid, None))
                index += self.batch_size
            else:
                if current_speaking and not last_speaking and self.custom_index.get(1) is not None:
                    index = 0  # silence->speech with a custom idle video: restart cycle
                try:
                    handle = self.submit_batch(index, audiofeat_batch, rid)
                except Exception:
                    logger.exception(
                        "inference submit failed: idle frames for this batch")
                    handle = None
                pending.append((handle, audio_frames, index, rid,
                                spans.now() if spans.on() else None))
                index += self.batch_size
            while len(pending) >= depth:
                emit_one()

            if current_speaking != last_speaking:
                logger.info(
                    "inference state switch: %s -> %s",
                    "speaking" if last_speaking else "silence",
                    "speaking" if current_speaking else "silence",
                )
                last_speaking = current_speaking
        while pending:
            emit_one()
        logger.info("baseavatar inference thread stop")

    def process_frames(self, quit_event) -> None:
        """Compose thread: silence frames replay the base/custom cycle;
        speech frames get pasted back; both are watermarked and pushed with
        their two 20 ms audio frames."""
        if self.output is None:
            logger.error("no streamout plugin - compose thread not starting")
            return
        self.output.start()
        while not quit_event.is_set():
            try:
                res_frame, audio_frames, idx, rid, queued = self.res_frame_queue.get(
                    block=True, timeout=1)
            except queue.Empty:
                continue
            spans.end(queued)
            with spans.span("compose.frame", rid):
                self._compose_one(res_frame, audio_frames, idx)

        self.output.stop()
        logger.info("baseavatar process_frames thread stop")

    def _compose_one(self, res_frame, audio_frames, idx: int) -> None:
        """Paste back (or replay the idle frame), watermark and push one
        frame with its two 20 ms audio frames."""
        import cv2  # the watermark: byte-identical to the reference's frames

        if audio_frames[0].type != 0 and audio_frames[1].type != 0:
            self.speaking = False
            audiotype = audio_frames[0].type
            if self.custom_index.get(audiotype) is not None:
                cycle = self.custom_img_cycle[audiotype]
                mirindex = mirror_index(len(cycle), self.custom_index[audiotype])
                frame = cycle[mirindex].copy()  # don't mutate the cycle
                self.custom_index[audiotype] += 1
            else:
                frame = self.frame_list_cycle[idx].copy()
        else:
            self.speaking = True
            if res_frame is None:
                # a degraded speech batch (inference_batch failure):
                # replay the idle frame rather than dropping A/V sync
                frame = self.frame_list_cycle[idx].copy()
            else:
                try:
                    frame = self.paste_back_frame(res_frame, idx)  # fresh frame
                except Exception as e:
                    logger.warning("paste_back_frame error: %s", e)
                    return

        # device-buffer views may be read-only or non-C-contiguous
        # (backend-dependent); cv2 needs a writable C-order Mat
        if not (frame.flags.c_contiguous and frame.flags.writeable):
            frame = np.array(frame, order="C", copy=True)
        cv2.putText(frame, WATERMARK, (10, 20), cv2.FONT_HERSHEY_SIMPLEX,
                    0.3, (128, 128, 128), 1)

        self.output.push_video_frame(frame)
        self.record_video_data(frame)

        for af in audio_frames:
            pcm16 = (af.data * 32767).astype(np.int16)
            self.output.push_audio_frame(pcm16, af.userdata)
            self.record_audio_data(pcm16)

    def render(self, quit_event) -> None:
        """Main per-session loop: start the TTS / inference / compose
        threads, then drive feature extraction with back-pressure."""
        self.quit_event = quit_event
        self.init_customindex()
        if self.tts is not None:
            self.tts.render(quit_event)

        infer_quit = Event()
        infer_thread = Thread(target=self.inference, args=(infer_quit,), daemon=True)
        infer_thread.start()

        compose_quit = Event()
        compose_thread = Thread(target=self.process_frames, args=(compose_quit,), daemon=True)
        compose_thread.start()

        while not quit_event.is_set():
            self.asr.run_step()
            buffer_size = self.output.get_buffer_size() if self.output else 0
            if buffer_size >= self.egress_buffer_frames:
                logger.debug("sleep qsize=%d", buffer_size)
                # identical to the reference 0.032*qsize at the default
                # threshold 5; shifted for deeper jitter buffers so the
                # sleep tracks the EXCESS, not the absolute depth
                time.sleep(0.04 * 0.8 *
                           (buffer_size - self.egress_buffer_frames + 5))
        logger.info("baseavatar render thread stop")

        infer_quit.set()
        infer_thread.join()
        compose_quit.set()
        compose_thread.join()
