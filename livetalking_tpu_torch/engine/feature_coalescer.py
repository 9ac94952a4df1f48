"""Cross-session batched feature encoding (ports
livetalking_tpu/engine/feature_coalescer.py).

Under --coalesce each session would otherwise run its own Whisper encode
before submitting to the BatchScheduler; the submissions then stagger and
super-batches coalesce poorly. Here sessions submit their rolling audio
windows, and one device worker drains whatever is queued and runs ONE
batched encode per tick (bucketed padding, the same discipline as
engine/scheduler.py). Each request resolves to its row of the batched
output, still on the device, so the per-session feature threads reach the
BatchScheduler nearly together.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeout
from queue import Empty, Queue
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from livetalking_tpu_torch.utils.logger import logger


class FeatureCoalescer:
    """One device worker batching fixed-size feature-encode requests.

    ``batched_fn_factory(k)`` must return a function
    ``(k, window_samples) float32 numpy -> (k, ...) tensor`` (e.g. the
    batched Whisper encode). ``buckets`` are the batch sizes run; padding
    absorbs request counts in between.
    """

    def __init__(self, batched_fn_factory: Callable[[int], Callable],
                 window_samples: int,
                 buckets: Sequence[int] = (1, 2, 4, 8),
                 coalesce_window_s: float = 0.0):
        self.window_samples = int(window_samples)
        self.buckets = sorted(buckets)
        # session-alignment window (same contract as
        # BatchScheduler.coalesce_window_s): hold the first request up to
        # this long for the other active sessions; the adaptive target
        # means a lone session never waits
        self.coalesce_window_s = float(coalesce_window_s)
        self._launch_sizes: "deque[int]" = deque(maxlen=16)
        self._factory = batched_fn_factory
        self._fns: Dict[int, Callable] = {}  # built per bucket at first use
        self._queue: "Queue[Tuple[np.ndarray, Future]]" = Queue()
        self._quit = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.batches_run = 0
        self.requests_run = 0
        # a bucket's first call (cuDNN/cuFFT plan set-up) may be slow;
        # encode() extends its bound while one is in progress
        self.first_contact_timeout = 900.0
        self.post_compile_grace = 120.0
        self._warm: set = set()
        self._compiling = False
        self._compile_started = 0.0
        self._grace_deadline = 0.0

    def _in_grace(self, now: float) -> bool:
        if self._compiling and (now - self._compile_started
                                < self.first_contact_timeout):
            return True
        return now < self._grace_deadline

    def submit(self, wav: np.ndarray) -> Future:
        if wav.shape != (self.window_samples,):
            raise ValueError(f"feature coalescer: window {wav.shape}, want ({self.window_samples},)")
        if self._quit.is_set():
            raise RuntimeError("feature coalescer stopped")
        fut: Future = Future()
        self._queue.put((np.asarray(wav, np.float32), fut))
        return fut

    def encode(self, wav: np.ndarray, timeout: float = 120.0):
        """Bounded wait: a wedged device surfaces as an error in the
        session's feature thread instead of a silent hang; a bucket's
        first call extends the bound."""
        fut = self.submit(wav)
        deadline = time.monotonic() + timeout
        while True:
            try:
                return fut.result(timeout=2.0)
            except FutureTimeout:
                now = time.monotonic()
                if now < deadline or self._in_grace(now):
                    continue
                raise

    def start(self) -> None:
        if self._thread is not None:
            return
        from livetalking_tpu_torch.utils.lifecycle import register
        register(self)  # stop before interpreter teardown
        self._quit.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="feature-coalescer")
        self._thread.start()

    def stop(self) -> None:
        self._quit.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        # fail any request still queued so no session blocks forever
        while True:
            try:
                _w, f = self._queue.get_nowait()
            except Empty:
                break
            if not f.done():
                f.set_exception(RuntimeError("feature coalescer stopped"))

    def prewarm(self) -> threading.Thread:
        """Run every bucket's batched encode once in the background."""

        def warm():
            for b in self.buckets:
                try:
                    if b not in self._fns:
                        self._fns[b] = self._factory(b)
                    self._fns[b](np.zeros((b, self.window_samples), np.float32))
                    self._warm.add(b)
                except Exception:
                    logger.exception("feature coalescer prewarm(%d) failed", b)

        t = threading.Thread(target=warm, daemon=True,
                             name="feature-coalescer-warm")
        t.start()
        return t

    def _run(self) -> None:
        logger.info("feature coalescer start (buckets=%s)", self.buckets)
        while not self._quit.is_set():
            try:
                first = self._queue.get(timeout=0.5)
            except Empty:
                continue
            reqs = [first]
            maxb = self.buckets[-1]
            # alignment hold, only as long as recent rounds prove the
            # other sessions exist (adaptive target)
            target = min(max(self._launch_sizes, default=1), maxb)
            deadline = time.monotonic() + self.coalesce_window_s
            while len(reqs) < maxb and not self._quit.is_set():
                try:
                    reqs.append(self._queue.get_nowait())
                    continue
                except Empty:
                    pass
                if len(reqs) >= target:
                    break
                wait = deadline - time.monotonic()
                if wait <= 0:
                    break
                try:
                    reqs.append(self._queue.get(timeout=min(wait, 0.01)))
                except Empty:
                    pass
            self._launch_sizes.append(len(reqs))
            bucket = next(b for b in self.buckets if b >= len(reqs))
            cold = bucket not in self._warm
            if cold:
                self._compile_started = time.monotonic()
                self._compiling = True
            wavs = np.zeros((bucket, self.window_samples), np.float32)
            for i, (w, _f) in enumerate(reqs):
                wavs[i] = w
            try:
                if bucket not in self._fns:
                    self._fns[bucket] = self._factory(bucket)
                out = self._fns[bucket](wavs)
                self._warm.add(bucket)
                for i, (_w, f) in enumerate(reqs):
                    if not f.done():
                        f.set_result(out[i])  # a row of the device output
            except Exception as e:
                logger.exception("feature coalescer encode failed")
                for _w, f in reqs:
                    if not f.done():
                        f.set_exception(e)
            finally:
                if cold:
                    self._grace_deadline = time.monotonic() + self.post_compile_grace
                    self._compiling = False
            self.batches_run += 1
            self.requests_run += len(reqs)
        logger.info("feature coalescer stop (batches=%d requests=%d)",
                    self.batches_run, self.requests_run)
