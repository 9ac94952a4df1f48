"""Cross-session device batching (ports livetalking_tpu/engine/scheduler.py).

All sessions of a model family share ONE device worker:

  - ``AvatarStore`` packs every loaded avatar's face-crop cycle into a
    single device-resident uint8 tensor; a session's frame index becomes
    ``store offset + mirror index``, so any mix of sessions/avatars is one
    gather. Auxiliary planes (the paste-back's full frames and boxes) are
    packed with the same offsets;
  - ``BatchScheduler`` drains the queued per-session requests, concatenates
    their indices and feature windows, pads to a bucketed super-batch size,
    runs ONE device step, and scatters the resulting frames back to
    per-session futures.
  - ``SpmdLeader`` / ``serve_follower`` run that step on every rank of a
    device mesh: rank 0 schedules and sends each super-batch to the others.

The dispatch thread queues each batch's device->host copy on a side
stream, behind an event recorded after the step, into a ring of pinned host
buffers, so the copy starts the moment the step ends; a fetch thread waits
on the copy's event, copies the frames out of the slot, returns the slot
to the ring and resolves the futures. At most two batches are in flight,
so the ring holds at most two slots per shape, and a slot is never
overwritten before its fetch is done.

Spans (``utils/spans.py``, while a profiler runs), on the scheduler's clock:
``sched.hold`` per request, from ``submit`` to its super-batch's launch;
``sched.dispatch``, the launch itself; ``sched.to_host`` per super-batch,
from the launch to its frames on the host, ending on the reading that
stamps ``latency_s``, so a request's hold and its batch's ``to_host`` add
up to its ``latency_s`` entry.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from queue import Empty, Queue
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from livetalking_tpu_torch.utils import spans
from livetalking_tpu_torch.utils.logger import logger

MAX_IN_FLIGHT = 2
# with no idle window, after a batch resolves, partial batches wait for its
# sessions to submit again for at most this share of the batch's
# launch-to-resolve time
ALIGN_GRACE = 0.25


class SchedulerConfigError(ValueError):
    """A session requested scheduler flags conflicting with the running
    process-wide scheduler (per-session overrides under --coalesce)."""


class AvatarStore:
    """Packs per-avatar cycle data into one device-resident tensor.

    Item shape/dtype is fixed by the store: wav2lip packs (S, S, 3) uint8
    face crops."""

    def __init__(self, img_size: int = 256, device="cuda", item_shape=None,
                 dtype=np.uint8):
        self.item_shape = tuple(item_shape) if item_shape else (img_size, img_size, 3)
        self.dtype = np.dtype(dtype)
        self.device = torch.device(device)
        self._cycles: Dict[str, Tuple[int, int]] = {}  # id -> (offset, length)
        self._total = 0
        self._device_buffer: Optional[torch.Tensor] = None
        # auxiliary per-item device planes, indexed by the SAME global
        # index as the main cycle (e.g. the paste-back's full frames/boxes)
        self._aux_dev: Dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()

    def add(self, avatar_id: str, cycle: np.ndarray,
            aux: Optional[Dict[str, np.ndarray]] = None) -> Tuple[int, int]:
        """Register an (N, *item_shape) cycle; returns (offset, length).

        ``aux`` maps plane name -> (N, ...) array packed alongside the
        cycle (same offsets, so one global index gathers all planes).
        Every add after the first must supply the same plane set with the
        same trailing shapes. Only the new cycle crosses to the device: the
        packed tensors are extended there, as new tensors, so a step still
        running keeps reading the ones it was given."""
        with self._lock:
            if avatar_id in self._cycles:
                return self._cycles[avatar_id]
            if cycle.dtype != self.dtype or cycle.shape[1:] != self.item_shape:
                raise ValueError(f"cycle {cycle.dtype}{cycle.shape} does not match the "
                                 f"store's {self.dtype}{self.item_shape}")
            aux = {k: np.ascontiguousarray(v) for k, v in (aux or {}).items()}
            if self._total and set(aux) != set(self._aux_dev):
                raise ValueError(
                    f"store aux planes {sorted(aux)} do not match the "
                    f"registered set {sorted(self._aux_dev)}")
            for k, v in aux.items():
                if v.shape[0] != cycle.shape[0]:
                    raise ValueError(
                        f"aux plane {k!r} length {v.shape[0]} != cycle "
                        f"length {cycle.shape[0]}")
                prev = self._aux_dev.get(k)
                if prev is not None and tuple(prev.shape[1:]) != v.shape[1:]:
                    raise ValueError(
                        f"aux plane {k!r} item shape {v.shape[1:]} != "
                        f"registered {tuple(prev.shape[1:])}")
            offset = self._total
            self._total += cycle.shape[0]
            self._cycles[avatar_id] = (offset, cycle.shape[0])
            self._device_buffer = self._extend(self._device_buffer, cycle)
            # a new dict, swapped in whole: a step running meanwhile reads
            # ``aux`` without the lock and must see planes of one length
            self._aux_dev = {k: self._extend(self._aux_dev.get(k), v) for k, v in aux.items()}
            return offset, cycle.shape[0]

    def _extend(self, packed: Optional[torch.Tensor], part: np.ndarray) -> torch.Tensor:
        new = torch.from_numpy(np.ascontiguousarray(part)).to(self.device)
        return new if packed is None else torch.cat([packed, new])

    def lookup(self, avatar_id: str) -> Tuple[int, int]:
        return self._cycles[avatar_id]

    @property
    def buffer(self) -> Optional[torch.Tensor]:
        return self._device_buffer

    @property
    def aux(self) -> Dict[str, torch.Tensor]:
        """Device-resident aux planes (same global indexing as buffer); each
        ``add`` replaces the dict, so one read gives planes of one length."""
        return self._aux_dev


class _Request:
    __slots__ = ("idxs", "mel", "future", "t_submit", "rid")

    def __init__(self, idxs: np.ndarray, mel, future: Future, t_submit: float, rid=None):
        self.idxs = idxs
        self.mel = mel
        self.future = future
        self.t_submit = t_submit
        self.rid = rid  # the session batch's request id (spans)


def _ns(t: float) -> int:
    """A reading of the scheduler's clock in the spans' nanoseconds."""
    return round(t * 1e9)


class _HostRing:
    """Pinned host buffers for the device->host copies, per output shape.

    A slot goes back to the ring only after its frames were copied out, so
    no batch overwrites one still being fetched. At most ``MAX_IN_FLIGHT``
    batches are in flight, so the ring holds at most that many slots per
    shape."""

    def __init__(self):
        self._free: Dict[tuple, List[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def acquire(self, like: torch.Tensor) -> torch.Tensor:
        with self._lock:
            free = self._free.setdefault((tuple(like.shape), like.dtype), [])
            if free:
                return free.pop()
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)

    def release(self, slot: torch.Tensor) -> None:
        with self._lock:
            self._free[(tuple(slot.shape), slot.dtype)].append(slot)


class _InFlight:
    """One launched super-batch: its device output, and (on CUDA) the ring
    slot and the event that marks the device->host copy done."""

    __slots__ = ("out", "ring", "host", "copied")

    def __init__(self, out: torch.Tensor, ring: Optional[_HostRing] = None,
                 host: Optional[torch.Tensor] = None, copied=None):
        self.out = out
        self.ring = ring
        self.host = host
        self.copied = copied

    def frames(self) -> np.ndarray:
        if self.copied is None:  # CPU output: a fresh tensor per batch
            return self.out.numpy()
        try:
            self.copied.synchronize()
            # sessions keep frames long after the batch (queues,
            # transports): copy them out so the slot can go back
            return self.host.numpy().copy()
        finally:
            self.ring.release(self.host)


class BatchScheduler:
    """One device worker coalescing per-session inference requests.

    ``step_factory(total_batch)`` must return a
    ``(model, buffer, idxs(total,), mel(total, ...)) -> frames(total, ...)``
    function (e.g. models/wav2lip.py ``make_infer_fn``). ``buckets`` are
    the session-count bucket sizes (padding absorbs fluctuating session
    counts). ``clock`` stamps requests and times the alignment window; the
    spans read it too, so it runs in ``time.perf_counter``'s seconds.
    """

    def __init__(
        self,
        model,
        store: AvatarStore,
        step_factory: Callable[[int], Callable],
        batch_size: int,
        buckets: Sequence[int] = (1, 2, 4, 8),
        coalesce_window_s: float = 0.0,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.model = model
        self.store = store
        self.batch_size = batch_size
        self.buckets = sorted(buckets)
        # idle-device alignment window (seconds): while the device is
        # IDLE and the held set is partial, wait up to this long after
        # the oldest held request for more sessions to land on the same
        # super-batch. Hold-while-busy (below) aligns sessions only when
        # the device is saturated; a real-time-paced deployment idles
        # between rounds and needs this window. 0 = no idle window: a
        # partial batch waits only for the sessions of the batch that just
        # resolved (``_run``), at most ALIGN_GRACE of a round
        self.coalesce_window_s = float(coalesce_window_s)
        self._clock = clock
        # adaptive alignment target: rolling max of recently launched
        # coalesced sizes — a lone session never waits out the window
        self._launch_sizes: "deque[int]" = deque(maxlen=16)
        self._steps = {k: step_factory(k * batch_size) for k in self.buckets}
        self._queue: "Queue[_Request]" = Queue()
        self._quit = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ring = _HostRing()
        self._copy_stream = None
        # observability counters
        self.requests_submitted = 0
        self._submit_lock = threading.Lock()
        self.requests_run = 0
        self.batches_run = 0
        self.frames_run = 0
        # per-request submit->resolve time and per-batch coalesced size,
        # bounded rolling windows (admin metrics)
        self.latency_s: "deque[float]" = deque(maxlen=4096)
        self.batch_sizes: "deque[int]" = deque(maxlen=4096)
        # buckets whose step has run once (cuDNN setup happens on a
        # shape's first call); prewarm runs each cold bucket once
        self._warm_buckets: set = set()
        self._prewarm_lock = threading.Lock()
        self._spawn_lock = threading.Lock()  # guards _prewarm_threads only
        self._prewarm_threads: List[threading.Thread] = []

    # -- session API ------------------------------------------------------
    def submit(self, global_idxs: np.ndarray, mel, rid=None) -> Future:
        """Queue one session batch (B indices into the store + features,
        ``rid`` its request id); returns a Future resolving to (B, ...) uint8
        frames. While spans record, the future's ``host_ns`` is the instant
        the frames reached the host."""
        if self._quit.is_set():
            raise RuntimeError("batch scheduler stopped")
        fut: Future = Future()
        with self._submit_lock:
            self.requests_submitted += 1
        self._queue.put(_Request(np.asarray(global_idxs, np.int32), mel, fut,
                                 self._clock(), rid))
        return fut

    def wait(self, fut: Future, timeout: float = 120.0) -> np.ndarray:
        """Bounded wait on a submitted request: a wedged device surfaces as
        an error in the session's inference thread, not a silent hang."""
        return fut.result(timeout=timeout)

    def infer(self, global_idxs: np.ndarray, mel,
              timeout: float = 120.0) -> np.ndarray:
        """submit + bounded wait (synchronous convenience)."""
        return self.wait(self.submit(global_idxs, mel), timeout)

    def prewarm(self, feature_shape: Tuple[int, ...]) -> None:
        """Run every cold bucket's step once on zero inputs (``feature_shape``
        = one request's per-frame feature shape, (80, 16) for wav2lip mel),
        so no bucket's first call lands inside a live utterance."""
        B = self.batch_size
        with self._prewarm_lock:
            for b in self.buckets:
                if self._quit.is_set():
                    break
                if b in self._warm_buckets:
                    continue
                buffer = self.store.buffer
                idxs = torch.zeros((b * B,), dtype=torch.int32, device=buffer.device)
                feats = torch.zeros((b * B,) + tuple(feature_shape), device=buffer.device)
                self._steps[b](self.model, buffer, idxs, feats)
                if buffer.is_cuda:
                    torch.cuda.synchronize(buffer.device)
                self._warm_buckets.add(b)
                logger.info("scheduler prewarm: bucket %d ready", b)

    def prewarm_async(self, feature_shape: Tuple[int, ...]) -> threading.Thread:
        """Background ``prewarm``, kicked by a session right after its avatar
        registers in the store."""
        with self._spawn_lock:
            self._prewarm_threads = [
                t for t in self._prewarm_threads if t.is_alive()]
            if self._prewarm_threads:
                return self._prewarm_threads[-1]
            t = threading.Thread(target=self._prewarm_quiet,
                                 args=(tuple(feature_shape),),
                                 daemon=True, name="scheduler-prewarm")
            self._prewarm_threads.append(t)
        t.start()
        return t

    def _prewarm_quiet(self, feature_shape) -> None:
        try:
            self.prewarm(feature_shape)
        except Exception:
            # best-effort: a cold bucket just runs its first call live
            logger.exception("scheduler prewarm failed")

    # -- worker -----------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        from livetalking_tpu_torch.utils.lifecycle import register
        register(self)  # stop before interpreter teardown
        self._quit.clear()
        self._thread = threading.Thread(target=self._run, daemon=True, name="batch-scheduler")
        self._thread.start()

    def stop(self) -> None:
        self._quit.set()
        with self._spawn_lock:
            pthreads, self._prewarm_threads = self._prewarm_threads, []
        for t in pthreads:
            t.join(timeout=130)
        if self._thread is not None:
            # the worker fails still-held requests (it never launches new
            # device work on quit) and drains the in-flight batches
            self._thread.join(timeout=130)
            self._thread = None
        # fail any request still queued so no session blocks forever
        while True:
            try:
                r = self._queue.get_nowait()
            except Empty:
                break
            if not r.future.done():
                r.future.set_exception(RuntimeError("batch scheduler stopped"))

    def _drain(self, timeout: float = 0.5) -> List[_Request]:
        """Block for the first request, then greedily take whatever else is
        already queued."""
        try:
            first = self._queue.get(timeout=timeout)
        except Empty:
            return []
        reqs = [first]
        max_sessions = self.buckets[-1]
        while len(reqs) < max_sessions:
            try:
                reqs.append(self._queue.get_nowait())
            except Empty:
                break
        return reqs

    def _dispatch(self, reqs: List[_Request]) -> _InFlight:
        """Launch one padded super-batch without waiting for the device,
        and queue its device->host copy behind it on the copy stream."""
        k = len(reqs)
        bucket = next(b for b in self.buckets if b >= k)
        B = self.batch_size
        buffer = self.store.buffer
        dev = buffer.device

        idxs = np.zeros(bucket * B, np.int32)
        mels = []
        for i, r in enumerate(reqs):
            idxs[i * B : (i + 1) * B] = r.idxs
            mels.append(torch.as_tensor(r.mel, device=dev))  # no copy if already there
        pad = bucket - k
        if pad:
            mels.append(torch.zeros((pad * B,) + tuple(mels[0].shape[1:]), device=dev))
        mel = torch.cat(mels, dim=0).float()
        out = self._steps[bucket](self.model, buffer,
                                  torch.from_numpy(idxs).to(dev), mel)
        self._warm_buckets.add(bucket)
        if not out.is_cuda:
            return _InFlight(out)
        step_done = torch.cuda.Event()
        step_done.record()
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(dev)
        host = self._ring.acquire(out)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(step_done)
            host.copy_(out, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        return _InFlight(out, self._ring, host, copied)

    def _resolve(self, batch: _InFlight, reqs: List[_Request], t_launch: float) -> None:
        """Wait for the batch's frames on the host and scatter them to the
        per-session futures."""
        B = self.batch_size
        frames = batch.frames()
        now = self._clock()
        host_ns = _ns(now) if spans.on() else None
        if host_ns is not None:
            spans.record("sched.to_host", _ns(t_launch), host_ns,
                         tuple(r.rid for r in reqs), len(reqs))
        for i, r in enumerate(reqs):
            r.future.host_ns = host_ns
            r.future.set_result(frames[i * B : (i + 1) * B])
            self.latency_s.append(now - r.t_submit)
        self.batch_sizes.append(len(reqs))
        self.requests_run += len(reqs)
        self.batches_run += 1
        self.frames_run += len(reqs) * B

    def _try_dispatch(self, reqs: List[_Request]):
        try:
            return (self._dispatch(reqs), reqs)
        except Exception as e:
            logger.exception("batch scheduler dispatch failed")
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return None

    def _try_resolve(self, batch: _InFlight, reqs: List[_Request], t_launch: float) -> None:
        try:
            self._resolve(batch, reqs, t_launch)
        except Exception as e:
            logger.exception("batch scheduler resolve failed")
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)

    def _run(self) -> None:
        """Pipelined loop with coalescing hold.

        A dedicated fetch thread waits for each batch's frames on the host
        and resolves its futures, so the dispatch thread never blocks on
        the device; the copy of batch N overlaps the compute of batch N+1.

        While any super-batch is in flight, newly arriving requests are
        HELD unless they already fill the largest bucket: the in-flight
        step's duration is the natural cross-session alignment window.
        Dispatch-on-arrival locks free-running sessions into small
        staggered super-batches that never re-merge. A full bucket still
        dispatches immediately, two deep.

        With no idle window (``coalesce_window_s == 0``) the round does not
        end when the last batch resolves: its sessions have yet to submit
        again. So the hold lasts until as many requests arrived as that
        batch resolved, or ``ALIGN_GRACE`` of the batch's launch-to-resolve
        time passed (a session that stopped costs at most that). With an
        idle window, that window does this work instead."""
        logger.info("batch scheduler start (buckets=%s, B=%d)", self.buckets, self.batch_size)
        maxb = self.buckets[-1]
        held: List[_Request] = []
        # returning: requests of resolved batches not yet matched by an
        # arrival, the sessions expected back within the grace (no window)
        grace = self.coalesce_window_s == 0
        state = {"in_flight": 0, "returning": 0, "resolved_at": 0.0, "round_s": 0.0}
        lock = threading.Lock()
        fetchq: "Queue[Optional[Tuple[_InFlight, List[_Request], float]]]" = Queue()

        def fetcher() -> None:
            while True:
                item = fetchq.get()
                if item is None:
                    return
                batch, reqs, t_launch = item
                self._try_resolve(batch, reqs, t_launch)
                now = self._clock()
                with lock:
                    state["in_flight"] -= 1
                    if grace:
                        state["returning"] += len(reqs)
                    state["resolved_at"] = now
                    state["round_s"] = now - t_launch

        fthread = threading.Thread(target=fetcher, daemon=True,
                                   name="batch-scheduler-fetch")
        fthread.start()

        def launch(batch: List[_Request]) -> None:
            self._launch_sizes.append(len(batch))
            t_launch = self._clock()
            out = self._try_dispatch(batch)
            if spans.on():
                sent_ns, launch_ns = _ns(self._clock()), _ns(t_launch)
                spans.record("sched.dispatch", launch_ns, sent_ns,
                             tuple(r.rid for r in batch), len(batch))
                for r in batch:
                    spans.record("sched.hold", _ns(r.t_submit), launch_ns, r.rid)
            if out is not None:
                with lock:
                    state["in_flight"] += 1
                fetchq.put(out + (t_launch,))

        while not self._quit.is_set():
            new = self._drain(timeout=0.002 if (held or state["in_flight"]) else 0.5)
            held.extend(new)
            if not held:
                continue
            with lock:
                busy = state["in_flight"]
                state["returning"] = max(0, state["returning"] - len(new))
                if (state["returning"] and self._clock() - state["resolved_at"]
                        >= ALIGN_GRACE * state["round_s"]):
                    state["returning"] = 0  # those sessions stopped or slowed
                returning = state["returning"]
            if len(held) >= maxb and busy < MAX_IN_FLIGHT:
                batch, held = held[:maxb], held[maxb:]
                launch(batch)
            elif busy == 0 and not returning:
                # idle device, partial bucket: hold up to the alignment
                # window for the other active sessions — but dispatch as
                # soon as the held set matches what recent rounds prove
                # is actually out there (a lone session never waits)
                target = max(self._launch_sizes, default=1)
                if (len(held) >= min(target, maxb)
                        or (self._clock() - held[0].t_submit
                            >= self.coalesce_window_s)):
                    batch, held = held[:maxb], held[maxb:]
                    launch(batch)
        # shutdown: never launch NEW device work on quit — fail held
        # requests instead; sessions degrade those batches to idle frames
        for r in held:
            if not r.future.done():
                r.future.set_exception(RuntimeError("batch scheduler stopped"))
        fetchq.put(None)
        fthread.join(timeout=120)
        logger.info("batch scheduler stop (batches=%d requests=%d frames=%d)",
                    self.batches_run, self.requests_run, self.frames_run)


# -- a step that runs on every rank of a mesh ---------------------------------

_RUN, _STOP = 1, 2
_HEADER = 8  # cmd, total, new buffer?, buffer rows, feature ndim, <= 3 feature dims


class SpmdLeader:
    """Rank 0's side of a scheduler whose step runs on every rank of a mesh
    (``models/musetalk.py::make_sharded_infer_fn``).

    The scheduler's batches depend on timing, so only rank 0 runs it; the
    other ranks must run the same batches in the same order, or the first
    collective of two different ones deadlocks. So before each super-batch
    rank 0 sends them its size,
    indices and features, and the store's buffer whenever it is another
    tensor than the one last sent (``AvatarStore.add`` swaps in a new
    one); ``serve_follower`` runs those steps. The aux planes stay on rank
    0: the paste-back runs there, after the step gathers the faces.

    ``wrap(step_factory)`` is the factory to give ``BatchScheduler``;
    ``stop()`` ends the followers' loops (after the scheduler stopped)."""

    def __init__(self, mesh):
        self.mesh = mesh
        # prewarm and dispatch call steps from two threads: one batch's
        # messages and collectives at a time
        self._lock = threading.Lock()
        self._sent: Optional[torch.Tensor] = None

    def _header(self, cmd: int, total: int = 0, buffer=None, feats=None) -> None:
        h = torch.zeros(_HEADER, dtype=torch.int64)
        h[0], h[1] = cmd, total
        if buffer is not None:
            h[2], h[3] = 1, buffer.shape[0]
        if feats is not None:
            dims = feats.shape[1:]
            h[4] = len(dims)
            h[5:5 + len(dims)] = torch.tensor(dims)
        self.mesh.broadcast_(h.to(self.mesh.device))

    def wrap(self, step_factory: Callable[[int], Callable]) -> Callable[[int], Callable]:
        def factory(total: int):
            step = step_factory(total)

            def lead(model, buffer, idxs, feats):
                with self._lock:
                    new = buffer if buffer is not self._sent else None
                    self._header(_RUN, total, new, feats)
                    if new is not None:
                        self.mesh.broadcast_(buffer)
                        self._sent = buffer
                    idxs = self.mesh.broadcast_(idxs.to(torch.int32))
                    feats = self.mesh.broadcast_(feats.float())
                    return step(model, buffer, idxs, feats)
            return lead
        return factory

    def stop(self) -> None:
        with self._lock:
            self._header(_STOP)


def serve_follower(mesh, model, step_factory: Callable[[int], Callable],
                   item_shape: Sequence[int], dtype: torch.dtype) -> int:
    """The other ranks' side of ``SpmdLeader``: run every super-batch rank 0
    announces, on this rank's copy of the store's buffer (``item_shape``,
    ``dtype``), until it sends stop. Returns the number of batches run."""
    dev = mesh.device
    steps: Dict[int, Callable] = {}
    buffer = None
    n = 0
    while True:
        h = mesh.broadcast_(torch.zeros(_HEADER, dtype=torch.int64, device=dev)).tolist()
        if h[0] == _STOP:
            return n
        total = h[1]
        if h[2]:
            buffer = mesh.broadcast_(torch.empty((h[3],) + tuple(item_shape), dtype=dtype,
                                                 device=dev))
        idxs = mesh.broadcast_(torch.empty(total, dtype=torch.int32, device=dev))
        feats = mesh.broadcast_(torch.empty((total,) + tuple(h[5:5 + h[4]]),
                                            dtype=torch.float32, device=dev))
        if total not in steps:
            steps[total] = step_factory(total)
        steps[total](model, buffer, idxs, feats)
        n += 1

def parse_buckets(opt) -> tuple:
    """--coalesce_buckets spec ('1,2,4,8') -> sorted int tuple."""
    spec = str(getattr(opt, "coalesce_buckets", "") or "1,2,4,8")
    return tuple(int(v) for v in spec.split(",") if v.strip())


def resolve_coalesce_window(opt, batch_size: int) -> float:
    """--coalesce_window_ms -> seconds. Auto (-1) = one request period
    (batch_size / fps): the longest any paced session can lag the others
    within a round, so one window always gathers every active session
    while bounding the added latency to at most one request period."""
    ms = float(getattr(opt, "coalesce_window_ms", -1.0))
    if ms < 0:
        return batch_size / float(getattr(opt, "fps", 25) or 25)
    return ms / 1000.0
