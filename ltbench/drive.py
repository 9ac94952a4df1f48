"""Drive running sessions with a traffic mix and record what the viewers see.

One driver thread feeds speech into the sessions (``put_audio_frame``,
each chunk tagged ``{"ltb": serial}`` in its ``datainfo``, which the
pipeline carries to the egress audio queue), takes video frames from the
``queue`` transport and drains its audio queue. The compose thread pushes
each video frame before its two audio chunks, so the ``j``-th audio item
belongs to the ``j // 2``-th video frame; untagged items are the silence
the feature extractor makes when no speech is queued.

Per session it keeps: each video frame's take time, each audio item's
serial (-1 for silence), whether the frame's face box equals the idle
avatar frame's (a step that failed replays the idle frame), and a
reservoir sample, drawn from the seed, of the frames taken in the window.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ltbench.traffic import Speech, paced_schedule


def mirror_index(size: int, index: int) -> int:
    """Ping-pong index into a cycle of ``size`` frames."""
    if size <= 1:
        return 0
    turn, res = divmod(index, size)
    return res if turn % 2 == 0 else size - res - 1


@dataclasses.dataclass
class SessionLog:
    video_t: List[float] = dataclasses.field(default_factory=list)
    idle_face: List[bool] = dataclasses.field(default_factory=list)
    audio: List[int] = dataclasses.field(default_factory=list)
    kept: Dict[int, np.ndarray] = dataclasses.field(default_factory=dict)
    seen_in_window: int = 0
    put: int = 0


@dataclasses.dataclass
class Observed:
    logs: List[SessionLog]
    t0: float
    t1: float
    counters: Dict[str, dict]
    schedule: Optional[list] = None       # paced: per session, its utterances
    origin: float = 0.0                   # paced: the schedule's time origin
    ticks: Optional[list] = None          # paced: per session, (time, starved) of each tick
    tick_late_max_s: float = 0.0          # paced: the latest a viewer tick ran in the window
    ticks_skipped: int = 0                # paced: ticks dropped after a viewer stall
    trace: Optional[object] = None


class _Viewer:
    def __init__(self, served, avatars: List[dict], seed: int, keep: int):
        self.served = served
        self.outputs = [s.output for s in served.sessions]
        self.logs = [SessionLog() for _ in served.sessions]
        self.rngs = [np.random.default_rng([int(seed) % (2 ** 63), 7003, k])
                     for k in range(len(self.logs))]
        self.keep = keep
        x1, y1, x2, y2 = avatars[0]["coords"][0]
        self.box = (slice(y1, y2), slice(x1, x2))
        self.idle = [a["frames"] for a in avatars]
        self.window = (float("inf"), float("inf"))

    def take(self, k: int, frame: np.ndarray, t: float) -> None:
        log = self.logs[k]
        n = len(log.video_t)
        log.video_t.append(t)
        idle = self.idle[k][mirror_index(len(self.idle[k]), n)]
        log.idle_face.append(bool(np.array_equal(frame[self.box], idle[self.box])))
        if self.window[0] <= t < self.window[1]:
            log.seen_in_window += 1
            m = log.seen_in_window
            if len(log.kept) < self.keep:
                log.kept[n] = frame.copy()
            else:
                j = int(self.rngs[k].integers(0, m))
                if j < self.keep:
                    log.kept.pop(sorted(log.kept)[j])
                    log.kept[n] = frame.copy()

    def drain_audio(self) -> None:
        for out, log in zip(self.outputs, self.logs):
            while True:
                try:
                    _pcm, info = out.audio_queue.get_nowait()
                except queue.Empty:
                    break
                log.audio.append(int((info or {}).get("ltb", -1)))

    def settled(self, B: int, r: int) -> bool:
        """Every kept frame's encoder window has reached the viewer: batch
        ``j`` reads audio items up to ``2B(j + 1) + r``."""
        return all(len(log.audio) >= 2 * B * (max(log.kept) // B + 1) + r
                   for log in self.logs if log.kept)

    def poll(self, k: int) -> Optional[np.ndarray]:
        try:
            return self.outputs[k].video_queue.get_nowait()
        except queue.Empty:
            return None


def _put(session, speech: Speech, k: int, first: int, n: int) -> None:
    for serial in range(first, first + n):
        session.put_audio_frame(speech.chunk(k, serial), {"ltb": serial})


def run_free(served, mix: dict, avatars, seed: int, seconds: float, tracer=None,
             keep: int = 16, r: int = 10, tail_s: float = 30.0) -> Observed:
    """Closed loop: every session keeps ``queued_s`` of speech queued."""
    speech = Speech(seed)
    v = _Viewer(served, avatars, seed, keep)
    B = served.scheduler.batch_size
    if tracer is not None:  # its start holds this thread for seconds: before any frame
        tracer.start()
    served.start()
    target = int(mix["queued_s"] * 50) + 12 * B   # queued, plus what is in flight
    warm = int(mix["warm_batches"]) * B   # batches each session takes before the window
    counters: Dict[str, dict] = {}
    t0 = t1 = None
    last_feed = 0.0
    while True:
        now = time.perf_counter()
        if now - last_feed > 0.05 and (t1 is None or now < t1):
            for k, (s, log) in enumerate(zip(served.sessions, v.logs)):
                short = target - (log.put - len(log.audio))
                if short > 0:
                    _put(s, speech, k, log.put, short)
                    log.put += short
            last_feed = now
        got = False
        for k in range(len(v.logs)):
            f = v.poll(k)
            if f is not None:
                v.take(k, f, time.perf_counter())
                got = True
        v.drain_audio()
        now = time.perf_counter()
        if t0 is None and min(len(log.video_t) for log in v.logs) >= warm:
            t0 = time.perf_counter()
            t1 = t0 + seconds
            v.window = (t0, t1)
            counters["start"] = served.counters()
            if tracer is not None:
                tracer.mark()
        if t1 is not None and now >= t1 and "end" not in counters:
            counters["end"] = served.counters()
            if tracer is not None:  # its stop holds this thread: after the window
                tracer.mark()
                tracer.stop()
        if t1 is not None and now >= t1 and (v.settled(B, r) or now >= t1 + tail_s):
            break
        if not got:
            time.sleep(0.001)
    return Observed(v.logs, t0, t1, counters)


def run_paced(served, mix: dict, avatars, seed: int, seconds: float, tracer=None,
              keep: int = 16, r: int = 10, tail_s: float = 30.0) -> Observed:
    """Open loop at real-time pace, one frame per tick per viewer; a viewer
    that falls a tick or more behind drops the ticks it missed."""
    speech = Speech(seed)
    v = _Viewer(served, avatars, seed, keep)
    n = len(v.logs)
    lead = float(mix["lead_s"])
    sched = paced_schedule(mix, seed, n, lead + seconds + tail_s)
    B = served.scheduler.batch_size
    period = 1.0 / float(mix["fps"])
    if tracer is not None:
        tracer.start()
    served.start()
    origin = time.perf_counter() + 0.5
    t0, t1 = origin + lead, origin + lead + seconds
    v.window = (t0, t1)
    nxt = [0] * n
    ticks: List[list] = [[] for _ in range(n)]
    counters: Dict[str, dict] = {}
    late, skipped = 0.0, 0
    tick = 0
    while True:
        due = origin + tick * period
        now = time.perf_counter()
        if now < due:
            time.sleep(due - now)
            now = time.perf_counter()
        elif now - due >= period:
            # a stalled viewer drops the ticks it missed, as a player does,
            # rather than running them back to back faster than real time
            missed = int((now - due) / period)
            tick += missed
            if t0 <= now < t1:
                skipped += missed
            due = origin + tick * period
        if t0 <= now < t1:
            late = max(late, now - due)
        for k, s in enumerate(served.sessions):
            while nxt[k] < len(sched[k]) and origin + sched[k][nxt[k]].start_s <= now:
                u = sched[k][nxt[k]]
                _put(s, speech, k, u.first, u.n)
                nxt[k] += 1
        for k in range(n):
            f = v.poll(k)
            t = time.perf_counter()
            if f is not None:
                v.take(k, f, t)
            ticks[k].append((t, f is None))
        v.drain_audio()
        if "start" not in counters and now >= t0:
            counters["start"] = served.counters()
            if tracer is not None:
                tracer.mark()
        if "end" not in counters and now >= t1:
            counters["end"] = served.counters()
            if tracer is not None:
                tracer.mark()
                tracer.stop()
        if now >= t1 and (v.settled(B, r) or now >= t1 + tail_s):
            break
        tick += 1
    return Observed(v.logs, t0, t1, counters, schedule=sched, origin=origin, ticks=ticks,
                    tick_late_max_s=late, ticks_skipped=skipped)


def tally(obs: Observed) -> tuple:
    """(attempted, failed): frames taken in the window whose two audio
    items carry speech, and those of them whose face box is the idle
    avatar's (a step that failed replays the idle frame)."""
    attempted = failed = 0
    for log in obs.logs:
        for n, t in enumerate(log.video_t):
            if obs.t0 <= t < obs.t1 and 2 * n + 1 < len(log.audio) and \
                    max(log.audio[2 * n], log.audio[2 * n + 1]) >= 0:
                attempted += 1
                failed += log.idle_face[n]
    return attempted, failed


DRIVERS: Dict[str, Callable] = {"free": run_free, "paced": run_paced}
