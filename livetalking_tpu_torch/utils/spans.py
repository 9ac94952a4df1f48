"""Host spans at the serving path's layer boundaries, on the device trace's clock.

A span is ``(name, start_ns, end_ns, tid, parent, rid, n)``: two instants of
``time.perf_counter_ns()``, the native id of the thread it began on, the
span open around it on that thread when it began (0: none), the request id
it belongs to (a session batch's, or a tuple of them for a super-batch) and
one optional count (rows, requests). Spans go into a bounded ring; the
module also keeps named counters that only grow.

Recording is on exactly while a ``torch.profiler`` session is active in the
process: ``torch.autograd.profiler._is_profiler_enabled``, the profiler's
process-wide flag, which every thread reads (``_profiler_enabled()`` reads
the state of the calling thread only, and the serving threads never started
the profiler). That covers ``--profile_dir`` and any profiler a benchmark
runs. Off, a boundary costs that one check and stores nothing.

Three ways to record:

  - ``with span(name, rid, n):`` on one thread; parents come from the
    thread's stack of open spans, and ``note(n)`` sets the innermost one's
    count;
  - ``token = begin(name, rid)`` ... ``end(token)`` for a span that ends on
    another thread (a queue's put to its get);
  - ``record(name, start_ns, end_ns, rid, n)`` for a span whose instants
    were read elsewhere (the scheduler's clock).

``snapshot()`` returns the spans, the counters and ``to_trace``, which maps
an instant of this clock onto the time base of the events ``torch.profiler``
returns (``time.time_ns()``'s): piecewise linear between anchor pairs read
back to back by this module, one when it is imported, one a second while
spans are stored and one per snapshot. No kernel is launched for it.
``add_to_chrome_trace(path)`` writes the spans into a Chrome trace that
``torch.profiler`` exported, on their threads and in its time base.
"""

from __future__ import annotations

import bisect
import itertools
import json
import os
import re
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

RING = 1 << 17          # spans kept: ~300 s of eight free-running MuseTalk sessions
ANCHOR_EVERY_NS = 1_000_000_000
now = time.perf_counter_ns


def on() -> bool:
    """Whether a ``torch.profiler`` session is active in the process."""
    return _profiler._is_profiler_enabled


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    tid: int
    parent: int          # id of the span open around it when it began, 0 for none
    rid: object          # request id, a tuple of them, or None
    n: Optional[int]
    id: int
    nested: bool         # by span(): it began and ended on ``tid``, inside ``parent``


class Snapshot(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]
    to_trace: Callable[[int], int]
    threads: Dict[int, str]


class _Off:
    """What ``span()`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, val, tb):
        return False


_OFF = _Off()


class _Open:
    """An open span: a context manager (``span()``) or a token (``begin()``)."""

    __slots__ = ("rec", "name", "start_ns", "tid", "parent", "rid", "n", "id", "stack")

    def __init__(self, rec, name, start_ns, tid, parent, rid, n, stack):
        self.rec, self.name, self.start_ns = rec, name, start_ns
        self.tid, self.parent, self.rid, self.n = tid, parent, rid, n
        self.id = next(rec._ids)
        self.stack = stack

    def __enter__(self):
        self.stack.append(self)
        return self

    def __exit__(self, typ, val, tb):
        t = now()
        stack = self.stack
        if stack and stack[-1] is self:
            stack.pop()
        self.rec._store(Span(self.name, self.start_ns, t, self.tid, self.parent, self.rid,
                             self.n, self.id, True))
        return False


class Clock:
    """perf_counter_ns -> the profiler's time base, from anchor pairs."""

    def __init__(self, anchors):
        self._p = [p for p, _w in anchors]
        self._off = [w - p for p, w in anchors]

    def __call__(self, perf_ns: int) -> int:
        p, off = self._p, self._off
        i = bisect.bisect_right(p, perf_ns)
        if i == 0:
            return perf_ns + off[0]
        if i == len(p):
            return perf_ns + off[-1]
        f = (perf_ns - p[i - 1]) / (p[i] - p[i - 1])
        return perf_ns + int(round(off[i - 1] + f * (off[i] - off[i - 1])))


class Recorder:
    """The ring, the counters and the clock anchors of one process."""

    def __init__(self, size: int = RING):
        self._ring: "deque[Span]" = deque(maxlen=size)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._threads: Dict[int, str] = {}
        self._anchors: "deque[tuple]" = deque(maxlen=8192)
        self._next_anchor = 0
        self.anchor()

    # -- clock --------------------------------------------------------------
    def anchor(self) -> None:
        """One (perf_counter_ns, time_ns) pair: of three reads back to back,
        the one whose two perf_counter reads lie closest together."""
        best = None
        for _ in range(3):
            p0 = now()
            w = time.time_ns()
            p1 = now()
            if best is None or p1 - p0 < best[0]:
                best = (p1 - p0, (p0 + p1) // 2, w)
        with self._lock:
            if not self._anchors or best[1] > self._anchors[-1][0]:
                self._anchors.append((best[1], best[2]))
            self._next_anchor = best[1] + ANCHOR_EVERY_NS

    # -- recording ----------------------------------------------------------
    def _thread(self):
        """(native thread id, stack of open spans) of the calling thread."""
        loc = self._local
        try:
            return loc.tid, loc.stack
        except AttributeError:
            loc.tid, loc.stack = threading.get_native_id(), []
            with self._lock:
                self._threads[loc.tid] = threading.current_thread().name
            return loc.tid, loc.stack

    def _store(self, s: Span) -> None:
        if not _profiler._is_profiler_enabled:
            return
        self._ring.append(s)
        if s.end_ns >= self._next_anchor:
            self.anchor()

    def span(self, name: str, rid=None, n: Optional[int] = None):
        """A context manager around work on this thread."""
        if not _profiler._is_profiler_enabled:
            return _OFF
        tid, stack = self._thread()
        return _Open(self, name, now(), tid, stack[-1].id if stack else 0, rid, n, stack)

    def begin(self, name: str, rid=None, n: Optional[int] = None) -> Optional[_Open]:
        """Open a span that ``end(token)`` closes, on any thread; None while off."""
        if not _profiler._is_profiler_enabled:
            return None
        tid, stack = self._thread()
        return _Open(self, name, now(), tid, stack[-1].id if stack else 0, rid, n, None)

    def end(self, token: Optional[_Open]) -> None:
        if token is not None:
            self._store(Span(token.name, token.start_ns, now(), token.tid, token.parent,
                             token.rid, token.n, token.id, False))

    def record(self, name: str, start_ns: int, end_ns: int, rid=None,
               n: Optional[int] = None) -> None:
        """A span whose instants (of this clock) were read by the caller."""
        if not _profiler._is_profiler_enabled:
            return
        tid, stack = self._thread()
        self._store(Span(name, int(start_ns), int(end_ns), tid, stack[-1].id if stack else 0,
                         rid, n, next(self._ids), False))

    def note(self, n: int) -> None:
        """Set the count of the innermost span open on this thread."""
        if not _profiler._is_profiler_enabled:
            return
        _tid, stack = self._thread()
        if stack:
            stack[-1].n = n

    def count(self, name: str, k: int = 1) -> None:
        """Add ``k`` to the counter ``name`` (while recording)."""
        if not _profiler._is_profiler_enabled:
            return
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + k

    # -- reading ------------------------------------------------------------
    def snapshot(self) -> Snapshot:
        self.anchor()
        with self._lock:
            counters = dict(self._counters)
            threads = dict(self._threads)
            anchors = list(self._anchors)
        return Snapshot(list(self._ring), counters, Clock(anchors), threads)

    def clear(self) -> None:
        """Drop every span and counter (the anchors stay)."""
        with self._lock:
            self._ring.clear()
            self._counters.clear()


RECORDER = Recorder()
span = RECORDER.span
begin = RECORDER.begin
end = RECORDER.end
record = RECORDER.record
note = RECORDER.note
count = RECORDER.count
snapshot = RECORDER.snapshot
clear = RECORDER.clear

_sessions = itertools.count(1)


def request_ids() -> Iterator[int]:
    """One session's request ids, unique in the process: the session's
    serial in the high 32 bits, the batch's serial in the low 32."""
    base = next(_sessions) << 32
    return (base | k for k in itertools.count())


def chrome_events(snap: Snapshot, base_ns: int, pid: int) -> List[dict]:
    """The spans as Chrome trace events in microseconds from ``base_ns`` of
    the profiler's time base: a span of one thread as a complete event on
    it, one that may cross threads as an async pair."""
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": name}}
           for tid, name in snap.threads.items()]
    for s in snap.spans:
        ts = (snap.to_trace(s.start_ns) - base_ns) / 1e3
        args = {"rid": s.rid, "n": s.n, "id": s.id, "parent": s.parent}
        if s.nested:
            out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.tid,
                        "ts": ts, "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
        else:
            te = (snap.to_trace(s.end_ns) - base_ns) / 1e3
            for ph, t in (("b", ts), ("e", te)):
                out.append({"ph": ph, "cat": "span", "name": s.name, "id": s.id, "pid": pid,
                            "tid": s.tid, "ts": t, "args": args if ph == "b" else {}})
    return out


_EVENTS = re.compile(r'"traceEvents"\s*:\s*\[')
_BASE = re.compile(r'"baseTimeNanoseconds"\s*:\s*(\d+)')


def add_to_chrome_trace(path: str) -> int:
    """Insert the spans into the Chrome trace ``torch.profiler`` exported to
    ``path`` (text, so a large trace is not parsed); returns how many events
    were added."""
    snap = snapshot()
    with open(path) as f:
        text = f.read()
    m = _EVENTS.search(text)
    if m is None:
        raise ValueError(f"{path}: no traceEvents list")
    base = _BASE.search(text)
    events = chrome_events(snap, int(base.group(1)) if base else 0, os.getpid())
    if not events:
        return 0
    body = ",\n".join(json.dumps(e) for e in events)
    rest = text[m.end():]
    sep = "" if rest.lstrip().startswith("]") else ",\n"
    with open(path, "w") as f:
        f.write(text[:m.end()] + "\n" + body + sep + rest)
    return len(events)
