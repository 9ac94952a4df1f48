"""Arithmetic the span readers share: the program's spans in the window, and
the device's idle time under them on the trace's clock.

The spans are the program's own (``livetalking_tpu_torch/utils/spans.py``),
recorded while the traced run's profiler runs and read in this process
after the window. A span is in the window when it ends in
``[obs.t0, obs.t1)`` (both on ``time.perf_counter``, the spans' clock). The
program maps its clock onto the trace's (``snapshot().to_trace``), where
``run.trace.kernels`` lie. Every reader returns None, and raises nothing,
where the run was not traced, the program has no span module (one older
than it) or recorded no span.
"""

from __future__ import annotations

import importlib
from typing import List, Optional, Sequence, Tuple

from ltbench.stats import percentile

MODULE = "livetalking_tpu_torch.utils.spans"

Intervals = List[Tuple[int, int]]


def snapshot(run):
    """The program's spans, counters and clock map, or None."""
    if run.trace is None:
        return None
    try:
        mod = importlib.import_module(MODULE)
    except ImportError:
        return None
    snap = mod.snapshot()
    return snap if snap.spans else None


def _ns(t: float) -> int:
    return round(t * 1e9)


def window_spans(run, name: str) -> list:
    snap = snapshot(run)
    if snap is None:
        return []
    lo, hi = _ns(run.obs.t0), _ns(run.obs.t1)
    return [s for s in snap.spans if s.name == name and lo <= s.end_ns < hi]


def p95_ms(run, name: str) -> Optional[float]:
    """95th percentile of the window's ``name`` spans, in ms."""
    return percentile([(s.end_ns - s.start_ns) / 1e6 for s in window_spans(run, name)], 95)


def mean_ms(run, name: str) -> Optional[float]:
    d = [(s.end_ns - s.start_ns) / 1e6 for s in window_spans(run, name)]
    return sum(d) / len(d) if d else None


def union(iv: Sequence[Tuple[int, int]]) -> Intervals:
    """Sorted, disjoint intervals covering ``iv``."""
    out: Intervals = []
    for s, e in sorted(iv):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """Of two sorted disjoint lists, what both cover."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Intervals, b: Intervals) -> Intervals:
    """Of two sorted disjoint lists, what ``a`` covers and ``b`` does not."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def measure(iv: Intervals) -> int:
    return sum(e - s for s, e in iv)


def idle_shares(run) -> Optional[Tuple[float, float]]:
    """(device-idle time under an open ``sched.dispatch``, device-idle time
    under an open ``sched.hold`` and no ``sched.dispatch``), each in percent
    of the window: the window mapped onto the trace's clock, less every
    device activity of ``run.trace.kernels``."""
    snap, tr = snapshot(run), run.trace
    if snap is None or not tr.kernels:
        return None
    f = snap.to_trace
    lo, hi = f(_ns(run.obs.t0)), f(_ns(run.obs.t1))
    if hi <= lo:
        return None
    idle = subtract([(lo, hi)], union([(s, e) for _n, s, e in tr.kernels]))

    def covered(name: str) -> Intervals:
        return union([(f(s.start_ns), f(s.end_ns)) for s in snap.spans if s.name == name])

    dispatch = covered("sched.dispatch")
    in_dispatch = measure(intersect(idle, dispatch))
    held = measure(intersect(subtract(idle, dispatch), covered("sched.hold")))
    return 100.0 * in_dispatch / (hi - lo), 100.0 * held / (hi - lo)
