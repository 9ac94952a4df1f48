"""Arithmetic the metric readers share: percentiles, window deltas of the
program's counters, and the complete steps of a trace."""

from __future__ import annotations

import math
import re
from typing import List, Optional, Sequence

STEP_MARKER = re.compile(r"paste_kernel")   # kernel 2 ends every super-batch step


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile, linear between the closest ranks."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def chunk_latencies(run) -> List[tuple]:
    """(due time, latency) of every chunk due in the window, in every
    session: from its due time to the take of the frame carrying it, or to
    the window's end when none took it by then."""
    o = run.obs
    out = []
    for log, utts in zip(o.logs, o.schedule or []):
        taken = {}
        for j, serial in enumerate(log.audio):
            if serial >= 0 and j // 2 < len(log.video_t):
                taken.setdefault(serial, log.video_t[j // 2])
        for u in utts:
            for c in range(u.n):
                due = o.origin + u.start_s + 0.02 * c
                if o.t0 <= due < o.t1:
                    out.append((due, min(taken.get(u.first + c, o.t1), o.t1) - due))
    return out


def delta(run, key: str, a: str = "start", b: str = "end") -> Optional[float]:
    c = run.obs.counters
    if a not in c or b not in c or c[a].get(key) is None:
        return None
    return c[b][key] - c[a][key]


def window_entries(run, deque_key: str, count_key: str, a: str = "start",
                   b: str = "end") -> List[float]:
    """The entries a rolling counter deque gained between snapshots ``a``
    and ``b`` (at most its length)."""
    n = delta(run, count_key, a, b)
    if not n:
        return []
    return list(run.obs.counters[b][deque_key])[-int(n):]


def frames_per_step(run) -> Optional[float]:
    """Mean padded frames of the steps resolved in the window (the trace's)."""
    sizes = window_entries(run, "batch_sizes", "batches_run")
    if not sizes:
        return None
    c = run.obs.counters["end"]
    buckets = sorted(c["buckets"])
    return sum(next(b for b in buckets if b >= k) for k in sizes) * c["batch_size"] / len(sizes)


def kernel_share(run, name: re.Pattern, groups: Sequence[str]) -> Optional[float]:
    """Least time of the operations of ``groups`` over the device time of the
    kernels matching ``name``, in percent, over the complete steps of the
    trace (from the first step marker's end to the last's)."""
    tr = run.trace
    if tr is None:
        return None
    marks = [t for n, _s, t in tr.kernels if STEP_MARKER.search(n)]
    per_step = frames_per_step(run)
    ops = [op for unit in run.work.values() for op in unit if op.group in groups]
    if len(marks) < 2 or not per_step or not ops:
        return None
    lo, hi = marks[0], marks[-1]
    busy = sum(t - s for n, s, t in tr.kernels if lo <= s and t <= hi and name.search(n))
    if busy <= 0:
        return None
    least = (len(marks) - 1) * sum(op.least_s(per_step) for op in ops)
    return 100.0 * least / (busy / 1e9)
