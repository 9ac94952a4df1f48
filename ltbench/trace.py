"""``torch.profiler`` over the measured window, reduced in memory.

It records CUDA activity only (the device's kernels, copies and sets, and
the runtime calls that issued them), in one profiling session per process
that starts before any session renders: traced W8A8 runs whose profiler
started while the sessions ran (after a first short session in set-up)
ended in a segmentation fault or a heap corruption in three of nine runs.
Marker kernels on a side stream at the window's first and last instants
give the window in the trace's own clock. Nothing is written to disk. From
the raw events it keeps every device activity in the window as (name,
start, end), the union of device-busy time, and the ``breakdown``: the device operations that took the most time, and the
longest idle gaps, each labelled with the runtime call that issued the
device work ending it (``cudaLaunchKernel`` where the host was late to
launch, a copy or a synchronisation where it waited).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class TraceData:
    kernels: List[Tuple[str, int, int]]     # (name, start_ns, end_ns), by start
    busy_s: float
    window_s: float
    breakdown: dict


MARKER = "spin_kernel"  # torch.cuda._sleep's kernel


class Tracer:
    """Started before the sessions render and stopped after the window;
    ``mark()`` at the window's first and last instants."""

    def __init__(self, device_type: str = "cuda"):
        self.device_type = device_type
        self.started = self.stopped = False
        self._prof = None
        self._stream = None
        self.data: Optional[TraceData] = None

    def _activities(self):
        import torch

        if self.device_type == "cuda":
            return [torch.profiler.ProfilerActivity.CUDA]
        return [torch.profiler.ProfilerActivity.CPU]

    def start(self) -> None:
        import torch

        self._prof = torch.profiler.profile(activities=self._activities())
        self._prof.start()
        if self.device_type == "cuda":
            self._stream = torch.cuda.Stream()
        self.started = True

    def mark(self) -> None:
        """A marker kernel on a side stream: it runs at once, whatever the
        sessions' streams hold."""
        if self._stream is not None:
            import torch

            with torch.cuda.stream(self._stream):
                torch.cuda._sleep(1000)

    def stop(self) -> None:
        if self.device_type == "cuda":
            import torch

            torch.cuda.synchronize()
        self._prof.stop()
        self.stopped = True

    def reduce(self) -> TraceData:
        """Reduce the raw events (after the window: never inside it)."""
        from torch.autograd import DeviceType

        device, by_corr = [], {}
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CPU:
                if _is_op(e):
                    by_corr[e.correlation_id()] = e.name()
            elif e.duration_ns() > 0:
                device.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.linked_correlation_id()))
        device.sort(key=lambda d: d[1])
        marks = [d[1] for d in device if MARKER in d[0]]
        if len(marks) >= 2:  # the window in the trace's clock, without the markers
            lo, hi = marks[0], marks[-1]
            device = [(n, max(s, lo), min(t, hi), c) for n, s, t, c in device
                      if MARKER not in n and t > lo and s < hi]
        busy, gaps, cur = 0, [], None
        for i, (_n, s, t, _c) in enumerate(device):
            if cur is None:
                cur = [s, t]
            elif s > cur[1]:
                busy += cur[1] - cur[0]
                gaps.append((s - cur[1], i))
                cur = [s, t]
            else:
                cur[1] = max(cur[1], t)
        if cur is not None:
            busy += cur[1] - cur[0]
        totals: Dict[str, int] = defaultdict(int)
        for name, s, t, _c in device:
            totals[name] += t - s
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
        gaps.sort(reverse=True)
        idle = []
        for length, i in gaps[:10]:
            name, _s, _t, corr = device[i]
            host = by_corr.get(corr, "host")
            idle.append([f"{_short(host)} -> {_short(name)}", length / 1e9])
        if len(marks) >= 2:
            window_s = (marks[-1] - marks[0]) / 1e9
        else:
            window_s = (max(t for _n, _s, t, _c in device) - device[0][1]) / 1e9 if device else 0.0
        self.data = TraceData([(n, s, t) for n, s, t, _c in device], busy / 1e9, window_s,
                              {"device_ops": [[_short(n), v / 1e9] for n, v in ops],
                               "idle_gaps": idle})
        self._prof = None
        return self.data


def _is_op(e) -> bool:
    """A runtime call or a PyTorch operation (not the profiler's own events,
    which can share their correlation ids)."""
    return e.name().startswith(("cuda", "cu", "aten::"))


def _short(name: str, n: int = 90) -> str:
    return name if len(name) <= n else name[: n - 3] + "..."
