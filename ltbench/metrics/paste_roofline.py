"""paste_roofline: least time of the traced steps' fused rect pastes (kernel 1, one a
super-batch) over the device time of kernel 1's launches in those steps, the complete
steps of the trace as ``ltbench.stats.kernel_share`` takes them. Least time: the
paste's bytes at 3.35 TB/s, each distinct cycle frame read once with its box, each
output frame (padding included) written once, each 256 px crop and its index read
once (``ltbench/work_wav2lip.py::paste_bytes``). Distinct frames: a request's 16
consecutive ping-pong indices repeat one frame at each turn of an N-frame loop, so
a session reads N - 1 distinct frames a N; padded rows all read one frame. Kernels by
name from csrc/blend.cu: paste_kernel<false, ...> (the rect form; the masked form is
paste_kernel<true, ...>)."""

import re

from ltbench.stats import STEP_MARKER, window_entries
from ltbench.work import PEAKS
from ltbench.work_wav2lip import paste_bytes

NAMES = re.compile(r"paste_kernel<false")


def read(run):
    tr = run.trace
    if tr is None or "img_size" not in run.cfg:
        return None
    marks = [t for n, _s, t in tr.kernels if STEP_MARKER.search(n)]
    sizes = window_entries(run, "batch_sizes", "batches_run")
    if len(marks) < 2 or not sizes:
        return None
    lo, hi = marks[0], marks[-1]
    busy = sum(t - s for n, s, t in tr.kernels if lo <= s and t <= hi and NAMES.search(n))
    if busy <= 0:
        return None
    c = run.obs.counters["end"]
    buckets, B = sorted(c["buckets"]), c["batch_size"]
    N = run.cfg["avatar"]["frames"]
    frames = distinct = 0.0
    for k in sizes:
        bucket = next(b for b in buckets if b >= k)
        frames += bucket * B
        distinct += k * B * (1.0 - 1.0 / N) + (1 if bucket > k else 0)
    n = len(sizes)
    least = (len(marks) - 1) * paste_bytes(run.cfg, frames / n, distinct / n) \
        / PEAKS["hbm_bytes_per_s"]
    return 100.0 * least / (busy / 1e9)
