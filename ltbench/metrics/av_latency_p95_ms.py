"""av_latency_p95_ms: for every 20 ms chunk due in the window, in every session, the
time from when it was due (its utterance's scheduled start + 20 ms per chunk before
it) to when the viewer took the video frame that carries it; a chunk not taken by
the window's end counts to the window's end. The 95th percentile, pooled."""

from ltbench.stats import chunk_latencies, percentile


def read(run):
    if run.obs.schedule is None:
        return None
    p = percentile([lat for _due, lat in chunk_latencies(run)], 95)
    return None if p is None else 1000.0 * p
