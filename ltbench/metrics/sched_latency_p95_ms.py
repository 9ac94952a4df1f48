"""sched_latency_p95_ms: 95th percentile of the window's entries of
BatchScheduler.latency_s (a request's submit to its frames on the host)."""

from ltbench.stats import percentile, window_entries


def read(run):
    p = percentile(window_entries(run, "latency_s", "requests_run"), 95)
    return None if p is None else 1000.0 * p
