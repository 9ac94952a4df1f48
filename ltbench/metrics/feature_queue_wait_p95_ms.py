"""feature_queue_wait_p95_ms: 95th percentile of the window's ``features.queue`` spans
(a feature batch's ``feat_queue.put``, blocked while two wait, to the inference
thread's get), in ms."""

from ltbench.spans import p95_ms


def read(run):
    return p95_ms(run, "features.queue")
