"""compose_queue_wait_p95_ms: 95th percentile of the window's ``compose.queue`` spans
(a frame's ``res_frame_queue.put``, blocked while the queue is full, to the compose
thread's get), in ms."""

from ltbench.spans import p95_ms


def read(run):
    return p95_ms(run, "compose.queue")
