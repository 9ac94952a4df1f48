"""sched_hold_p95_ms: 95th percentile of the window's ``sched.hold`` spans (a request's
``BatchScheduler.submit`` to the launch of its super-batch), in ms."""

from ltbench.spans import p95_ms


def read(run):
    return p95_ms(run, "sched.hold")
