"""step_to_host_p95_ms: 95th percentile of the window's ``sched.to_host`` spans (a
super-batch's launch to its frames on the host: the model step, the paste and the
device-to-host copy), in ms."""

from ltbench.spans import p95_ms


def read(run):
    return p95_ms(run, "sched.to_host")
