"""inflight_hold_p95_ms: 95th percentile of the window's ``session.inflight`` spans (a
session batch's frames on the host to the inference thread handing them to the
compose queue: the ``--session_inflight`` hold), in ms."""

from ltbench.spans import p95_ms


def read(run):
    return p95_ms(run, "session.inflight")
