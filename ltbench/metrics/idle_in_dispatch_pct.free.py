"""idle_in_dispatch_pct.free: the traced window's device-idle time while the
scheduler's dispatch thread builds and launches a super-batch (an open
``sched.dispatch`` span), over the window, in percent; the free-running cells."""

from ltbench.spans import idle_shares


def read(run):
    shares = idle_shares(run)
    return None if shares is None else shares[0]
