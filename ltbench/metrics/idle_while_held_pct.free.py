"""idle_while_held_pct.free: the traced window's device-idle time while a request waits
in the scheduler (an open ``sched.hold`` span) and no super-batch is being launched,
over the window, in percent; the free-running cells."""

from ltbench.spans import idle_shares


def read(run):
    shares = idle_shares(run)
    return None if shares is None else shares[1]
