"""setup_s: process start to the first instant of the measured window (host clock)."""


def read(run):
    return run.setup_s
