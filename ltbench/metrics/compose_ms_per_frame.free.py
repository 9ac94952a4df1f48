"""compose_ms_per_frame.free: mean of the window's ``compose.frame`` spans (the compose
thread's paste-back, watermark and push of one frame), in ms; the free-running cells."""

from ltbench.spans import mean_ms


def read(run):
    return mean_ms(run, "compose.frame")
