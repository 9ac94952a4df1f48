"""compose_ms_per_frame.paced: compose_ms_per_frame.free's quantity in the paced cell."""

from ltbench.spans import mean_ms


def read(run):
    return mean_ms(run, "compose.frame")
