"""step_mfu_pct: the window's useful work at the H100's published dense peaks (each
operation at its precision's rate: ltbench/work.py), over the window's seconds. Work:
each of the program's counters that the family counts work for (MuseTalk: frames the
scheduler ran, padding left out, and feature requests the coalescer ran), its window
delta times the operations of one unit of it."""

from ltbench.stats import delta
from ltbench.work import PEAKS


def read(run):
    t = sum((delta(run, counter) or 0) * sum(op.flops / PEAKS[op.prec] for op in ops)
            for counter, ops in run.work.items())
    return 100.0 * t / (run.obs.t1 - run.obs.t0) if t > 0 else None
