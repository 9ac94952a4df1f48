"""Calibration runs of a cell: its control, and the paced knee sweep.

    python -m ltbench.calibrate --workload <cell> --seed <n> --seconds <s> --trace 0 \
        [--control 1] [--sessions N]

One run as ``ltbench.run`` makes it, with its result line extended by a
``calibration`` key:

- ``--control 1`` runs the configuration's control in the program's place
  (the family's ``control(cfg)``); its ``correct`` must come out false;
- ``--sessions N`` overrides the mix's session count (the knee sweep);
- every run adds the session count and, for a paced mix, the readings the
  sweep needs (starved ticks during speech, the latency tail, the mean
  latency of chunks due in each third of the window, whether the viewer
  fell behind); for a free mix, the frames taken in each quarter of the
  window (whether the warm-up reached a steady rate).

Never a measured run of the benchmark.
"""

from __future__ import annotations

import argparse
import sys

from ltbench import run as ltrun


def summary(result: dict, run) -> None:
    from ltbench.stats import chunk_latencies
    from ltbench.spec import Spec

    o = run.obs
    out = {"sessions": len(o.logs)}
    if o.ticks is not None:
        spec = Spec(".")
        thirds = [[], [], []]
        for due, lat in chunk_latencies(run):
            thirds[min(2, int(3 * (due - o.t0) / (o.t1 - o.t0)))].append(lat)
        out.update(starved_tick_pct=spec.reader("starved_tick_pct")(run),
                   av_latency_p95_ms=spec.reader("av_latency_p95_ms")(run),
                   latency_mean_ms_by_third=[1000 * sum(t) / len(t) if t else None
                                             for t in thirds],
                   tick_late_max_s=o.tick_late_max_s, ticks_skipped=o.ticks_skipped)
    else:
        q = (o.t1 - o.t0) / 4
        out["frames_by_quarter"] = [
            sum(sum(1 for t in log.video_t if o.t0 + i * q <= t < o.t0 + (i + 1) * q)
                for log in o.logs) for i in range(4)]
    result["calibration"] = out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m ltbench.calibrate",
                                description=__doc__.split("\n")[0])
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--sessions", type=int, default=0)
    args = ltrun.parse(argv, p)

    def edit(cfg, mix, fam):
        if args.control:
            cfg = fam.control(cfg)
        if args.sessions:
            mix = dict(mix, sessions=int(args.sessions))
        return cfg, mix

    return ltrun.main(args=args, edit=edit, extra=summary)


if __name__ == "__main__":
    sys.exit(main())
