"""starved_tick_pct: viewer ticks in the window, during a session's scheduled speech,
that found no frame, over all such ticks (the benchmark's viewer)."""


def read(run):
    o = run.obs
    if o.ticks is None:
        return None
    n = starved = 0
    for ticks, utts in zip(o.ticks, o.schedule):
        spans = [(o.origin + u.start_s, o.origin + u.start_s + 0.02 * u.n) for u in utts]
        for t, empty in ticks:
            if o.t0 <= t < o.t1 and any(a <= t < b for a, b in spans):
                n += 1
                starved += empty
    return None if n == 0 else 100.0 * starved / n
