"""frames_per_s: every video frame all viewers took in the window, over its seconds."""


def read(run):
    o = run.obs
    n = sum(sum(1 for t in log.video_t if o.t0 <= t < o.t1) for log in o.logs)
    return n / (o.t1 - o.t0)
