"""``idle_share``: the device's idle share of the profiled steps, in %:
1 - the union of the device's kernel, copy and fill intervals over the
span of the steps, from ``torch.profiler`` after the timed window.  The
profiler's own cost on the host, and launches it drops, read as idle."""


def read(ctx):
    p = ctx.profile
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
