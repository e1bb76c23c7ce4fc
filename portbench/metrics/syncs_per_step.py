"""``syncs_per_step``: blocking syncs a step of the fit: the syncs the
port's tracer counts (``repro_torch.trace``, through
``torch.cuda.set_sync_debug_mode("warn")`` while it records the profiled
steps) under each ``runtime.step`` record and its descendants, over the
number of those records.  Counted only on the card: a CPU run, or a
program without the tracer, reads nothing."""


def read(ctx):
    if ctx.device.type != "cuda" or ctx.profile is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    steps, syncs = 0, 0
    for r in recs:
        steps += r.name == "runtime.step"
        up = r
        while up is not None and up.name != "runtime.step":
            up = by_id.get(up.parent)
        if up is not None:
            syncs += r.syncs
    return syncs / steps if steps else None
