"""``zstats_roofline``: the token plate's ``ops.zstats`` calls' share of
their roofline, in %.

Each call of the module attribute ``repro_torch.kernels.ops.zstats`` in
the timed window is marked with CUDA events.  Its work is the frozen count
``work/zstats.py`` of the call's shapes and index streams; the share is the
calls' least time at the H100's peaks (``peaks.py``) over their measured
time.  A run whose window calls no ``zstats`` reads nothing.
"""

import peaks
from work import zstats as work

WRAP = "repro_torch.kernels.ops:zstats"


def signature(args, kwargs):
    """(key, what the count needs) of one call: the prior table's shape,
    the streams, and each child's table shape and streams; no table."""
    table_prior, prior_rows, children = args[:3]
    zmask = kwargs.get("zmask", args[3] if len(args) > 3 else None)
    kids = tuple(work.Child(tuple(c.elog.shape), c.values, c.base, c.mask,
                            c.zmap) for c in children)
    key = (tuple(table_prior.shape), id(prior_rows),
           tuple((k.table, id(k.values)) for k in kids))
    return key, (tuple(table_prior.shape), prior_rows, kids, zmask)


def read(ctx):
    calls = ctx.wrapped.get(WRAP)
    if not calls:
        return None
    counts = {}
    bound = measured = 0.0
    for sig, ms in calls:
        if id(sig) not in counts:
            counts[id(sig)] = peaks.bound_s(*work.count(*sig))[0]
        bound += counts[id(sig)]
        measured += ms * 1e-3
    return 100.0 * bound / measured
