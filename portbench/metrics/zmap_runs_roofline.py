"""``zmap_runs_roofline``: the share of their roofline, in %, of the
``ops.zstats`` calls of a segment latent whose zmap child is strided (it
carries a ``base``: DCM-SLDA's per-document phi, rows ``base + stride *
k``), the route whose phase 2b is the ``runs`` pass.

Each call of ``repro_torch.kernels.ops.zstats`` in the timed window is
marked with CUDA events (the wrapper and signature of
``zstats_roofline``); of those, this reads only the calls with a child
that has both a ``zmap`` and a ``base``.  Its work is the frozen count
``work/zstats.py:count_zmap``; the share is the calls' least time at the
H100's peaks (``peaks.py``) over their measured time.  A CPU run, or one
whose window makes no such call, reads nothing.
"""

import peaks
from work import zstats as work

from metrics.zstats_roofline import WRAP, signature  # noqa: F401


def strided_zmap(children) -> bool:
    """True where a child has a zmap and a base."""
    return any(c.zmap is not None and c.base is not None for c in children)


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    calls = [(sig, ms) for sig, ms in ctx.wrapped.get(WRAP, ())
             if strided_zmap(sig[2])]
    if not calls:
        return None
    counts = {}
    bound = measured = 0.0
    for sig, ms in calls:
        if id(sig) not in counts:
            counts[id(sig)] = peaks.bound_s(*work.count_zmap(*sig))[0]
        bound += counts[id(sig)]
        measured += ms * 1e-3
    return 100.0 * bound / measured
