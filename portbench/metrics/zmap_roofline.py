"""``zmap_roofline``: a segment latent's ``ops.zstats`` calls' share of
their roofline, in %.

The port sends a latent whose children carry a ``zmap`` (SLDA's
sentences) to ``zstats_zmap``: phase 1's summed child messages, phase 2a's
prior pass and phase 2b's r-weighted child stats.  Each call of
``repro_torch.kernels.ops.zstats`` in the timed window is marked with CUDA
events (the wrapper and signature of ``zstats_roofline``); of those, this
reads only the calls with a child that has a ``zmap``.  Its work is the
frozen count ``work/zstats.py:count_zmap``; the share is the calls' least
time at the H100's peaks (``peaks.py``) over their measured time.  A run
whose window makes no such call reads nothing.
"""

import peaks
from work import zstats as work

from metrics.zstats_roofline import WRAP, signature  # noqa: F401


def read(ctx):
    calls = [(sig, ms) for sig, ms in ctx.wrapped.get(WRAP, ())
             if work.segmented(sig[2])]
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
