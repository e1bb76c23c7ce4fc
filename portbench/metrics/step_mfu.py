"""``step_mfu``: the whole step's share of the chip's peak, in %.

The step's necessary work (``work/vmp_step.py``: the token plates'
``zstats``, each Dirichlet's Elog, ELBO term and update, counted from the
configuration's shapes and the corpus's streams) at the H100's data-sheet
peaks (``peaks.py``: 67 TFLOP/s f32 or 3.35 TB/s, whichever bounds), over
the timed window's mean step (the window's host seconds over its steps).
"""

import peaks


def read(ctx):
    if ctx.step_work is None or not ctx.window["steps"]:
        return None
    bound, _ = peaks.bound_s(*ctx.step_work)
    return 100.0 * bound / (ctx.window["seconds"] / ctx.window["steps"])
