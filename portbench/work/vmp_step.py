"""The necessary work of one full-batch VMP step: ``(operations, bytes)``
from the configuration's shapes and streams alone.

A step is, for each Dirichlet (rows g, dim k): its Elog table (a digamma a
cell; the posterior read, the table written), its ELBO term (an lgamma and
3 operations a cell; the posterior and the Elog table read, a number
written) and its update ``prior + stats`` (an add a cell; the stats read,
the new posterior written); and for each token plate, its ``zstats`` call
(``work/zstats.py``: ``count`` for a flat latent, ``count_zmap`` for a
segment latent).  Each part is one read of its inputs and one write of
its outputs, whatever the program launches: a fusion of the parts does not
lower this count, and eager temporaries do not raise it.
"""

from __future__ import annotations

from work import zstats

#: f32 operations of one digamma (shift by 8, then the asymptotic series),
#: the port's ``kernels/work.py`` figure; an lgamma is counted the same
DIGAMMA_OPS = 30
LGAMMA_OPS = DIGAMMA_OPS


def dirichlet(g: int, k: int) -> tuple:
    """``(operations, bytes)`` of one Dirichlet's Elog, ELBO term and
    update."""
    n = g * k
    ops = DIGAMMA_OPS * n + (LGAMMA_OPS + 3) * n + n
    nbytes = 8 * n + (8 * n + 4) + 8 * n
    return ops, nbytes


def count(dirichlets: dict, plates) -> tuple:
    """``dirichlets`` ``{name: (rows, dim, prior)}``; ``plates`` a list of
    ``(prior shape, prior rows, [work.zstats.Child])``, one per latent (a
    segment latent's children carry their ``zmap``)."""
    ops = nbytes = 0
    for g, k, _ in dirichlets.values():
        o, b = dirichlet(g, k)
        ops, nbytes = ops + o, nbytes + b
    for prior_shape, rows, children in plates:
        plate = zstats.count_zmap if zstats.segmented(children) \
            else zstats.count
        o, b = plate(prior_shape, rows, children)
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes


def of_model(model) -> tuple:
    """:func:`count` of a plain reference model with one latent: flat
    (``reference.flat.FlatModel``) or segment
    (``reference.segment.SegmentModel``, whose ``seg`` is each child's
    zmap)."""
    dirs = model.dirichlets
    zmap = getattr(model, "seg", None)
    children = [zstats.Child(dirs[c.dirichlet][:2], c.values, c.base,
                             zmap=zmap) for c in model.children]
    return count(dirs, [(dirs[model.prior][:2], model.rows, children)])
