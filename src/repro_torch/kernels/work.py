"""The work of each kernel call: ``(operations, bytes)`` from the call's
shapes and index streams, whatever implements the call.

One function per kernel of ``ops``: :func:`zstats` (a flat latent),
:func:`zstats_zmap` (a segment latent), :func:`zmap_logits`,
:func:`dirichlet_expectation`, :func:`dirichlet_elbo_term`,
:func:`dirichlet_update`, :func:`zstep` and :func:`flash_attention`;
and :func:`zmap_stats`, phase 2b of ``zstats_zmap`` timed apart.
Bytes count each input read once and each output written once; where the
work depends on the data (the table cells a call's tokens gather, the
tokens a mask keeps) it is what these streams need.  A stream that holds
no data (a ``meta`` tensor, as in a dry run) counts at its most: every
token kept, every cell its tokens could reach.  ``chip_smoke.py`` divides
these by the card's peaks (``launch.roofline.bound``); a cost count
(``launch.step_cost.count``) adds them to a step's.

A cost count listens here: :func:`recording` installs its sink for the
calls in its block, and ``ops`` hands each kernel call on ``meta`` tensors
to :func:`active`'s sink instead of a kernel.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch

#: f32 operations of one digamma (shift by 8, then the asymptotic series)
DIGAMMA_OPS = 30
#: f32 operations counted for one lgamma, as for a digamma
LGAMMA_OPS = 30

_SINK = contextvars.ContextVar("kernel_work_sink", default=None)


def active():
    """The sink of the cost count this call runs in, or None."""
    return _SINK.get()


@contextlib.contextmanager
def recording(sink):
    """Hand the kernel calls on ``meta`` tensors inside the block to
    ``sink.kernel(name, routes, ops, nbytes)``."""
    token = _SINK.set(sink)
    try:
        yield sink
    finally:
        _SINK.reset(token)


# ---------------------------------------------------------------------------
# index streams: values where they exist
# ---------------------------------------------------------------------------

def _t(a):
    """An index stream or mask as a tensor (numpy arrays are wrapped)."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(np.asarray(a))


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in map(_t, ts)
               if t is not None)


def _held(*ts) -> bool:
    """True where every stream given holds values (none is ``meta``)."""
    return all(t is None or t.device.type != "meta" for t in map(_t, ts))


def counted(child, zmask=None):
    """The tokens of ``child`` that count: its own mask, else the latent's
    ``zmask`` (through ``zmap`` for a segment latent), else None (all)."""
    if child.mask is not None or zmask is None:
        return _t(child.mask)
    zmask = _t(zmask)
    return zmask if child.zmap is None else zmask[_t(child.zmap).long()]


def _kept(n: int, mask) -> int:
    """Of ``n`` entries, those a mask keeps (all of them without one, or
    when the mask holds no values)."""
    if mask is None or not _held(mask):
        return n
    return int((_t(mask) > 0).sum())


def real_tokens(children, zmask=None, n_latent: int = 0) -> int:
    """The tokens of the first child that count (:func:`counted`);
    ``n_latent`` instances kept by ``zmask`` for a childless latent."""
    if not children:
        return _kept(n_latent, zmask)
    c = children[0]
    if not _held(c.mask, zmask, c.zmap):
        return len(c.values)
    return _kept(len(c.values), counted(c, zmask))


def _cells(key, base, keep, k: int, table: tuple) -> int:
    """Cells of a ``table`` of that shape that the kept tokens gather, one
    for each of ``k`` values at each distinct (``base``, ``key``) pair: all
    that they could reach where a stream holds no values."""
    size = math.prod(table)
    if not _held(key, base, keep):
        return min(len(key) * k, size)
    key = _t(key).long()
    if base is not None:
        key = key + _t(base).long() * table[1]
    if keep is not None:
        key = key[_t(keep) > 0]
    return min(torch.unique(key).numel() * k, size)


def gathered_bytes(children, k: int, zmask=None) -> int:
    """Each child's index streams read once, and of its table only the
    cells that its counted tokens gather (:func:`_cells`).  Tables are read
    for their shapes only (stand-ins do)."""
    return sum(_nbytes(c.values, c.zmap, c.base, c.mask)
               + _cells(c.values, c.base, counted(c, zmask), k,
                        tuple(c.elog.shape)) * 4 for c in children)


def zstats_bytes(table_prior, prior_rows, children, zmask=None) -> int:
    """The least bytes a ``zstats`` call on these arguments moves: the prior
    rows and zmask read once, the prior table's gathered rows, each child's
    streams and gathered cells (:func:`gathered_bytes`), every stats table
    written once as the dense table the function returns, the lse sum.
    Streams may be tensors on any device or numpy arrays."""
    k = table_prior.shape[1]
    prior_cells = _cells(prior_rows, None, zmask, k, tuple(table_prior.shape))
    return (_nbytes(prior_rows, zmask) + prior_cells * 4
            + math.prod(table_prior.shape) * 4
            + gathered_bytes(children, k, zmask)
            + sum(math.prod(c.elog.shape) * 4 for c in children) + 4)


# ---------------------------------------------------------------------------
# one function per kernel: (operations, bytes)
# ---------------------------------------------------------------------------

def zstats(table_prior, prior_rows, children, zmask=None) -> tuple:
    """A flat latent's ``zstats``: 8 operations a (counted token, topic)
    (the message sum, softmax, logsumexp and the scattered stats), and
    :func:`zstats_bytes`."""
    k = table_prior.shape[1]
    n = real_tokens(children, zmask, len(prior_rows))
    return 8 * n * k, zstats_bytes(table_prior, prior_rows, children, zmask)


def zstats_zmap(table_prior, prior_rows, children, zmask=None) -> tuple:
    """A segment latent's ``zstats_zmap``: 8 operations a (kept instance,
    topic) and 4 a (counted token, topic) (phase 1's message sum, phase
    2b's weighted stats), and :func:`zstats_bytes`: each child's streams,
    the cells its tokens gather (for a strided child, the cells its runs
    store), and its stats table written dense, which is the zero fill of a
    strided child's cells that no token reaches.  The logits and r are
    intermediates, not counted; :func:`zmap_stats` counts phase 2b's r."""
    k = table_prior.shape[1]
    inst = _kept(len(prior_rows), zmask)
    tok = real_tokens(children, zmask, len(prior_rows))
    return 8 * inst * k + 4 * tok * k, \
        zstats_bytes(table_prior, prior_rows, children, zmask)


def zmap_stats(children, n_latent: int, k: int) -> tuple:
    """Phase 2b of ``zstats_zmap`` alone, each child's (each with a
    ``zmap``) stats pass from the ``(n_latent, K)`` f32 responsibilities r:
    2 operations a (kept token, topic), the child's streams read once, the
    rows of r that its kept tokens gather, and its stats table written once
    (the cells its tokens reach and the zero fill of the others).  Not a
    call of ``ops``: ``chip_smoke.py`` times the pass apart against it."""
    ops = nbytes = 0
    for c in children:
        ops += 2 * _kept(len(c.values), c.mask) * k
        nbytes += (_nbytes(c.values, c.zmap, c.base, c.mask)
                   + _cells(c.zmap, None, c.mask, k, (n_latent, k)) * 4
                   + math.prod(c.elog.shape) * 4)
    return ops, nbytes


def zmap_logits(children, n_latent: int, k: int) -> tuple:
    """``zmap_logits``: 2 operations a (token, topic), the children's
    streams and gathered cells read, the ``(n_latent, K)`` f32 logits
    written."""
    tokens = sum(_kept(len(c.values), c.mask) for c in children)
    return 2 * tokens * k, gathered_bytes(children, k) + n_latent * k * 4


def dirichlet_expectation(alpha) -> tuple:
    """The Elog pass over a ``(G, K)`` table: a digamma a cell, the table
    read and the f32 result written."""
    n = math.prod(alpha.shape)
    return DIGAMMA_OPS * n, n * (_esize(alpha) + 4)


def dirichlet_elbo_term(post, elog) -> tuple:
    """A Dirichlet's ELBO term over a ``(G, K)`` posterior: an lgamma and 5
    operations a cell (``post - prior``, the lgamma's excess over the
    prior's, the three sums), the posterior and the Elog table read once,
    the prior row read and the scalar written."""
    g, k = post.shape
    return (LGAMMA_OPS + 5) * g * k, g * k * (_esize(post) + _esize(elog)) \
        + 4 * k + 4


def dirichlet_update(stats) -> tuple:
    """A Dirichlet's update ``prior + stats`` over a ``(G, K)`` table: an add
    a cell, the stats and the prior row read, the f32 posterior written."""
    g, k = stats.shape
    return g * k, g * k * (_esize(stats) + 4) + 4 * k


def zstep(logits) -> tuple:
    """``zstep`` over ``(N, K)`` logits: 5 operations a cell (max, exp,
    sum, divide, log), the logits read, the f32 responsibilities and the
    ``(N,)`` logsumexp written."""
    n, k = logits.shape
    return 5 * n * k, n * k * (_esize(logits) + 4) + n * 4


def attention_pairs(sq: int, sk: int, causal: bool) -> int:
    """The (query, key) pairs attention keeps: the causal mask ``kpos <=
    qpos`` keeps ``min(i + 1, Sk)`` keys for query ``i``."""
    if not causal:
        return sq * sk
    m = min(sq, sk)
    return m * (m + 1) // 2 + max(sq - sk, 0) * sk


def flash_attention(q, k, v, causal: bool = True) -> tuple:
    """``flash_attention`` on q ``(BH, Sq, Dh)`` and k, v ``(BH, Sk, Dh)``:
    the products ``q k^T`` and ``P v`` over the kept pairs (4 Dh
    operations a pair), q, k and v read and the output written."""
    bh, sq, dh = q.shape
    sk = k.shape[1]
    nbytes = (2 * bh * sq * dh + 2 * bh * sk * dh) * _esize(q)
    return 4 * bh * dh * attention_pairs(sq, sk, causal), nbytes


def _esize(t) -> int:
    return t.dtype.itemsize
