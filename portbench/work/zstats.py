"""The work of one ``ops.zstats`` call: ``(operations, bytes)`` from the
call's shapes and index streams alone, :func:`count` for a flat latent's
token plate and :func:`count_zmap` for a segment latent's (a child with a
``zmap``, which the port sends to ``zstats_zmap``).

Frozen copies of the port's ``kernels/work.py:zstats`` and
``zstats_zmap``, so that a change to the program cannot move its own
yardstick.  A flat latent: 8 operations a (counted token, topic), the
message sum, the softmax, the logsumexp and the scattered stats.  A
segment latent: 8 a (kept instance, topic), the softmax, the logsumexp and
the prior stats, and 4 a (counted token, topic), the message summed into
its instance and the r-weighted child stats; its logits and r are
intermediates, not counted.  Both count the same bytes, each input read
once and each output written once: the prior rows and mask, the prior
table's cells that the instances gather, each child's streams (its zmap
among them) and the cells its tokens gather (one for each topic at each
distinct (base, value) pair), every stats table written once as the dense
table the call returns, and the logsumexp total.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class Child(NamedTuple):
    """A child of the latent as the count sees it: its table's shape and
    its streams (tensors)."""
    table: tuple
    values: torch.Tensor
    base: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    zmap: Optional[torch.Tensor] = None


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _kept(n: int, mask) -> int:
    return n if mask is None else int((mask > 0).sum())


def counted(child: Child, zmask=None):
    """The tokens of ``child`` that count: its own mask, else the latent's
    ``zmask`` (through ``zmap``), else None (all)."""
    if child.mask is not None or zmask is None:
        return child.mask
    return zmask if child.zmap is None else zmask[child.zmap.long()]


def real_tokens(children, zmask=None, n_latent: int = 0) -> int:
    """The tokens of the first child that count; ``n_latent`` instances
    kept by ``zmask`` for a childless latent."""
    if not children:
        return _kept(n_latent, zmask)
    c = children[0]
    return _kept(len(c.values), counted(c, zmask))


def cells(key, base, keep, k: int, table: tuple) -> int:
    """Cells of a table of shape ``table`` that the kept tokens gather: one
    for each of ``k`` topics at each distinct (``base``, ``key``) pair."""
    key = key.long()
    if base is not None:
        key = key + base.long() * table[1]
    if keep is not None:
        key = key[keep > 0]
    return min(torch.unique(key).numel() * k, math.prod(table))


def segmented(children) -> bool:
    """True where the latent is a segment latent (a child has a zmap)."""
    return any(c.zmap is not None for c in children)


def count(prior_shape: tuple, prior_rows, children, zmask=None) -> tuple:
    """``(operations, bytes)`` of a ``zstats`` call on a ``prior_shape``
    (G, K) prior table with these streams and children."""
    k = prior_shape[1]
    n = real_tokens(children, zmask, len(prior_rows))
    return 8 * n * k, _bytes(prior_shape, prior_rows, children, zmask)


def count_zmap(prior_shape: tuple, prior_rows, children,
               zmask=None) -> tuple:
    """``(operations, bytes)`` of a segment latent's ``zstats`` call (the
    port's ``zstats_zmap``) on a ``prior_shape`` (G, K) prior table, with
    ``prior_rows`` one per instance and children with a ``zmap``."""
    k = prior_shape[1]
    inst = _kept(len(prior_rows), zmask)
    tok = real_tokens(children, zmask, len(prior_rows))
    return 8 * inst * k + 4 * tok * k, _bytes(prior_shape, prior_rows,
                                              children, zmask)


def _bytes(prior_shape: tuple, prior_rows, children, zmask) -> int:
    """Each input read once and each output written once (the module's
    docstring)."""
    k = prior_shape[1]
    nbytes = (_nbytes(prior_rows, zmask)
              + cells(prior_rows, None, zmask, k, tuple(prior_shape)) * 4
              + math.prod(prior_shape) * 4 + 4)
    for c in children:
        nbytes += (_nbytes(c.values, c.zmap, c.base, c.mask)
                   + cells(c.values, c.base, counted(c, zmask), k,
                           tuple(c.table)) * 4
                   + math.prod(c.table) * 4)
    return nbytes
