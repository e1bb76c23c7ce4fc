"""Triton kernels: a Dirichlet's ELBO term and its ``prior + stats`` update.

    elbo_term = sum_g [sum_k lgamma(post_gk) - lgamma(sum_k post_gk)]
                - G * [sum_k lgamma(prior_k) - lgamma(sum_k prior_k)]
                + sum_gk (prior_k - post_gk) * elog_gk
    update    = prior_k + stats_gk

Replaces no TPU kernel: the JAX package leaves both to XLA, which fuses
them.  Eager PyTorch ran them as a dozen passes over the table
(``dists.dirichlet_elbo_term``: lgamma of the posterior and of the prior
broadcast to its shape, their row sums, ``prior - post``, the product with
the Elog table, the sums; the update made ``prior * ones`` before adding
the stats), 53 ms of DCM-LDA's 91 ms step over its (150,000 x 12,419) phi.
``core/vmp.py`` calls both once per Dirichlet a step, through ``ops``.

Bound on the H100: bytes.  The ELBO term has to read the posterior and
the Elog table once (8 bytes a cell) against one lgamma and five adds;
the update reads the stats and writes the posterior (8 bytes a cell).
Design, each table read once:

  - the ELBO term is four launches.  The first takes lgamma of the prior
    row once per call (K values) and its sum in f64 by blocks; it is a
    launch of its own because an lgamma of the prior in the second pass,
    per tile, made that pass 7% slower on DCM-LDA's phi.  The second cuts
    the table into tiles of rows by one chunk of columns (:func:`elbo_plan`)
    and writes, per row and chunk, three f64 partials of each cell's excess
    over its prior: lgamma(post) - lgamma(prior), post - prior and (post -
    prior) * elog, each summed lane-wise in f32 over the chunk and then
    across the lanes by one tree in f64, so a cell equal to its prior (most
    of phi's) adds exactly 0 and the prior's log-normalizer is never taken
    G times and subtracted.  (With that tree in f32 the term over a
    (150,000 x 12,419) table was 2.6-3.1 f32 units in the last place off an
    f64 evaluation, against 0.15-0.6 for the plain f32 version; in f64,
    0.6-1.1.)  The third adds a row's chunk partials by one tree, forms
    the row's term (lgamma(sum post) - lgamma(sum prior), from the prior's
    block sums and the row's excess) and sums a block of rows, all in f64;
    the fourth, one program, sums the blocks in f64.  Every sum has an
    order fixed by (G, K) and the layout, so repeated calls, a minibatch
    that is the whole corpus and the shards of a mesh give the same bits.
  - a row is cut into chunks only where the table has too few rows to
    fill the card (LDA's phi, 100 rows of 102,660: route ``chunks``);
    otherwise a program takes a tile of rows whole (DCM-LDA's phi, 150,000
    rows of 12,419, 4 rows of 256 columns at a time; theta; Beta's rows of
    2: route ``rows``).  The chunks are planned as the Elog pass plans its
    row sums (``dirichlet_expectation.chunk_plan``).
  - the Elog table may be a transposed view (LDA's phi is stored (V, K)
    and read as (K, V)): it is read through its strides, and a tile of 16
    rows by 64 columns keeps both tables' reads in runs of 64 bytes or
    more.
  - the update is one elementwise pass over the output in memory order,
    ``prior[k] + stats``: the same f32 add as ``prior * 1 + stats``, so
    the posteriors keep their bits.  It took 5.2 ms on DCM-LDA's phi
    where eager PyTorch's broadcast ``stats + prior``, the same add, took
    6.1 ms.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .. import trace
from .dirichlet_expectation import _n_sm, _next_pow2, chunk_plan

#: most chunks a row is cut into
_MAX_CHUNKS = 256
#: a tile of the ELBO term's first pass: at most _MAX_COLS columns, at
#: least _MIN_ROWS rows and _MIN_CELLS cells, _PER_THREAD cells a thread;
#: where the Elog table is a transposed view, (rows, columns) and warps
#: (each the fastest of the tiles and warp counts timed at the benchmark's
#: tables on the H100; PERF.md)
_MAX_COLS, _MIN_ROWS, _MIN_CELLS, _PER_THREAD = 256, 4, 512, 4
_T_TILE, _T_WARPS = (16, 64), 8
#: entries of a program of the prior's pass, cells of one of the update
_P_BLOCK, _U_BLOCK = 1024, 1024
#: the H100's SMs, for a plan made where no card is asked (a dry run)
N_SM = 132

ROUTES = ("rows", "chunks")


class Plan(NamedTuple):
    """How the ELBO term's first pass tiles a (G, K) table: ``route``
    ``"rows"`` where a program's chunk spans whole rows, ``"chunks"`` where
    a row is cut into ``chunks`` runs of ``chunk_cols`` columns; ``block``
    the (rows, columns) a program holds at a time, with ``warps``."""
    route: str
    block: tuple
    chunks: int
    chunk_cols: int
    warps: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def error_limit(plain_err: float, truth: float) -> float:
    """The largest error of the ELBO term against an f64 evaluation of the
    same table that the kernel is held to (its tests, ``chip_smoke.py``):
    four times the plain f32 version's error there, or two units in the
    last place of the f32 result, whichever is larger.  The f32 result
    alone rounds by half a unit, and the f32 lgamma of the prior, shared
    by both versions, biases each counted cell alike."""
    ulp = float(torch.finfo(torch.float32).eps) * 2.0 ** math.floor(
        math.log2(abs(truth))) if truth else 0.0
    return max(4.0 * plain_err, 2.0 * ulp)


def transposed(elog: torch.Tensor) -> bool:
    """True where the Elog table's rows lie along memory (a transposed
    view, as LDA's phi): its tiles are then :data:`_T_TILE`."""
    return elog.stride(0) < elog.stride(1)


def elbo_plan(g: int, k: int, transposed: bool = False,
              n_sm: int = N_SM) -> Plan:
    """The ELBO term's tiles over a (g, k) table: a tile of whole column
    blocks, each row cut into chunks as ``dirichlet_expectation.chunk_plan``
    cuts them for the card's ``n_sm`` SMs (within ``_MAX_CHUNKS``)."""
    if transposed:
        (br, bk), warps = _T_TILE, _T_WARPS
    else:
        bk = min(_next_pow2(k), _MAX_COLS)
        br = max(_MIN_ROWS, _MIN_CELLS // bk)
        warps = br * bk // (_PER_THREAD * 32)
    chunks, chunk_cols = chunk_plan(g, k, (br, bk), n_sm, _MAX_CHUNKS)
    return Plan("rows" if chunks == 1 else "chunks", (br, bk), chunks,
                chunk_cols, warps)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Import Triton and define the kernels, at the first launch: the CPU
    build of the port has no Triton.  Triton looks the names a kernel uses
    up in its module's globals when it compiles, so the imports bind there."""
    global triton, tl, libdevice
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def prior_terms(prior_ptr, lgp_ptr, psum_ptr, K, BLOCK: tl.constexpr):
        # a block of the prior row: each entry's lgamma, and the block's
        # sum in f64
        c = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = c < K
        p = tl.load(prior_ptr + c, mask=m, other=1.0)
        tl.store(lgp_ptr + c, libdevice.lgamma(p), mask=m)
        tl.store(psum_ptr + tl.program_id(0),
                 tl.sum(tl.where(m, p, 0.0).to(tl.float64), axis=0))

    @triton.jit
    def partials(post_ptr, elog_ptr, prior_ptr, lgp_ptr, part_ptr,
                 G, K, s_pg, s_pk, s_eg, s_ek, C, CHUNK, PLANE,
                 BLOCK_R: tl.constexpr, BLOCK_K: tl.constexpr):
        # rows of program axis 0, columns CHUNK * c .. of chunk c (axis 1);
        # part holds three f64 (G, C) planes of PLANE = G * C partials each:
        # lgamma(post) - lgamma(prior), post - prior, (post - prior) * elog,
        # each 0 at a cell equal to its prior
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        chunk = tl.program_id(1)
        cols = tl.arange(0, BLOCK_K)
        rmask = rows < G
        r64 = rows.to(tl.int64)
        lo = chunk * CHUNK
        hi = tl.minimum(lo + CHUNK, K)
        # each row's base in 64 bits, once; its column offsets in 32 (the
        # wrapper refuses tables whose column offsets pass 2^31)
        prow = post_ptr + r64[:, None] * s_pg
        erow = elog_ptr + r64[:, None] * s_eg
        lg = tl.zeros((BLOCK_R, BLOCK_K), dtype=tl.float32)
        s = tl.zeros((BLOCK_R, BLOCK_K), dtype=tl.float32)
        x = tl.zeros((BLOCK_R, BLOCK_K), dtype=tl.float32)
        for k0 in range(lo, hi, BLOCK_K):
            c = k0 + cols
            cm = c < hi
            m = rmask[:, None] & cm[None, :]
            a = tl.load(prow + c[None, :] * s_pk, mask=m, other=1.0)
            e = tl.load(erow + c[None, :] * s_ek, mask=m, other=0.0)
            p = tl.load(prior_ptr + c, mask=cm, other=1.0)
            lp = tl.load(lgp_ptr + c, mask=cm, other=0.0)
            d = tl.where(m, a - p[None, :], 0.0)
            lg += tl.where(m, libdevice.lgamma(a) - lp[None, :], 0.0)
            s += d
            x += d * e
        # the lanes' f32 sums added across the lanes in f64
        out = part_ptr + r64 * C + chunk
        tl.store(out, tl.sum(lg.to(tl.float64), axis=1), mask=rmask)
        tl.store(out + PLANE, tl.sum(s.to(tl.float64), axis=1), mask=rmask)
        tl.store(out + 2 * PLANE, tl.sum(x.to(tl.float64), axis=1),
                 mask=rmask)

    @triton.jit
    def row_terms(part_ptr, psum_ptr, blk_ptr, G, C, PLANE, NP,
                  CP: tl.constexpr, PP: tl.constexpr, BLOCK_R: tl.constexpr):
        # each row's C chunk partials added by one tree over CP (>= C,
        # zero-padded) slots, the prior's NP block sums likewise over PP;
        # the row's term, lgamma(sum post) - lgamma(sum prior) from the
        # prior's sum and the row's excess over it; the block's terms
        # summed; all in f64
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        c = tl.arange(0, CP)
        rmask = rows < G
        m = rmask[:, None] & (c < C)[None, :]
        off = rows.to(tl.int64)[:, None] * C + c[None, :]
        lg = tl.sum(tl.load(part_ptr + off, mask=m, other=0.0), axis=1)
        s = tl.sum(tl.load(part_ptr + PLANE + off, mask=m, other=0.0), axis=1)
        x = tl.sum(tl.load(part_ptr + 2 * PLANE + off, mask=m, other=0.0),
                   axis=1)
        j = tl.arange(0, PP)
        sp = tl.sum(tl.load(psum_ptr + j, mask=j < NP, other=0.0), axis=0)
        norm = libdevice.lgamma(sp + s) - libdevice.lgamma(sp)
        term = lg - norm - x
        tl.store(blk_ptr + tl.program_id(0),
                 tl.sum(tl.where(rmask, term, 0.0), axis=0))

    @triton.jit
    def total(blk_ptr, out_ptr, NB, BLOCK: tl.constexpr):
        # one program: the blocks' f64 sums in a fixed order
        i = tl.arange(0, BLOCK)
        acc = tl.zeros((BLOCK,), dtype=tl.float64)
        for b0 in range(0, NB, BLOCK):
            acc += tl.load(blk_ptr + b0 + i, mask=b0 + i < NB, other=0.0)
        tl.store(out_ptr, tl.sum(acc, axis=0).to(tl.float32))

    @triton.jit
    def update(prior_ptr, stats_ptr, out_ptr, N, K, BLOCK: tl.constexpr):
        # a block of cells in memory order, each with its column's prior
        i = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
        m = i < N
        st = tl.load(stats_ptr + i, mask=m, other=0.0)
        p = tl.load(prior_ptr + i % K, mask=m, other=0.0)
        tl.store(out_ptr + i, p + st, mask=m)

    return prior_terms, partials, row_terms, total, update


def _check(prior: torch.Tensor, table: torch.Tensor, *others) -> None:
    for t in (prior, table, *others):
        if t.dtype != torch.float32:
            raise TypeError(f"expected float32 tables, got {t.dtype}")
    if table.ndim != 2:
        raise ValueError(f"expected a (rows, K) table, got shape "
                         f"{tuple(table.shape)}")
    for t in others:
        if t.shape != table.shape:
            raise ValueError(f"tables of shapes {tuple(table.shape)} and "
                             f"{tuple(t.shape)} differ")
    if prior.numel() != table.shape[1]:
        raise ValueError(f"a prior row of {prior.numel()} entries for "
                         f"{table.shape[1]} columns")
    for t in (table, *others):
        if t.stride(1) * max(t.shape[1] - 1, 0) >= 2 ** 31:
            raise ValueError("a table whose column offsets pass 2^31 "
                             "elements")
    for t in (prior, table, *others):
        if t.device.type != "cuda":
            raise ValueError(f"no kernel for device {t.device}")


def elbo_term(prior: torch.Tensor, post: torch.Tensor,
              elog: torch.Tensor) -> torch.Tensor:
    """The 0-d f32 ELBO term of a (G, K) posterior table against its prior
    row (K entries) and its Elog table (any strides), on the card.  CUDA
    tensors only: the plain version is ``ref.dirichlet_elbo_term``, which
    ``ops`` runs on the CPU."""
    _check(prior, post, elog)
    prior_terms, partials, row_terms, total, _ = _kernels()
    g, k = post.shape
    dev = post.device
    if g == 0:
        return torch.zeros((), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    prior = prior.reshape(-1).contiguous()
    plan = elbo_plan(g, k, transposed(elog), _n_sm(dev))
    (br, bk), c = plan.block, plan.chunks
    lgp = torch.empty((k,), dtype=torch.float32, device=dev)
    n_p = _cdiv(k, _P_BLOCK)
    psum = torch.empty((n_p,), dtype=torch.float64, device=dev)
    part = torch.empty((3, g, c), dtype=torch.float64, device=dev)
    prior_terms[(n_p,)](prior, lgp, psum, k, BLOCK=_P_BLOCK)
    partials[(_cdiv(g, br), c)](
        post, elog, prior, lgp, part, g, k, post.stride(0), post.stride(1),
        elog.stride(0), elog.stride(1), c, plan.chunk_cols, g * c,
        BLOCK_R=br, BLOCK_K=bk, num_warps=plan.warps)
    cp = max(2, _next_pow2(c))
    rr = max(1, 2048 // cp)
    nb = _cdiv(g, rr)
    blk = torch.empty((nb,), dtype=torch.float64, device=dev)
    row_terms[(nb,)](part, psum, blk, g, c, g * c, n_p, CP=cp,
                     PP=max(2, _next_pow2(n_p)), BLOCK_R=rr)
    total[(1,)](blk, out, nb, BLOCK=1024)
    trace.count("kernels.launches.dirichlet_elbo_term")
    trace.count(f"kernels.routes.dirichlet_elbo_term.{plan.route}")
    return out


def update(prior: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """The new (G, K) f32 posterior ``prior[k] + stats``, from a prior row
    of K entries and the contiguous (G, K) stats, on the card.  CUDA
    tensors only: the plain version is ``ref.dirichlet_update``."""
    if not stats.is_contiguous():
        raise ValueError("expected contiguous stats")
    _check(prior, stats)
    upd = _kernels()[4]
    g, k = stats.shape
    out = torch.empty((g, k), dtype=torch.float32, device=stats.device)
    if g == 0 or k == 0:
        return out
    upd[(_cdiv(g * k, _U_BLOCK),)](prior.reshape(-1).contiguous(), stats,
                                   out, g * k, k, BLOCK=_U_BLOCK)
    trace.count("kernels.launches.dirichlet_update")
    return out
