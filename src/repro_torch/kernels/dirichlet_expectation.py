"""Triton kernel: rowwise Dirichlet log-expectation, for Hopper.

    E[log theta]_gk = digamma(alpha_gk) - digamma(sum_k alpha_gk)

Replaces the Pallas TPU kernel
``repro/kernels/dirichlet_expectation.py:dirichlet_expectation`` (its
``_kernel`` and ``_digamma``).  The VMP step runs it once per Dirichlet
table, theta (D, K) and phi (K, V), and the token plate, the statics and
the Dirichlet ELBO terms all read that one table (``core/vmp.py``).  It is
also the Elog pre-pass of ``fused_zstats.zstats`` with ``tables="alpha"``,
and ``latent_responsibilities`` runs it.

Bound on the H100: bytes.  Each element is read once and written once
(8 bytes) against some 30 f32 operations of digamma, far below the card's
ratio of operations to bytes, so the least time is the table's traffic over
3.35 TB/s.  Design:

  - a row-sum pass then an elementwise pass.  The row-sum pass cuts each
    row into chunks of whole column blocks (:func:`row_chunks`) and gives
    a program a block of rows and one chunk, so that a few long rows (phi's
    100 rows of V = 102,660) still fill the card; each program sums its
    chunk in a fixed order and writes one partial per row.  The
    elementwise pass adds a row's chunk partials in a fixed order (a tree
    over the padded partials), takes its digamma and subtracts it over its
    tile, so repeated calls are bitwise equal.  For theta's short rows
    (K = 100) a row is one chunk and both passes take blocks of 8 rows.
    The TPU's 128-lane padding with 1.0 and its row-sum correction are gone:
    lanes past K are masked in the kernel.
  - the output is written through strides, so the same pass can emit a
    table transposed, as the VMP step asks for phi: (V, K), the layout the
    ``zstats`` kernel reads.  A transposed tile is 8 rows by 256 columns,
    so each column's 8 outputs are one 32-byte run.
  - digamma is the TPU kernel's recurrence: shift by 8, then the asymptotic
    series, valid for x > 0 (concentrations always are).  The shift's eight
    reciprocals are taken as four pairs, 1/x + 1/(x+1) = (2x+1)/(x(x+1)),
    each an approximate division (2 ulp): the elementwise pass is bound by
    its instructions as much as by its bytes.

Input f32 or bf16, output f32 (narrow tables are upcast in registers).
"""

import functools

import torch

from .. import trace

_MAX_BLOCK_K = 1024
#: row-sum programs to aim for, per SM
_WAVES = 8
#: most chunks a row is cut into: every program of the elementwise pass
#: loads its rows' partials padded to a power of two, and with 64 a row
#: that pass ran some 25 times slower on phi (PERF.md)
_MAX_CHUNKS = 16
#: (rows, columns) and warps of a tile of a transposed table
_T_TILE, _T_WARPS = (8, 256), 4


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def _blocks(k: int) -> tuple:
    """(rows, columns) of a row-sum program's block for rows of length k."""
    bk = min(_next_pow2(k), _MAX_BLOCK_K)
    return _MAX_BLOCK_K // bk, bk


def chunk_plan(g: int, k: int, block: tuple, n_sm: int = 132,
               max_chunks: int = _MAX_CHUNKS) -> tuple:
    """``(chunks, chunk columns)`` of a pass over a (g, k) table whose
    programs each take a ``block`` of (rows, columns) tiles and one chunk
    of a row: each row is cut into ``chunks`` runs of ``chunk columns``
    (whole column blocks; the last run shorter), the shortest runs that
    keep the count within the chunks that give ``_WAVES`` programs per SM
    over the card's ``n_sm`` SMs, and within ``max_chunks``."""
    br, bk = block
    blocks = -(-k // bk)
    want = -(-_WAVES * n_sm // -(-g // br))
    per = -(-blocks // max(1, min(want, blocks, max_chunks)))
    return -(-blocks // per), per * bk


def row_chunks(g: int, k: int, n_sm: int = 132) -> tuple:
    """``(chunks, chunk columns)`` of the row-sum pass over a (g, k) table
    (:func:`chunk_plan` over its blocks)."""
    return chunk_plan(g, k, _blocks(k), n_sm)


@functools.lru_cache(maxsize=None)
def _kernels():
    """Import Triton and define the kernels, at the first launch: the CPU
    build of the port has no Triton.  Triton looks the names a kernel uses
    up in its module's globals when it compiles, so the imports bind there."""
    global triton, tl, _digamma, _row_digamma
    import triton
    import triton.language as tl

    @triton.jit
    def _digamma(x):
        acc = tl.zeros_like(x)
        for _ in tl.static_range(4):
            y = x + 1.0
            acc = acc + tl.fdiv(x + y, x * y, ieee_rounding=False)
            x = y + 1.0
        inv = tl.fdiv(1.0, x, ieee_rounding=False)
        inv2 = inv * inv
        series = (tl.log(x) - 0.5 * inv
                  - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)))
        return series - acc

    @triton.jit
    def _row_digamma(part_ptr, rows, rmask, C, CP: tl.constexpr):
        # digamma of each row's sum: its C chunk partials added by one tree
        # over the CP (>= C, zero-padded) slots, the same in every program
        c = tl.arange(0, CP)
        p = tl.load(part_ptr + rows[:, None] * C + c[None, :],
                    mask=rmask[:, None] & (c < C)[None, :], other=0.0)
        return _digamma(tl.sum(p, axis=1))

    @triton.jit
    def rowsum(a_ptr, part_ptr, G, K, stride_ag, C, CHUNK,
               BLOCK_R: tl.constexpr, BLOCK_K: tl.constexpr):
        # rows of program axis 0, columns CHUNK * c .. of chunk c (axis 1)
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        chunk = tl.program_id(1)
        cols = tl.arange(0, BLOCK_K)
        rmask = rows < G
        lo = chunk * CHUNK
        hi = tl.minimum(lo + CHUNK, K)
        # lane-wise partial sums in the loop, one tree reduction after it
        acc = tl.zeros((BLOCK_R, BLOCK_K), dtype=tl.float32)
        for k0 in range(lo, hi, BLOCK_K):
            c = k0 + cols
            m = rmask[:, None] & (c < hi)[None, :]
            acc += tl.load(a_ptr + rows[:, None] * stride_ag + c[None, :],
                           mask=m, other=0.0).to(tl.float32)
        tl.store(part_ptr + rows * C + chunk, tl.sum(acc, axis=1), mask=rmask)

    @triton.jit
    def elog(a_ptr, part_ptr, out_ptr, G, K, stride_ag, stride_og, stride_ok,
             C, CP: tl.constexpr, BLOCK_R: tl.constexpr,
             BLOCK_K: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_K + tl.arange(0, BLOCK_K)
        rmask = rows < G
        m = rmask[:, None] & (cols < K)[None, :]
        a = tl.load(a_ptr + rows[:, None] * stride_ag + cols[None, :],
                    mask=m, other=1.0).to(tl.float32)
        dg = _row_digamma(part_ptr, rows, rmask, C, CP)
        out = _digamma(a) - dg[:, None]
        tl.store(out_ptr + rows[:, None] * stride_og + cols[None, :] * stride_ok,
                 out, mask=m)

    return rowsum, elog


def _check(alpha: torch.Tensor):
    if alpha.ndim != 2:
        raise ValueError(f"expected a (rows, K) table, got shape {tuple(alpha.shape)}")
    if alpha.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16, got {alpha.dtype}")
    if not alpha.is_contiguous():
        raise ValueError("expected a contiguous table")


def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def row_sums(alpha: torch.Tensor) -> torch.Tensor:
    """The row-sum pass: the (G, chunks) f32 chunk partials of each row of a
    non-empty (G, K) table on the card (:func:`row_chunks`)."""
    rowsum = _kernels()[0]
    g, k = alpha.shape
    c, chunk = row_chunks(g, k, _n_sm(alpha.device))
    br, bk = _blocks(k)
    part = torch.empty((g, c), dtype=torch.float32, device=alpha.device)
    rowsum[(-(-g // br), c)](alpha, part, g, k, alpha.stride(0), c, chunk,
                             BLOCK_R=br, BLOCK_K=bk)
    return part


def elog_from_sums(alpha: torch.Tensor, part: torch.Tensor,
                   transpose: bool = False) -> torch.Tensor:
    """The elementwise pass: E[log theta] of a non-empty (G, K) table from
    its :func:`row_sums` partials, as (G, K) or, ``transpose``, (K, G)."""
    elog = _kernels()[1]
    g, k = alpha.shape
    c = part.shape[1]
    out = torch.empty((k, g) if transpose else (g, k), dtype=torch.float32,
                      device=alpha.device)
    (er, ek), warps = (_T_TILE, _T_WARPS) if transpose else (_blocks(k), 4)
    so_g, so_k = (1, g) if transpose else (k, 1)
    elog[(-(-g // er), -(-k // ek))](
        alpha, part, out, g, k, alpha.stride(0), so_g, so_k, c,
        CP=max(2, _next_pow2(c)), BLOCK_R=er, BLOCK_K=ek, num_warps=warps)
    return out


def dirichlet_expectation(alpha: torch.Tensor,
                          transpose: bool = False) -> torch.Tensor:
    """f32 E[log theta] of a (G, K) concentration table on the card, as
    (G, K), or as (K, G) when ``transpose``.  CUDA tensors only: the plain
    version is ``ref.dirichlet_expectation``, which ``ops`` runs on the
    CPU."""
    _check(alpha)
    if alpha.device.type != "cuda":
        raise ValueError(f"no kernel for device {alpha.device}")
    g, k = alpha.shape
    if g == 0 or k == 0:
        return torch.empty((k, g) if transpose else (g, k),
                           dtype=torch.float32, device=alpha.device)
    out = elog_from_sums(alpha, row_sums(alpha), transpose)
    trace.count("kernels.launches.dirichlet_expectation")
    return out
