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

  - a row-sum pass then an elementwise pass.  The row-sum pass gives a
    program a block of whole rows and loops over column blocks, so a row of
    any length (phi's V = 102,660) sums in a fixed order; the elementwise
    pass subtracts the row's digamma over 2-D tiles.  For theta's short rows
    (K = 100) both passes take blocks of 8 rows.  The TPU's 128-lane padding
    with 1.0 and its row-sum correction are gone: lanes past K are masked
    in the kernel.
  - the output is written through strides, so the same pass can emit a
    table transposed — the VMP step asks for phi as (V, K), the layout the
    ``zstats`` kernel reads, which puts one token's K-vector message in
    contiguous memory.
  - digamma is the TPU kernel's recurrence: shift by 8, then the asymptotic
    series, valid for x > 0 (concentrations always are).
  - sums run in a fixed order per program, so repeated calls are bitwise
    equal.

Input f32 or bf16, output f32 (narrow tables are upcast in registers).
"""

import functools

import torch

#: launches of the Triton kernel pair (one per wrapper call)
launches = 0

_MAX_BLOCK_K = 1024


@functools.lru_cache(maxsize=None)
def _kernels():
    """Import Triton and define the kernels, at the first launch: the CPU
    build of the port has no Triton.  Triton looks the names a kernel uses
    up in its module's globals when it compiles, so the imports bind there."""
    global triton, tl, _digamma
    import triton
    import triton.language as tl

    @triton.jit
    def _digamma(x):
        acc = tl.zeros_like(x)
        for _ in tl.static_range(8):
            acc = acc + 1.0 / x
            x = x + 1.0
        inv = 1.0 / x
        inv2 = inv * inv
        series = (tl.log(x) - 0.5 * inv
                  - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)))
        return series - acc

    @triton.jit
    def rowsum_digamma(a_ptr, dg_ptr, G, K, stride_ag,
                       BLOCK_R: tl.constexpr, BLOCK_K: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_K)
        rmask = rows < G
        # lane-wise partial sums in the loop, one tree reduction after it
        acc = tl.zeros((BLOCK_R, BLOCK_K), dtype=tl.float32)
        for k0 in range(0, K, BLOCK_K):
            c = k0 + cols
            m = rmask[:, None] & (c < K)[None, :]
            acc += tl.load(a_ptr + rows[:, None] * stride_ag + c[None, :],
                           mask=m, other=0.0).to(tl.float32)
        tl.store(dg_ptr + rows, _digamma(tl.sum(acc, axis=1)), mask=rmask)

    @triton.jit
    def elog(a_ptr, dg_ptr, out_ptr, G, K, stride_ag, stride_og, stride_ok,
             BLOCK_R: tl.constexpr, BLOCK_K: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_K + tl.arange(0, BLOCK_K)
        m = (rows < G)[:, None] & (cols < K)[None, :]
        a = tl.load(a_ptr + rows[:, None] * stride_ag + cols[None, :],
                    mask=m, other=1.0).to(tl.float32)
        dg = tl.load(dg_ptr + rows, mask=rows < G, other=0.0)
        out = _digamma(a) - dg[:, None]
        tl.store(out_ptr + rows[:, None] * stride_og + cols[None, :] * stride_ok,
                 out, mask=m)

    return rowsum_digamma, elog


def _check(alpha: torch.Tensor):
    if alpha.ndim != 2:
        raise ValueError(f"expected a (rows, K) table, got shape {tuple(alpha.shape)}")
    if alpha.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expected float32 or bfloat16, got {alpha.dtype}")
    if not alpha.is_contiguous():
        raise ValueError("expected a contiguous table")


def dirichlet_expectation(alpha: torch.Tensor,
                          transpose: bool = False) -> torch.Tensor:
    """f32 E[log theta] of a (G, K) concentration table on the card, as
    (G, K), or as (K, G) when ``transpose``.  CUDA tensors only: the plain
    version is ``ref.dirichlet_expectation``, which ``ops`` runs on the
    CPU."""
    global launches
    _check(alpha)
    if alpha.device.type != "cuda":
        raise ValueError(f"no kernel for device {alpha.device}")
    import triton
    rowsum_digamma, elog = _kernels()
    g, k = alpha.shape
    out = torch.empty((k, g) if transpose else (g, k), dtype=torch.float32,
                      device=alpha.device)
    if g == 0 or k == 0:
        return out
    so_g, so_k = (1, g) if transpose else (k, 1)
    bk = min(triton.next_power_of_2(k), _MAX_BLOCK_K)
    br = _MAX_BLOCK_K // bk
    dg = torch.empty((g,), dtype=torch.float32, device=alpha.device)
    rowsum_digamma[(triton.cdiv(g, br),)](alpha, dg, g, k, alpha.stride(0),
                                          BLOCK_R=br, BLOCK_K=bk)
    er, ek = (32, 64) if transpose else (br, bk)
    elog[(triton.cdiv(g, er), triton.cdiv(k, ek))](
        alpha, dg, out, g, k, alpha.stride(0), so_g, so_k,
        BLOCK_R=er, BLOCK_K=ek)
    launches += 1
    return out
