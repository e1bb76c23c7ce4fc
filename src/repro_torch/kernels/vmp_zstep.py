"""Triton kernel: fused latent-Categorical update (the VMP z-substep).

Given summed messages ``logits`` (N, K) this computes, in one pass:

    r   = softmax(logits, axis=-1)        (the new responsibilities q(z))
    lse = logsumexp(logits, axis=-1)      (the per-instance ELBO term)

Replaces the Pallas TPU kernel ``repro/kernels/vmp_zstep.py:zstep`` (its
``_kernel``).  Callers: ``core/vmp.py:latent_responsibilities``, which is
what ``Model["z"].get_result()`` runs.

Bound on the H100: bytes.  Each logit is read once and each responsibility
written once (8 bytes per element, plus 4 per row for lse) against a handful
of operations.  Design: one program owns ``BLOCK_N`` whole rows, held in
registers, so max, exp, sum and the division need no second read; the lanes
at K and above are masked inside the kernel (the TPU's -1e30 padding in
memory is gone).  K is a compile-time constant, so the compiler knows each
row's alignment and can widen its loads.  Row offsets are 64-bit, since
N * K nears 2^31 at the main path's size.
"""

import functools

import torch

from .. import trace

_MAX_K = 8192


@functools.lru_cache(maxsize=None)
def _kernel():
    """Import Triton and define the kernel, at the first launch: the CPU
    build of the port has no Triton.  Triton looks the names a kernel uses
    up in its module's globals when it compiles, so the imports bind there."""
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def zstep_kernel(x_ptr, r_ptr, lse_ptr, N, K: tl.constexpr,
                     BLOCK_N: tl.constexpr, BLOCK_K: tl.constexpr):
        rows = tl.program_id(0).to(tl.int64) * BLOCK_N + tl.arange(0, BLOCK_N)
        cols = tl.arange(0, BLOCK_K)
        rmask = rows < N
        m = rmask[:, None] & (cols < K)[None, :]
        offs = rows[:, None] * K + cols[None, :]
        x = tl.load(x_ptr + offs, mask=m, other=float("-inf"))
        mx = tl.max(x, axis=1)
        mx = tl.where(rmask, mx, 0.0)
        e = tl.exp(x - mx[:, None])
        s = tl.sum(e, axis=1)
        tl.store(r_ptr + offs, e / s[:, None], mask=m)
        tl.store(lse_ptr + rows, mx + tl.log(s), mask=rmask)

    return zstep_kernel


def zstep(logits: torch.Tensor):
    """Rowwise ``(softmax, logsumexp)`` of (N, K) float32 logits on the
    card.  CUDA tensors only: the plain version is ``ref.zstep``, which
    ``ops`` runs on the CPU."""
    if logits.ndim != 2:
        raise ValueError(f"expected (N, K) logits, got shape {tuple(logits.shape)}")
    if logits.dtype != torch.float32:
        raise TypeError(f"expected float32 logits, got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("expected contiguous logits")
    if logits.device.type != "cuda":
        raise ValueError(f"no kernel for device {logits.device}")
    n, k = logits.shape
    if k > _MAX_K:
        raise ValueError(f"zstep kernel takes K <= {_MAX_K}, got {k}")
    import triton
    kernel = _kernel()
    r = torch.empty_like(logits)
    lse = torch.empty((n,), dtype=torch.float32, device=logits.device)
    if n == 0 or k == 0:
        return r, lse
    bk = triton.next_power_of_2(k)
    bn = max(1, min(64, 4096 // bk))
    kernel[(triton.cdiv(n, bn),)](logits, r, lse, n, k,
                                  BLOCK_N=bn, BLOCK_K=bk,
                                  num_warps=4 if bk <= 1024 else 8)
    trace.count("kernels.launches.zstep")
    return r, lse
