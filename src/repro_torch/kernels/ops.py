"""Dispatch layer over the port's kernels.

Dispatch goes by the tensor's device, never by an environment variable, and
this module is the one place that looks: a CPU tensor runs the plain PyTorch
version from ``ref.py``, any other tensor goes to the Hopper kernel's
wrapper (CUDA C++ for ``zstats``, Triton for ``dirichlet_expectation`` and
``zstep``).  The wrappers take CUDA tensors only and raise on any other
device, and a CUDA call that no kernel of this slice covers raises
``NotImplementedError``: nothing on the card falls back to a plain version.
Each kernel module keeps a plain integer count of its launches
(``<module>.launches``).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import dirichlet_expectation as _de
from . import fused_zstats as _fz
from . import ref
from . import vmp_zstep as _zs
from .ref import ZChild


def _plain(t: torch.Tensor) -> bool:
    """True where the plain version runs: on a CPU tensor."""
    return t.device.type == "cpu"


def dirichlet_expectation(alpha: torch.Tensor,
                          transpose: bool = False) -> torch.Tensor:
    """Rowwise expected log under a Dirichlet: ``digamma(alpha) -
    digamma(alpha.sum(-1, keepdim=True))`` of a ``(G, K)`` concentration
    table (f32 or bf16), as float32 ``(G, K)``, or ``(K, G)`` when
    ``transpose``.  The VMP step's Elog tables, which the token plate, the
    statics and the Dirichlet ELBO terms share."""
    if not _plain(alpha):
        return _de.dirichlet_expectation(alpha, transpose)
    out = ref.dirichlet_expectation(alpha.float())
    return out.T.contiguous() if transpose else out


def zstep(logits: torch.Tensor):
    """Rowwise softmax with its normalizer: ``(r, lse)`` where ``r`` is the
    ``(N, K)`` float32 responsibilities ``softmax(logits, -1)`` and ``lse``
    the ``(N,)`` float32 ``logsumexp(logits, -1)``."""
    return ref.zstep(logits) if _plain(logits) else _zs.zstep(logits)


def zstats_plan(table_prior, prior_rows, children) -> Optional[_fz.ZPlan]:
    """The ``zstats`` kernel's host-side owner plan for these static index
    streams, on their device; ``None`` where no kernel runs (CPU tensors,
    or segment latents, which the kernel does not take).  ``None`` is always
    safe to pass back as ``zstats(..., plan=)``."""
    if _plain(table_prior) or any(c.zmap is not None for c in children):
        return None
    return _fz.build_plan(prior_rows, children,
                          tuple(table_prior.shape)).to(table_prior.device)


def zstats(table_prior: torch.Tensor, prior_rows: torch.Tensor,
           children: tuple, zmask=None, *, tables: str = "elog", plan=None):
    """Fused token-plate substep: ``(lse_sum, prior_stats, child_stats)``.

    Inputs: ``table_prior`` — the ``(G, K)`` prior-Dirichlet table;
    ``prior_rows`` — ``(N,) int32`` row of each latent instance;
    ``children`` — a tuple of :class:`ZChild`; ``zmask`` — optional
    ``(n_latent,) float32`` validity mask.  With ``tables="elog"`` the
    tables hold Elog expectations; with ``tables="alpha"`` they hold
    Dirichlet concentrations (f32 or bf16) and the expectations are
    computed first.  Returns the scalar float32 sum of per-instance
    logsumexp, the ``(G, K)`` float32 prior stats, and per child a
    ``(Gc, Kc)`` float32 stats table.  ``plan`` — an optional
    :func:`zstats_plan` result, cached per program by ``core/vmp.py``.

    On the CPU this is ``ref.zstats`` (flat and segment latents).  On CUDA
    flat latents run the ``csrc/zstats.cu`` kernel; segment latents raise
    until the ``fused_zmap`` slice.
    """
    if _plain(table_prior):
        return ref.zstats(table_prior, prior_rows, children, zmask,
                          tables=tables)
    return _fz.zstats(table_prior, prior_rows, children, zmask,
                      tables=tables, plan=plan)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    _de.launches = _fz.launches = _zs.launches = 0


def launch_counts() -> dict:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    return {"zstats": _fz.launches, "dirichlet_expectation": _de.launches,
            "zstep": _zs.launches}


__all__ = ["ZChild", "dirichlet_expectation", "zstep", "zstats",
           "zstats_plan", "reset_launch_counts", "launch_counts"]
