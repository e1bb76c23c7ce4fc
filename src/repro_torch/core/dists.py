"""Exponential-family primitives for the conjugate class InferSpark supports.

The port of ``repro.core.dists``: mixtures of Categorical distributions with
Dirichlet/Beta priors (paper section 8), in plain PyTorch.

  - Dirichlet expectations  E[log theta_k] = digamma(a_k) - digamma(sum a)
  - Dirichlet log-normalizer / KL (the per-node ELBO contribution)
  - Beta is Dirichlet with dim=2 throughout the stack.

The Triton kernel in ``repro_torch.kernels.dirichlet_expectation`` computes
:func:`dirichlet_expectation` on the GPU; callers go through
``repro_torch.kernels.ops``, which picks by the tensor's device.
"""

from __future__ import annotations

import torch

from ..kernels import ref


def dirichlet_expectation(alpha: torch.Tensor) -> torch.Tensor:
    """E_q[log theta] for rows of Dirichlet parameters.

    alpha: (..., K) positive concentration parameters.
    returns: (..., K)  digamma(alpha) - digamma(alpha.sum(-1, keepdim=True))
    """
    return torch.special.digamma(alpha) - torch.special.digamma(
        alpha.sum(dim=-1, keepdim=True))


def dirichlet_log_norm(alpha: torch.Tensor) -> torch.Tensor:
    """log B(alpha) = sum lgamma(alpha_k) - lgamma(sum alpha_k), rowwise."""
    return torch.lgamma(alpha).sum(dim=-1) - torch.lgamma(alpha.sum(dim=-1))


def dirichlet_elbo_term(prior: torch.Tensor, post: torch.Tensor,
                        elog: torch.Tensor | None = None) -> torch.Tensor:
    """E_q[log p(theta)] - E_q[log q(theta)] summed over rows.

    ``prior`` broadcasts against ``post`` (priors are usually symmetric
    scalars expanded lazily).  ``elog`` may be supplied to reuse an already
    computed expectation table.  The formula is the plain version of the
    card's kernel, ``kernels/ref.py:dirichlet_elbo_term``.
    """
    if elog is None:
        elog = dirichlet_expectation(post)
    return ref.dirichlet_elbo_term(prior, post, elog)


def categorical_entropy(r: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """-sum r log r with the 0 log 0 = 0 convention."""
    return -torch.sum(r * torch.log(torch.where(r > 0, r, 1.0)), dim=dim)


def softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """Numerically stable softmax over the trailing axis."""
    m = logits.max(dim=-1, keepdim=True).values.detach()
    e = torch.exp(logits - m)
    return e / e.sum(dim=-1, keepdim=True)
