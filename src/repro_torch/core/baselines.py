"""Baselines the paper compares against (the port of
``repro.core.baselines``).

- EM-LDA: the MLlib-style expectation-maximization LDA (paper section 5.1):
  point (MAP) estimates of theta/phi instead of full posteriors.  Faster per
  iteration and specific to LDA — exactly the paper's framing of MLlib vs
  InferSpark ("C++ programs vs DBMS").

Its two responsibility sums (per document, per word) are segment sums in a
fixed order (``svi.segment_index`` on the host, ``svi.segment_sum`` on the
device): no float scatter-add, so a run on the card is repeatable.  The
initial draws come from a ``torch.Generator`` seeded with ``seed``, not the
reference's threefry, so the two packages agree statistically only.
"""

from __future__ import annotations

import numpy as np
import torch

from .svi import segment_index, segment_sum
from .vmp import resolve_device


def em_lda(tokens: np.ndarray, doc_ids: np.ndarray, K: int, V: int,
           alpha: float = 0.1, beta: float = 0.1, iters: int = 20,
           seed: int = 0, device=None):
    """MAP EM for LDA; returns (theta (D,K), phi (K,V), log-lik trace), the
    tables as numpy float32 and the trace a list of floats.  ``device``
    (``None`` means ``"cuda"``) holds the tables."""
    device = resolve_device(device)
    D = int(np.max(doc_ids)) + 1
    toks = torch.from_numpy(np.asarray(tokens, np.int64)).to(device)
    docs = torch.from_numpy(np.asarray(doc_ids, np.int64)).to(device)
    by_doc = [torch.from_numpy(a).to(device)
              for a in segment_index(doc_ids, D)]
    by_word = [torch.from_numpy(a).to(device)
               for a in segment_index(tokens, V)]
    gen = torch.Generator(device=device).manual_seed(seed)

    def dirichlet(shape):
        g = torch._standard_gamma(torch.ones(shape, device=device),
                                  generator=gen)
        return g / g.sum(-1, keepdim=True)

    theta, phi = dirichlet((D, K)), dirichlet((K, V))
    trace = []
    for _ in range(iters):
        # E: responsibilities r_ik ∝ theta[d_i,k] * phi[k, w_i]
        p = theta[docs] * phi.T[toks]                    # (N, K)
        norm = p.sum(-1, keepdim=True)
        r = p / torch.clamp_min(norm, 1e-30)
        ll = torch.log(torch.clamp_min(norm[:, 0], 1e-30)).sum()
        # M: MAP with Dirichlet priors
        th = segment_sum(r, by_doc) + (alpha - 1.0)
        th = torch.clamp_min(th, 1e-9)
        theta = th / th.sum(-1, keepdim=True)
        ph = segment_sum(r, by_word).T + (beta - 1.0)
        ph = torch.clamp_min(ph, 1e-9)
        phi = ph / ph.sum(-1, keepdim=True)
        trace.append(float(ll))
    return theta.cpu().numpy(), phi.cpu().numpy(), trace
