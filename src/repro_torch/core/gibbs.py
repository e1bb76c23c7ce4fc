"""Gibbs sampling for LDA — the paper's named future work, in PyTorch.

The port of ``repro.core.gibbs``.  Section 2.3 of the paper excludes MCMC
because "sharing a single random number generator across the nodes in a
cluster is a serious performance bottleneck [and] different generators on
different nodes would risk the correctness".  The port draws every sweep
from one counter-based Philox ``torch.Generator`` on the device, seeded
from ``seed``: the same seed gives bitwise the same chain.  Its draws are
not the reference's threefry ones, so the two packages agree statistically
only.

The blocked (uncollapsed) Gibbs sweep mirrors the VMP schedule:

    z_i | theta, phi  ~ Cat(theta[d_i] * phi[:, w_i])    (parallel per token)
    theta_d | z       ~ Dir(alpha + counts_d)            (parallel per doc)
    phi_k | z, x      ~ Dir(beta + counts_k)             (parallel per topic)

The categorical is a Gumbel-max argmax over ``log theta[d_i] + log phi[:,
w_i]``, and the counts are integer ``bincount``s, exact and in no order.
The (tokens, K) logits, noise and likelihood terms are made CHUNK tokens at
a time, and the posterior means are running sums over the kept sweeps (the
keep flag is known on the host), so a sweep's memory is O(CHUNK K + D K +
K V), not O(N K) per sweep kept.
"""

from __future__ import annotations

import numpy as np
import torch

from .vmp import resolve_device

CHUNK = 1 << 21                 # tokens per chunk of the z draw and the LL


def _dirichlet(gen: torch.Generator, conc: torch.Tensor) -> torch.Tensor:
    """One Dirichlet draw per row of ``conc``: normalized Gamma draws."""
    g = torch._standard_gamma(conc, generator=gen)
    return g / g.sum(-1, keepdim=True)


def gibbs_lda(tokens, doc_ids, K: int, V: int, alpha: float = 0.1,
              beta: float = 0.05, iters: int = 200, burnin: int = 100,
              seed: int = 0, thin: int = 1, return_conc: bool = False,
              device=None, on_sweep=None):
    """Returns posterior-mean estimates (theta (D,K), phi (K,V)) and the
    per-iteration complete-data log-likelihood trace, as numpy (float32).

    With ``return_conc=True`` a fourth value is appended: the posterior-mean
    Dirichlet *concentrations* ``(alpha + E[cnt_d], beta + E[cnt_k])`` over
    the kept sweeps — the sampling-backend analogue of the variational
    engines' posterior concentration tables, which is what the query
    layer's fold-in scorer consumes (``repro_torch.query``).  ``device``
    (``None`` means ``"cuda"``) holds the chain; ``on_sweep(it, cnt_d,
    cnt_k)``, if given, sees each sweep's integer count tables."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    tok = torch.from_numpy(np.asarray(tokens, np.int64)).to(device)
    docs = torch.from_numpy(np.asarray(doc_ids, np.int64)).to(device)
    n = tok.shape[0]
    d = int(np.max(doc_ids)) + 1

    theta = _dirichlet(gen, torch.full((d, K), alpha + 1.0, device=device))
    phi = _dirichlet(gen, torch.full((K, V), beta + 1.0, device=device))
    keep = [it >= burnin and (it - burnin) % thin == 0 for it in range(iters)]
    denom = float(max(sum(keep), 1))
    # running sums over the kept sweeps: theta, phi and, with return_conc,
    # their concentrations (nothing kept: zero means, as in the reference)
    sums = [torch.zeros_like(theta), torch.zeros_like(phi)] * (
        2 if return_conc else 1)
    lls = []
    z = torch.empty(n, dtype=torch.int64, device=device)
    for it in range(iters):
        # z | theta, phi — one Gumbel-max categorical per token
        log_theta, log_phi_t = torch.log(theta), torch.log(phi).T.contiguous()
        for s in range(0, n, CHUNK):
            logits = log_theta[docs[s:s + CHUNK]] + log_phi_t[tok[s:s + CHUNK]]
            u = torch.rand(logits.shape, generator=gen, device=device)
            z[s:s + CHUNK] = torch.argmax(logits - torch.log(-torch.log(u)),
                                          dim=-1)
            del logits, u
        cnt_d = torch.bincount(docs * K + z, minlength=d * K).reshape(d, K)
        cnt_k = torch.bincount(z * V + tok, minlength=K * V).reshape(K, V)
        if on_sweep is not None:
            on_sweep(it, cnt_d, cnt_k)
        # theta | z, phi | z, x
        conc_d = alpha + cnt_d.float()
        conc_k = beta + cnt_k.float()
        theta = _dirichlet(gen, conc_d)
        phi = _dirichlet(gen, conc_k)
        phi_t = phi.T.contiguous()
        ll = torch.zeros((), dtype=torch.float32, device=device)
        for s in range(0, n, CHUNK):
            p = (theta[docs[s:s + CHUNK]] * phi_t[tok[s:s + CHUNK]]).sum(-1)
            ll = ll + torch.log(torch.clamp_min(p, 1e-30)).sum()
        lls.append(ll)
        if keep[it]:
            now = [theta, phi, conc_d, conc_k]
            sums = [a + b for a, b in zip(sums, now)]
    means = [(t / denom).cpu().numpy() for t in sums]
    lls = torch.stack(lls).cpu().numpy() if lls else np.zeros(0, np.float32)
    if return_conc:
        return means[0], means[1], lls, (means[2], means[3])
    return means[0], means[1], lls
