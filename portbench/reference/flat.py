"""Plain PyTorch VMP for a model with one flat latent: the yardstick that
decides ``correct``.

A flat latent ``z`` has one instance per token.  Its prior is a row of the
Dirichlet ``prior`` (``rows[i]``), and each child is an observed word whose
Dirichlet row under topic ``k`` is ``base[i] + stride * k`` (``base`` None:
row ``k``, as LDA's phi).  One step of coordinate ascent from posteriors
``post``:

    E[n]      = digamma(post[n]) - digamma(post[n].sum(-1))
    logits_ik = E[prior][rows_i, k] + sum_c E[c][row_c(i, k), value_c(i)]
    lse_i     = logsumexp_k logits_ik,   r_ik = exp(logits_ik - lse_i)
    stats     = the r-weighted counts of each Dirichlet's cells
    ELBO      = sum_i lse_i + sum_n KL-form term of Dirichlet n
    post'[n]  = prior_n + stats[n]

The ELBO is the exact bound at ``post`` (the responsibilities at their
optimum).  Tables and per-token arithmetic are float32, as the
configuration states; every sum over tokens or cells (the stats, the
logsumexp total, the Dirichlet terms) runs in float64, so the reference's
own rounding stays far below the program's.  Tokens go in blocks of
``block``, Dirichlet terms in blocks of rows, so a corpus of 10^8 tokens
fits beside nothing else on the card.  Imports only torch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class Child(NamedTuple):
    """An observed child: its Dirichlet, its value per token, and the row
    of that Dirichlet it reads under topic k: ``base + stride * k``."""
    dirichlet: str
    values: torch.Tensor
    base: Optional[torch.Tensor] = None
    stride: int = 1


class FlatModel(NamedTuple):
    """Dirichlets ``{name: (rows, dim, symmetric prior)}``, the latent's
    prior Dirichlet and row per token, and its children."""
    dirichlets: dict
    prior: str
    rows: torch.Tensor
    children: tuple


#: faults a reference step can plant (the check's upper readings):
#: "half" leaves out every other token and doubles the rest's sums, "topic"
#: doubles the child stats of topic 0 where they are produced
FAULTS = ("half", "topic")


def elog(post: torch.Tensor) -> torch.Tensor:
    """E[log theta] rowwise, float32."""
    return torch.special.digamma(post) - torch.special.digamma(
        post.sum(-1, keepdim=True))


def dirichlet_term(prior: float, post: torch.Tensor, e: torch.Tensor,
                   block_rows: int) -> torch.Tensor:
    """``log B(post) - log B(prior) + sum (prior - post) E`` summed over
    rows, in float64, ``block_rows`` rows at a time."""
    g, k = post.shape
    p0 = torch.tensor(float(prior), dtype=torch.float64)
    prior_norm = float(k * torch.lgamma(p0) - torch.lgamma(k * p0))
    total = torch.zeros((), dtype=torch.float64, device=post.device)
    for s in range(0, g, block_rows):
        p = post[s:s + block_rows].double()
        ev = e[s:s + block_rows].double()
        total += (torch.lgamma(p).sum() - torch.lgamma(p.sum(-1)).sum()
                  - p.shape[0] * prior_norm + ((float(prior) - p) * ev).sum())
    return total


def step(model: FlatModel, post: dict, block: int = 1 << 22,
         fault: Optional[str] = None) -> tuple:
    """One VMP step from ``post`` (``{name: (rows, dim) float32}``):
    ``(ELBO at post as a float, {name: new float32 posterior})``."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, not {fault!r}")
    e = {n: elog(p) for n, p in post.items()}
    stats = {n: torch.zeros(p.numel(), dtype=torch.float64, device=p.device)
             for n, p in post.items()}
    k = post[model.prior].shape[1]
    kk = torch.arange(k, device=model.rows.device)
    n_tok = model.rows.numel()
    weight = 2.0 if fault == "half" else 1.0
    lse_total = torch.zeros((), dtype=torch.float64, device=model.rows.device)
    for s in range(0, n_tok, block):
        sl = slice(s, min(s + block, n_tok), 2 if fault == "half" else 1)
        rows = model.rows[sl].long()
        logits = e[model.prior][rows]
        cells = []
        for c in model.children:
            v = c.values[sl].long()
            width = post[c.dirichlet].shape[1]
            if c.base is None and c.stride == 1:
                logits = logits + e[c.dirichlet][:, v].T
                crow = kk[None, :].expand(len(v), k)
            else:
                crow = c.base[sl].long()[:, None] + c.stride * kk[None, :]
                logits = logits + e[c.dirichlet][crow, v[:, None]]
            cells.append(crow * width + v[:, None])
        lse = torch.logsumexp(logits, dim=-1)
        r = torch.exp(logits - lse[:, None]).double() * weight
        lse_total += lse.double().sum() * weight
        del logits
        stats[model.prior].view(-1, k).index_add_(0, rows, r)
        for c, cell in zip(model.children, cells):
            stats[c.dirichlet].index_add_(0, cell.reshape(-1), r.reshape(-1))
    if fault == "topic":
        for c in model.children:
            stats[c.dirichlet].view(post[c.dirichlet].shape)[::k] *= 2.0
    elbo = lse_total
    new = {}
    for n, p in post.items():
        prior = float(model.dirichlets[n][2])
        elbo = elbo + dirichlet_term(prior, p, e[n],
                                     max(1, (1 << 24) // p.shape[1]))
        new[n] = (stats[n].view(p.shape) + prior).float()
    return float(elbo), new
