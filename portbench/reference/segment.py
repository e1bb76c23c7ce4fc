"""Plain PyTorch VMP for a model with one segment latent: the yardstick
that decides ``correct`` where a latent instance owns a run of tokens (a
sentence, as in SLDA, or a document, as in naive Bayes).

Instance ``s`` of the latent has its prior in row ``rows[s]`` of the
Dirichlet ``prior``; token ``i`` belongs to instance ``seg[i]`` (never
decreasing, so an instance's tokens lie together), and each child is an
observed word whose Dirichlet row under topic ``k`` is ``base[i] +
stride * k`` (``reference.flat.Child``).  One step of coordinate ascent
from posteriors ``post``:

    E[n]      = digamma(post[n]) - digamma(post[n].sum(-1))
    logits_sk = E[prior][rows_s, k] + sum_{i: seg_i = s} sum_c
                E[c][row_c(i, k), value_c(i)]
    lse_s     = logsumexp_k logits_sk,   r_sk = exp(logits_sk - lse_s)
    stats     = r_s at prior row rows_s; r_{seg_i} at each child's cell of
                token i
    ELBO      = sum_s lse_s + sum_n KL-form term of Dirichlet n
    post'[n]  = prior_n + stats[n]

Tables are float32, as the configuration states (``flat.elog``); every sum
over tokens, instances or cells (the messages of an instance, its
logsumexp and responsibilities, the stats, the Dirichlet terms) runs in
float64, so the reference's own rounding stays far below the program's.
Instances go in blocks of whole instances, about ``block`` tokens each, so
neither the (S, K) logits nor the (N, K) messages are ever whole.  Imports
only torch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reference.flat import dirichlet_term, elog

#: faults a reference step can plant (the check's upper readings):
#: "half" leaves out every other instance and doubles the rest's sums,
#: "topic" doubles the child stats of topic 0 where they are produced
FAULTS = ("half", "topic")


class SegmentModel(NamedTuple):
    """Dirichlets ``{name: (rows, dim, symmetric prior)}``, the latent's
    prior Dirichlet and row per instance, the instance of each token, and
    the children (``reference.flat.Child``, one value per token)."""
    dirichlets: dict
    prior: str
    rows: torch.Tensor
    seg: torch.Tensor
    children: tuple


def _cells(c, v, tok: slice, k: int, width: int) -> torch.Tensor:
    """``(T, K)`` flat cell of each token of the block under each topic."""
    kk = torch.arange(k, device=v.device)
    base = 0 if c.base is None else c.base[tok].long()[:, None]
    return (base + c.stride * kk[None, :]) * width + v[:, None]


def step(model: SegmentModel, post: dict, block: int = 1 << 22,
         fault: Optional[str] = None) -> tuple:
    """One VMP step from ``post`` (``{name: (rows, dim) float32}``):
    ``(ELBO at post as a float, {name: new float32 posterior})``."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, not {fault!r}")
    e = {n: elog(p) for n, p in post.items()}
    stats = {n: torch.zeros(p.numel(), dtype=torch.float64, device=p.device)
             for n, p in post.items()}
    k = post[model.prior].shape[1]
    n_inst, n_tok = model.rows.numel(), model.seg.numel()
    device = model.rows.device
    seg = model.seg.long()
    # the first token of each block of whole instances
    per = max(1, block * n_inst // max(n_tok, 1))
    starts = list(range(0, n_inst, per))
    firsts = torch.searchsorted(
        seg, torch.tensor(starts + [n_inst], device=device)).tolist()
    lse_total = torch.zeros((), dtype=torch.float64, device=device)
    for s0, t0, t1 in zip(starts, firsts, firsts[1:]):
        s1 = min(s0 + per, n_inst)
        tok = slice(t0, t1)
        local = seg[tok] - s0
        rows = model.rows[s0:s1].long()
        logits = e[model.prior][rows].double()
        cells = []
        for c in model.children:
            v = c.values[tok].long()
            width = post[c.dirichlet].shape[1]
            cell = _cells(c, v, tok, k, width)
            logits.index_add_(0, local, e[c.dirichlet].view(-1)[cell]
                              .double())
            cells.append(cell)
        lse = torch.logsumexp(logits, dim=-1)
        r = torch.exp(logits - lse[:, None])
        del logits
        if fault == "half":
            keep = torch.arange(s0, s1, device=device) % 2 == 0
            lse = lse * keep * 2.0
            r = r * (keep * 2.0)[:, None]
        lse_total += lse.sum()
        stats[model.prior].view(-1, k).index_add_(0, rows, r)
        r_tok = r[local]
        for c, cell in zip(model.children, cells):
            stats[c.dirichlet].index_add_(0, cell.reshape(-1),
                                          r_tok.reshape(-1))
        del r, r_tok, cells
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
