"""The benchmark's inputs, made on the device from ``--seed``.

:func:`make` draws a planted-LDA corpus, the process of the port's
``data.SyntheticCorpus`` vectorised for the card: topics ``phi_k ~
Dir(beta)`` over the vocabulary, per-document mixtures ``theta_d ~
Dir(alpha)``, Poisson document lengths (at least ``min_len``), a topic per
token from its document's mixture and a word from that topic.  Documents lie
back to back, so ``doc_ids`` never decreases.  With ``sentence_len`` in the
spec, each document is cut into consecutive sentences of that many tokens
(the last one may be shorter) and the topic is drawn once per sentence and
shared by all its words (SLDA's process, the paper's Figure 21).
:func:`initial_posteriors` makes the fit's starting point: each
Dirichlet's prior plus uniform(0.5, 1.5) noise, as the port's
``vmp.init_state`` does, drawn here so that the program and the reference
start from the same tensors.

Everything comes from a ``torch.Generator`` on the target device, in a few
large calls, so a seed gives the same inputs on the same device every time.
This module imports only torch.
"""

from __future__ import annotations

import torch

#: mixes a seed into the stream of the starting point, apart from the corpus
_INIT_SALT = 0x9E3779B97F4A7C15


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any whole number that
    fits 64 bits once mixed with ``salt``)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) ^ salt) % 2 ** 64)


def log_gamma(a: float, n: int, gen, device) -> torch.Tensor:
    """``(n,)`` float64 logs of Gamma(a, 1) draws: Marsaglia and Tsang's
    squeeze at shape ``a + 1``, then the boost ``U ** (1 / a)`` in log
    space, so draws at small shapes (0.05) do not underflow."""
    d = a + 1.0 - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        x = torch.randn(m, generator=gen, dtype=torch.float64, device=device)
        u = torch.rand(m, generator=gen, dtype=torch.float64, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out[todo[ok]] = torch.log(d * v[ok])
        todo = todo[~ok]
    u = torch.rand(n, generator=gen, dtype=torch.float64, device=device)
    return out + torch.log(u) / a


def dirichlet(conc: float, rows: int, dim: int, gen, device) -> torch.Tensor:
    """``(rows, dim)`` float64 draws of a symmetric Dirichlet(conc)."""
    lg = log_gamma(conc, rows * dim, gen, device).view(rows, dim)
    return torch.softmax(lg, dim=-1)


def _inverse_cdf(p: torch.Tensor) -> torch.Tensor:
    """Row CDFs of ``p``, each ending at exactly 1."""
    cdf = torch.cumsum(p, dim=-1)
    return (cdf / cdf[:, -1:]).clamp_(max=1.0)


def _sentences(lengths: torch.Tensor, size: int) -> tuple:
    """Each document cut into sentences of ``size`` tokens, the last one
    shorter: ``(sentences per document, sentence of each token, document
    of each sentence)``, the last two int64 and never decreasing."""
    device = lengths.device
    per_doc = (lengths + size - 1) // size
    first_tok = torch.cumsum(lengths, 0) - lengths
    first_sent = torch.cumsum(per_doc, 0) - per_doc
    docs = torch.repeat_interleave(
        torch.arange(len(lengths), device=device), lengths)
    pos = torch.arange(len(docs), device=device) - first_tok[docs]
    sent_ids = first_sent[docs] + pos // size
    sent_doc = torch.repeat_interleave(
        torch.arange(len(lengths), device=device), per_doc)
    return per_doc, sent_ids, sent_doc


def make(spec: dict, seed: int, device) -> dict:
    """The corpus of ``spec`` (``docs``, ``topics``, ``vocab``, ``alpha``,
    ``beta``, ``mean_len``, ``min_len``, and optionally ``sentence_len``)
    as int32 tensors on ``device``: ``tokens`` and ``doc_ids`` ``(N,)``;
    with ``sentence_len`` also ``sent_ids`` ``(N,)`` (token -> sentence)
    and ``sent_doc`` ``(S,)`` (sentence -> document)."""
    device = torch.device(device)
    gen = generator(seed, device)
    n_docs, k, v = int(spec["docs"]), int(spec["topics"]), int(spec["vocab"])
    phi = dirichlet(float(spec["beta"]), k, v, gen, device)
    theta = dirichlet(float(spec["alpha"]), n_docs, k, gen, device)
    lengths = torch.poisson(
        torch.full((n_docs,), float(spec["mean_len"]), dtype=torch.float64,
                   device=device), generator=gen).long().clamp_(
        min=int(spec.get("min_len", 2)))
    out = {}
    if spec.get("sentence_len") is None:
        # a topic for each position of each document, kept up to its length
        lmax = int(lengths.max())
        u = torch.rand((n_docs, lmax), generator=gen, dtype=torch.float64,
                       device=device)
        z = torch.searchsorted(_inverse_cdf(theta), u,
                               right=True).clamp_(max=k - 1)
        keep = torch.arange(lmax, device=device)[None, :] < lengths[:, None]
        z = z[keep]
    else:
        # a topic for each sentence of each document, shared by its words
        per_doc, sent_ids, sent_doc = _sentences(
            lengths, int(spec["sentence_len"]))
        smax = int(per_doc.max())
        u = torch.rand((n_docs, smax), generator=gen, dtype=torch.float64,
                       device=device)
        z = torch.searchsorted(_inverse_cdf(theta), u,
                               right=True).clamp_(max=k - 1)
        keep = torch.arange(smax, device=device)[None, :] < per_doc[:, None]
        z = z[keep][sent_ids]
        out = {"sent_ids": sent_ids.to(torch.int32),
               "sent_doc": sent_doc.to(torch.int32)}
        del per_doc, sent_ids, sent_doc
    del u, keep, theta
    # a word from its topic: one sorted search over the topics' CDFs laid
    # end to end (topic k's spans [k, k + 1])
    glob = (_inverse_cdf(phi) + torch.arange(k, dtype=torch.float64,
                                             device=device)[:, None]).view(-1)
    u = torch.rand(z.numel(), generator=gen, dtype=torch.float64,
                   device=device)
    words = torch.searchsorted(glob, z.double() + u, right=True) - z * v
    tokens = words.clamp_(0, v - 1).to(torch.int32)
    del glob, u, words, z, phi
    doc_ids = torch.repeat_interleave(
        torch.arange(n_docs, dtype=torch.int32, device=device), lengths)
    return {"tokens": tokens, "doc_ids": doc_ids, **out}


def initial_posteriors(dirichlets: dict, seed: int, device) -> dict:
    """The fit's starting point: for each Dirichlet ``{name: (rows, dim,
    prior)}``, in sorted name order, ``prior + uniform(0.5, 1.5)`` as a
    float32 ``(rows, dim)`` tensor on ``device``."""
    gen = generator(seed, device, _INIT_SALT)
    return {name: torch.rand((g, k), generator=gen, dtype=torch.float32,
                             device=device) + (0.5 + float(prior))
            for name, (g, k, prior) in sorted(dirichlets.items())}
