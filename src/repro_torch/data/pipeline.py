"""Deterministic data generation: the port's copies of ``SyntheticCorpus``
and ``TokenStream``.

:class:`SyntheticCorpus` is a topic-mixture document generator (planted
topics over a vocabulary, Poisson document lengths) and :class:`TokenStream`
gives packed LM training batches, seekable by step.  Both are copied op for
op from ``repro.data.pipeline`` so that the same seed gives the same corpus
and the same batches, bit for bit, in both packages.  Everything is numpy on
the host; device placement happens in the runtime and the trainer.  The
samplers and the sharded store arrive with the SVI slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    """Planted-topic corpus: theta_d ~ Dir(alpha), phi_k ~ Dir(beta).

    ``generate()`` returns a dict of numpy arrays — ``tokens`` and
    ``doc_ids`` ``(N,) int32`` (documents stored back to back, doc ids
    nondecreasing), ``lengths`` ``(n_docs,) int64``, ``z`` ``(N,) int32``
    planted topic per token, and the planted distributions ``true_phi``
    ``(n_topics, vocab)`` / ``true_theta`` ``(n_docs, n_topics)`` float64 —
    deterministic in ``seed``.
    """
    n_docs: int
    vocab: int
    n_topics: int
    alpha: float = 0.1
    beta: float = 0.05
    mean_len: int = 120
    seed: int = 0

    def generate(self):
        rng = np.random.default_rng(self.seed)
        phi = rng.dirichlet(np.full(self.vocab, self.beta), size=self.n_topics)
        theta = rng.dirichlet(np.full(self.n_topics, self.alpha),
                              size=self.n_docs)
        lengths = np.maximum(
            rng.poisson(self.mean_len, size=self.n_docs), 2).astype(np.int64)
        n = int(lengths.sum())
        doc_ids = np.repeat(np.arange(self.n_docs, dtype=np.int32), lengths)
        z = np.empty(n, np.int32)
        start = 0
        for d, ln in enumerate(lengths):
            z[start:start + ln] = rng.choice(self.n_topics, size=ln,
                                             p=theta[d])
            start += ln
        # vectorized word draw: inverse-cdf per token against its topic row
        cdf = np.cumsum(phi, axis=1)
        u = rng.random(n)
        tokens = np.empty(n, np.int32)
        for k in range(self.n_topics):
            m = z == k
            tokens[m] = np.searchsorted(cdf[k], u[m]).astype(np.int32)
        tokens = np.minimum(tokens, self.vocab - 1)
        return {"tokens": tokens, "doc_ids": doc_ids, "lengths": lengths,
                "true_phi": phi, "true_theta": theta, "z": z}


@dataclasses.dataclass
class TokenStream:
    """Packed LM batches; ``batch_at`` is pure in (seed, step, shard).

    ``batch_at(step)`` returns ``{"tokens", "labels"}``, each
    ``(batch, seq_len) int32`` with ``labels`` the one-position shift of
    ``tokens`` (next-token targets); shards draw disjoint streams.
    """
    vocab: int
    seq_len: int
    batch: int                      # per-shard batch
    seed: int = 0
    shard: int = 0
    n_shards: int = 1
    weights: np.ndarray | None = None   # per-domain sampling weights

    def batch_at(self, step: int) -> dict:
        # counter-based: a fresh generator keyed by (seed, shard, step)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.shard, step]))
        toks = rng.integers(1, self.vocab, size=(self.batch, self.seq_len + 1),
                            dtype=np.int64).astype(np.int32)
        if self.weights is not None:
            # domain-reweighted mixing: choose a domain per sequence and
            # restrict its token range (a stand-in for real domain data)
            k = len(self.weights)
            dom = rng.choice(k, size=self.batch, p=self.weights)
            lo = (dom * (self.vocab // k)).astype(np.int32)
            toks = lo[:, None] + toks % (self.vocab // k)
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].astype(np.int32)}
