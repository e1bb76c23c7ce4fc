"""Deterministic data generation: the port's copies of ``SyntheticCorpus``,
the SVI samplers and ``TokenStream``.

:class:`SyntheticCorpus` is a topic-mixture document generator (planted
topics over a vocabulary, Poisson document lengths) and :class:`TokenStream`
gives packed LM training batches, seekable by step.  Both are copied op for
op from ``repro.data.pipeline`` so that the same seed gives the same corpus
and the same batches, bit for bit, in both packages.
:class:`MinibatchSampler`, :class:`GrowingMinibatchSampler` and
:func:`holdout_split` are copied the same way, so both packages draw the
same minibatches and the same held-out split.  Everything is numpy on the host; device placement happens in the
runtime, the SVI engine and the trainer.  The sharded on-disk store is
``store.py``.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable

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
class MinibatchSampler:
    """Seekable document-minibatch sampler for the streaming VMP engine.

    Samples without replacement within an epoch: the group order is a fresh
    permutation keyed by ``(seed, epoch)``, so — like :class:`TokenStream` —
    ``batch_at(step)`` is a pure function of (seed, step) and a restarted
    job resumes its schedule bitwise-identically.  Batches are returned
    sorted (instance order inside a sliced program then matches the
    corpus's group-major order, which keeps full-batch slicing an identity).
    """
    groups: np.ndarray               # (G,) int group ids (e.g. doc ids)
    batch_size: int                  # groups per batch; must be <= G
    seed: int = 0
    shuffle: bool = True

    def __post_init__(self):
        self.groups = np.asarray(self.groups, np.int64)
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if len(self.groups) == 0:
            raise ValueError("no groups to sample")
        if self.batch_size > len(self.groups):
            raise ValueError(
                f"batch_size {self.batch_size} exceeds the {len(self.groups)}"
                f" available groups; clamp it (the SVI engine clamps to "
                f"min(batch_size, n_train_groups)) or add groups")

    @property
    def batches_per_epoch(self) -> int:
        return -(-len(self.groups) // self.batch_size)

    def batch_at(self, step: int) -> np.ndarray:
        """Sorted ``(<=batch_size,) int64`` group ids of schedule slot
        ``step`` (the epoch's tail batch may be short); a pure function of
        ``(seed, step)``."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        epoch, idx = divmod(int(step), self.batches_per_epoch)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch]))
            perm = rng.permutation(self.groups)
        else:
            perm = self.groups
        lo = idx * self.batch_size
        return np.sort(perm[lo:lo + self.batch_size])


@dataclasses.dataclass
class GrowingMinibatchSampler:
    """Epoch-snapshot sampler over a *growing* group population.

    Streaming corpora keep gaining documents while SVI runs, so a fixed
    ``groups`` array goes stale.  This sampler instead calls
    ``population()`` — any callable returning the current sorted group-id
    array — once at the start of every epoch, and runs that epoch over the
    returned *snapshot*: each epoch ``e`` covers
    ``ceil(len(snapshot_e) / batch_size)`` consecutive schedule slots, its
    batch order the same ``(seed, epoch)``-keyed permutation
    :class:`MinibatchSampler` uses.  The determinism contract therefore
    becomes ``(seed, epoch, snapshot)``: while the population does not
    change, the schedule is **bitwise identical** to a fixed
    :class:`MinibatchSampler` over the same groups, and a growing run is
    reproducible whenever appends land at the same epoch boundaries
    (``tests/test_streaming.py``).

    ``batch_at`` is monotone-friendly, not monotone-only: epochs already
    snapshotted replay from their record (seeking backward is exact), and
    only a step past the recorded frontier triggers a new snapshot.
    ``epoch_log()`` exposes the records for checkpointing / inspection.
    Thread-safe: the record is extended under a lock (the sharded
    prefetcher calls ``batch_at`` from its worker thread).
    """
    population: Callable[[], np.ndarray]
    batch_size: int
    seed: int = 0
    shuffle: bool = True

    def __post_init__(self):
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self._lock = threading.Lock()
        # per-epoch records: (start_step, snapshot groups); epochs abut
        self._epochs: list[tuple[int, np.ndarray]] = []

    def _bpe(self, groups: np.ndarray) -> int:
        return -(-len(groups) // min(self.batch_size, len(groups)))

    def _epoch_at(self, step: int) -> tuple[int, int, np.ndarray]:
        """(epoch index, epoch start step, snapshot) covering ``step``,
        snapshotting forward as needed."""
        if step < 0:
            raise ValueError(f"step must be >= 0, got {step}")
        with self._lock:
            while True:
                if self._epochs:
                    start, groups = self._epochs[-1]
                    end = start + self._bpe(groups)
                else:
                    end = 0
                if step < end:
                    break
                groups = np.asarray(self.population(), np.int64)
                if len(groups) == 0:
                    raise ValueError("population() returned no groups")
                self._epochs.append((end, groups))
            # binary search the record (starts are strictly increasing)
            starts = [s for s, _ in self._epochs]
            e = int(np.searchsorted(starts, step, "right")) - 1
            start, groups = self._epochs[e]
            return e, start, groups

    def batch_at(self, step: int) -> np.ndarray:
        """Sorted ``(<=batch_size,) int64`` group ids of schedule slot
        ``step`` — :class:`MinibatchSampler`'s permutation over ``step``'s
        epoch snapshot."""
        e, start, groups = self._epoch_at(step)
        bs = min(self.batch_size, len(groups))
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, e]))
            perm = rng.permutation(groups)
        else:
            perm = groups
        lo = (step - start) * bs
        return np.sort(perm[lo:lo + bs])

    def population_at(self, step: int) -> int:
        """Size of the epoch snapshot covering ``step`` — the ``G`` of the
        SVI stochastic scale ``G / |B|`` under the growing contract."""
        return len(self._epoch_at(step)[2])

    @property
    def batches_per_epoch(self) -> int:
        """Batches in the *latest* snapshotted epoch (epoch 0 is
        snapshotted on first use)."""
        with self._lock:
            if self._epochs:
                return self._bpe(self._epochs[-1][1])
        self._epoch_at(0)
        return self.batches_per_epoch

    def epoch_log(self) -> list[tuple[int, int]]:
        """``[(start_step, snapshot_size), ...]`` of every epoch
        snapshotted so far."""
        with self._lock:
            return [(s, len(g)) for s, g in self._epochs]

    def epoch_snapshots(self) -> list[tuple[int, np.ndarray]]:
        """Copies of the full per-epoch records ``[(start_step, groups)]``
        — the sampler's resumable cursor (``epoch_log`` with the frozen
        group arrays, which a restarted process cannot re-derive from a
        since-grown corpus)."""
        with self._lock:
            return [(s, g.copy()) for s, g in self._epochs]

    def restore_epochs(self, records: list[tuple[int, np.ndarray]]) -> None:
        """Reseat the cursor from :meth:`epoch_snapshots` — replay of every
        recorded step is then bitwise-identical to the run that saved them.
        Only valid before this sampler has snapshotted anything itself."""
        with self._lock:
            if self._epochs:
                raise RuntimeError(
                    "restore_epochs() must run before the sampler has "
                    "snapshotted any epoch of its own")
            end = 0
            cleaned = []
            for start, groups in records:
                groups = np.asarray(groups, np.int64)
                if len(groups) == 0:
                    raise ValueError("epoch record with no groups")
                if int(start) != end:
                    raise ValueError(
                        f"epoch records must abut: expected start {end}, "
                        f"got {start}")
                cleaned.append((end, groups))
                end += self._bpe(groups)
            self._epochs = cleaned


def holdout_split(n_groups: int, frac: float, seed: int = 0):
    """Deterministic ``(train, holdout)`` group split — two sorted, disjoint
    ``int64`` arrays covering ``arange(n_groups)``, pure in ``seed``.

    ``frac`` must satisfy ``0 < frac < 1`` *and* round to at least one group
    on each side: silent empty splits produced nonsense downstream (NaN
    held-out ELBOs, un-trainable models), so degenerate requests raise
    instead.  Callers that genuinely want no holdout should skip the split
    (the SVI engine does this for ``holdout_frac=0``).
    """
    if n_groups <= 0:
        raise ValueError(f"n_groups must be positive, got {n_groups}")
    if not 0.0 < frac < 1.0:
        raise ValueError(
            f"holdout frac must be in (0, 1), got {frac}; for no holdout "
            f"skip the split instead of requesting an empty one")
    n_hold = int(round(frac * n_groups))
    if n_hold == 0:
        raise ValueError(
            f"frac={frac} rounds to an empty holdout over {n_groups} "
            f"groups; raise frac (>= {0.5 / n_groups:.4g}) or skip the split")
    if n_hold == n_groups:
        raise ValueError(
            f"frac={frac} holds out all {n_groups} groups, leaving nothing "
            f"to train on; lower frac")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_groups)
    return np.sort(perm[n_hold:]), np.sort(perm[:n_hold])


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
