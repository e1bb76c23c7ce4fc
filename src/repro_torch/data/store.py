"""Out-of-core sharded corpus store for the streaming (SVI) engine: the
single-host parts of ``repro.data.store``, copied op for op, in the same
on-disk format, so that either package reads what the other wrote.

The resident pipeline (``pipeline.py``) assumes the whole corpus — the
``(N,) int32`` token array plus its ``(N,) int32`` doc ids — lives in one
process's memory, which caps scale exactly where the paper starts.  This
module keeps the corpus on disk instead:

- :class:`ShardedCorpus` — a directory of memory-mapped token shards plus a
  ``manifest.json`` of per-shard group (document) offsets and vocab stats,
  and a small resident ``lengths.npy`` (``(n_docs,) int64``, the only
  O(n_docs) state).  Shards are split on document boundaries, so a document
  minibatch touches only the shards its documents live in.
- :class:`ShardedCorpusWriter` / :func:`write_sharded_corpus` — convert a
  :class:`~repro_torch.data.pipeline.SyntheticCorpus` result (or any
  ``tokens``/``doc_ids`` numpy pair) to shards; the writer appends document
  chunks, so a corpus larger than memory can be ingested without ever being
  resident.  :meth:`ShardedCorpusWriter.commit` publishes a consistent
  snapshot mid-stream (atomic manifest replace — temp + rename), so a
  corpus can keep *arriving* while readers train on it; a live
  :class:`ShardedCorpus` picks committed documents up with
  :meth:`ShardedCorpus.refresh` without invalidating its open shard mmaps.
- :func:`sharded_template` / :func:`slice_sharded` — compile a model into a
  full-size :class:`~repro_torch.core.compiler.VMPProgram` *template* whose
  ``(N,)`` arrays are never materialized, and slice minibatches from the
  shards so that the arrays are **bitwise identical** to what
  :func:`repro_torch.core.compiler.slice_arrays` builds from a resident
  program.
- :class:`ShardedMinibatchSampler` — the :class:`MinibatchSampler`
  determinism contract (same ``(seed, epoch)`` permutation, seekable
  ``batch_at``) over a sharded corpus, plus a background double-buffered
  prefetch thread so building batch ``t+1``'s host arrays (shard I/O, index
  construction, owner plans) overlaps the SVI step on batch ``t``.

- :class:`HostAssignment` / :func:`shard_ownership` /
  :func:`doc_ownership` — which host of a multi-host run owns which shard
  (rendezvous hashing, the reference's op for op, so both packages give the
  same map); ``ShardedCorpus.open(path, hosts=)`` is one host's view, which
  reads only the shards it owns.

Everything here is numpy on the host; device placement stays in
``core/svi.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, Optional

import numpy as np

from ..testing import faults

from .pipeline import MinibatchSampler, SyntheticCorpus

_MANIFEST = "manifest.json"
_LENGTHS = "lengths.npy"
_FORMAT = "sharded-corpus"
_VERSION = 1
_OWNER_TAG = 0x1f5c  # domain-separates ownership hashing from sampler seeds


# ---------------------------------------------------------------------------
# shard ownership (multi-host corpora)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HostAssignment:
    """This process's place in a multi-host corpus partition.

    ``shard_ownership(n_shards, n_hosts, seed)`` is the single source of
    truth for which host owns which shard; a :class:`ShardedCorpus` opened
    with ``hosts=HostAssignment(...)`` enforces it — only owned shards are
    ever memory-mapped, so each host's page cache holds its partition and
    nothing else, while the global metadata (doc count, vocab, lengths)
    still comes from the shared manifest and is identical on every host.
    """
    n_hosts: int
    host_id: int
    seed: int = 0

    def __post_init__(self):
        if self.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {self.n_hosts}")
        if not (0 <= self.host_id < self.n_hosts):
            raise ValueError(f"host_id {self.host_id} out of range "
                             f"[0, {self.n_hosts})")


def shard_ownership(n_shards: int, n_hosts: int, seed: int = 0) -> np.ndarray:
    """Deterministic shard -> owner-host assignment, ``(n_shards,) int32``.

    Rendezvous (highest-random-weight) hashing: shard ``s`` belongs to the
    host ``h`` maximizing a pseudorandom weight drawn from
    ``SeedSequence([seed, _OWNER_TAG, s, h])`` — a pure function of
    ``(seed, s, h)`` with no ordering or state, which gives the three
    properties the multi-host layer needs (property-tested in
    ``tests/test_torch_multihost.py``):

    - every shard has exactly one owner on every host's copy of the map;
    - the map is a deterministic function of ``(n_shards, n_hosts, seed)``
      — hosts never have to communicate to agree on it;
    - **minimal movement on remesh**: adding host ``n`` only moves shards
      whose new maximum is at ``n`` (each shard's other weights are
      untouched), and removing a host only moves the shards it owned.

    Shards are written on document boundaries, so shard ownership is also
    document ownership (:func:`doc_ownership`).
    """
    if n_shards < 0:
        raise ValueError("n_shards must be >= 0")
    if n_hosts < 1:
        raise ValueError("n_hosts must be >= 1")
    owner = np.zeros(n_shards, np.int32)
    if n_hosts == 1:
        return owner
    for s in range(n_shards):
        best, best_w = 0, -1
        for h in range(n_hosts):
            w = int(np.random.SeedSequence(
                [int(seed), _OWNER_TAG, s, h]).generate_state(
                    1, np.uint64)[0])
            if w > best_w:
                best, best_w = h, w
        owner[s] = best
    return owner


def doc_ownership(manifest: dict, n_hosts: int, seed: int = 0) -> np.ndarray:
    """Per-document owner host, ``(n_docs,) int32`` — the shard owner map
    expanded over each shard's ``[doc_start, doc_end)`` range.  Computed
    from the manifest alone (no shard I/O), so every host can build the
    identical map and partition a *global* minibatch without talking to
    anyone."""
    shards = manifest["shards"]
    owner = shard_ownership(len(shards), n_hosts, seed)
    out = np.zeros(int(manifest["n_docs"]), np.int32)
    for sid, s in enumerate(shards):
        out[int(s["doc_start"]):int(s["doc_end"])] = owner[sid]
    return out




# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class ShardedCorpusWriter:
    """Append-only converter to the on-disk sharded format.

    Call :meth:`add_docs` with ``(tokens, lengths)`` chunks — ``tokens`` a
    ``(sum lengths,) int`` array of the chunk's documents back to back,
    ``lengths`` their ``(n_chunk_docs,) int`` token counts — then
    :meth:`close`.  A shard file is flushed whenever the buffered token
    count reaches ``shard_tokens`` (always on a document boundary, so one
    document never spans shards unless it alone exceeds ``shard_tokens``,
    in which case it gets a dedicated oversized shard).  Chunks can be far
    smaller than the corpus: ingestion is streaming and never holds more
    than one unflushed shard resident.

    **Streaming corpora**: :meth:`commit` publishes everything added so far
    as a consistent, openable snapshot *without* closing the writer, so
    readers (a training run, :meth:`ShardedCorpus.refresh`) can consume the
    corpus while it is still growing.  Shard files are immutable once
    written and documents are append-only, so every snapshot is a prefix of
    every later one.
    """

    def __init__(self, path: str, shard_tokens: int = 1 << 22,
                 vocab: Optional[int] = None):
        if shard_tokens <= 0:
            raise ValueError("shard_tokens must be positive")
        self.path = str(path)
        self.shard_tokens = int(shard_tokens)
        self._vocab = vocab
        self._buf: list[np.ndarray] = []        # tokens of pending docs
        self._buf_off = 0                       # consumed prefix of _buf[0]
        self._buf_tokens = 0
        self._pending: list[int] = []           # lengths of pending docs
        self._done_lengths: list[np.ndarray] = []
        self._shards: list[dict] = []
        self._n_docs = 0
        self._n_tokens = 0
        self._token_max = -1
        self._commits = 0
        self._closed = False
        os.makedirs(self.path, exist_ok=True)

    def add_docs(self, tokens, lengths) -> "ShardedCorpusWriter":
        """Append one chunk of whole documents (see class docstring)."""
        if self._closed:
            raise RuntimeError("writer is closed")
        tokens = np.ascontiguousarray(tokens, np.int32).ravel()
        lengths = np.asarray(lengths, np.int64).ravel()
        if (lengths < 0).any():
            raise ValueError("negative document length")
        if int(lengths.sum()) != len(tokens):
            raise ValueError(f"lengths sum to {int(lengths.sum())} but chunk "
                             f"has {len(tokens)} tokens")
        if len(tokens) and int(tokens.min()) < 0:
            raise ValueError("negative token id")
        if len(tokens):
            self._token_max = max(self._token_max, int(tokens.max()))
        self._n_docs += len(lengths)
        self._n_tokens += len(tokens)
        self._pending.extend(int(n) for n in lengths)
        self._buf.append(tokens)
        self._buf_tokens += len(tokens)
        # flush whole-document prefixes while a full shard is buffered:
        # one cumsum + one prefix-trim per call, not per shard, so a
        # single huge add_docs stays O(n_docs + tokens)
        if self._buf_tokens < self.shard_tokens or not self._pending:
            return self
        cum = np.cumsum(np.asarray(self._pending, np.int64))
        lo, base = 0, 0
        while cum[-1] - base >= self.shard_tokens:
            idx = int(np.searchsorted(cum, base + self.shard_tokens))
            if idx >= len(cum) - 1:
                break                     # keep a tail for the next chunk
            self._flush(np.asarray(self._pending[lo:idx + 1], np.int64))
            lo, base = idx + 1, int(cum[idx])
        del self._pending[:lo]
        return self

    def _take(self, n_tok: int) -> np.ndarray:
        """Pop the next ``n_tok`` buffered tokens (amortized O(n_tok):
        whole chunks are consumed by popping, never re-concatenated)."""
        pieces, need = [], n_tok
        while need:
            head = self._buf[0]
            avail = len(head) - self._buf_off
            if avail <= need:
                pieces.append(head[self._buf_off:])
                self._buf.pop(0)
                self._buf_off = 0
                need -= avail
            else:
                pieces.append(head[self._buf_off:self._buf_off + need])
                self._buf_off += need
                need = 0
        self._buf_tokens -= n_tok
        return (pieces[0] if len(pieces) == 1
                else np.concatenate(pieces) if pieces
                else np.zeros(0, np.int32))

    def _flush(self, lengths: np.ndarray):
        """Write the next ``len(lengths)`` pending documents as one shard
        (the caller trims ``_pending``)."""
        n_docs = len(lengths)
        n_tok = int(lengths.sum())
        shard = self._take(n_tok)
        done_docs = (self._shards[-1]["doc_end"] if self._shards else 0)
        tok_start = (self._shards[-1]["token_end"] if self._shards else 0)
        fname = f"shard-{len(self._shards):05d}.npy"
        faults.trip("store.flush.pre_shard")
        np.save(os.path.join(self.path, fname),
                np.ascontiguousarray(shard))
        faults.trip("store.flush.post_shard")
        self._shards.append({
            "path": fname,
            "doc_start": done_docs, "doc_end": done_docs + n_docs,
            "token_start": tok_start, "token_end": tok_start + n_tok,
            "token_min": int(shard.min()) if n_tok else 0,
            "token_max": int(shard.max()) if n_tok else 0,
        })
        self._done_lengths.append(lengths)

    def commit(self) -> "ShardedCorpus":
        """Publish every whole document added so far as a consistent,
        openable snapshot; the writer stays open for further appends.

        The buffered tail documents are flushed to a (possibly small) shard
        first — commit at chunk granularity, not per document — then
        ``lengths.npy`` is replaced atomically (temp + ``os.replace``) and
        ``manifest.json`` *last*, also atomically.  A reader therefore
        always observes a manifest whose shards and lengths are fully on
        disk, and because documents are append-only, a lengths file that is
        *newer* than the manifest a reader holds is a strict superset — its
        ``[:n_docs]`` prefix is exactly the manifest-consistent view
        (:meth:`ShardedCorpus.refresh` relies on this).  Returns the opened
        snapshot."""
        if self._closed:
            raise RuntimeError("writer is closed")
        if self._n_docs == 0:
            raise ValueError("cannot write an empty corpus")
        if self._pending:
            self._flush(np.asarray(self._pending, np.int64))
            self._pending = []
        vocab = self._token_max + 1
        if self._vocab is not None:
            if self._vocab < vocab:
                raise ValueError(f"vocab={self._vocab} but corpus has token "
                                 f"id {self._token_max}")
            vocab = int(self._vocab)
        self._commits += 1
        lengths = np.concatenate(self._done_lengths)
        faults.trip("store.commit.pre_lengths")
        ltmp = os.path.join(self.path, _LENGTHS + ".tmp")
        with open(ltmp, "wb") as fh:
            np.save(fh, lengths)
        os.replace(ltmp, os.path.join(self.path, _LENGTHS))
        faults.trip("store.commit.pre_manifest")
        manifest = {"format": _FORMAT, "version": _VERSION,
                    "commit": self._commits,
                    "n_docs": self._n_docs, "n_tokens": self._n_tokens,
                    "vocab": vocab, "dtype": "int32",
                    "shards": self._shards,
                    # writer-recovery context (readers ignore it): the raw
                    # token ceiling and construction knobs reopen() needs to
                    # continue appending faithfully after a crash
                    "writer": {"shard_tokens": self.shard_tokens,
                               "vocab": self._vocab,
                               "token_max": self._token_max}}
        mtmp = os.path.join(self.path, _MANIFEST + ".tmp")
        with open(mtmp, "w") as fh:
            json.dump(manifest, fh, indent=1)
        os.replace(mtmp, os.path.join(self.path, _MANIFEST))
        faults.trip("store.commit.post_manifest")
        return ShardedCorpus.open(self.path)

    def close(self) -> "ShardedCorpus":
        """Final :meth:`commit` (flush the tail shard, write
        ``manifest.json`` + ``lengths.npy``); the writer accepts no further
        documents.  Returns the opened :class:`ShardedCorpus`."""
        corpus = self.commit()
        self._closed = True
        return corpus

    @classmethod
    def reopen(cls, path: str, shard_tokens: Optional[int] = None,
               vocab: Optional[int] = None) -> "ShardedCorpusWriter":
        """Resume appending to an existing store — including one whose
        writer crashed mid-commit.

        The manifest is the commit record, so recovery adopts it as truth:
        every manifest-listed shard is kept (and header-checked), while any
        *orphan* state a crash left behind is removed — shard files past
        the manifest's count (flushed by an uncommitted ``add_docs`` or an
        aborted commit; never reader-visible, so deleting them cannot
        violate the append-only invariant), torn partial ``*.tmp`` files,
        and the over-long ``lengths.npy`` tail written when a crash landed
        between the lengths replace and the manifest replace (readers
        already ignore it by the prefix rule; the next commit rewrites it).
        Counters (doc/token totals, commit number, token ceiling) restore
        from the manifest's ``writer`` record, so later commits continue
        the sequence exactly.

        Documents added after the last successful :meth:`commit` were never
        durable and are NOT recovered — the ingestion caller re-adds them
        (at-least-once delivery is the caller's contract).  On a directory
        with no manifest at all, stray files are cleared and a fresh writer
        is returned.  ``shard_tokens`` / ``vocab`` default to the crashed
        writer's own settings.
        """
        path = str(path)
        mf = os.path.join(path, _MANIFEST)
        manifest = None
        if os.path.exists(mf):
            with open(mf) as fh:
                manifest = json.load(fh)
            if manifest.get("format") != _FORMAT:
                raise ValueError(f"{mf}: not a {_FORMAT} manifest")
        winfo = (manifest or {}).get("writer") or {}
        if shard_tokens is None:
            shard_tokens = int(winfo.get("shard_tokens") or (1 << 22))
        if vocab is None:
            vocab = winfo.get("vocab")
        w = cls(path, shard_tokens=shard_tokens, vocab=vocab)

        n_committed = len(manifest["shards"]) if manifest else 0
        committed = {s["path"] for s in manifest["shards"]} if manifest else set()
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            if name.endswith(".tmp") or ".tmp" in name:
                os.remove(full)
            elif (name.startswith("shard-") and name.endswith(".npy")
                    and name not in committed):
                os.remove(full)        # orphan: flushed but never committed

        if manifest is None:
            return w

        lengths = np.load(os.path.join(path, _LENGTHS))
        n_docs = int(manifest["n_docs"])
        if len(lengths) < n_docs:
            raise ValueError(
                f"{path}: lengths file has {len(lengths)} docs but the "
                f"manifest commits {n_docs} — the store is damaged beyond "
                f"the commit protocol's crash states")
        lengths = np.asarray(lengths[:n_docs], np.int64)
        if int(lengths.sum()) != int(manifest["n_tokens"]):
            raise ValueError(
                f"{path}: committed lengths sum {int(lengths.sum())} != "
                f"manifest n_tokens {manifest['n_tokens']}")
        legacy_max = -1
        for s in manifest["shards"]:
            full = os.path.join(path, s["path"])
            if not os.path.exists(full):
                raise ValueError(f"{path}: committed shard {s['path']} is "
                                 f"missing")
            got = np.load(full, mmap_mode="r").shape[0]
            want = int(s["token_end"]) - int(s["token_start"])
            if got != want:
                raise ValueError(
                    f"{path}: committed shard {s['path']} holds {got} "
                    f"tokens, manifest says {want}")
            if want:
                legacy_max = max(legacy_max, int(s["token_max"]))
        w._shards = list(manifest["shards"])
        w._done_lengths = [lengths] if n_docs else []
        w._n_docs = n_docs
        w._n_tokens = int(manifest["n_tokens"])
        w._commits = int(manifest["commit"])
        # pre-"writer"-record manifests: derive the ceiling from the shards
        w._token_max = int(winfo["token_max"]) if "token_max" in winfo \
            else legacy_max
        return w


def write_sharded_corpus(corpus, path: str, shard_tokens: int = 1 << 22,
                         vocab: Optional[int] = None) -> "ShardedCorpus":
    """One-shot conversion of a resident corpus to the sharded format.

    ``corpus`` is a :class:`~repro_torch.data.pipeline.SyntheticCorpus` (it is
    generated first), the dict its ``generate()`` returns, or any dict with
    ``tokens`` (``(N,) int``) plus either ``lengths`` (``(n_docs,) int``)
    or ``doc_ids`` (``(N,) int``, nondecreasing — documents must be stored
    back to back, the layout ``SyntheticCorpus`` and the compiler use).
    """
    if isinstance(corpus, SyntheticCorpus):
        corpus = corpus.generate()
    tokens = np.asarray(corpus["tokens"])
    if "lengths" in corpus:
        lengths = np.asarray(corpus["lengths"], np.int64)
    else:
        doc_ids = np.asarray(corpus["doc_ids"], np.int64)
        if len(doc_ids) != len(tokens):
            raise ValueError("doc_ids must align with tokens")
        if len(doc_ids) and (np.diff(doc_ids) < 0).any():
            raise ValueError("doc_ids must be nondecreasing (documents "
                             "stored back to back)")
        n_docs = int(doc_ids.max()) + 1 if len(doc_ids) else 0
        lengths = np.bincount(doc_ids, minlength=n_docs).astype(np.int64)
    return ShardedCorpusWriter(path, shard_tokens=shard_tokens,
                               vocab=vocab).add_docs(tokens, lengths).close()


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class ShardedCorpus:
    """A corpus that lives on disk as document-aligned token shards.

    Only ``lengths`` (``(n_docs,) int64``) and the manifest are resident;
    token shards are opened as read-only memory maps and copied into host
    buffers one minibatch at a time (:meth:`gather_tokens`).  ``bytes_read``
    / ``reads`` count the explicit buffer traffic (``chip_smoke.py``'s
    ``lda_ooc`` phase reports them).

    A corpus still being written (:meth:`ShardedCorpusWriter.commit`) grows
    under a live reader: :meth:`refresh` swaps in the latest committed
    manifest without reopening — existing shard mmaps stay valid (shards
    are immutable; commits only append), and already-handed-out doc ids
    keep meaning the same documents.

    **Multi-host partitioning**: with ``hosts=`` a :class:`HostAssignment`,
    this reader is one host's view of a corpus shared by ``n_hosts``
    processes (e.g. on a cluster filesystem).  Shard ownership comes from
    :func:`shard_ownership`; only owned shards may be memory-mapped
    (:meth:`gather_tokens` of an unowned document raises
    ``PermissionError``), while the global metadata — ``n_docs``,
    ``n_tokens``, ``vocab``, ``lengths`` — is read from the shared manifest
    and is identical on every host.
    """

    def __init__(self, path: str, manifest: dict, lengths: np.ndarray,
                 hosts: Optional[HostAssignment] = None):
        self.path = str(path)
        self.hosts = hosts
        self._mmaps: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()   # gather_tokens runs on the prefetch
        self.bytes_read = 0             # thread concurrently with held-out
        self.reads = 0                  # slicing on the consumer thread
        self._install(manifest, lengths)

    def _install(self, manifest: dict, lengths: np.ndarray) -> None:
        """Validate and adopt one committed (manifest, lengths) snapshot.
        All derived arrays are built first and published together under the
        lock, so a concurrent :meth:`gather_tokens` sees either the old or
        the new snapshot, never a mix."""
        lengths = np.asarray(lengths, np.int64)
        if len(lengths) < int(manifest["n_docs"]):
            raise ValueError(
                f"{self.path}: lengths file has {len(lengths)} docs but the "
                f"manifest claims {manifest['n_docs']} (torn commit?)")
        # a newer lengths file is a strict superset (docs are append-only):
        # its prefix is exactly the manifest-consistent view
        lengths = lengths[:int(manifest["n_docs"])]
        # offsets[d] is doc d's first token position; (n_docs + 1,) int64
        offsets = np.concatenate([[0], np.cumsum(lengths)])
        if int(offsets[-1]) != int(manifest["n_tokens"]):
            raise ValueError(
                f"{self.path}: lengths sum {int(offsets[-1])} "
                f"!= manifest n_tokens {manifest['n_tokens']}")
        tok_start = np.asarray(
            [s["token_start"] for s in manifest["shards"]], np.int64)
        tok_end = np.asarray(
            [s["token_end"] for s in manifest["shards"]], np.int64)
        shard_owner = doc_owner = None
        if self.hosts is not None:
            # ownership is per shard, so a refresh (append-only: existing
            # shards keep their ids) never reassigns an existing shard
            shard_owner = shard_ownership(len(manifest["shards"]),
                                          self.hosts.n_hosts,
                                          self.hosts.seed)
            doc_owner = np.zeros(int(manifest["n_docs"]), np.int32)
            for sid, s in enumerate(manifest["shards"]):
                doc_owner[int(s["doc_start"]):int(s["doc_end"])] = \
                    shard_owner[sid]
        with self._lock:
            self.manifest = manifest
            self.lengths = lengths
            self.offsets = offsets
            self._shard_tok_start = tok_start
            self._shard_tok_end = tok_end
            self.shard_owner = shard_owner
            self.doc_owner = doc_owner

    def refresh(self) -> bool:
        """Pick up documents committed since this reader's snapshot.

        Re-reads ``manifest.json`` (atomically replaced by the writer, so
        it is always complete) and, if the corpus grew, adopts the new
        manifest + lengths: ``n_docs``/``n_tokens``/``offsets`` advance,
        new shards become readable, and **live mmaps stay valid** (shards
        are immutable; a commit only appends new ones).  Doc ids are
        stable across refreshes.  Returns ``True`` iff the corpus grew;
        shrinkage (a different corpus written over this path) raises.
        """
        mf = os.path.join(self.path, _MANIFEST)
        with open(mf) as fh:
            manifest = json.load(fh)
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"{mf}: not a {_FORMAT} manifest")
        if (manifest["n_docs"] == self.n_docs
                and manifest["n_tokens"] == self.n_tokens):
            return False
        if (manifest["n_docs"] < self.n_docs
                or manifest["n_tokens"] < self.n_tokens):
            raise ValueError(
                f"{self.path}: corpus shrank ({manifest['n_docs']} docs < "
                f"{self.n_docs}); sharded corpora are append-only — was the "
                f"directory rewritten?")
        lengths = np.load(os.path.join(self.path, _LENGTHS))
        self._install(manifest, lengths)
        return True

    @classmethod
    def open(cls, path: str,
             hosts: Optional[HostAssignment] = None) -> "ShardedCorpus":
        """Open an existing store directory (``manifest.json`` required).
        ``hosts=`` opens one host's partition view (see class docstring)."""
        mf = os.path.join(str(path), _MANIFEST)
        if not os.path.exists(mf):
            raise FileNotFoundError(f"no {_MANIFEST} in {path}; write one "
                                    f"with write_sharded_corpus()")
        with open(mf) as fh:
            manifest = json.load(fh)
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"{mf}: not a {_FORMAT} manifest")
        lengths = np.load(os.path.join(str(path), _LENGTHS))
        return cls(path, manifest, lengths, hosts=hosts)

    # -- metadata ---------------------------------------------------------
    @property
    def n_docs(self) -> int:
        return int(self.manifest["n_docs"])

    @property
    def n_tokens(self) -> int:
        return int(self.manifest["n_tokens"])

    @property
    def vocab(self) -> int:
        """Max token id + 1 (or the writer's explicit ``vocab``)."""
        return int(self.manifest["vocab"])

    @property
    def n_shards(self) -> int:
        return len(self.manifest["shards"])

    @property
    def disk_bytes(self) -> int:
        """Total bytes of the token shards on disk."""
        return sum(os.path.getsize(os.path.join(self.path, s["path"]))
                   for s in self.manifest["shards"])

    # -- multi-host partition view ----------------------------------------
    def owned_shards(self) -> np.ndarray:
        """Shard ids this host owns (all of them without ``hosts=``)."""
        if self.hosts is None:
            return np.arange(self.n_shards, dtype=np.int64)
        return np.flatnonzero(self.shard_owner == self.hosts.host_id)

    def owned_doc_ids(self) -> np.ndarray:
        """Doc ids this host owns — the docs of its owned shards."""
        if self.hosts is None:
            return np.arange(self.n_docs, dtype=np.int64)
        return np.flatnonzero(self.doc_owner == self.hosts.host_id)

    @property
    def owned_disk_bytes(self) -> int:
        """On-disk bytes of the owned shards — the ceiling of what this
        host's page cache can ever hold of the corpus."""
        if self.hosts is None:
            return self.disk_bytes
        return sum(os.path.getsize(
            os.path.join(self.path, self.manifest["shards"][int(s)]["path"]))
            for s in self.owned_shards())

    def _mmap(self, sid: int) -> np.ndarray:
        with self._lock:
            if (self.shard_owner is not None
                    and int(self.shard_owner[sid]) != self.hosts.host_id):
                raise PermissionError(
                    f"{self.path}: shard {sid} is owned by host "
                    f"{int(self.shard_owner[sid])}, not this host "
                    f"{self.hosts.host_id} — multi-host readers mmap only "
                    f"their own shards (partition the batch by doc_owner)")
            mm = self._mmaps.get(sid)
            if mm is None:
                mm = np.load(
                    os.path.join(self.path,
                                 self.manifest["shards"][sid]["path"]),
                    mmap_mode="r")
                self._mmaps[sid] = mm
            return mm

    # -- reads ------------------------------------------------------------
    def _read_token_range(self, lo: int, hi: int, tok_start: np.ndarray,
                          tok_end: np.ndarray) -> list[np.ndarray]:
        """Copy tokens [lo, hi) out of the (possibly several) shards that
        hold them; returns the pieces in order.  ``tok_start``/``tok_end``
        are the caller's snapshot of the shard token bounds (so a
        concurrent refresh cannot tear one gather)."""
        out = []
        sid = int(np.searchsorted(tok_start, lo, "right")) - 1
        while lo < hi:
            s_lo = int(tok_start[sid])
            s_hi = int(tok_end[sid])
            take = min(hi, s_hi)
            piece = np.asarray(self._mmap(sid)[lo - s_lo:take - s_lo])
            with self._lock:
                self.bytes_read += piece.nbytes
                self.reads += 1
            out.append(piece)
            lo = take
            sid += 1
        return out

    def gather_tokens(self, docs) -> np.ndarray:
        """Concatenated tokens of ``docs`` (``(n,) int`` doc ids, in the
        given order) as a fresh ``(sum lengths[docs],) int32`` host buffer.
        Consecutive-id runs are merged into single range reads, so a sorted
        minibatch touches each shard at most once per contiguous run."""
        docs = np.asarray(docs, np.int64)
        if len(docs) == 0:
            return np.zeros(0, np.int32)
        with self._lock:                # one consistent snapshot per gather
            offsets = self.offsets
            tok_start = self._shard_tok_start
            tok_end = self._shard_tok_end
            n_docs = int(self.manifest["n_docs"])
            doc_owner = self.doc_owner
        if int(docs.min()) < 0 or int(docs.max()) >= n_docs:
            raise IndexError(f"doc ids out of range [0, {n_docs})")
        if doc_owner is not None:
            alien = docs[doc_owner[docs] != self.hosts.host_id]
            if len(alien):
                raise PermissionError(
                    f"{self.path}: docs {alien[:5].tolist()}... are not "
                    f"owned by host {self.hosts.host_id} "
                    f"(of {self.hosts.n_hosts}); gather only owned docs")
        starts = offsets[docs]
        ends = offsets[docs + 1]
        pieces: list[np.ndarray] = []
        i = 0
        while i < len(docs):
            j = i
            while j + 1 < len(docs) and docs[j + 1] == docs[j] + 1:
                j += 1
            pieces.extend(self._read_token_range(int(starts[i]),
                                                 int(ends[j]),
                                                 tok_start, tok_end))
            i = j + 1
        return np.concatenate(pieces) if pieces else np.zeros(0, np.int32)

    def resident(self) -> dict:
        """Materialize the whole corpus (``tokens``/``doc_ids``/``lengths``)
        — for tests and corpora small enough to run both ways; defeats the
        point at scale."""
        tokens = self.gather_tokens(np.arange(self.n_docs))
        doc_ids = np.repeat(np.arange(self.n_docs, dtype=np.int32),
                            self.lengths)
        return {"tokens": tokens, "doc_ids": doc_ids,
                "lengths": self.lengths.copy()}


# ---------------------------------------------------------------------------
# full-size program template + sharded minibatch slicing
# ---------------------------------------------------------------------------

def _token_plate_spec(program):
    """The (latent, child) pair of a token-plate program, or raise.

    The sharded slicer supports the corpus-shaped model family: exactly one
    latent selector living *on* the observed token plate (no ``zmap``), one
    specialized child (rows are the selector value: ``base is None``,
    ``stride == 1`` — LDA's shape), no static factors.  Models whose
    per-token index arrays cannot be rebuilt from (tokens, lengths) alone
    (SLDA's sentence maps, DCMLDA's per-doc row bases, naive Bayes'
    doc-level latents) need the resident pipeline.
    """
    if (len(program.latents) == 1 and not program.statics
            and len(program.latents[0].children) == 1):
        spec = program.latents[0]
        f = spec.children[0]
        if f.specialized and f.zmap is None:
            return spec, f
    raise ValueError(
        f"model {program.name} is outside the sharded-corpus family (need "
        f"one token-plate latent with one specialized child and no static "
        f"factors, like LDA); use the resident pipeline")


def sharded_template(model, corpus: ShardedCorpus,
                     observe: str = "x", proto_docs: int = 2,
                     capacity_docs: Optional[int] = None):
    """Compile ``model`` into a full-size program template for ``corpus``
    without materializing any ``(N,)`` array.

    A tiny prototype slice (the first ``proto_docs`` documents) is observed
    on a deep copy of ``model`` and compiled to capture the program
    *structure*; the specs are then rescaled to the corpus: local
    Dirichlets get ``g = n_docs`` rows, ``meta["pstar_size"] = n_docs``,
    the latent spec ``n = n_tokens``.  The template's per-token arrays
    (``prior_rows``, child ``values``, ``group``) are set to ``None`` —
    :func:`slice_sharded` rebuilds each minibatch's slice from the shards
    instead, and any resident-path access fails loudly.  The caller's
    ``model`` is left untouched (it really does stay unobserved).

    ``capacity_docs`` — padded-growth headroom for *streaming* corpora:
    local Dirichlets get ``capacity_docs`` rows (documents committed later
    slot into the pre-allocated tail rows), so the SVI step's state keeps
    its shapes as the corpus grows.  ``meta["pstar_size"]`` stays the doc
    count at template-build time (the holdout split is taken over it);
    ``meta["capacity_docs"]`` records the ceiling and the growing sampler
    refuses to sample past it.
    """
    import copy
    import dataclasses as dc

    from ..core.compiler import VMPProgram

    model = copy.deepcopy(model)      # the prototype observation is ours
    p = min(int(proto_docs), corpus.n_docs)
    if p < 1:
        raise ValueError("corpus has no documents")
    # the proto slice reads the first documents, which a host-partitioned
    # view may not own; read them through an unrestricted reader over the
    # SAME snapshot (manifest + lengths), so the template — and everything
    # derived from it — is identical on every host
    reader = corpus
    if corpus.hosts is not None:
        reader = ShardedCorpus(corpus.path, corpus.manifest, corpus.lengths)
    proto_tokens = reader.gather_tokens(np.arange(p))
    proto_ids = np.repeat(np.arange(p, dtype=np.int32), corpus.lengths[:p])
    try:
        model[observe].observe(proto_tokens, segment_ids=proto_ids)
    except ValueError as e:
        raise ValueError(f"corpus (vocab {corpus.vocab}) does not fit "
                         f"{observe!r}: {e}") from e
    proto: VMPProgram = model.compile()

    spec, f = _token_plate_spec(proto)
    if proto.meta.get("pstar") is None:
        raise ValueError("sharded SVI needs a '?' partition plate")
    if spec.group is None or not np.array_equal(spec.prior_rows, proto_ids):
        raise ValueError(
            f"latent {spec.name} must live on the token plate directly "
            f"under the partition plate (one prior row per document)")
    if corpus.vocab > proto.dirichlets[f.dir_name].k:
        raise ValueError(
            f"corpus vocab {corpus.vocab} exceeds {f.dir_name}'s dimension "
            f"{proto.dirichlets[f.dir_name].k}")
    theta = proto.dirichlets[spec.prior_dir]
    if theta.group_rows is None or theta.g != p:
        raise ValueError(f"{spec.prior_dir} must have exactly one row per "
                         f"partition group for sharded slicing")

    n_docs, n_tokens = corpus.n_docs, corpus.n_tokens
    cap_docs = n_docs if capacity_docs is None else int(capacity_docs)
    if cap_docs < n_docs:
        raise ValueError(f"capacity_docs={cap_docs} is below the corpus's "
                         f"current {n_docs} documents")
    dirichlets = {}
    for name, d in proto.dirichlets.items():
        if d.group_rows is None:
            dirichlets[name] = d
        else:
            dirichlets[name] = dc.replace(
                d, g=cap_docs, group_rows=np.arange(cap_docs, dtype=np.int32))
    children = [dc.replace(f, values=None, n_z=n_tokens)]
    latents = [dc.replace(spec, n=n_tokens, prior_rows=None,
                          children=children, group=None)]

    plate_sizes = dict(proto.plate_sizes)
    token_plate = model.net.rvs[observe].plate
    plate_sizes[token_plate.name] = n_tokens
    plate_sizes[proto.meta["pstar"]] = cap_docs
    layout, off = {}, 0
    for rv in proto.net.rvs.values():
        cnt = plate_sizes.get(rv.plate.name, 1)
        layout[rv.name] = (off, off + cnt)
        off += cnt
    meta = dict(proto.meta)
    meta.update(n_observed=n_tokens, n_vertices=off, pstar_size=n_docs,
                capacity_docs=cap_docs, sharded=True,
                corpus_path=str(corpus.path))
    return dc.replace(proto, dirichlets=dirichlets, latents=latents,
                      vertex_layout=layout, plate_sizes=plate_sizes,
                      meta=meta)


def sharded_caps(template, corpus: ShardedCorpus, groups) -> dict[str, int]:
    """The exact caps :func:`slice_sharded` would realize for ``groups``
    under no padding policy — computed from ``corpus.lengths`` alone, with
    **no shard I/O**.  The distributed batch builder probes per-shard caps
    this way instead of slicing every sub-minibatch twice (which would
    double the disk reads)."""
    spec, f = _token_plate_spec(template)
    groups = np.unique(np.asarray(groups, np.int64))
    nz = int(corpus.lengths[groups].sum())
    return {spec.prior_dir: max(len(groups), 1), spec.name: max(nz, 1),
            f.x_name: max(nz, 1)}


def slice_sharded(template, corpus: ShardedCorpus, groups, caps_fn=None):
    """Sharded drop-in for :func:`repro_torch.core.compiler.slice_arrays`.

    Builds one minibatch's ``(arrays, dir_rows, caps, n_tokens)`` by reading
    only the shards the batch's documents live in; every array (values,
    prior rows, masks, sentinel padding, caps) is constructed to be bitwise
    identical to what ``slice_arrays`` would produce from the equivalent
    resident program — the property that makes sharded and resident SVI
    bitwise-interchangeable (``tests/test_torch_store.py``).
    """
    # the exact padding/mask conventions of the resident slicer — the
    # bitwise contract lives in one place (compiler.py)
    from ..core.compiler import _padded, _slice_mask

    spec, f = _token_plate_spec(template)
    d_theta = template.dirichlets[spec.prior_dir]
    # member-mask semantics of slice_arrays: ascending, duplicates collapse
    groups = np.unique(np.asarray(groups, np.int64))
    if len(groups) and (groups[0] < 0 or groups[-1] >= corpus.n_docs):
        raise IndexError(f"group ids out of range [0, {corpus.n_docs})")
    cap_of = caps_fn if caps_fn is not None else (lambda name, n: n)
    always_mask = caps_fn is not None

    def _mask(cap, n):
        return _slice_mask(cap, n, always_mask)

    arrays: dict[str, dict] = {}
    dir_rows: dict[str, dict] = {}
    caps: dict[str, int] = {}

    g_b = len(groups)
    cap_d = max(int(cap_of(spec.prior_dir, g_b)), 1)
    rows = np.full(cap_d, d_theta.g, np.int32)      # sentinel: out-of-range
    rows[:g_b] = groups
    mask_d = np.zeros(cap_d, np.float32)
    mask_d[:g_b] = 1.0
    dir_rows[spec.prior_dir] = {"rows": rows, "mask": mask_d}
    caps[spec.prior_dir] = cap_d

    lengths_b = corpus.lengths[groups]
    nz = int(lengths_b.sum())
    capz = max(int(cap_of(spec.name, nz)), 1)
    caps[spec.name] = capz
    prior_rows = np.repeat(np.arange(g_b, dtype=np.int64),
                           lengths_b).astype(np.int32)
    arrays[spec.name] = {"prior_rows": _padded(prior_rows, capz),
                         "mask": _mask(capz, nz)}

    caps[f.x_name] = capz                           # zmap-None child: capt=capz
    arrays[f.x_name] = {
        "values": _padded(corpus.gather_tokens(groups).astype(np.int32),
                          capz),
        "zmap": None, "base": None, "mask": _mask(capz, nz)}
    return arrays, dir_rows, caps, nz


# ---------------------------------------------------------------------------
# sampler + double-buffered prefetch
# ---------------------------------------------------------------------------

class _Prefetcher:
    """Double-buffered background loader.

    ``get(t)`` returns ``fn(t)``: from the prefetch buffer when the
    prediction matched (the common sequential case — the worker built it
    while the consumer was busy, e.g. while the SVI step ran on
    device), synchronously otherwise (first call, or a seek/resume jump).
    Either way it then schedules ``fn(t + 1)`` on the worker thread, so at
    most two batches' host buffers are ever live — the double buffer the
    out-of-core working-set bound is stated in terms of.  Exceptions raised
    by a prefetched ``fn`` are re-raised at the matching ``get``.
    """

    def __init__(self, fn: Callable[[int], object]):
        self._fn = fn
        self._thread: Optional[threading.Thread] = None
        self._step: Optional[int] = None
        self._box: Optional[dict] = None

    def get(self, t: int):
        out = None
        if self._thread is not None:
            self._thread.join()
            kind, val = (self._box.get("r", (None, None))
                         if self._step == t else (None, None))
            self._thread = None
            self._box = None
            if kind == "exc":
                raise val
            out = val
        if out is None:
            out = self._fn(t)
        self._schedule(t + 1)
        return out

    def _schedule(self, t: int):
        # each worker writes into its own box: a worker abandoned by a
        # timed-out close() that finishes late can never leak its stale
        # result into a newer schedule slot
        box: dict = {}

        def work():
            try:
                box["r"] = ("ok", self._fn(t))
            except BaseException as e:          # re-raised at get(t)
                box["r"] = ("exc", e)

        self._step = t
        self._box = box
        self._thread = threading.Thread(target=work, daemon=True,
                                        name="sharded-corpus-prefetch")
        self._thread.start()

    def close(self, timeout: Optional[float] = 5.0) -> bool:
        """Stop prefetching and drop the in-flight result.

        Joins the worker with ``timeout`` (seconds; ``None`` = wait
        forever).  A worker stuck in a blocked loader — shard I/O on a hung
        filesystem, a corpus refresh waiting on a dead writer — used to
        hang ``close()`` indefinitely; now it is *abandoned* instead: the
        daemon thread keeps running but writes only to its own private
        result box, so it can never corrupt later state, and the process
        can still exit (daemon threads don't block interpreter shutdown).
        Returns ``True`` iff the worker actually finished (always ``True``
        when there was none)."""
        th, self._thread = self._thread, None
        self._box = None
        self._step = None
        if th is None:
            return True
        th.join(timeout)
        return not th.is_alive()


@dataclasses.dataclass
class ShardedMinibatchSampler:
    """Minibatch schedule + host-batch loading over a :class:`ShardedCorpus`.

    The *schedule* is delegated to an inner
    :class:`~repro_torch.data.pipeline.MinibatchSampler` over the same
    ``(groups, batch_size, seed, shuffle)``, so ``batch_at(step)`` is — by
    construction, not by parallel implementation — the identical pure
    function of ``(seed, step)`` as the resident sampler's: resident and
    sharded runs visit the same documents in the same order, and a resumed
    run reproduces the remaining schedule.

    ``loader(groups) -> batch`` builds one batch's host-side arrays from
    the shards (numpy only — it runs on the prefetch thread);
    :meth:`host_batch_at` serves it through a double-buffered prefetcher so
    shard I/O overlaps the consumer's device step.  ``peak_buffer_bytes``
    tracks the largest concurrent footprint of the (at most two) live host
    batches with their owner plans — the resident working set.

    **Streaming mode** (``grow=True``): the schedule is delegated to a
    :class:`~repro_torch.data.pipeline.GrowingMinibatchSampler` whose per-epoch
    population snapshot calls :meth:`ShardedCorpus.refresh` and returns
    every committed document except ``exclude`` (the holdout) — so
    documents appended by a live :class:`ShardedCorpusWriter` enter the
    schedule at the next epoch boundary.  ``max_group`` (the template's
    ``capacity_docs``) bounds growth: sampling past it would write local
    posterior rows that do not exist, so the snapshot raises instead of
    silently dropping documents.  With prefetch on, the epoch boundary is
    crossed one batch early (batch ``t+1`` builds while ``t`` runs), so
    the snapshot that opens epoch ``e`` is taken while the last batch of
    epoch ``e-1`` is still on device — benign, but it means appends land
    in the schedule at *prefetch* granularity, not step granularity.
    """
    corpus: ShardedCorpus
    groups: np.ndarray
    batch_size: int
    seed: int = 0
    shuffle: bool = True
    loader: Optional[Callable[[np.ndarray], object]] = None
    prefetch: bool = True
    grow: bool = False
    exclude: Optional[np.ndarray] = None    # doc ids never sampled (holdout)
    max_group: Optional[int] = None         # capacity_docs growth ceiling

    def __post_init__(self):
        if self.grow:
            from .pipeline import GrowingMinibatchSampler
            if self.exclude is not None:
                self.exclude = np.asarray(self.exclude, np.int64)
            self._inner = GrowingMinibatchSampler(
                population=self._snapshot_population,
                batch_size=self.batch_size,
                seed=self.seed, shuffle=self.shuffle)
            self.groups = self._snapshot_population()
        else:
            self._inner = MinibatchSampler(groups=self.groups,
                                           batch_size=self.batch_size,
                                           seed=self.seed,
                                           shuffle=self.shuffle)
            self.groups = self._inner.groups
        self._prefetcher = (_Prefetcher(self._load_at)
                            if self.prefetch and self.loader else None)
        self._live = [0, 0]                     # [consumer, prefetch] bytes
        self.peak_buffer_bytes = 0

    def _snapshot_population(self) -> np.ndarray:
        """Refresh the corpus and return the current sampleable doc ids
        (every committed doc minus ``exclude``) — the grow-mode epoch
        snapshot."""
        self.corpus.refresh()
        n = self.corpus.n_docs
        if self.max_group is not None and n > self.max_group:
            raise RuntimeError(
                f"corpus grew to {n} documents, past the template's "
                f"capacity_docs={self.max_group}; rebuild the template "
                f"(sharded_template(..., capacity_docs=...)) with more "
                f"headroom and restart from the checkpoint")
        pop = np.arange(n, dtype=np.int64)
        if self.exclude is not None and len(self.exclude):
            pop = np.setdiff1d(pop, self.exclude, assume_unique=True)
        return pop

    @property
    def batches_per_epoch(self) -> int:
        return self._inner.batches_per_epoch

    def population_at(self, step: int) -> int:
        """Size of the group population at schedule slot ``step`` — the
        epoch snapshot size in grow mode, ``len(groups)`` otherwise."""
        if self.grow:
            return self._inner.population_at(step)
        return len(self.groups)

    def batch_at(self, step: int) -> np.ndarray:
        """Sorted ``(<=batch_size,) int64`` doc ids of schedule slot
        ``step`` — bitwise the resident :class:`MinibatchSampler` order."""
        return self._inner.batch_at(step)

    def epoch_snapshots(self):
        """Resumable sampler cursor: the growing sampler's per-epoch group
        snapshots (``[]`` in fixed mode, where ``batch_at`` is already pure
        in ``(seed, step)`` and needs no cursor)."""
        if not self.grow:
            return []
        return self._inner.epoch_snapshots()

    def restore_epochs(self, records) -> None:
        """Reseat the growing schedule from a checkpointed cursor (see
        :meth:`~repro_torch.data.pipeline.GrowingMinibatchSampler.restore_epochs`).
        No-op for empty records; invalid in fixed mode."""
        if not records:
            return
        if not self.grow:
            raise ValueError("epoch records only apply to grow=True mode")
        self._inner.restore_epochs(records)

    def _load_at(self, step: int):
        batch = self.loader(self.batch_at(step))
        nbytes = _tree_nbytes(batch)
        # double-buffered: the previous batch is still live at the consumer
        # while this one builds; without prefetch only one batch is ever
        # resident at a time
        self._live = ([self._live[1], nbytes] if self._prefetcher is not None
                      else [0, nbytes])
        self.peak_buffer_bytes = max(self.peak_buffer_bytes,
                                     sum(self._live))
        return batch

    def host_batch_at(self, step: int):
        """``loader(batch_at(step))``, prefetched: the call for ``step+1``
        starts on the worker thread before this one returns."""
        if self.loader is None:
            raise ValueError("no loader bound; use batch_at()")
        if self._prefetcher is None:
            return self._load_at(step)
        return self._prefetcher.get(step)

    def close(self, timeout: Optional[float] = 5.0) -> bool:
        """Stop the prefetch worker (idempotent).  Joins with ``timeout``
        seconds (``None`` = forever); a worker blocked in the loader is
        abandoned rather than hanging the caller — see
        :meth:`_Prefetcher.close`.  Returns ``True`` iff no worker was left
        running."""
        if self._prefetcher is not None:
            return self._prefetcher.close(timeout)
        return True


def _tree_nbytes(obj) -> int:
    """Total nbytes of the array-like leaves of a nested dict/list/tuple
    (anything exposing ``nbytes`` counts — e.g. the multi-host batch's
    per-shard leaf containers)."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_tree_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tree_nbytes(v) for v in obj)
    return int(getattr(obj, "nbytes", 0) or 0)


__all__ = ["ShardedCorpus", "ShardedCorpusWriter", "ShardedMinibatchSampler",
           "sharded_caps", "sharded_template", "slice_sharded",
           "write_sharded_corpus"]
