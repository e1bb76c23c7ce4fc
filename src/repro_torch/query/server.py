"""Micro-batching statistical-query server over a frozen posterior.

The port of ``repro.query.server``, copied op for op; the one addition is
the dispatcher's device guard: the dispatch thread scores inside
``torch.cuda.device(fold.device)`` (PyTorch's current CUDA device is
per thread), so the kernels of a batch launch on its :class:`FoldIn`'s card.

The serving shape of the ROADMAP north star ("serve heavy traffic"):
requests (each one or more documents to score) land on a queue; a single
dispatch thread drains up to ``max_batch_docs`` of them (waiting at most
``max_delay_s`` after the first), concatenates their documents into one
fold-in batch, pads it to the :class:`~repro_torch.query.foldin.FoldIn`
length bucket, and runs the *one* scorer for that bucket — so concurrent
clients share scorers and amortize dispatch exactly like training batches
do.  Per-document results are split back out and each request's future is
resolved with its own :class:`QueryResponse`.

Latency/throughput accounting is built in (:meth:`QueryServer.stats`):
request/batch/document/token counts, mean batch occupancy, quantile
latencies, and the bucket cache size.

:class:`QueryClient` is the synchronous facade: ``client.score(tokens,
lengths=...)`` blocks for one request; many client threads can share one
server (that is the point).

**Hot refresh** (:meth:`QueryServer.swap`): a long-lived server follows a
training run that keeps producing newer posteriors.  ``swap(foldin)``
replaces the served artifact atomically under load — the dispatcher
captures the ``(scorer, version)`` pair once per batch, immediately before
dispatch, so an in-flight batch finishes on the scorer it started with and
every later batch lands on the new one; no request is ever dropped or
scored against a half-installed artifact.  Every :class:`QueryResponse`
names the ``artifact_version`` that scored it, so clients can tell which
model generation produced a number.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .foldin import FoldIn


@dataclasses.dataclass
class QueryResponse:
    """One request's slice of a dispatched batch."""
    doc_ll: np.ndarray               # (n_docs,) per-document score
    per_token_ll: float              # request-level nats/token
    perplexity: float
    n_tokens: int
    n_docs: int
    mixtures: dict[str, np.ndarray]  # local RV -> this request's rows
    batch_docs: int                  # documents in the dispatched batch
    latency_s: float                 # enqueue -> resolve
    artifact_version: str = "v0"     # which served artifact scored this


@dataclasses.dataclass
class _Request:
    values: np.ndarray
    lengths: np.ndarray
    future: Future
    t_enqueue: float
    deadline: float | None = None    # absolute; expired requests fail fast


class QueryServer:
    """Batched dispatch over a :class:`FoldIn` scorer.

    ``max_batch_docs`` — documents per dispatched fold-in batch;
    ``max_delay_s`` — how long the dispatcher holds the first request of a
    batch waiting for co-riders (the latency/throughput knob);
    ``max_queue`` — backpressure bound on undispatched requests;
    ``stats_window`` — samples kept for the batch-occupancy/latency
    quantiles (a sliding window, so a long-lived server's accounting
    stays O(window); the counters are lifetime totals).
    ``version`` — label of the initial artifact (responses carry the label
    of the artifact that scored them; :meth:`swap` installs new ones).
    ``admission_timeout_s`` — bound on how long :meth:`submit` waits for
    queue room before rejecting with ``TimeoutError`` (backpressure with a
    floor, instead of the old unbounded retry loop that could park a
    client forever behind a stalled dispatcher).
    ``default_timeout_s`` — deadline applied to requests submitted without
    one; ``None`` = no deadline.  An expired request is failed fast by the
    dispatcher *before* scoring (``stats()["expired"]``) — previously a
    timed-out ``QueryClient`` left its request queued, and the dispatcher
    later burned a batch slot scoring it for a dead caller.
    """

    def __init__(self, foldin: FoldIn, max_batch_docs: int = 64,
                 max_delay_s: float = 0.002, max_queue: int = 1024,
                 stats_window: int = 4096, version: str = "v0",
                 admission_timeout_s: float = 5.0,
                 default_timeout_s: float | None = None):
        if max_batch_docs <= 0:
            raise ValueError("max_batch_docs must be positive")
        if admission_timeout_s <= 0:
            raise ValueError("admission_timeout_s must be positive")
        self._foldin = foldin
        self._version = str(version)
        self._swaps = 0
        self.max_batch_docs = max_batch_docs
        self.max_delay_s = max_delay_s
        self.admission_timeout_s = admission_timeout_s
        self.default_timeout_s = default_timeout_s
        self._n_expired = 0
        self._n_rejected = 0
        self._q: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._stopped = False           # guarded by _lock, final
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._n_requests = 0
        self._n_batches = 0
        self._n_docs = 0
        self._n_tokens = 0
        self._batch_sizes = collections.deque(maxlen=stats_window)
        self._latencies = collections.deque(maxlen=stats_window)
        self._t_start = time.time()

    # -- lifecycle ---------------------------------------------------------

    @property
    def foldin(self) -> FoldIn:
        """The currently served :class:`FoldIn` (changes on :meth:`swap`)."""
        with self._lock:
            return self._foldin

    @property
    def artifact_version(self) -> str:
        """Label of the currently served artifact."""
        with self._lock:
            return self._version

    def start(self) -> "QueryServer":
        with self._lock:
            if self._stopped:
                raise RuntimeError(
                    "query server stopped; build a new QueryServer (stop() "
                    "is final so no submitted request can be stranded)")
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop serving, permanently: the in-flight batch finishes, queued
        requests are failed with ``RuntimeError``, and later :meth:`submit`
        calls raise instead of enqueueing.

        The shutdown order makes the single drain below complete:
        ``_stopped`` is set under the same lock :meth:`submit` enqueues
        under, so once it is set nothing can enter the queue; the
        dispatcher is then joined (it may still consume and resolve
        requests — those count as served); whatever remains is failed.  No
        future can be left unresolved."""
        with self._lock:
            self._stopped = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.future.set_exception(RuntimeError("query server stopped"))

    def swap(self, foldin: FoldIn, version: str | None = None) -> str:
        """Atomically replace the served artifact; returns its version.

        Safe under concurrent load: the dispatcher reads the
        ``(foldin, version)`` pair once per batch, right before dispatch —
        the batch in flight finishes on the artifact it started with,
        every batch formed after the swap scores on ``foldin``, and each
        response's ``artifact_version`` says which one it was.  No queue
        flush, no dropped futures.  Build ``foldin`` via
        :meth:`FoldIn.with_posterior` to reuse the warm bucket cache (a
        swap then builds no scorer).  ``version`` defaults to
        ``"v<swap count>"``."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("query server stopped")
            self._swaps += 1
            self._foldin = foldin
            self._version = (str(version) if version is not None
                             else f"v{self._swaps}")
            return self._version

    def __enter__(self) -> "QueryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client edge -------------------------------------------------------

    def submit(self, values, segment_ids=None, lengths=None,
               timeout_s: float | None = None) -> Future:
        """Enqueue one request (one or more documents); returns a
        :class:`~concurrent.futures.Future` of :class:`QueryResponse`.
        Raises ``RuntimeError`` once the server is stopped (fail fast —
        a request accepted after :meth:`stop` could never resolve).

        ``timeout_s`` (default ``default_timeout_s``) sets the request's
        deadline: if the dispatcher reaches it after the deadline the
        future fails with ``TimeoutError`` instead of being scored for a
        caller that has given up.  A full queue blocks at most
        ``admission_timeout_s`` before rejecting with ``TimeoutError``."""
        values = np.asarray(values, np.int32).ravel()
        if lengths is None:
            if segment_ids is None:
                lengths = np.array([len(values)], np.int64)
            else:
                seg = np.asarray(segment_ids, np.int64).ravel()
                if seg.shape != values.shape:
                    raise ValueError("segment_ids must align with values")
                n_docs = int(seg.max()) + 1 if len(seg) else 0
                lengths = np.bincount(seg, minlength=n_docs)
                if (np.sort(seg) != seg).any():
                    raise ValueError("segment_ids must be nondecreasing "
                                     "per request (documents back to back)")
        lengths = np.asarray(lengths, np.int64).ravel()
        if len(lengths) == 0:
            raise ValueError("request has no documents")
        if (lengths <= 0).any():
            # a zero/negative length silently shifts every later document's
            # doc_ll slice in _dispatch — reject at the edge instead
            bad = int(lengths[lengths <= 0][0])
            raise ValueError(f"document lengths must be positive, got {bad} "
                             f"(every document needs at least one token)")
        if int(lengths.sum()) != len(values):
            raise ValueError(f"lengths sum to {int(lengths.sum())}, "
                             f"got {len(values)} values")
        fut: Future = Future()
        now = time.time()
        t = timeout_s if timeout_s is not None else self.default_timeout_s
        req = _Request(values, lengths, fut, now,
                       deadline=(now + t) if t is not None else None)
        # enqueue under the lifecycle lock: once stop() has set _stopped,
        # nothing can enter the queue, so its single drain is complete and
        # no future is ever stranded.  Backpressure (queue full) is a
        # retry loop so the lock is never held while blocked — bounded by
        # admission_timeout_s so a stalled dispatcher can't park a client
        # forever.
        admit_by = now + self.admission_timeout_s
        while True:
            with self._lock:
                if self._stopped:
                    raise RuntimeError(
                        "query server stopped; submit() after stop() would "
                        "enqueue into a dead dispatcher")
                try:
                    self._q.put_nowait(req)
                    return fut
                except queue.Full:
                    if time.time() >= admit_by:
                        self._n_rejected += 1
                        raise TimeoutError(
                            f"query queue full for {self.admission_timeout_s}"
                            f"s ({self._q.maxsize} undispatched requests); "
                            f"rejecting instead of blocking forever")
            time.sleep(5e-4)

    # -- dispatch ----------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            docs = len(first.lengths)
            deadline = time.time() + self.max_delay_s
            while docs < self.max_batch_docs:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    req = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                batch.append(req)
                docs += len(req.lengths)
            # fail-fast expired requests before burning a batch slot on a
            # caller whose QueryClient already raised and walked away
            now = time.time()
            live, expired = [], []
            for r in batch:
                (expired if r.deadline is not None and now > r.deadline
                 else live).append(r)
            if expired:
                batch = live
                for req in expired:
                    req.future.set_exception(TimeoutError(
                        f"request expired {now - req.deadline:.3f}s past its "
                        f"deadline before dispatch"))
                with self._lock:
                    self._n_expired += len(expired)
                if not batch:
                    continue
            # the swap capture point: one (scorer, version) read per batch,
            # after batch formation and before dispatch — a swap() lands
            # between batches, never inside one
            with self._lock:
                fold, ver = self._foldin, self._version
            try:
                with _on_device(fold):
                    self._dispatch(batch, fold, ver)
            except Exception as e:                 # surface, don't die
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
            # the loop holds no artifact between batches: after a swap the
            # old tables leave the device once the last batch on them ends
            del fold

    def _dispatch(self, batch: list[_Request], fold: FoldIn,
                  version: str) -> None:
        values = np.concatenate([r.values for r in batch])
        lengths = np.concatenate([r.lengths for r in batch])
        res = fold.score(values, lengths=lengths)
        t_done = time.time()

        off = 0
        for req in batch:
            nd = len(req.lengths)
            doc_ll = res.doc_ll[off:off + nd]
            n_tok = int(req.lengths.sum())
            ptl = float(doc_ll.sum()) / n_tok if n_tok else float("nan")
            mixtures = {}
            for name, rows in res.mixtures.items():
                grp = res.mixture_groups[name]
                sel = (grp >= off) & (grp < off + nd)
                mixtures[name] = rows[sel]
            req.future.set_result(QueryResponse(
                doc_ll=doc_ll.copy(), per_token_ll=ptl,
                perplexity=float(np.exp(-ptl)) if n_tok else float("nan"),
                n_tokens=n_tok, n_docs=nd, mixtures=mixtures,
                batch_docs=res.n_docs,
                latency_s=t_done - req.t_enqueue,
                artifact_version=version))
            off += nd

        with self._lock:
            self._n_requests += len(batch)
            self._n_batches += 1
            self._n_docs += res.n_docs
            self._n_tokens += res.n_tokens
            self._batch_sizes.append(res.n_docs)
            self._latencies.extend(t_done - r.t_enqueue for r in batch)

    # -- accounting --------------------------------------------------------

    def stats(self) -> dict:
        """Serving counters since construction: lifetime counts, docs/s,
        the compiled-bucket cache size, and windowed mean batch occupancy
        and p50/p95 latency (ms)."""
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            dt = max(time.time() - self._t_start, 1e-9)
            return {
                "requests": self._n_requests,
                "batches": self._n_batches,
                "docs": self._n_docs,
                "tokens": self._n_tokens,
                "mean_batch_docs": (float(np.mean(self._batch_sizes))
                                    if self._batch_sizes else 0.0),
                "latency_p50_ms": (float(np.percentile(lat, 50)) * 1e3
                                   if len(lat) else float("nan")),
                "latency_p95_ms": (float(np.percentile(lat, 95)) * 1e3
                                   if len(lat) else float("nan")),
                "docs_per_s": self._n_docs / dt,
                "tokens_per_s": self._n_tokens / dt,
                "compiled_buckets": self._foldin.compiled_buckets,
                "bucket_evictions": getattr(
                    self._foldin, "bucket_evictions", 0),
                "artifact_version": self._version,
                "swaps": self._swaps,
                "queue_depth": self._q.qsize(),
                "expired": self._n_expired,
                "rejected": self._n_rejected,
            }


def _on_device(fold: FoldIn):
    """The dispatch thread's device guard: PyTorch's current CUDA device is
    per thread, and a batch's kernels must launch on its FoldIn's card."""
    if fold.device.type == "cuda":
        return torch.cuda.device(fold.device)
    return contextlib.nullcontext()


class QueryClient:
    """Synchronous facade over a running :class:`QueryServer`."""

    def __init__(self, server: QueryServer, timeout_s: float = 120.0):
        self.server = server
        self.timeout_s = timeout_s

    def score(self, values, segment_ids=None, lengths=None) -> QueryResponse:
        """Score one request's documents; blocks until the batched
        dispatch resolves it.  The client's ``timeout_s`` travels with the
        request as its deadline, so a request this client gives up on is
        failed fast by the dispatcher instead of being scored for nobody."""
        fut = self.server.submit(values, segment_ids=segment_ids,
                                 lengths=lengths, timeout_s=self.timeout_s)
        return fut.result(timeout=self.timeout_s)

    def topics(self, name: str, k: int = 10):
        """Convenience pass-through: top-k columns of a posterior table
        (answered from the artifact, no dispatch)."""
        return self.server.foldin.posterior.top_k(name, k)
