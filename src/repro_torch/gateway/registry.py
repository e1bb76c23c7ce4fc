"""Artifact registry + router: one gateway, many served posteriors.

The port of ``repro.gateway.registry``, over the port's ``FoldIn`` and
``QueryServer``; every artifact's fold-in runs on the registry's one
device (``device=None`` means ``"cuda"``).  A ``QueryServer`` serves *one*
artifact.  A gateway hosts a fleet: every registered artifact id gets its
own entry (the frozen :class:`~repro_torch.query.posterior.Posterior`, its
:class:`~repro_torch.query.foldin.FoldIn`, and a running micro-batching
``QueryServer``) and queries route by artifact id.  (Batches can never mix
artifacts: a dispatched fold-in batch runs one scorer over one posterior,
so per-artifact servers are the unit of batching, and the registry is
pure routing above them.)

Hot operations keep the server's zero-drop guarantees:

- :meth:`ArtifactRegistry.swap` replaces an entry's posterior under load.
  The new scorer is built with :meth:`FoldIn.with_posterior`, which
  *shares the warm bucket cache* when the new posterior is a later
  checkpoint of the same model family, so a swap builds no scorer and the
  first post-swap request runs warm.  The server-side capture point (one
  ``(scorer, version)`` read per batch) means no request is dropped or
  scored on a half-installed artifact, and the old tables leave the
  device once no request holds them.
- :meth:`ArtifactRegistry.retire` unroutes the id first (under the
  registry lock), then stops its server *outside* the lock: ``stop()``
  joins the dispatcher thread, and joining under a lock that ``route``
  takes would stall every other artifact's traffic.  In-flight requests on
  the retired artifact finish or fail per ``stop()``'s contract; none
  strand.
"""

from __future__ import annotations

import threading
from typing import Optional

from ..query.foldin import FoldIn, FoldInConfig
from ..query.posterior import Posterior
from ..query.server import QueryServer

__all__ = ["ArtifactEntry", "ArtifactRegistry", "UnknownArtifactError"]


class UnknownArtifactError(KeyError):
    """Routing to an id that is not (or no longer) registered."""

    def __init__(self, artifact_id: Optional[str], known: list):
        self.artifact_id = artifact_id
        super().__init__(
            f"no artifact {artifact_id!r} registered; serving {known}"
            if known else
            f"no artifact {artifact_id!r}: the registry is empty")

    def __str__(self) -> str:      # KeyError.__str__ repr-quotes the message
        return self.args[0]


class ArtifactEntry:
    """One served artifact: posterior + fold-in + its query server.

    The mutable triple ``(posterior, foldin, version)`` changes together
    on :meth:`ArtifactRegistry.swap`; :meth:`capture` reads it as one
    consistent snapshot (the registry-level analogue of the server's
    per-batch capture point) for callers that score outside the batched
    path, e.g. nested-plate PREDICT."""

    def __init__(self, artifact_id: str, posterior: Posterior,
                 foldin: FoldIn, server: QueryServer, version: str):
        self.artifact_id = artifact_id
        self._lock = threading.Lock()
        self._posterior = posterior
        self._foldin = foldin
        self._version = version
        self.server = server

    @property
    def posterior(self) -> Posterior:
        with self._lock:
            return self._posterior

    @property
    def foldin(self) -> FoldIn:
        with self._lock:
            return self._foldin

    @property
    def version(self) -> str:
        with self._lock:
            return self._version

    def capture(self):
        """One consistent ``(foldin, version)`` snapshot."""
        with self._lock:
            return self._foldin, self._version

    def _install(self, posterior: Posterior, foldin: FoldIn,
                 version: str) -> None:
        with self._lock:
            self._posterior = posterior
            self._foldin = foldin
            self._version = version

    def describe(self) -> dict:
        with self._lock:
            post, version = self._posterior, self._version
        return {"artifact": self.artifact_id, "version": version,
                "model": post.model, "params": dict(post.params),
                "compacted": bool(getattr(post, "compaction", None)),
                "error_bound": getattr(post, "error_bound", None),
                "tables": {n: list(v.shape)
                           for n, v in sorted(post.posteriors.items())}}


class ArtifactRegistry:
    """Routes artifact ids to live :class:`ArtifactEntry` serving stacks.

    ``default_artifact`` answers queries that name no artifact; it
    defaults to the first id registered and follows retirement (first
    remaining id wins).  ``device`` — where every artifact's fold-in runs
    (``None`` means ``"cuda"``)."""

    def __init__(self, foldin_config: FoldInConfig = None,
                 server_defaults: dict = None, device=None):
        self._foldin_config = foldin_config
        self._device = device
        self._server_defaults = dict(server_defaults or {})
        self._lock = threading.Lock()
        self._entries: dict[str, ArtifactEntry] = {}
        self._default: Optional[str] = None
        self._stopped = False

    # -- registration ------------------------------------------------------

    def register(self, artifact_id: str, posterior: Posterior, *,
                 version: str = "v0", model=None,
                 **server_kwargs) -> ArtifactEntry:
        """Bring an artifact online: build its fold-in, start its server,
        make the id routable.  The server starts *before* the id becomes
        routable, so a routed query never lands on a dispatcher that is
        not running."""
        fold = FoldIn(posterior, self._foldin_config, model=model,
                      device=self._device)
        kwargs = {**self._server_defaults, **server_kwargs}
        server = QueryServer(fold, version=version, **kwargs)
        server.start()
        entry = ArtifactEntry(artifact_id, posterior, fold, server, version)
        with self._lock:
            if self._stopped:
                stale = True
            elif artifact_id in self._entries:
                stale = False
            else:
                self._entries[artifact_id] = entry
                if self._default is None:
                    self._default = artifact_id
                return entry
        server.stop()            # undo: never leak a running dispatcher
        if stale:
            raise RuntimeError("registry stopped; no new registrations")
        raise ValueError(f"artifact {artifact_id!r} already registered; "
                         f"swap() replaces a live artifact's posterior")

    def swap(self, artifact_id: str, posterior: Posterior,
             version: str = None) -> str:
        """Hot-replace a served artifact's posterior; returns the new
        version label (default ``v<server swap count>``).

        Same-family posteriors keep the warm compiled-bucket cache
        (:meth:`FoldIn.with_posterior`); the entry triple and the server's
        capture pair are updated in that order, so the direct-score path
        and the batched path converge on the new artifact with each
        response labelled by the version that actually scored it."""
        entry = self.get(artifact_id)
        fold = entry.foldin.with_posterior(posterior)
        version = entry.server.swap(fold, version)
        entry._install(posterior, fold, version)
        return version

    def retire(self, artifact_id: str) -> None:
        """Take an artifact offline: unroute the id, then stop its server
        (queued requests fail with ``RuntimeError``, nothing strands)."""
        with self._lock:
            entry = self._entries.pop(artifact_id, None)
            if entry is not None and self._default == artifact_id:
                self._default = next(iter(self._entries), None)
        if entry is None:
            raise UnknownArtifactError(artifact_id, self.ids())
        # outside the lock: stop() joins the dispatcher thread, and other
        # artifacts' routing must not wait on that
        entry.server.stop()

    def stop(self) -> None:
        """Retire everything and refuse new registrations (final)."""
        with self._lock:
            self._stopped = True
            entries = list(self._entries.values())
            self._entries.clear()
            self._default = None
        for entry in entries:
            entry.server.stop()

    # -- routing -----------------------------------------------------------

    def get(self, artifact_id: Optional[str] = None) -> ArtifactEntry:
        """Route an id (or the default) to its live entry."""
        with self._lock:
            aid = artifact_id if artifact_id is not None else self._default
            entry = self._entries.get(aid) if aid is not None else None
            known = sorted(self._entries)
        if entry is None:
            raise UnknownArtifactError(artifact_id, known)
        return entry

    def ids(self) -> list:
        with self._lock:
            return sorted(self._entries)

    def describe(self) -> list:
        """``SHOW ARTIFACTS``: one provenance dict per served artifact."""
        with self._lock:
            entries = [self._entries[a] for a in sorted(self._entries)]
        return [e.describe() for e in entries]

    def stats(self) -> dict:
        """Per-artifact ``QueryServer.stats()`` trees (queue depth,
        batch occupancy, latency quantiles, built buckets + evictions,
        swap count)."""
        with self._lock:
            entries = [(a, self._entries[a]) for a in sorted(self._entries)]
        return {a: {"version": e.version, **e.server.stats()}
                for a, e in entries}

    def __enter__(self) -> "ArtifactRegistry":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
