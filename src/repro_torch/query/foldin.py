"""Fold-in: score documents the engine never saw.

The port of ``repro.query.foldin``.  Fold-in is held-out inference
productionized: freeze the global Dirichlets at a
:class:`~repro_torch.query.posterior.Posterior`'s concentrations, give the
unseen documents fresh local posteriors at the prior, run a fixed number of
local-only VMP passes (the ``zstats`` token-plate kernel — the same hot loop
as training), and read off

  - the per-token predictive ELBO (global-KL terms excluded) and its
    perplexity ``exp(-elbo/token)``,
  - per-document scores (the ELBO's partition-group decomposition),
  - MAP topic mixtures (the fitted local Dirichlet rows, normalized).

The compute is :func:`repro_torch.core.svi.build_local_scorer` — the *same*
machinery as the SVI engine's held-out ELBO, so at matching bucket (exact
shapes) and iteration settings a fold-in score of the engine's held-out
documents reproduces ``svi.heldout_elbo`` **bitwise**.

Requests are padded to **length buckets**: every sliced axis is padded up to
a power-of-two bucket (masked, update-invariant), and one scorer serves
every request of a bucket signature (a bounded LRU, as in the reference).
The port compiles nothing, so a bucket's scorer is a closure over its
sliced program; what each request pays is the host work: the blank model's
copy and ``compile``, the slice (``compiler.slice_arrays``), the owner plans
of its own token streams (``svi.host_batch``: a cached plan would feed one
request's kernel another request's tokens) and the copy to the device.
``FoldIn.times`` (a list, None by default) records those ms per score.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import math
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import trace
from ..core import svi
from ..core.compiler import _padded, slice_arrays
from ..core.vmp import resolve_device
from ..kernels.fused_zstats import placed
from .posterior import Posterior


class _BucketCache:
    """Bounded LRU of bucket scorers.

    Shared by reference across :meth:`FoldIn.with_posterior` generations
    (scorers are shape-specialized, not value-specialized), and mutated
    from whatever thread scores — the dispatcher, a direct caller — so
    every access is under one lock.  ``capacity`` caps the cache and
    ``evictions`` counts what fell out (surfaced in
    ``QueryServer.stats()["bucket_evictions"]``)."""

    def __init__(self, capacity: Optional[int]):
        self._cap = capacity                  # None = unbounded
        self._fns: "collections.OrderedDict" = collections.OrderedDict()
        self._lock = threading.Lock()
        self._evictions = 0

    def get(self, sig):
        with self._lock:
            fn = self._fns.get(sig)
            if fn is not None:
                self._fns.move_to_end(sig)    # LRU touch
            return fn

    def put(self, sig, fn) -> None:
        with self._lock:
            self._fns[sig] = fn
            self._fns.move_to_end(sig)
            while self._cap is not None and len(self._fns) > self._cap:
                self._fns.popitem(last=False)
                self._evictions += 1

    def contains(self, sig) -> bool:
        """Membership without the LRU touch (a warm/cold probe must not
        reorder the cache it is only asking about)."""
        with self._lock:
            return sig in self._fns

    @property
    def evictions(self) -> int:
        with self._lock:
            return self._evictions

    def __len__(self) -> int:
        with self._lock:
            return len(self._fns)


@dataclasses.dataclass
class FoldInConfig:
    """Knobs of the fold-in scorer.

    ``local_iters`` — local coordinate-ascent passes (match the engine's
    ``holdout_local_iters`` for comparable/bitwise scores).
    ``bucket`` — padding policy for the scorer cache: ``"pow2"`` (default)
    pads every sliced axis up to ``max(min_cap, next_pow2(n))`` so request
    shapes collapse onto few scorers; ``None`` = exact shapes (one scorer
    per distinct shape — the bitwise-reference mode).
    ``max_compiled`` — LRU bound on the bucket cache (``None`` =
    unbounded); evictions are counted (:attr:`FoldIn.bucket_evictions`).
    """
    local_iters: int = 10
    bucket: Optional[str] = "pow2"
    min_cap: int = 64
    max_compiled: Optional[int] = 64

    def __post_init__(self):
        if self.local_iters < 0:
            raise ValueError("local_iters must be >= 0")
        if self.bucket not in (None, "exact", "pow2"):
            raise ValueError(f"unknown bucket policy {self.bucket!r}; "
                             f"choose 'pow2', 'exact', or None")
        if self.max_compiled is not None and self.max_compiled < 1:
            raise ValueError("max_compiled must be >= 1 (or None for "
                             "an unbounded cache)")


@dataclasses.dataclass
class FoldInResult:
    """One scored batch of documents."""
    elbo: float                      # total score, global KLs excluded
    n_tokens: int                    # observed instances scored
    n_docs: int
    per_token_ll: float              # elbo / n_tokens (nats per token)
    perplexity: float                # exp(-per_token_ll)
    doc_ll: np.ndarray               # (n_docs,) per-document decomposition
    mixtures: dict[str, np.ndarray]  # local RV -> (rows, K) MAP mixtures
    mixture_groups: dict[str, np.ndarray]  # local RV -> (rows,) doc of row
    caps: dict                       # bucket signature this ran at


class FoldIn:
    """Score unseen documents against a frozen :class:`Posterior`, on one
    device (``device=None`` means ``"cuda"``)::

        post = Posterior.load("/artifacts/lda")
        fold = FoldIn(post)                       # rebuilds the model
        res = fold.score(tokens, lengths=doc_lengths)
        res.per_token_ll, res.perplexity, res.mixtures["theta"]

    ``model`` overrides the zoo rebuild (``models.make(post.model,
    **post.params)``) for models defined outside the zoo; any observations
    on it are discarded (each query binds its own).
    """

    def __init__(self, posterior: Posterior, config: FoldInConfig = None,
                 model=None, device=None):
        self.posterior = posterior
        self.cfg = config or FoldInConfig()
        # "cuda" as its card, by index: the server's dispatch thread
        # enters this device, and PyTorch's current device is per thread
        self.device = placed(resolve_device(device))
        if model is None:
            from ..core import models
            try:
                model = models.make(posterior.model, **posterior.params)
            except KeyError:
                raise ValueError(
                    f"model {posterior.model!r} is not in the zoo; pass "
                    f"the defining Model via FoldIn(..., model=)") from None
        self._proto = _blank_model(model)
        self._globals = self._on_device(posterior)
        # caps signature -> scorer (bounded LRU, lock inside)
        self._fns = _BucketCache(self.cfg.max_compiled)
        # a list to record, per score, the ms of its host parts ("compile":
        # the blank model's copy, observe and compile; "slice", "plan":
        # the latest svi.slice and svi.plan spans of the process, this
        # score's unless another thread built a batch meanwhile; "h2d")
        # and of the scorer's run to results on the host ("run"), one
        # record appended whole by whichever thread scored (the server's
        # dispatcher, or a gateway caller scoring direct)
        self.times: Optional[list] = None

    def _on_device(self, posterior: Posterior) -> dict:
        return {n: torch.tensor(np.asarray(v, np.float32), device=self.device)
                for n, v in posterior.globals().items()}

    def with_posterior(self, posterior: Posterior) -> "FoldIn":
        """A :class:`FoldIn` serving ``posterior`` that reuses this one's
        warm state — the hot-refresh path for :meth:`QueryServer.swap`.

        The scorers are shape-specialized, not value-specialized (the
        posterior tables are runtime arguments), so when the new artifact
        comes from the same model family — same model name and parameters,
        same global table shapes — the blank prototype *and* the bucket
        cache are shared.  A posterior of a different shape gets a fresh
        :class:`FoldIn` instead."""
        new_globals = self._on_device(posterior)
        same = (posterior.model == self.posterior.model
                and posterior.params == self.posterior.params
                and set(new_globals) == set(self._globals)
                and all(new_globals[n].shape == self._globals[n].shape
                        for n in self._globals))
        if not same:
            return FoldIn(posterior, self.cfg, device=self.device)
        new = copy.copy(self)        # shares _proto (deep-copied per score)
        new.posterior = posterior    # and _fns (new scorers serve both)
        new._globals = new_globals
        return new

    # -- bucketing ---------------------------------------------------------

    def _caps_fn(self, name: str, n: int) -> int:
        if self.cfg.bucket in (None, "exact"):
            return n
        return max(self.cfg.min_cap, 1 << max(0, math.ceil(
            math.log2(max(n, 1)))))

    @property
    def compiled_buckets(self) -> int:
        """Distinct bucket signatures built so far (cache size)."""
        return len(self._fns)

    @property
    def bucket_evictions(self) -> int:
        """Scorers evicted from the bounded bucket cache."""
        return self._fns.evictions

    # -- scoring -----------------------------------------------------------

    def _bind(self, values, segment_ids, lengths, observed, bindings):
        """Bind the request onto a blank model and compile it: ``(program,
        n_docs, caps_fn)``, the host-side metadata pass shared by
        :meth:`score` and :meth:`plan`."""
        if observed is None:
            if len(self.posterior.observed) != 1:
                raise ValueError(
                    f"artifact observes {list(self.posterior.observed)}; "
                    f"pass observed= to pick the RV this data binds to")
            observed = self.posterior.observed[0]
        values = np.asarray(values, np.int32).ravel()
        if segment_ids is None and lengths is None:
            lengths = np.array([len(values)], np.int64)   # one document
        model = copy.deepcopy(self._proto)
        model[observed].observe(values, segment_ids=segment_ids,
                                lengths=lengths)
        for pname, ids in (bindings or {}).items():
            model.bind(pname, ids)
        program = model.compile()
        self._check_globals(program)
        n_docs = program.meta.get("pstar_size")
        if not n_docs:
            raise ValueError("fold-in needs a '?' partition plate "
                             "(documents) in the model")
        caps_fn = None if self.cfg.bucket in (None, "exact") \
            else self._caps_fn
        return program, n_docs, caps_fn

    def _signature(self, caps: dict, n_docs: int):
        n_seg = self._caps_fn("__groups__", n_docs)
        return n_seg, (("__groups__", n_seg),) + tuple(sorted(caps.items()))

    def plan(self, lengths, *, observed: str = None,
             bindings: dict = None) -> dict:
        """The dispatch a request with these document ``lengths`` would
        take, without scoring anything: the padded bucket ``caps`` and cache
        ``signature``, document/token counts, and whether that bucket's
        scorer is already built (``warm``).  Token *values* never influence
        a plan — only extents do — so zeros stand in for the payload."""
        lengths = np.asarray(lengths, np.int64).ravel()
        values = np.zeros(int(lengths.sum()), np.int32)
        program, n_docs, caps_fn = self._bind(values, None, lengths,
                                              observed, bindings)
        _, _, caps, n_tok = slice_arrays(program, np.arange(n_docs), caps_fn)
        n_seg, sig = self._signature(caps, n_docs)
        return {"signature": sig, "caps": dict(caps), "n_seg": int(n_seg),
                "n_docs": int(n_docs), "n_tokens": int(n_tok),
                "warm": self._fns.contains(sig)}

    def score(self, values, segment_ids=None, lengths=None, *,
              observed: str = None, bindings: dict = None) -> FoldInResult:
        """Fold in one batch of documents and score it.

        ``values`` — observed category indices, documents back to back;
        ``segment_ids``/``lengths`` — the ragged document structure (as in
        ``Model.observe``).  ``observed`` names the RV the data binds to
        (optional when the artifact records exactly one); ``bindings``
        supplies intermediate ``?``-plate parent maps (``Model.bind``, e.g.
        SLDA's sentence->document map)."""
        t0 = time.perf_counter()
        program, n_docs, caps_fn = self._bind(values, segment_ids, lengths,
                                              observed, bindings)
        t1 = time.perf_counter()
        hb, caps, n_tok = svi.host_batch(program, np.arange(n_docs), caps_fn,
                                         device=self.device)
        n_seg, sig = self._signature(caps, n_docs)
        seg = {k: svi.segment_index(v, n_seg) for k, v in
               _segment_arrays(program, caps, hb["dirs"], n_seg).items()}
        t2 = time.perf_counter()
        batch = svi.device_put_batch(hb, self.device)
        seg_dev = {k: tuple(torch.from_numpy(a).to(self.device) for a in v)
                   for k, v in seg.items()}
        t3 = time.perf_counter()

        fn = self._fns.get(sig)
        if fn is None:
            fn = svi.build_local_scorer(program, caps, self.cfg.local_iters,
                                        extras=True, n_seg=n_seg)
            self._fns.put(sig, fn)
        elbo, locs, grp = fn(self._globals, batch["arrays"], batch["plans"],
                             seg_dev)

        elbo = float(elbo)
        mixtures, mix_groups = {}, {}
        for name in self.posterior.local:
            if name not in locs:
                continue
            d = program.dirichlets[name]
            rows = locs[name].cpu().numpy()[:d.g]
            mixtures[name] = rows / rows.sum(-1, keepdims=True)
            mix_groups[name] = (np.asarray(d.group_rows, np.int64)
                                if d.group_rows is not None
                                else np.zeros(d.g, np.int64))
        doc_ll = grp.cpu().numpy()[:n_docs]
        if self.times is not None:
            spans = trace.totals()
            self.times.append(dict(
                compile=(t1 - t0) * 1e3,
                slice=spans["svi.slice"]["last_s"] * 1e3,
                plan=spans["svi.plan"]["last_s"] * 1e3,
                h2d=(t3 - t2) * 1e3, run=(time.perf_counter() - t3) * 1e3))
        per_tok = elbo / n_tok if n_tok else float("nan")
        return FoldInResult(
            elbo=elbo, n_tokens=int(n_tok), n_docs=int(n_docs),
            per_token_ll=per_tok,
            perplexity=float(np.exp(-per_tok)) if n_tok else float("nan"),
            doc_ll=doc_ll, mixtures=mixtures,
            mixture_groups=mix_groups, caps=dict(caps))

    def _check_globals(self, program):
        for name, tab in self._globals.items():
            d = program.dirichlets.get(name)
            if d is None:
                raise ValueError(
                    f"artifact global {name!r} is not a Dirichlet of the "
                    f"rebuilt model — artifact/model mismatch")
            if (d.g, d.k) != tuple(tab.shape):
                raise ValueError(
                    f"artifact global {name!r} has shape "
                    f"{tuple(tab.shape)}, the rebuilt model expects "
                    f"({d.g}, {d.k}) — vocabulary/topic-count mismatch")


def _blank_model(model):
    """A deep copy of ``model`` with all observations/bindings dropped, so
    each query binds its own data without inheriting the training corpus
    (or its memory)."""
    model = copy.copy(model)          # shallow: share nothing mutable below
    model.net = copy.deepcopy(model.net)
    model.observations = {}
    model.plate_bindings = {}
    model._program = None
    model._state = None
    model._elbo_trace = []
    for rv in model.net.rvs.values():
        if getattr(rv, "observed", False):
            rv.observed = False
    return model


def _segment_arrays(program, caps: dict, dirs: dict, n_seg: int) -> dict:
    """Per-axis partition-group ids for the scorer's ``group_elbo``
    decomposition, padded to ``caps`` with the out-of-range sentinel
    ``n_seg`` (:func:`~repro_torch.core.svi.segment_index` drops it).
    Covers each latent plate, each static factor, and each local
    Dirichlet's rows."""
    seg = {}
    for spec in program.latents:
        g = np.asarray(spec.group, np.int32)
        seg[spec.name] = _padded(g, caps[spec.name], fill=n_seg)
    for s in program.statics:
        g = np.asarray(s.group, np.int32)
        seg[s.x_name] = _padded(g, caps[s.x_name], fill=n_seg)
    for name, d in program.dirichlets.items():
        if d.group_rows is None or name not in dirs:
            continue
        rows = np.asarray(dirs[name]["rows"], np.int64)
        valid = rows < d.g
        seg[name] = np.where(valid, d.group_rows[np.minimum(rows, d.g - 1)],
                             n_seg).astype(np.int32)
    return seg
