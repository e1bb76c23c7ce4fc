"""Logical plans for the declarative statistical query language.

The port of ``repro.gateway.plan``.  ``ql.py`` parses query text into the
small dataclasses here; the gateway compiles each plan onto the machinery
that already exists: artifact-direct statistical queries
(``repro_torch.query.posterior.Posterior``) and fold-in
(``repro_torch.query.foldin.FoldIn``, micro-batched through the artifact's
``QueryServer``).  Nothing in this module owns state: a plan is a value,
``execute`` binds it to one registry entry, and ``explain`` renders what
``execute`` *would* do, including, for PREDICT, the padded bucket
signature the fold-in scorer would build or reuse and the kernel routes of
that bucket from the port's analyzer (``repro_torch.analysis.explain``).

The **route contract**: ``explain()`` and ``execute()`` derive the route
line from the same :func:`route_of` helper on the same entry snapshot, so
an EXPLAIN's stated route is exactly the executed result's ``route``.
Every line of an EXPLAIN is the reference's, letter for letter, except the
kernel routes, which name the Hopper routes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..query.server import _on_device

__all__ = ["TopicsQuery", "SimilarityQuery", "CredibleQuery",
           "PredictQuery", "ExplainQuery", "ShowQuery", "GatewayResult",
           "route_of", "execute", "explain"]


# ---------------------------------------------------------------------------
# the logical plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopicsQuery:
    """``TOPICS OF <rv> [TOP <k>] [USING ARTIFACT '<id>']``."""
    rv: str
    k: int = 10
    artifact: Optional[str] = None
    kind = "topics"

    def to_text(self) -> str:
        return (f"TOPICS OF {self.rv} TOP {self.k}"
                + _art_clause(self.artifact))


@dataclasses.dataclass(frozen=True)
class SimilarityQuery:
    """``SIMILARITY BETWEEN rv[i] AND rv[j] USING <metric>`` (one pair) or
    ``SIMILARITY OF rv [USING <metric>]`` (the full ``(G, G)`` matrix)."""
    rv: str
    metric: str = "hellinger"
    pair: Optional[tuple] = None          # (row_i, row_j) | None = matrix
    artifact: Optional[str] = None
    kind = "similarity"

    def to_text(self) -> str:
        if self.pair is not None:
            i, j = self.pair
            head = (f"SIMILARITY BETWEEN {self.rv}[{i}] AND "
                    f"{self.rv}[{j}] USING {self.metric}")
        else:
            head = f"SIMILARITY OF {self.rv} USING {self.metric}"
        return head + _art_clause(self.artifact)


@dataclasses.dataclass(frozen=True)
class CredibleQuery:
    """``CREDIBLE INTERVAL <prob> FOR rv[row]`` (or the whole table)."""
    rv: str
    prob: float = 0.9
    row: Optional[int] = None
    artifact: Optional[str] = None
    kind = "credible"

    def to_text(self) -> str:
        tgt = self.rv if self.row is None else f"{self.rv}[{self.row}]"
        return (f"CREDIBLE INTERVAL {self.prob:g} FOR {tgt}"
                + _art_clause(self.artifact))


@dataclasses.dataclass(frozen=True)
class PredictQuery:
    """``PREDICT LL FOR DOCS $<payload> [USING ARTIFACT '<id>']``.

    ``payload`` names a key of the caller's ``params`` dict holding the
    documents: an array of token values (one document), or a dict with
    ``values`` plus ``lengths``/``segment_ids`` and optional ``bindings``
    (nested-plate parent maps, e.g. SLDA's sentence->document)."""
    payload: str
    artifact: Optional[str] = None
    kind = "predict"

    def to_text(self) -> str:
        return f"PREDICT LL FOR DOCS ${self.payload}" \
            + _art_clause(self.artifact)


@dataclasses.dataclass(frozen=True)
class ExplainQuery:
    """``EXPLAIN <query>`` — render the inner plan, execute nothing."""
    inner: object
    kind = "explain"

    @property
    def artifact(self):
        return self.inner.artifact

    def to_text(self) -> str:
        return f"EXPLAIN {self.inner.to_text()}"


@dataclasses.dataclass(frozen=True)
class ShowQuery:
    """``SHOW ARTIFACTS`` / ``SHOW STATS`` — gateway introspection."""
    what: str                              # "artifacts" | "stats"
    artifact = None
    kind = "show"

    def to_text(self) -> str:
        return f"SHOW {self.what.upper()}"


def _art_clause(artifact) -> str:
    return f" USING ARTIFACT '{artifact}'" if artifact else ""


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GatewayResult:
    """One executed query.  ``route`` is the exact line an ``EXPLAIN`` of
    the same query renders (the route contract); ``error_bound`` is the
    compaction's measured total-variation bound when the serving artifact
    is compacted (``None`` for full artifacts)."""
    kind: str
    artifact: Optional[str]
    version: Optional[str]
    route: str
    value: dict
    error_bound: Optional[float] = None
    latency_s: float = 0.0
    tenant: str = "default"


# ---------------------------------------------------------------------------
# routing + execution
# ---------------------------------------------------------------------------

def _payload_parts(plan: PredictQuery, params: dict):
    """Normalize the named payload to ``(values, segment_ids, lengths,
    bindings)``."""
    if not params or plan.payload not in params:
        raise KeyError(
            f"query names payload ${plan.payload} but params has "
            f"{sorted(params or ())} — pass params={{{plan.payload!r}: "
            f"docs}}")
    p = params[plan.payload]
    if isinstance(p, dict):
        return (np.asarray(p["values"], np.int32).ravel(),
                p.get("segment_ids"), p.get("lengths"),
                p.get("bindings"))
    return np.asarray(p, np.int32).ravel(), None, None, None


def route_of(plan, entry, payload_bindings: bool = False) -> str:
    """The one-line route an execution of ``plan`` on ``entry`` takes.
    ``explain`` and ``execute`` both call this, which is what makes the
    EXPLAIN output match the executed route by construction."""
    base = f"artifact '{entry.artifact_id}' {entry.version}"
    if plan.kind == "topics":
        return (f"{base} · posterior.top_k({plan.rv!r}, {plan.k}) "
                f"[artifact-direct]")
    if plan.kind == "similarity":
        tgt = "" if plan.pair is None else list(plan.pair)
        return (f"{base} · posterior.similarity({plan.rv!r}, "
                f"{plan.metric!r}){tgt or ''} [artifact-direct]")
    if plan.kind == "credible":
        tgt = "" if plan.row is None else f"[{plan.row}]"
        return (f"{base} · posterior.credible_interval({plan.rv!r}, "
                f"{plan.prob:g}){tgt} [artifact-direct]")
    if plan.kind == "predict":
        if payload_bindings:
            return f"{base} · FoldIn.score [direct: nested-plate bindings]"
        return f"{base} · QueryServer.submit -> FoldIn.score [micro-batched]"
    raise ValueError(f"unroutable plan kind {plan.kind!r}")


def execute(plan, entry, params: dict = None,
            deadline: float = None) -> GatewayResult:
    """Run one (non-EXPLAIN, non-SHOW) plan against one registry entry.

    Artifact-direct queries run host numpy on the caller thread; PREDICT
    goes through the entry's micro-batching ``QueryServer`` (the deadline
    travels with the queued request) unless the payload
    carries nested-plate ``bindings``, which the batched dispatch cannot
    concatenate across requests — those score direct, same admission and
    accounting."""
    post = entry.posterior
    err = getattr(post, "error_bound", None)

    if plan.kind == "predict":
        values, seg, lengths, bindings = _payload_parts(plan, params)
        route = route_of(plan, entry, payload_bindings=bool(bindings))
        if bindings:
            fold, version = entry.capture()
            # the caller's thread scores on the fold-in's card, as the
            # dispatch thread does (the current device is per thread)
            with _on_device(fold):
                res = fold.score(values, segment_ids=seg, lengths=lengths,
                                 bindings=bindings)
            value = {"doc_ll": res.doc_ll, "per_token_ll": res.per_token_ll,
                     "perplexity": res.perplexity, "n_docs": res.n_docs,
                     "n_tokens": res.n_tokens, "mixtures": res.mixtures,
                     "batch_docs": res.n_docs}
        else:
            remaining = None if deadline is None \
                else max(deadline - time.time(), 1e-3)
            fut = entry.server.submit(values, segment_ids=seg,
                                      lengths=lengths, timeout_s=remaining)
            res = fut.result(timeout=remaining)
            version = res.artifact_version
            value = {"doc_ll": res.doc_ll, "per_token_ll": res.per_token_ll,
                     "perplexity": res.perplexity, "n_docs": res.n_docs,
                     "n_tokens": res.n_tokens, "mixtures": res.mixtures,
                     "batch_docs": res.batch_docs}
        return GatewayResult(kind=plan.kind, artifact=entry.artifact_id,
                             version=version, route=route, value=value,
                             error_bound=err)

    route = route_of(plan, entry)
    if plan.kind == "topics":
        idx, probs = post.top_k(plan.rv, plan.k)
        value = {"indices": idx, "probs": probs}
    elif plan.kind == "similarity":
        sim = post.similarity(plan.rv, kind=plan.metric)
        if plan.pair is not None:
            i, j = plan.pair
            if not (0 <= i < sim.shape[0] and 0 <= j < sim.shape[0]):
                raise IndexError(
                    f"similarity pair {plan.pair} out of range for "
                    f"{plan.rv} with {sim.shape[0]} rows")
            value = {"pair": (i, j), "similarity": float(sim[i, j]),
                     "metric": plan.metric}
        else:
            value = {"matrix": sim, "metric": plan.metric}
    elif plan.kind == "credible":
        if plan.row is not None:
            n_rows = post._conc(plan.rv).shape[0]   # KeyError if unknown RV
            if not 0 <= plan.row < n_rows:
                raise IndexError(
                    f"row {plan.row} out of range for {plan.rv} with "
                    f"{n_rows} rows")
            # row-pruned: one row's bisection, not the whole table's
            lo, hi = post.credible_interval(plan.rv, plan.prob,
                                            rows=plan.row)
            lo, hi = lo[0], hi[0]
        else:
            lo, hi = post.credible_interval(plan.rv, plan.prob)
        value = {"lo": lo, "hi": hi, "prob": plan.prob}
    else:
        raise ValueError(f"cannot execute plan kind {plan.kind!r}")
    return GatewayResult(kind=plan.kind, artifact=entry.artifact_id,
                         version=entry.version, route=route, value=value,
                         error_bound=err)


# ---------------------------------------------------------------------------
# EXPLAIN rendering
# ---------------------------------------------------------------------------

def explain(plan, entry, params: dict = None) -> str:
    """Render what :func:`execute` would do, without doing any of it.

    For PREDICT with the payload provided, this includes the padded
    bucket signature the fold-in scorer keys its cache on (``FoldIn.plan``,
    the same binding pass ``score`` uses, so the stated caps are the
    executed caps) and the per-latent kernel routes of that bucket from the
    port's analyzer, on the fold-in's device."""
    inner = plan.inner if plan.kind == "explain" else plan
    post = entry.posterior
    bindings = None
    if inner.kind == "predict" and params and inner.payload in params:
        p = params[inner.payload]
        bindings = p.get("bindings") if isinstance(p, dict) else None
    route = route_of(inner, entry, payload_bindings=bool(bindings))

    out = [f"EXPLAIN {inner.to_text()}",
           f"  route: {route}",
           f"  artifact: model={post.model} params={post.params} "
           f"backend={post.meta.get('backend')}"]
    comp = getattr(post, "compaction", None)
    if comp:
        worst = getattr(post, "error_bound", None)
        out.append(f"  compacted: yes — tv error <= {worst:.3e} "
                   f"(reported on every result as error_bound)")
    else:
        out.append("  compacted: no")

    if inner.kind in ("topics", "similarity", "credible"):
        tab = post.posteriors.get(inner.rv)
        if tab is None:
            out.append(f"  !! no posterior for RV {inner.rv!r}; available: "
                       f"{sorted(post.posteriors)}")
            return "\n".join(out)
        g, k = tab.shape
        out.append(f"  table {inner.rv}: {g}x{k} {tab.dtype}")
        rows = g if getattr(inner, "row", None) is None else 1
        cost = {"topics": f"O(G*K log K) = O({g}*{k} log {k}) stable sort",
                "similarity": f"O(G^2*K) = O({g}^2*{k}) affinity matmul",
                "credible": f"O(R*K*60) = O({rows}*{k}*60) betainc "
                            f"bisection (row-pruned)",
                }[inner.kind]
        out.append(f"  execution: host numpy, {cost}; no device dispatch, "
                   f"no queue")
        return "\n".join(out)

    # PREDICT: fold-in dispatch + static kernel routes
    if not params or inner.payload not in params:
        out.append(f"  payload ${inner.payload}: not bound — pass params="
                   f"{{{inner.payload!r}: docs}} to plan the exact bucket")
        out.append("  dispatch: QueryServer micro-batch -> compiled "
                   "fold-in bucket (signature depends on document lengths)")
        return "\n".join(out)

    values, seg, lengths, bindings = _payload_parts(inner, params)
    if lengths is None and seg is None:
        lengths = np.array([len(values)], np.int64)
    elif lengths is None:
        segarr = np.asarray(seg, np.int64).ravel()
        lengths = np.bincount(segarr, minlength=int(segarr.max()) + 1)
    lengths = np.asarray(lengths, np.int64).ravel()
    fold, _ = entry.capture()
    fp = fold.plan(lengths, bindings=bindings)
    out.append(f"  payload ${inner.payload}: {fp['n_docs']} docs, "
               f"{fp['n_tokens']} tokens")
    caps = " ".join(f"{n}={c}" for n, c in sorted(fp["caps"].items()))
    out.append(f"  bucket caps: __groups__={fp['n_seg']} {caps} "
               f"(scorer {'warm' if fp['warm'] else 'cold: compiles'})")
    if bindings:
        out.append("  dispatch: direct FoldIn.score on the caller thread "
                   "(nested-plate bindings cannot ride a shared batch)")
    else:
        srv = entry.server
        out.append(f"  dispatch: micro-batched (max_batch_docs="
                   f"{srv.max_batch_docs}, max_delay_s={srv.max_delay_s}); "
                   f"deadline travels with the queued request")
    out.extend(_kernel_route_lines(fold, values, seg, lengths, bindings))
    return "\n".join(out)


def _kernel_route_lines(fold, values, seg, lengths, bindings) -> list:
    """Per-latent kernel routes of the fold-in bucket this payload scores
    in, through the port's analyzer (``explain.routes_at``) with the
    fold-in's own device as the backend, so the routes named are the
    routes the card takes (zero device work).  The bucket's padded streams
    are the ones routed, as ``FoldIn.score`` slices them: padding tokens
    join instance 0, which can move a segment latent's logits route."""
    try:
        from ..analysis.explain import routes_at
        from ..core.compiler import slice_arrays
        program, n_docs, caps_fn = fold._bind(values, seg, lengths, None,
                                              bindings)
        arrays, _, caps, _ = slice_arrays(program, np.arange(n_docs),
                                          caps_fn)
        lines = ["  kernel routes (static, repro_torch.analysis.explain):"]
        for r in routes_at(program, arrays, caps,
                           backend=fold.device.type):
            lines.append(f"    latent {r.latent} (prior {r.prior_dir}): "
                         f"route={r.label} tokens={r.n_tokens} K={r.k}")
        return lines
    except Exception as e:          # pragma: no cover - analysis optional
        return [f"  kernel routes: unavailable ({type(e).__name__}: {e})"]
