"""Compacted posterior artifacts: bf16 + top-k tables, measured error.

The port of ``repro.gateway.compact``, with torch's bfloat16 in place of
``ml_dtypes``: the float64 probabilities are cast with
``Tensor.to(torch.bfloat16)``, which rounds through float32 to nearest
even as ``ml_dtypes`` does, so both packages store the same bits (ties
included), and the bf16 leaves are ``torch.bfloat16`` CPU tensors, which
the port's checkpoint store bitcasts as the reference's does.  Each
package loads the other's compacted artifacts.

A frozen posterior's tables are ``(G, K) float32`` Dirichlet
concentrations — for a real vocabulary, mostly near-zero mass.  Serving
replicas rarely need the full tables: :func:`compact_posterior` keeps,
per row, the ``k`` highest-mean cells as **bfloat16 probabilities** plus
the exact ``float32`` row concentration total, and spreads the dropped
tail uniformly.  Storage drops from ``4*G*K`` bytes to roughly
``6*G*k + 4*G`` (int32 index + bf16 value per kept cell, one row sum) —
``>= 4x`` whenever ``k <~ K/6``.

The error is *measured, not assumed*: compaction records, per table, the
worst-row total-variation distance between the original and the
reconstructed mean distribution, and the artifact-level maximum rides
every query answer as ``GatewayResult.error_bound`` — a gateway client
always knows how far a compacted answer can be from the full artifact's.

:class:`CompactedPosterior` *is a* :class:`Posterior`: construction
reconstructs dense float32 tables from the compact representation, so
every statistical query and fold-in runs unchanged — and because the
reconstruction is a deterministic function of the stored arrays (which
round-trip bitwise through the checkpoint layer, bf16 via its
``stored_as`` encoding), a compacted artifact answers bitwise-identically
before and after a save/load cycle.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..query.posterior import FORMAT_VERSION, _META, _STEP, Posterior

__all__ = ["CompactedPosterior", "compact_posterior", "load_compacted"]

_MIN_TAIL = 1e-6      # floor on the spread tail: keeps every cell's
                      # concentration positive (Beta marginals need a > 0)


def _bf16(p: np.ndarray) -> torch.Tensor:
    """float64 probabilities as a bf16 CPU tensor (through float32, to
    nearest even)."""
    return torch.from_numpy(np.ascontiguousarray(p)).to(torch.bfloat16)


def _reconstruct(shape, k, idx, vals, rowsum) -> np.ndarray:
    """Dense ``(G, K) float32`` concentrations from the compact triple.

    Deterministic in the stored arrays — the bitwise pre/post-save
    contract rests on this function being the only constructor."""
    g, kk = shape
    v = vals.float().numpy()                      # bf16 -> f32 is exact
    if idx is None:                               # dense-bf16 mode (k >= K)
        p = v.copy()
    else:
        tail = np.clip(1.0 - v.sum(-1), _MIN_TAIL, None)
        p = np.broadcast_to((tail / (kk - k))[:, None], (g, kk)).copy()
        np.put_along_axis(p, np.asarray(idx, np.int64), v, axis=-1)
    p /= p.sum(-1, keepdims=True)
    return (p * np.asarray(rowsum, np.float32)[:, None]).astype(np.float32)


@dataclasses.dataclass
class CompactedPosterior(Posterior):
    """A :class:`Posterior` whose tables were rebuilt from a compact
    representation.  ``posteriors`` is dense float32 (queries and fold-in
    run unchanged); ``compact_tables`` is what :meth:`save` persists;
    ``compaction`` records per-table shape/k/measured error/byte counts;
    ``error_bound`` is the artifact-wide worst total-variation error,
    attached to every gateway answer."""

    compact_tables: dict = dataclasses.field(default_factory=dict)
    compaction: dict = dataclasses.field(default_factory=dict)
    error_bound: float = 0.0

    # -- accounting --------------------------------------------------------

    def nbytes_full(self) -> int:
        return sum(r["bytes_full"] for r in self.compaction.values())

    def nbytes_compact(self) -> int:
        return sum(r["bytes_compact"] for r in self.compaction.values())

    def compression_ratio(self) -> float:
        return self.nbytes_full() / max(self.nbytes_compact(), 1)

    # -- persistence -------------------------------------------------------

    def save(self, directory: str) -> str:
        """Write the *compact* tree (bf16 leaves ride the checkpoint
        layer's ``stored_as`` bitcast encoding) plus a ``posterior.json``
        whose ``compact`` record routes :meth:`Posterior.load` to
        :func:`load_compacted`."""
        from ..checkpoint import store
        store.save(directory, _STEP, dict(self.compact_tables))
        doc = {"format_version": FORMAT_VERSION,
               "model": self.model, "params": self.params,
               "local": list(self.local), "observed": list(self.observed),
               "names": sorted(self.posteriors),
               "shapes": {n: list(self.posteriors[n].shape)
                          for n in sorted(self.posteriors)},
               "meta": {k: v for k, v in self.meta.items()
                        if isinstance(v, (bool, int, float, str))},
               "compact": {"error_bound": self.error_bound,
                           "tables": self.compaction}}
        tmp = os.path.join(directory, _META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, os.path.join(directory, _META))
        return directory


def compact_posterior(post: Posterior, top_k: int = 64) -> CompactedPosterior:
    """Compact every table of ``post`` to top-``top_k`` bf16 cells.

    Tables with ``K <= top_k`` keep all columns and only drop to bf16
    (dense-bf16 mode).  Tie-breaking uses the same stable order as
    :meth:`Posterior.top_k`, so compaction is deterministic."""
    if top_k < 1:
        raise ValueError(f"top_k must be >= 1, got {top_k}")
    if isinstance(post, CompactedPosterior):
        raise ValueError("posterior is already compacted; compact the "
                         "full artifact instead of stacking error")
    tables, records, dense = {}, {}, {}
    worst = 0.0
    for name in sorted(post.posteriors):
        alpha = np.asarray(post.posteriors[name], np.float32)
        g, kk = alpha.shape
        rowsum = alpha.sum(-1)
        p = (alpha.astype(np.float64)
             / np.maximum(alpha.sum(-1, keepdims=True), 1e-30))
        k = min(top_k, kk)
        if k < kk:
            idx = np.argsort(-p, axis=-1, kind="stable")[:, :k]
            idx = np.ascontiguousarray(idx.astype(np.int32))
            vals = _bf16(np.take_along_axis(p, idx, -1))
            tables[f"{name}__idx"] = idx
        else:
            idx = None
            vals = _bf16(p)
        tables[f"{name}__vals"] = vals
        tables[f"{name}__rowsum"] = rowsum.astype(np.float32)
        rec_alpha = _reconstruct(
            (g, kk), k, idx, vals, rowsum)
        q = rec_alpha / rec_alpha.sum(-1, keepdims=True)
        tv = float(0.5 * np.abs(p - q).sum(-1).max())
        worst = max(worst, tv)
        records[name] = {
            "shape": [g, kk], "k": k, "tv_error": tv,
            "bytes_full": int(alpha.nbytes),
            "bytes_compact": int(vals.nbytes + rowsum.nbytes
                                 + (idx.nbytes if idx is not None else 0)),
        }
        dense[name] = rec_alpha
    return CompactedPosterior(
        posteriors=dense, model=post.model, params=dict(post.params),
        local=post.local, observed=post.observed,
        meta={**post.meta, "compacted_from": post.meta.get("note", ""),
              "compact_top_k": top_k},
        compact_tables=tables, compaction=records, error_bound=worst)


def load_compacted(directory: str, doc: dict) -> CompactedPosterior:
    """Rebuild a saved compacted artifact (called by
    :meth:`Posterior.load` when ``posterior.json`` carries a ``compact``
    record — don't call this directly)."""
    from ..checkpoint import store
    comp = doc["compact"]
    names = {}
    for name, rec in comp["tables"].items():
        names[f"{name}__vals"] = 0
        names[f"{name}__rowsum"] = 0
        if rec["k"] < rec["shape"][1]:
            names[f"{name}__idx"] = 0
    tree = store.restore(directory, names, step=_STEP)
    dense, tables = {}, {}
    for name, rec in comp["tables"].items():
        idx = tree.get(f"{name}__idx")
        vals = tree[f"{name}__vals"]
        rowsum = tree[f"{name}__rowsum"]
        dense[name] = _reconstruct(tuple(rec["shape"]), rec["k"],
                                   idx, vals, rowsum)
        tables[f"{name}__vals"] = vals
        tables[f"{name}__rowsum"] = rowsum
        if idx is not None:
            tables[f"{name}__idx"] = idx
    return CompactedPosterior(
        posteriors=dense, model=doc["model"], params=doc["params"],
        local=tuple(doc["local"]), observed=tuple(doc["observed"]),
        meta=doc["meta"], compact_tables=tables,
        compaction=comp["tables"], error_bound=comp["error_bound"])
