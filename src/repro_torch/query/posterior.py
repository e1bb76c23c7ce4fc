"""Frozen posterior artifacts: the train-once half of train-once/query-many.

The port of ``repro.query.posterior``.  InferSpark's stated goal is
"answering various statistical queries about the model", not just fitting
it — but a fit ends at ``InferenceEngine.fit() -> InferenceResult``, a live
in-process object.  :class:`Posterior` is the boundary between training and
serving: the posterior Dirichlet concentrations of every RV plus enough
model/program provenance (zoo name + parameters, the local/global split,
the observed-RV names, backend metadata) to reconstruct a *fold-in* program
for documents the engine never saw (``foldin.py``).

The on-disk format is the reference's: the port's checkpoint store (atomic
rename commit, manifest as the commit record — ``checkpoint/store.py``,
the reference's file format) with a versioned ``posterior.json`` on top, so
each package loads the other's artifacts; a loader rejects artifacts whose
format version it does not understand rather than misreading them.
Compacted artifacts (the gateway's sparse top-k tables,
``repro_torch.gateway.compact``) load through the same :meth:`Posterior.load`.

Statistical queries answered directly from the artifact (numpy on the host,
no engine, no device):

  - :meth:`Posterior.mean` — posterior-mean distributions,
  - :meth:`Posterior.credible_interval` — per-cell Dirichlet-marginal
    (Beta) credible intervals,
  - :meth:`Posterior.top_k` — the k highest-probability columns per row
    (top words per topic),
  - :meth:`Posterior.similarity` — pairwise row similarity
    (Bhattacharyya/Hellinger affinity or cosine).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

FORMAT_VERSION = 1
_META = "posterior.json"
_STEP = 0                        # artifacts are single-step checkpoint trees


@dataclasses.dataclass
class Posterior:
    """A frozen, servable posterior.

    ``posteriors`` maps every Dirichlet RV to its ``(G, K) float32``
    posterior concentrations (for the sampling backend: the posterior-mean
    concentrations ``prior + E[counts]``).  ``local`` names the Dirichlets
    rooted at the partition plate (per-document state — re-inferred per
    query by fold-in); the rest are the frozen globals fold-in conditions
    on.  ``model``/``params`` identify the generating model in the zoo
    (``repro_torch.core.models.make``), ``observed`` the RV names a query
    binds data to, and ``meta`` carries provenance (backend, steps,
    held-out score, creation time).
    """

    posteriors: dict[str, np.ndarray]
    model: str
    params: dict
    local: tuple
    observed: tuple
    meta: dict

    # -- construction ------------------------------------------------------

    @classmethod
    def from_result(cls, result, model, program=None, note: str = ""):
        """Freeze an :class:`~repro_torch.core.engine.InferenceResult`.

        ``model`` — the :class:`~repro_torch.core.dsl.Model` the result was
        fit from (supplies the zoo name + parameters and, unless ``program``
        is given, the compiled program that defines the local/global split
        and the observed-RV names).  For the sampling backend the
        concentrations come from ``result.meta["concentrations"]`` (the
        normalized means alone cannot be folded in)."""
        if program is None:
            try:
                program = model.compile()
            except Exception as e:
                raise ValueError(
                    "freeze() needs a compiled program to record the "
                    "local/global split; the model has no observations "
                    "bound (out-of-core fit?) — pass program= explicitly "
                    "(e.g. repro_torch.data.store.sharded_template(model, "
                    "corpus))") from e
        from ..core.compiler import local_dirichlets
        conc = result.meta.get("concentrations") \
            if result.meta.get("normalized") else result.posteriors
        if conc is None:
            raise ValueError(
                "normalized result carries no posterior concentrations; "
                "re-fit with a backend that records them "
                "(meta['concentrations'])")
        observed = tuple(sorted(
            [f.x_name for spec in program.latents for f in spec.children]
            + [s.x_name for s in program.statics]))
        meta = {"backend": result.backend,
                "heldout_elbo": result.heldout_elbo,
                "created": time.time(), "note": note}
        meta.update({k: v for k, v in result.meta.items()
                     if isinstance(v, (int, float, str, bool))})
        return cls(posteriors={n: np.asarray(v, np.float32)
                               for n, v in conc.items()},
                   model=model.net.name, params=dict(model.params),
                   local=tuple(sorted(local_dirichlets(program))),
                   observed=observed, meta=meta)

    # -- persistence -------------------------------------------------------

    def save(self, directory: str) -> str:
        """Write the artifact (atomic: the checkpoint commit protocol).

        Layout: ``<dir>/step_0000000000.npz`` (the concentration tree as a
        single self-validating checkpoint file, via
        ``checkpoint.store.save`` — embedded manifest + per-leaf
        checksums) plus ``<dir>/posterior.json`` (format version +
        provenance), written last so a directory with a
        ``posterior.json`` is always complete."""
        from ..checkpoint import store
        store.save(directory, _STEP, dict(self.posteriors))
        doc = {"format_version": FORMAT_VERSION,
               "model": self.model, "params": self.params,
               "local": list(self.local), "observed": list(self.observed),
               "names": sorted(self.posteriors),
               "shapes": {n: list(self.posteriors[n].shape)
                          for n in sorted(self.posteriors)},
               "meta": _jsonable(self.meta)}
        tmp = os.path.join(directory, _META + ".tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, os.path.join(directory, _META))
        return directory

    @classmethod
    def load(cls, directory: str) -> "Posterior":
        """Load a saved artifact; rejects unknown format versions."""
        path = os.path.join(directory, _META)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no posterior artifact at {directory} (missing {_META})")
        with open(path) as f:
            doc = json.load(f)
        version = doc.get("format_version")
        if version != FORMAT_VERSION:
            raise ValueError(
                f"posterior artifact at {directory} has format version "
                f"{version!r}; this build reads version {FORMAT_VERSION} "
                f"— re-freeze the posterior with this build")
        if doc.get("compact"):
            # compacted artifacts store sparse top-k/bf16 tables; the
            # compaction layer owns their layout (and its error record)
            from ..gateway.compact import load_compacted
            return load_compacted(directory, doc)
        from ..checkpoint import store
        tree = store.restore(directory, {n: 0 for n in doc["names"]},
                             step=_STEP)
        posts = {n: np.asarray(v, np.float32) for n, v in tree.items()}
        for n, shape in doc["shapes"].items():
            if list(posts[n].shape) != shape:
                raise ValueError(
                    f"artifact corrupt: {n} has shape "
                    f"{list(posts[n].shape)}, manifest says {shape}")
        return cls(posteriors=posts, model=doc["model"],
                   params=doc["params"], local=tuple(doc["local"]),
                   observed=tuple(doc["observed"]), meta=doc["meta"])

    # -- queries -----------------------------------------------------------

    def globals(self) -> dict[str, np.ndarray]:
        """The frozen global tables fold-in conditions on."""
        return {n: v for n, v in self.posteriors.items()
                if n not in self.local}

    def _conc(self, name: str) -> np.ndarray:
        if name not in self.posteriors:
            raise KeyError(f"no posterior for RV {name!r}; available: "
                           f"{sorted(self.posteriors)}")
        return np.asarray(self.posteriors[name], np.float64)

    def mean(self, name: str) -> np.ndarray:
        """Posterior-mean distribution per row: ``alpha / alpha.sum()``."""
        a = self._conc(name)
        return a / a.sum(-1, keepdims=True)

    def credible_interval(self, name: str, prob: float = 0.9, rows=None):
        """Equal-tailed marginal credible interval per cell.

        Under ``Dir(alpha)`` each component's marginal is
        ``Beta(alpha_k, alpha_0 - alpha_k)``; the interval is that Beta's
        ``[(1-prob)/2, 1-(1-prob)/2]`` quantile pair, computed by bisection
        in float64 on the regularized incomplete beta.  Returns ``(lo,
        hi)``, each the table's shape — or, with ``rows`` (an index or
        index array), just those rows' worth of bisection (a single-row
        query need not pay for the whole table)."""
        if not 0.0 < prob < 1.0:
            raise ValueError(f"prob must be in (0, 1), got {prob}")
        a = self._conc(name)
        if rows is not None:
            a = np.atleast_2d(a[rows])
        b = a.sum(-1, keepdims=True) - a
        lo_q = (1.0 - prob) / 2.0
        return (_beta_quantile(a, b, lo_q),
                _beta_quantile(a, b, 1.0 - lo_q))

    def top_k(self, name: str, k: int = 10):
        """The ``k`` highest-mean columns per row: ``(indices, probs)``,
        both ``(G, k)``, sorted descending (top words per topic).

        Ties break toward the smaller column index (stable sort), so the
        result is deterministic."""
        p = self.mean(name)
        k = min(k, p.shape[-1])
        idx = np.argsort(-p, axis=-1, kind="stable")[..., :k]
        return idx, np.take_along_axis(p, idx, -1)

    def similarity(self, name: str, kind: str = "hellinger") -> np.ndarray:
        """Pairwise row similarity of a table's posterior means: ``(G, G)``
        in [0, 1], 1 on the diagonal.  ``hellinger`` is the Bhattacharyya
        affinity ``sum_k sqrt(p_k q_k)`` (1 - squared Hellinger distance);
        ``cosine`` the cosine of the mean vectors."""
        p = self.mean(name)
        if kind == "hellinger":
            r = np.sqrt(p)
            return np.clip(r @ r.T, 0.0, 1.0)
        if kind == "cosine":
            nrm = np.linalg.norm(p, axis=-1, keepdims=True)
            q = p / np.maximum(nrm, 1e-30)
            return np.clip(q @ q.T, 0.0, 1.0)
        raise ValueError(f"unknown similarity kind {kind!r}; "
                         f"choose 'hellinger' or 'cosine'")


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, (bool, int, float, str)) or v is None:
            out[k] = v
        elif isinstance(v, (np.integer, np.floating)):
            out[k] = v.item()
    return out


def _beta_quantile(a: np.ndarray, b: np.ndarray, q: float,
                   iters: int = 60) -> np.ndarray:
    """Elementwise Beta(a, b) quantile by bisection on the CDF
    (``scipy.special.betainc`` in float64 — monotone in x), to ~2^-60."""
    from scipy.special import betainc
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lo = np.zeros_like(a)
    hi = np.ones_like(a)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = betainc(a, b, mid) < q
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    return 0.5 * (lo + hi)
