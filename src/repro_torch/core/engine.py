"""One API over the inference backends: the VMP and SVI part of
``repro.core.engine``.

``make_engine`` builds an engine from a backend name, a config dict or an
:class:`EngineConfig`, and ``fit(model)`` returns an
:class:`InferenceResult`::

    result = make_engine("vmp", steps=50).fit(model)     # on the GPU
    result = make_engine("svi", steps=500, batch_size=256,
                         holdout_frac=0.05).fit(model)
    topics = result.topics("phi")

The port runs full-batch VMP and single-host SVI on one device, SVI over a
resident corpus or a sharded one on disk (``corpus=``, growing or not), with
crash-safe sessions (``checkpoint_dir=``, ``resume=``).  ``device=None``
means ``"cuda"``; the CPU runs only when asked for (``device="cpu"``).  The
config keeps every field of the reference's, with its default, so that one
config reads the same in both packages; what needs a later slice of the port
(the Gibbs backend, multi-host corpora, static analysis, freezing for the
query layer) raises ``NotImplementedError`` naming that slice when it is set
away from its default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .svi import SVI, SVIConfig, later_slice
from .vmp import resolve_device


@dataclasses.dataclass
class EngineConfig:
    """Backend selection + the union of backend knobs, as in the reference;
    ``device`` is the port's own.  A knob of a later slice raises in
    ``fit`` unless it keeps its default."""
    backend: str = "vmp"            # vmp | svi | gibbs (the port: vmp, svi)
    steps: int = 50
    seed: int = 0
    sharding: object = None         # None = 1 device
    elog_dtype: object = None       # e.g. "bfloat16": narrow the token
                                    # plate's concentration tables (f32 accum)
    corpus: object = None           # svi only: a data.ShardedCorpus for
                                    # out-of-core minibatches; the model
                                    # passed to fit() stays unobserved
    hosts: object = None            # svi, multi-host
    # svi
    batch_size: int = 64
    kappa: float = 0.7
    tau: float = 10.0
    rho: Optional[float] = None
    local_iters: int = 1
    pad_multiple: int = 256
    holdout_frac: float = 0.0
    holdout_every: int = 10
    holdout_local_iters: int = 10
    prefetch: bool = True
    growing: bool = False
    capacity_docs: int = 0
    population_size: int = 0
    # crash safety
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 10
    resume: bool = False
    # gibbs
    burnin: Optional[int] = None
    thin: int = 1
    # static analysis
    validate: bool = False
    # the port: where the state and every step live (None means "cuda")
    device: object = None


@dataclasses.dataclass
class InferenceResult:
    """What every backend returns: posterior summaries + diagnostics."""
    backend: str
    posteriors: dict[str, np.ndarray]   # per Dirichlet RV: (G, K) float32
                                        # concentrations
    elbo_trace: list                    # per-step float ELBO
    heldout_trace: list                 # [(step, per-token heldout ELBO)]
    meta: dict

    def topics(self, name: str) -> np.ndarray:
        """Row-normalized posterior-mean distribution for a Dirichlet RV."""
        if name not in self.posteriors:
            raise KeyError(
                f"no posterior for RV {name!r} in this {self.backend} "
                f"result; available: {sorted(self.posteriors)}")
        p = np.asarray(self.posteriors[name], np.float64)
        return p / p.sum(-1, keepdims=True)

    @property
    def heldout_elbo(self) -> float:
        return self.heldout_trace[-1][1] if self.heldout_trace else float("nan")

    def freeze(self, model, program=None, note: str = ""):
        """A servable posterior artifact: arrives with the query slice."""
        raise NotImplementedError(
            "freezing a result into a Posterior artifact arrives with the "
            "query slice of the port")


# the config's knobs that a later slice reads, by field: fit raises when one
# differs from its default, so that none is ignored quietly
_SLICE_OF = {
    **dict.fromkeys(("hosts", "sharding"), "distributed"),
    **dict.fromkeys(("burnin", "thin"), "Gibbs"),
    "validate": "analysis",
}
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(EngineConfig)}


def _check_slice_knobs(cfg: EngineConfig):
    for name, slice_name in _SLICE_OF.items():
        value, default = getattr(cfg, name), _DEFAULTS[name]
        if value is not default and value != default:
            later_slice(f"{name}={value!r} (default {default!r})", slice_name)


class InferenceEngine:
    """Backend-agnostic interface: ``fit(model) -> InferenceResult``."""

    name = ""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg

    def fit(self, model) -> InferenceResult:
        raise NotImplementedError


class VMPEngine(InferenceEngine):
    """Full-batch VMP (the paper's engine): deterministic, monotone ELBO,
    every step touches all N tokens.  ``fit(model)`` takes a
    :class:`repro_torch.core.dsl.Model` with its observations bound.  With
    ``holdout_frac > 0`` the held-out groups are excluded from training (via
    the SVI machinery at rho=1 and |B| = all training groups — exactly the
    full-batch update on the training slice) so its held-out ELBO is
    comparable to SVI's."""

    name = "vmp"

    def fit(self, model) -> InferenceResult:
        cfg = self.cfg
        if cfg.corpus is not None:
            raise ValueError(
                "full-batch VMP touches every token each step and needs a "
                "resident corpus; use backend='svi' with corpus=")
        _check_slice_knobs(cfg)
        device = resolve_device(cfg.device)
        if cfg.holdout_frac > 0:
            return _fit_svi(model, cfg, full_batch=True)
        # every fit starts fresh: a model inferred before must not warm-start
        model.reset()
        model.infer(steps=cfg.steps, seed=cfg.seed,
                    elog_dtype=cfg.elog_dtype, device=device)
        program = model.compile()
        posts = {n: model[n].get_result() for n in model.net.rvs
                 if n in program.dirichlets}
        return InferenceResult(self.name, posts, model.elbo_trace, [],
                               {"steps": cfg.steps, "device": str(device)})


class SVIEngine(InferenceEngine):
    """Streaming minibatch VMP with natural-gradient global updates
    (Hoffman et al., JMLR 2013; see ``core/svi.py``).  Per-step cost is
    O(batch tokens), not O(N); posteriors come back as ``(G, K) float32``
    concentrations like ``vmp``'s.  With ``cfg.corpus`` (a
    :class:`repro_torch.data.ShardedCorpus`) minibatches stream from
    on-disk shards and the model passed to ``fit`` stays unobserved."""

    name = "svi"

    def fit(self, model) -> InferenceResult:
        _check_slice_knobs(self.cfg)
        return _fit_svi(model, self.cfg, full_batch=False)


def _svi_config(cfg: EngineConfig, full_batch: bool, n_groups: int):
    """The :class:`~repro_torch.core.svi.SVIConfig` an :class:`EngineConfig`
    denotes.  Every SVI knob round-trips; ``full_batch=True`` pins the knobs
    that make one SVI step an exact full-batch VMP step (rho=1, |B| = all
    training groups, exact padding, fixed order)."""
    return SVIConfig(
        batch_size=(n_groups or 1) if full_batch else cfg.batch_size,
        kappa=cfg.kappa, tau=cfg.tau,
        local_iters=cfg.local_iters,
        pad_multiple=0 if full_batch else cfg.pad_multiple,
        holdout_frac=cfg.holdout_frac, holdout_every=cfg.holdout_every,
        holdout_local_iters=cfg.holdout_local_iters,
        shuffle=not full_batch,
        rho=1.0 if full_batch else cfg.rho,
        prefetch=cfg.prefetch,
        growing=cfg.growing and not full_batch,
        capacity_docs=0 if full_batch else cfg.capacity_docs,
        population_size=0 if full_batch else cfg.population_size,
        elog_dtype=cfg.elog_dtype,
        seed=cfg.seed)


def _fit_svi(model, cfg: EngineConfig, full_batch: bool) -> InferenceResult:
    """Shared SVI fit of the ``svi`` backend and the holdout-comparable
    full-batch reference (``full_batch=True``: rho=1, |B| = all training
    groups).  With ``cfg.corpus`` set, ``model`` stays unobserved and
    minibatches stream from the sharded corpus (out-of-core mode).  With
    ``cfg.resume``, ``cfg.steps`` is the total budget: only what the newest
    session of ``cfg.checkpoint_dir`` has not run, runs."""
    if cfg.corpus is not None and full_batch:
        raise ValueError("the full-batch reference needs a resident corpus")
    if cfg.corpus is None:
        target = model.compile()
        n_groups = target.meta.get("pstar_size") or 0
    else:
        target, n_groups = model, cfg.corpus.n_docs
    svi = SVI(target, _svi_config(cfg, full_batch, n_groups),
              plan=cfg.sharding, corpus=cfg.corpus, hosts=cfg.hosts,
              device=cfg.device)
    steps, resumed_from = cfg.steps, None
    if cfg.resume:
        if cfg.checkpoint_dir is None:
            raise ValueError("resume=True needs checkpoint_dir=")
        from ..checkpoint import latest_session_step
        resumed_from = latest_session_step(cfg.checkpoint_dir)
        # steps is the total budget; run only what the session hasn't
        steps = max(cfg.steps - (resumed_from or 0), 0)
    try:
        state, history = svi.fit(
            steps=steps, checkpoint_dir=cfg.checkpoint_dir,
            checkpoint_every=cfg.checkpoint_every,
            resume_from=True if cfg.resume else None)
    finally:
        svi.close()
    posts = {n: p.cpu().numpy() for n, p in state.posteriors.items()}
    return InferenceResult("vmp" if full_batch else "svi", posts,
                           history["elbo"], history["heldout"],
                           {"steps": cfg.steps,
                            "batch_size": svi.sampler.batch_size,
                            "n_train_groups": len(svi.train),
                            "n_holdout_groups": len(svi.holdout),
                            "resumed_from_step": resumed_from,
                            "device": str(svi.device)})


_ENGINES = {"vmp": VMPEngine, "svi": SVIEngine}
_LATER = {"gibbs": "Gibbs"}


def make_engine(spec="vmp", **overrides) -> InferenceEngine:
    """Build an engine from a backend name, a config dict, or an
    :class:`EngineConfig`; keyword overrides win."""
    if isinstance(spec, EngineConfig):
        cfg = dataclasses.replace(spec, **overrides)
    elif isinstance(spec, dict):
        cfg = EngineConfig(**{**spec, **overrides})
    else:
        cfg = EngineConfig(backend=str(spec), **overrides)
    if cfg.backend in _LATER:
        later_slice(f"the {cfg.backend} backend", _LATER[cfg.backend])
    if cfg.backend not in _ENGINES:
        raise ValueError(f"unknown backend {cfg.backend!r}; "
                         f"choose from {sorted(_ENGINES) + sorted(_LATER)}")
    return _ENGINES[cfg.backend](cfg)
