"""One API over the inference backends: the port of ``repro.core.engine``.

``make_engine`` builds an engine from a backend name, a config dict or an
:class:`EngineConfig`, and ``fit(model)`` returns an
:class:`InferenceResult`::

    result = make_engine("vmp", steps=50).fit(model)     # on the GPU
    result = make_engine("svi", steps=500, batch_size=256,
                         holdout_frac=0.05).fit(model)
    result = make_engine("gibbs", steps=200, holdout_frac=0.05).fit(model)
    topics = result.topics("phi")
    post = result.freeze(model)           # a servable query.Posterior

The port runs full-batch VMP (on one device or under a
``partition.ShardingPlan``: ``sharding=``), SVI (over a resident corpus or a
sharded one on disk, ``corpus=``, growing or not, with crash-safe sessions:
``checkpoint_dir=``, ``resume=``; sharded with ``sharding=``, over the
hosts of a partitioned corpus with ``hosts=``) and blocked Gibbs sampling
for LDA-shaped models.  ``device=None`` means ``"cuda"``; the CPU runs
only when asked for (``device="cpu"``).  The config keeps every field of
the reference's, with its default, so that one config reads the same in
both packages; as in the reference a backend ignores the knobs it does not
read.  ``validate=True`` runs the static pre-flight
(``repro_torch.analysis``) before any device work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..data.pipeline import holdout_split
from .svi import SVI, SVIConfig
from .vmp import resolve_device


@dataclasses.dataclass
class EngineConfig:
    """Backend selection + the union of backend knobs (unused ones are
    ignored by the chosen backend), as in the reference; ``device`` is the
    port's own."""
    backend: str = "vmp"            # vmp | svi | gibbs
    steps: int = 50
    seed: int = 0
    sharding: object = None         # a ShardingPlan for vmp/svi; None =
                                    # 1 device
    elog_dtype: object = None       # e.g. "bfloat16": narrow the token
                                    # plate's concentration tables (f32 accum)
    corpus: object = None           # svi only: a data.ShardedCorpus for
                                    # out-of-core minibatches; the model
                                    # passed to fit() stays unobserved
    hosts: object = None            # svi only: a data.HostAssignment —
                                    # partition the corpus by shard
                                    # ownership over the plan's processes
                                    # (or virtual hosts in one)
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
    burnin: Optional[int] = None    # default: steps // 2
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
                                        # concentrations, or (G, K) mean
                                        # probabilities when
                                        # meta["normalized"] (gibbs)
    elbo_trace: list                    # per-step float ELBO (gibbs: the
                                        # complete-data log-likelihood)
    heldout_trace: list                 # [(step, per-token heldout ELBO)]
    meta: dict

    def topics(self, name: str) -> np.ndarray:
        """Row-normalized posterior-mean distribution for a Dirichlet RV —
        directly comparable across variational and sampling backends."""
        if name not in self.posteriors:
            raise KeyError(
                f"no posterior for RV {name!r} in this {self.backend} "
                f"result; available: {sorted(self.posteriors)}")
        p = np.asarray(self.posteriors[name], np.float64)
        if self.meta.get("normalized"):
            return p
        return p / p.sum(-1, keepdims=True)

    @property
    def heldout_elbo(self) -> float:
        return self.heldout_trace[-1][1] if self.heldout_trace else float("nan")

    def freeze(self, model, program=None, note: str = ""):
        """Freeze this result into a servable
        :class:`repro_torch.query.Posterior` artifact (posterior
        concentrations + model/program provenance).  ``model`` is the fitted
        :class:`~repro_torch.core.dsl.Model`; ``program`` overrides
        ``model.compile()`` when the model itself was never observed (the
        out-of-core path — pass its ``sharded_template``)."""
        from ..query import Posterior
        return Posterior.from_result(self, model, program=program,
                                     note=note)


class InferenceEngine:
    """Backend-agnostic interface: ``fit(model) -> InferenceResult``."""

    name = ""

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg

    def fit(self, model) -> InferenceResult:
        raise NotImplementedError

    def _preflight(self, model):
        """Opt-in static analysis (``cfg.validate=True``): raise
        ``PreflightError`` with every error finding before any device
        work starts, and audit the config for rebuild hazards."""
        if not self.cfg.validate:
            return
        from ..analysis.audit import audit_config
        from ..analysis.validate import PreflightError, preflight
        diags = preflight(model)
        n_docs = self.cfg.corpus.n_docs if self.cfg.corpus is not None \
            else None
        n_hosts = self.cfg.hosts.n_hosts if self.cfg.hosts is not None \
            else None
        diags += audit_config(self.cfg, n_docs=n_docs, n_hosts=n_hosts)
        if any(d.severity == "error" for d in diags):
            raise PreflightError(diags)


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
        self._preflight(model)
        device = resolve_device(cfg.device)
        if cfg.holdout_frac > 0:
            return _fit_svi(model, cfg, full_batch=True)
        # every fit starts fresh: a model inferred before must not warm-start
        model.reset()
        model.infer(steps=cfg.steps, sharding=cfg.sharding, seed=cfg.seed,
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
        self._preflight(model)
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
    group = cfg.sharding.group if cfg.sharding is not None else None
    before = (dict(group.payload), dict(group.wire), group.calls,
              group.seconds) if group else None
    t0 = time.perf_counter()
    try:
        state, history = svi.fit(
            steps=steps, checkpoint_dir=cfg.checkpoint_dir,
            checkpoint_every=cfg.checkpoint_every,
            resume_from=True if cfg.resume else None)
    finally:
        svi.close()
    fit_s = time.perf_counter() - t0
    posts = {n: p.cpu().numpy() for n, p in state.posteriors.items()}
    meta = {"steps": cfg.steps, "batch_size": svi.sampler.batch_size,
            "n_train_groups": len(svi.train),
            "n_holdout_groups": len(svi.holdout),
            "resumed_from_step": resumed_from, "device": str(svi.device),
            "fit_s": fit_s}
    if group is not None:
        # what the plan's shards handed their group in this fit, and the
        # bytes that went through the backend to other ranks
        payload, wire, calls, seconds = before
        meta["group"] = dict(
            payload={k: v - payload.get(k, 0)
                     for k, v in group.payload.items()},
            wire={k: v - wire.get(k, 0) for k, v in group.wire.items()},
            calls=group.calls - calls, seconds=group.seconds - seconds)
    return InferenceResult("vmp" if full_batch else "svi", posts,
                           history["elbo"], history["heldout"], meta)


class GibbsEngine(InferenceEngine):
    """Blocked Gibbs sampling for LDA-shaped models (one latent selector
    with a single specialized child and a per-group prior Dirichlet;
    ``core/gibbs.py``).

    With ``holdout_frac > 0`` the held-out documents (the same
    ``holdout_split`` as the variational engines, so the splits coincide
    at equal seeds) are excluded from the sweeps and scored afterwards by
    the query layer's fold-in against the frozen posterior-mean
    concentrations — populating ``heldout_trace`` with the same per-token
    ELBO metric the other backends report."""

    name = "gibbs"

    def fit(self, model) -> InferenceResult:
        from .gibbs import gibbs_lda
        cfg = self.cfg
        if cfg.corpus is not None:
            raise ValueError("gibbs sweeps every token and needs a resident "
                             "corpus; use backend='svi' with corpus=")
        self._preflight(model)
        device = resolve_device(cfg.device)
        program = model.compile()
        spec, child = _lda_shape(program)
        theta_d = program.dirichlets[spec.prior_dir]
        phi_d = program.dirichlets[child.dir_name]
        burnin = cfg.burnin if cfg.burnin is not None else cfg.steps // 2
        values, doc_rows = child.values, spec.prior_rows
        train = holdout = None
        if cfg.holdout_frac > 0:
            train, holdout = holdout_split(theta_d.g, cfg.holdout_frac,
                                           cfg.seed)
            member = np.zeros(theta_d.g, bool)
            member[train] = True
            tm = member[doc_rows]
            values = values[tm]
            doc_rows = np.searchsorted(train, doc_rows[tm])
        theta, phi, lls, (theta_conc, phi_conc) = gibbs_lda(
            values, doc_rows, spec.k, phi_d.k,
            alpha=float(theta_d.prior[0]), beta=float(phi_d.prior[0]),
            iters=cfg.steps, burnin=burnin, seed=cfg.seed, thin=cfg.thin,
            return_conc=True, device=device)
        posts = {spec.prior_dir: theta, child.dir_name: phi}
        meta = {"normalized": True, "burnin": burnin, "steps": cfg.steps,
                "concentrations": {spec.prior_dir: theta_conc,
                                   child.dir_name: phi_conc},
                "device": str(device)}
        result = InferenceResult(self.name, posts, list(lls), [], meta)
        if cfg.holdout_frac > 0:
            meta["n_train_groups"] = len(train)
            meta["n_holdout_groups"] = len(holdout)
            meta["train_groups"] = train
            from ..query import FoldIn, FoldInConfig
            fold = FoldIn(result.freeze(model, program=program),
                          FoldInConfig(
                              local_iters=cfg.holdout_local_iters,
                              bucket=None),
                          model=model, device=device)
            hm = ~member[spec.prior_rows]
            score = fold.score(
                child.values[hm],
                segment_ids=np.searchsorted(holdout,
                                            spec.prior_rows[hm]))
            result.heldout_trace.append((cfg.steps - 1,
                                         score.per_token_ll))
        return result


def _lda_shape(program):
    """The (latent, child) pair of an LDA-shaped program, or raise."""
    if (len(program.latents) == 1 and not program.statics
            and len(program.latents[0].children) == 1):
        spec = program.latents[0]
        f = spec.children[0]
        if f.specialized and f.zmap is None:
            return spec, f
    raise ValueError(
        f"gibbs backend needs an LDA-shaped model (one latent selector, one "
        f"specialized child); {program.name} is not — use vmp or svi")


_ENGINES = {"vmp": VMPEngine, "svi": SVIEngine, "gibbs": GibbsEngine}


def make_engine(spec="vmp", **overrides) -> InferenceEngine:
    """Build an engine from a backend name, a config dict, or an
    :class:`EngineConfig`; keyword overrides win."""
    if isinstance(spec, EngineConfig):
        cfg = dataclasses.replace(spec, **overrides)
    elif isinstance(spec, dict):
        cfg = EngineConfig(**{**spec, **overrides})
    else:
        cfg = EngineConfig(backend=str(spec), **overrides)
    if cfg.backend not in _ENGINES:
        raise ValueError(f"unknown backend {cfg.backend!r}; "
                         f"choose from {sorted(_ENGINES)}")
    return _ENGINES[cfg.backend](cfg)
