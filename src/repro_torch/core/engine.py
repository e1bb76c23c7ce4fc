"""One API over the inference backends: the VMP half of ``repro.core.engine``.

``make_engine`` builds an engine from a backend name, a config dict or an
:class:`EngineConfig`, and ``fit(model)`` returns an
:class:`InferenceResult`::

    result = make_engine("vmp", steps=50).fit(model)     # on the GPU
    topics = result.topics("phi")

This slice of the port runs full-batch VMP on one device.  ``device=None``
means ``"cuda"``; the CPU runs only when asked for (``device="cpu"``).  The
config keeps every field of the reference's, with its default, so that one
config reads the same in both packages; what needs a later slice of the
port (the SVI and Gibbs backends and every knob they read, held-out
scoring, out-of-core and multi-host corpora, sessions, static analysis,
freezing for the query layer) raises ``NotImplementedError`` naming that
slice when it is set away from its default.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .vmp import resolve_device


@dataclasses.dataclass
class EngineConfig:
    """Backend selection + the union of backend knobs, as in the reference;
    ``device`` is the port's own.  A knob of a later slice raises in
    ``fit`` unless it keeps its default."""
    backend: str = "vmp"            # vmp | svi | gibbs (this slice: vmp)
    steps: int = 50
    seed: int = 0
    sharding: object = None         # None = 1 device
    elog_dtype: object = None       # e.g. "bfloat16": narrow the token
                                    # plate's concentration tables (f32 accum)
    corpus: object = None           # svi, out-of-core
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


def _later_slice(what: str, slice_name: str):
    raise NotImplementedError(f"{what} arrives with the {slice_name} slice "
                              f"of the port")


# the config's knobs that a later slice reads, by field: fit raises when one
# differs from its default, so that none is ignored quietly
_SLICE_OF = {
    **dict.fromkeys((
        "corpus", "hosts", "batch_size", "kappa", "tau", "rho",
        "local_iters", "pad_multiple", "holdout_frac", "holdout_every",
        "holdout_local_iters", "prefetch", "growing", "capacity_docs",
        "population_size"), "SVI"),
    **dict.fromkeys(("checkpoint_dir", "checkpoint_every", "resume"),
                    "checkpoint"),
    **dict.fromkeys(("burnin", "thin"), "Gibbs"),
    "validate": "analysis",
}
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(EngineConfig)}


class VMPEngine:
    """Full-batch VMP (the paper's engine): deterministic, monotone ELBO,
    every step touches all N tokens.  ``fit(model)`` takes a
    :class:`repro_torch.core.dsl.Model` with its observations bound."""

    name = "vmp"

    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg

    def fit(self, model) -> InferenceResult:
        cfg = self.cfg
        for name, slice_name in _SLICE_OF.items():
            value, default = getattr(cfg, name), _DEFAULTS[name]
            if value is not default and value != default:
                _later_slice(f"{name}={value!r} (default {default!r})",
                             slice_name)
        device = resolve_device(cfg.device)
        # every fit starts fresh: a model inferred before must not warm-start
        model.reset()
        model.infer(steps=cfg.steps, sharding=cfg.sharding, seed=cfg.seed,
                    elog_dtype=cfg.elog_dtype, device=device)
        program = model.compile()
        posts = {n: model[n].get_result() for n in model.net.rvs
                 if n in program.dirichlets}
        return InferenceResult(self.name, posts, model.elbo_trace, [],
                               {"steps": cfg.steps, "device": str(device)})


_LATER = {"svi": "SVI", "gibbs": "Gibbs"}


def make_engine(spec="vmp", **overrides) -> VMPEngine:
    """Build an engine from a backend name, a config dict, or an
    :class:`EngineConfig`; keyword overrides win."""
    if isinstance(spec, EngineConfig):
        cfg = dataclasses.replace(spec, **overrides)
    elif isinstance(spec, dict):
        cfg = EngineConfig(**{**spec, **overrides})
    else:
        cfg = EngineConfig(backend=str(spec), **overrides)
    if cfg.backend in _LATER:
        _later_slice(f"the {cfg.backend} backend", _LATER[cfg.backend])
    if cfg.backend != "vmp":
        raise ValueError(f"unknown backend {cfg.backend!r}; "
                         f"choose from {['vmp'] + sorted(_LATER)}")
    return VMPEngine(cfg)
