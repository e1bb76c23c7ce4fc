"""Model-definition DSL (the paper's Scala `@Model` extension, in Python).

The port's copy of ``repro.core.dsl``: the same builder, the same
``Model`` facade and the same paper API (Figure 7)::

    model = models.make("lda", alpha=0.1, beta=0.01, K=16, V=1000)
    model["x"].observe(tokens, segment_ids=doc_ids)
    model.infer(steps=20, callback=...)          # on the GPU by default
    post_phi = model["phi"].get_result()

``Model.infer`` runs the port's full-batch VMP runtime on one device:
``device=None`` means ``"cuda"``, and without a card the call raises
unless the caller passes ``device="cpu"``.  Sharded runs and
checkpointing arrive with later slices of the port; until then their
arguments raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..analysis.diagnostics import raise_error

from .network import UNKNOWN, BayesianNetwork, CategoricalRV, DirichletRV, Plate


class ModelBuilder:
    """Accumulates a :class:`BayesianNetwork` (paper section 3.2)."""

    def __init__(self, name: str):
        self.net = BayesianNetwork(name)
        self._loc = 0

    # each DSL call counts as one model-definition line (LOC fidelity check)
    def _line(self):
        self._loc += 1
        self.net._loc = self._loc

    def plate(self, size, name: Optional[str] = None, within: Optional[Plate] = None) -> Plate:
        self._line()
        if size != UNKNOWN and (not isinstance(size, int) or size <= 0):
            raise_error("bad-plate-size", name or f"plate{len(self.net.plates)}",
                        f"plate size must be positive int or '?', got {size!r}")
        name = name or f"plate{len(self.net.plates)}"
        return self.net.add_plate(name, size, within)

    def dirichlet(self, name: str, conc, dim: int, plate: Optional[Plate] = None) -> DirichletRV:
        self._line()
        if dim < 2:
            raise_error("bad-dim", name, f"{name}: dirichlet dim must be >= 2",
                        hint="Beta is dim=2; use m.beta() for that")
        rv = DirichletRV(name, plate or self.net.toplevel, dim, conc)
        return self.net.add_rv(rv)

    def beta(self, name: str, conc, plate: Optional[Plate] = None) -> DirichletRV:
        """Beta(a, a) == symmetric Dirichlet of dim 2 (paper Figure 7)."""
        return self.dirichlet(name, conc, dim=2, plate=plate)

    def categorical(self, name: str, given: DirichletRV, plate: Plate,
                    selector: Optional[CategoricalRV] = None) -> CategoricalRV:
        self._line()
        rv = CategoricalRV(name, plate, given, selector)
        return self.net.add_rv(rv)


def build(define: Callable, name: Optional[str] = None, **params) -> BayesianNetwork:
    """Run a model-definition function and return the validated network."""
    b = ModelBuilder(name or define.__name__)
    define(b, **params)
    b.net.validate()
    return b.net


class _RVHandle:
    """The paper's per-RV interface object (``m.x``, ``m.phi`` ...)."""

    def __init__(self, model: "Model", name: str):
        self._model = model
        self.name = name

    def observe(self, values, segment_ids=None, lengths=None):
        """Bind observed data (paper's ``observe`` API).

        ``values`` — int array of category indices, flattened.
        ``segment_ids`` — for RVs on a nested ``?`` plate: outer-plate index of
        each instance (e.g. doc id per token), nondecreasing not required.
        ``lengths`` — alternative ragged spec: per-outer-instance counts.
        """
        self._model._observe(self.name, values, segment_ids, lengths)
        return self

    def get_result(self):
        """Posterior for Dirichlet RVs; responsibilities for latent RVs."""
        return self._model._get_result(self.name)


class Model:
    """A model instance: network template + runtime metadata + inference.

    This is the object the paper's generated Scala class plays; construction
    corresponds to "metadata collection" (section 3.3), ``infer`` to code
    generation + execution (sections 3.4, 4.2, 4.3).
    """

    def __init__(self, define: Callable, name: Optional[str] = None, **params):
        self.net = build(define, name=name, **params)
        self.params = params
        self.observations: dict[str, dict] = {}
        self.plate_bindings: dict[str, object] = {}
        self._program = None
        self._state = None
        self._elbo_trace: list[float] = []

    def __getitem__(self, name: str) -> _RVHandle:
        if name not in self.net.rvs:
            raise KeyError(f"no random variable {name!r} in model {self.net.name}")
        return _RVHandle(self, name)

    # -- observe ----------------------------------------------------------
    def _observe(self, name, values, segment_ids, lengths):
        rv = self.net.rvs[name]
        if not isinstance(rv, CategoricalRV):
            raise TypeError(f"only Categorical RVs can be observed, not {name}")
        values = np.asarray(values, dtype=np.int32).ravel()
        if lengths is not None and segment_ids is None:
            lengths = np.asarray(lengths, dtype=np.int32)
            segment_ids = np.repeat(np.arange(len(lengths), dtype=np.int32), lengths)
        if segment_ids is not None:
            segment_ids = np.asarray(segment_ids, dtype=np.int32).ravel()
            if segment_ids.shape != values.shape:
                raise ValueError("segment_ids must align with values")
        if (values < 0).any() or (values >= rv.dim).any():
            raise_error("value-range", name,
                        f"{name}: observed values out of range [0, {rv.dim})",
                        hint="category indices must fit the parent "
                             "Dirichlet's dim (vocab size)")
        rv.observed = True
        self.observations[name] = {"values": values, "segment_ids": segment_ids}
        self._program = None      # metadata changed; force re-compile
        self._state = None

    def bind(self, plate_name: str, parent_ids):
        """Provide the parent map of an intermediate ``?`` plate (e.g. SLDA's
        sentence->document map); the paper infers these from nested RDDs."""
        self.plate_bindings[plate_name] = np.asarray(parent_ids, np.int32)
        self._program = None
        return self

    def reset(self):
        """Drop inference state (posteriors, ELBO trace) so the next
        ``infer`` starts fresh; the compiled program is kept."""
        self._state = None
        self._elbo_trace = []
        return self

    # -- inference --------------------------------------------------------
    def compile(self):
        """Metadata collection + "code generation" (the ``VMPProgram``)."""
        from .compiler import compile_program
        if self._program is None:
            self._program = compile_program(self.net, self.observations,
                                            plate_bindings=self.plate_bindings)
        return self._program

    def infer(self, steps: int = 20, callback=None, checkpoint_every: int = 0,
              checkpoint_dir: str | None = None, sharding=None, seed: int = 0,
              elog_dtype=None, device=None):
        """Run VMP iterations (paper's ``infer`` API with callback, Fig 12).

        ``device`` is where the state and every step live (``None`` means
        ``"cuda"``).  ``elog_dtype`` (e.g. ``"bfloat16"``) narrows the
        concentration tables the token plate gathers from; accumulation
        stays f32.  With ``checkpoint_every`` and ``checkpoint_dir`` the
        state is saved every k steps, and a later ``infer`` (of this model
        or a fresh one) resumes from the newest valid checkpoint there.
        """
        if sharding is not None:
            raise NotImplementedError(
                "sharded inference arrives with the distributed slice of "
                "the port; run on one device (sharding=None)")
        from .runtime import run_inference
        prog = self.compile()
        self._state, trace = run_inference(
            prog, steps=steps, callback=callback,
            checkpoint_every=checkpoint_every, checkpoint_dir=checkpoint_dir,
            state=self._state, seed=seed, elog_dtype=elog_dtype,
            device=device)
        self._elbo_trace.extend(trace)
        return self

    @property
    def lower_bound(self) -> float:
        """ELBO of the current result (paper's ``lowerBound`` API)."""
        if not self._elbo_trace:
            raise RuntimeError("call infer() first")
        return float(self._elbo_trace[-1])

    @property
    def elbo_trace(self) -> list[float]:
        return list(self._elbo_trace)

    # -- results ------------------------------------------------------------
    def _get_result(self, name):
        if self._state is None:
            raise RuntimeError("call infer() first")
        rv = self.net.rvs[name]
        if isinstance(rv, DirichletRV):
            return self._state.posteriors[name].cpu().numpy()
        if not rv.observed:
            from .vmp import latent_responsibilities
            return latent_responsibilities(self._program, self._state,
                                           name).cpu().numpy()
        raise TypeError(f"{name} is observed data")
