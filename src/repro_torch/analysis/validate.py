"""Pre-compile model validation: diagnostics instead of stack traces.

The port of ``repro.analysis.validate``, op for op over the port's own
front end (``core/network.py``, ``compiler.py``, ``diagnostics.py``).

``validate_model`` runs the same supported-class / plate / prior checks
that ``net.validate()`` and ``compile_program`` enforce — but *collects*
:class:`Diagnostic` objects instead of raising at the first one, and adds
advisories (nothing observed, no partition plate) plus per-RV inferred
shapes when a compile is possible.  Everything here is numpy metadata;
no tensor, no device allocation.

``preflight`` is the raising form engines call for opt-in
``validate=True``: it raises one error listing every error-severity
finding, so users see the full picture in one exception.
"""

from __future__ import annotations

from .diagnostics import (
    Diagnostic, ModelDiagnosticError, UnsupportedConstructError, make,
)

__all__ = ["validate_model", "preflight", "PreflightError"]


class PreflightError(ValueError):
    """Raised by :func:`preflight`; carries the full diagnostics list."""

    def __init__(self, diagnostics: list[Diagnostic]):
        self.diagnostics = diagnostics
        errors = [d for d in diagnostics if d.severity == "error"]
        lines = "\n".join(f"  {d}" for d in errors)
        super().__init__(
            f"model failed pre-flight validation with {len(errors)} "
            f"error(s):\n{lines}")


def _net_of(model):
    """Accept a dsl.Model, a BayesianNetwork, or anything with ``.net``."""
    net = getattr(model, "net", model)
    observations = dict(getattr(model, "observations", None) or {})
    bindings = dict(getattr(model, "plate_bindings", None) or {})
    return net, observations, bindings


def validate_model(model, compile: bool = True) -> list[Diagnostic]:
    """All findings about ``model`` (a ``dsl.Model`` or ``BayesianNetwork``).

    Structural supported-class checks run per RV (so one bad edge does not
    mask another RV's problem); if the model carries observations and no
    structural errors were found, a real ``compile_program`` runs (numpy
    only) to surface data-dependent errors and emit per-RV ``rv-shape``
    infos from the resolved plates.
    """
    from ..core.network import UNKNOWN, CategoricalRV

    net, observations, bindings = _net_of(model)
    out: list[Diagnostic] = []

    for rv in net.rvs.values():
        if isinstance(rv, CategoricalRV):
            try:
                net._validate_categorical(rv)
            except (ModelDiagnosticError, UnsupportedConstructError) as e:
                out.append(e.diagnostic)

    observed = [r.name for r in net.rvs.values()
                if getattr(r, "observed", False)] or list(observations)
    if not observed:
        out.append(make(
            "no-observed", net.name,
            "no RV is observed; inference has nothing to condition on",
            hint="call m[rv].observe(values, segment_ids=...) before fit"))
    if not any(p.parent is net.toplevel and p.size == UNKNOWN
               for p in net.plates):
        out.append(make(
            "no-partition-plate", net.name,
            "no outermost '?' plate: the model has no partition dimension, "
            "so minibatch slicing (the SVI engine) is unavailable",
            hint="make the data-indexed plate unknown-size ('?') if you "
                 "want SVI/out-of-core training"))

    errors = any(d.severity == "error" for d in out)
    if compile and observations and not errors:
        from ..core.compiler import compile_program
        try:
            program = compile_program(net, observations,
                                      plate_bindings=bindings)
        except (ModelDiagnosticError, UnsupportedConstructError) as e:
            out.append(e.diagnostic)
        else:
            out.extend(_shape_infos(program))
    return out


def _shape_infos(program) -> list[Diagnostic]:
    """One ``rv-shape`` info per RV of a compiled program."""
    out = []
    for name, d in program.dirichlets.items():
        scope = "local" if d.group_rows is not None else "global"
        out.append(make("rv-shape", name,
                        f"Dirichlet posterior ({d.g}, {d.k}) float32 "
                        f"[{scope}]"))
    for spec in program.latents:
        out.append(make("rv-shape", spec.name,
                        f"latent responsibilities ({spec.n}, {spec.k}) "
                        f"float32"))
        for f in spec.children:
            kind = ("identity" if f.zmap is None else "zmap") \
                + ("" if f.specialized else ", strided")
            out.append(make("rv-shape", f.x_name,
                            f"observed ({len(f.values)},) int32 -> "
                            f"{f.dir_name} via {spec.name} [{kind}]"))
    for s in program.statics:
        out.append(make("rv-shape", s.x_name,
                        f"observed ({len(s.values)},) int32 -> {s.dir_name} "
                        f"[static rows]"))
    return out


def preflight(model, compile: bool = True) -> list[Diagnostic]:
    """Validate and raise :class:`PreflightError` on any error finding;
    returns the (warning/info) diagnostics otherwise."""
    diags = validate_model(model, compile=compile)
    if any(d.severity == "error" for d in diags):
        raise PreflightError(diags)
    return diags
