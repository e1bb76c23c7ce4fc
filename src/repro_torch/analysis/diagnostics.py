"""Diagnostic vocabulary of the front end: a copy of ``repro``'s.

Every way a model can be outside the supported class — or merely
suspicious — has a stable ``code`` here.  ``compile_program`` raises
exceptions *carrying* a :class:`Diagnostic`, with the same codes, classes
and messages as the JAX package, so a model rejected by one package is
rejected by the other in the same words.

This module is a leaf: it imports nothing from the rest of
``repro_torch`` so ``core.compiler`` / ``core.network`` can depend on it
without cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "Diagnostic", "ModelDiagnosticError", "UnsupportedConstructError",
    "CODES", "ERROR", "WARNING", "INFO", "make", "raise_error",
    "raise_unsupported",
]

ERROR = "error"
WARNING = "warning"
INFO = "info"

#: code -> (default severity, one-line meaning).  docs/static_analysis.md
#: renders this table; tests assert every code is exercised.
CODES: dict[str, tuple[str, str]] = {
    # -- structural / plate errors (compile refuses) ----------------------
    "plate-size-conflict":   (ERROR, "a plate was bound to two different sizes"),
    "plate-unresolved":      (ERROR, "an RV's plate size cannot be resolved "
                                     "from observations or bindings"),
    "prior-shape":           (ERROR, "Dirichlet prior vector has the wrong shape"),
    "prior-positive":        (ERROR, "Dirichlet concentrations must be positive"),
    "duplicate-rv":          (ERROR, "two random variables share a name"),
    "bad-dim":               (ERROR, "Dirichlet dimension must be >= 2"),
    "bad-plate-size":        (ERROR, "plate size must be a positive int or '?'"),
    "value-range":           (ERROR, "observed values outside [0, dim)"),
    # -- supported-class violations (paper section 8) ---------------------
    "latent-mixture":        (ERROR, "a latent Categorical selected by another "
                                     "latent (latent mixtures of latents) is "
                                     "outside the supported class"),
    "chained-selector":      (ERROR, "a selector that itself has a selector is "
                                     "outside the supported class"),
    "latent-strided":        (ERROR, "a latent whose own prior row depends on "
                                     "a selector (a latent that is itself a "
                                     "mixture) is unsupported"),
    "unknown-plate-position": (ERROR, "'?' plates are only supported as the "
                                      "outermost plate of a Dirichlet's chain"),
    "unsupported-edge":      (ERROR, "a parent plate is neither an ancestor "
                                     "nor selector-resolved; outside the "
                                     "mixture-of-Categoricals class"),
    "selector-dim-mismatch": (ERROR, "selector dim != the parent plate size "
                                     "it must index"),
    "selector-plate":        (ERROR, "selector must live on the same plate or "
                                     "an ancestor plate of the child"),
    "selector-observed":     (ERROR, "selectors must be latent"),
    "orphan-selector":       (ERROR, "an observed child references a selector "
                                     "that has no latent spec"),
    # -- validate-only advisories (compile may still succeed) -------------
    "no-observed":           (WARNING, "no RV is observed; inference has "
                                       "nothing to condition on"),
    "no-partition-plate":    (WARNING, "no outermost '?' plate; minibatch "
                                       "slicing (SVI) is unavailable"),
    "rv-shape":              (INFO, "inferred shape/dtype of an RV"),
    # -- retrace-hazard audit (analysis.audit) ----------------------------
    "retrace-growth":        (WARNING, "growing corpus will exceed "
                                       "capacity_docs and force a retrace"),
    "retrace-bucket-churn":  (WARNING, "per-shape compilation (no bucketing) "
                                       "compiles once per distinct size"),
    "retrace-host-caps":     (WARNING, "multi-host caps may diverge across "
                                       "hosts and retrace per host"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding about a model/program/config, in the shared vocabulary.

    ``subject`` names the RV, edge (``"x->phi"``), plate, or config field
    the finding is about; ``message`` is the human sentence (compile errors
    reuse it verbatim as the exception text); ``hint`` says what to do.
    """
    code: str
    severity: str
    subject: str
    message: str
    hint: Optional[str] = None

    def __post_init__(self):
        if self.code not in CODES:
            raise KeyError(f"unknown diagnostic code {self.code!r}")

    def __str__(self) -> str:
        s = f"{self.severity}[{self.code}] {self.subject}: {self.message}"
        return s + (f"  (hint: {self.hint})" if self.hint else "")


class ModelDiagnosticError(ValueError):
    """A compile/validation error carrying its :class:`Diagnostic`.

    Subclasses ``ValueError`` so every pre-existing ``except ValueError`` /
    ``pytest.raises(ValueError, match=...)`` keeps working.
    """

    def __init__(self, diagnostic: Diagnostic):
        self.diagnostic = diagnostic
        super().__init__(diagnostic.message)


class UnsupportedConstructError(NotImplementedError):
    """A supported-class rejection carrying its :class:`Diagnostic`.

    Subclasses ``NotImplementedError`` (the historical type for
    "outside the supported class") for the same compatibility reason.
    """

    def __init__(self, diagnostic: Diagnostic):
        self.diagnostic = diagnostic
        super().__init__(diagnostic.message)


def make(code: str, subject: str, message: str,
         hint: Optional[str] = None, severity: Optional[str] = None
         ) -> Diagnostic:
    """Build a Diagnostic with the code's registered default severity."""
    return Diagnostic(code, severity or CODES[code][0], subject, message, hint)


def raise_error(code: str, subject: str, message: str,
                hint: Optional[str] = None) -> None:
    raise ModelDiagnosticError(make(code, subject, message, hint))


def raise_unsupported(code: str, subject: str, message: str,
                      hint: Optional[str] = None) -> None:
    raise UnsupportedConstructError(make(code, subject, message, hint))
