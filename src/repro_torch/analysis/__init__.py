"""Static analysis over models, programs and configs: nothing launches.

The port of ``repro.analysis``, three passes:

  - ``validate`` — pre-compile diagnostics for a model (supported class,
    plates, shapes) as :class:`~repro_torch.analysis.diagnostics.Diagnostic`
    objects instead of mid-compile exceptions,
  - ``explain``  — the inference EXPLAIN plan: the Hopper kernel route of
    each latent, padded shape signatures, bytes a step, working set,
  - ``audit``    — hazards of (config, corpus) combinations that keep
    building per-shape steps or scorers.

Lazy attribute access keeps ``repro_torch.analysis.diagnostics`` importable
from ``core.compiler`` without dragging ``explain`` (which imports core)
into the import cycle.
"""

from __future__ import annotations

__all__ = ["diagnostics", "validate", "explain", "audit",
           "Diagnostic", "validate_model", "preflight", "explain_plan",
           "Plan", "audit_config"]

_LAZY = {
    "Diagnostic": ("repro_torch.analysis.diagnostics", "Diagnostic"),
    "validate_model": ("repro_torch.analysis.validate", "validate_model"),
    "preflight": ("repro_torch.analysis.validate", "preflight"),
    "explain_plan": ("repro_torch.analysis.explain", "explain_plan"),
    "Plan": ("repro_torch.analysis.explain", "Plan"),
    "audit_config": ("repro_torch.analysis.audit", "audit_config"),
    "diagnostics": ("repro_torch.analysis.diagnostics", None),
    "validate": ("repro_torch.analysis.validate", None),
    "explain": ("repro_torch.analysis.explain", None),
    "audit": ("repro_torch.analysis.audit", None),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.analysis' has no "
                             f"attribute {name!r}") from None
    import importlib
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr) if attr else mod
