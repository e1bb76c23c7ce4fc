"""``dirichlet_ms``: device ms a step of the Dirichlets' ELBO terms and
updates: the CUDA event pairs of the port's ``vmp.elbo_terms`` and
``vmp.update`` records (``repro_torch.trace``, recorded while the profiled
steps run under ``torch.profiler``), summed over those steps and divided
by their ``runtime.step`` records.  The pairs take in the device's idle
time inside the spans, the host-to-device copies of the priors included.
A CPU run (no events) or a program without the spans reads nothing."""

NAMES = ("vmp.elbo_terms", "vmp.update")


def read(ctx):
    if ctx.device.type != "cuda" or ctx.profile is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    recs = trace.records()
    steps = sum(r.name == "runtime.step" for r in recs)
    parts = [r for r in recs if r.name in NAMES]
    if not steps or not parts or any(r.events is None for r in parts):
        return None
    return sum(r.device_ms for r in parts) / steps
