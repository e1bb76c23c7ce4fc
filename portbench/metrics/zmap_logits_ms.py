"""``zmap_logits_ms``: device ms a step of a segment latent's phase 1 (the
summed child messages of ``zstats_zmap``): the CUDA event pairs of the
port's ``zmap.logits`` records (``repro_torch.trace``, recorded while the
profiled steps run under ``torch.profiler``), summed over those steps and
divided by their ``runtime.step`` records, as ``dirichlet_ms`` reads its
spans.  A CPU run (no events) or a program without the span reads
nothing."""

NAMES = ("zmap.logits",)


def span_ms(ctx, names):
    """Device ms a profiled step of the port's records named ``names``;
    None on the CPU, without the tracer or without such records."""
    if ctx.device.type != "cuda" or ctx.profile is None:
        return None
    try:
        from repro_torch import trace
    except ImportError:
        return None
    recs = trace.records()
    steps = sum(r.name == "runtime.step" for r in recs)
    parts = [r for r in recs if r.name in names]
    if not steps or not parts or any(r.events is None for r in parts):
        return None
    return sum(r.device_ms for r in parts) / steps


def read(ctx):
    return span_ms(ctx, NAMES)
