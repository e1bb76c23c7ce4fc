"""``zmap_stats_ms``: device ms a step of a segment latent's phase 2b (each
zmap child's r-weighted stats pass of ``zstats_zmap``, its zero fill
included): the CUDA event pairs of the port's ``zmap.stats`` records over
the profiled steps' ``runtime.step`` records, as ``zmap_logits_ms`` reads
``zmap.logits``.  A CPU run or a program without the span reads
nothing."""

from metrics.zmap_logits_ms import span_ms

NAMES = ("zmap.stats",)


def read(ctx):
    return span_ms(ctx, NAMES)
