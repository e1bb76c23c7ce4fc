"""Rebuild-hazard audit: configs that keep paying a per-shape cost.

The port of ``repro.analysis.audit``: the same three hazard families, with
each finding's code, field and severity as the reference's.  The port
compiles nothing per shape, so a message names what the port really pays
for each new shape signature: a step or scorer closure kept in a cache (a
``sliced_shadow`` and its ``make_svi_step`` or ``build_local_scorer``),
where the reference retraces a jitted step.

  - **retrace-growth** — ``growing=True`` corpora approaching (or past)
    ``capacity_docs``: the padded-capacity template absorbs growth only
    up to the cap; a batch touching documents beyond it cannot be sliced;
  - **retrace-bucket-churn** — per-shape builds: SVI with
    ``pad_multiple=0`` builds a step per distinct batch extent; ``FoldIn``
    with ``bucket=None``/``"exact"`` builds a scorer per query shape;
  - **retrace-host-caps** — multi-host mode: ``growing=True`` is
    single-host only, and unpadded caps would churn on every host.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.audit --preset lda_topics
    PYTHONPATH=src python -m repro_torch.analysis.audit --preset streaming_lda

Exit status is nonzero only for error-severity findings; warnings print
but pass.
"""

from __future__ import annotations

from typing import Optional

from .diagnostics import Diagnostic, make

__all__ = ["audit_config"]


def audit_config(config=None, *, foldin=None, n_docs: Optional[int] = None,
                 n_hosts: Optional[int] = None) -> list[Diagnostic]:
    """Hazard findings for an ``SVIConfig``/``EngineConfig`` (``config``)
    and/or a ``FoldInConfig`` (``foldin``).

    ``n_docs`` — the corpus's *current* document count (from its manifest
    or lengths); enables the capacity-headroom checks.  ``n_hosts`` —
    planned host count (defaults to ``config.hosts`` when that is an
    int).  Pure metadata in, diagnostics out.
    """
    out: list[Diagnostic] = []
    if config is not None:
        growing = bool(getattr(config, "growing", False))
        capacity = int(getattr(config, "capacity_docs", 0) or 0)
        pad = getattr(config, "pad_multiple", None)
        hosts_attr = getattr(config, "hosts", None)
        if n_hosts is None and isinstance(hosts_attr, int):
            n_hosts = hosts_attr

        if growing and capacity and n_docs is not None:
            if n_docs > capacity:
                out.append(make(
                    "retrace-growth", "capacity_docs",
                    f"corpus already has {n_docs} docs but capacity_docs="
                    f"{capacity}: batches touching docs past the capacity "
                    f"template cannot be sliced into it",
                    hint=f"raise capacity_docs above the corpus's planned "
                         f"peak (now >= {n_docs})", severity="error"))
            elif n_docs > 0.8 * capacity:
                out.append(make(
                    "retrace-growth", "capacity_docs",
                    f"corpus at {n_docs}/{capacity} docs "
                    f"({100 * n_docs / capacity:.0f}% of capacity_docs): "
                    f"appends will soon exhaust the padded template",
                    hint="raise capacity_docs before the writer catches up"))
        if pad == 0:
            out.append(make(
                "retrace-bucket-churn", "pad_multiple",
                "pad_multiple=0: every distinct batch extent signature "
                "builds and keeps a step of its own (the epoch tail batch "
                "alone adds one per epoch length)",
                hint="set pad_multiple (e.g. 256) so batches share padded "
                     "signatures"))
        if n_hosts and n_hosts > 1:
            if growing:
                out.append(make(
                    "retrace-host-caps", "hosts",
                    f"growing=True with {n_hosts} hosts: growing corpora "
                    f"are single-host only (no refresh barrier — hosts "
                    f"would adopt different commits and build divergent "
                    f"capacity templates)",
                    hint="train growing corpora on one host, or freeze "
                         "the corpus before going multi-host",
                    severity="error"))
            if pad == 0:
                out.append(make(
                    "retrace-host-caps", "pad_multiple",
                    f"pad_multiple=0 with {n_hosts} hosts: the shared "
                    f"lengths-probe caps change with every batch, so all "
                    f"hosts build a new step together on every new extent",
                    hint="set pad_multiple so the shared caps quantize"))

    if foldin is not None:
        bucket = getattr(foldin, "bucket", "pow2")
        if bucket in (None, "exact"):
            out.append(make(
                "retrace-bucket-churn", "FoldInConfig.bucket",
                f"bucket={bucket!r}: fold-in builds a scorer closure per "
                f"distinct query shape — an unbounded scorer cache under "
                f"organic traffic",
                hint="use bucket='pow2' (default) to quantize query "
                     "shapes into a bounded set"))
    return out


# ---------------------------------------------------------------------------
# CLI: audit the example configs
# ---------------------------------------------------------------------------

def _preset(name: str):
    """Reconstruct an example script's config surface for auditing."""
    from ..core.svi import SVIConfig
    from ..query.foldin import FoldInConfig
    if name == "lda_topics":
        # examples/lda_topics.py --engine svi defaults: batch 256 docs,
        # padded signatures, resident or sharded corpus, no growth
        return SVIConfig(batch_size=256, holdout_frac=0.05,
                         holdout_every=10), None, None
    if name == "streaming_lda":
        # examples/streaming_lda.py: grows a 400-doc seed corpus by
        # 3 rounds x 150 docs against capacity 2048
        cfg = SVIConfig(batch_size=64, local_iters=3, holdout_frac=0.05,
                        holdout_every=10, pad_multiple=512, seed=0,
                        growing=True, capacity_docs=2048)
        return cfg, FoldInConfig(local_iters=5), 400 + 3 * 150
    raise SystemExit(f"unknown preset {name!r} "
                     f"(have: lda_topics, streaming_lda)")


def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.audit",
        description="Rebuild-hazard audit of engine/serving configs")
    ap.add_argument("--preset", action="append", default=[],
                    help="example config to audit: lda_topics|streaming_lda "
                         "(repeatable)")
    args = ap.parse_args(argv)
    if not args.preset:
        ap.error("pass at least one --preset")
    worst = 0
    for name in args.preset:
        cfg, foldin, n_docs = _preset(name)
        findings = audit_config(cfg, foldin=foldin, n_docs=n_docs)
        print(f"audit {name}: {len(findings)} finding(s)")
        for d in findings:
            print(f"  {d}")
            if d.severity == "error":
                worst = 1
    return worst


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(_main())
