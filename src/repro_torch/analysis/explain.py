"""Inference EXPLAIN plans: what will run on the card, before anything runs.

The port of ``repro.analysis.explain``.  Given ``(model, corpus metadata,
config)``, :func:`explain_plan` reproduces every decision the engines and
kernels will make, without launching a kernel or placing a tensor on a
device:

  - the **padded-shape signature** a step is built at (for SVI, by
    replaying the real ``holdout_split``, ``MinibatchSampler.batch_at(0)``
    and ``compiler.slice_arrays``, all numpy, so the predicted signature is
    the key ``SVI.step`` keeps its step under, exactly);
  - the **kernel route** per latent, from ``kernels.ops.routing`` over the
    step's own index streams: ``plain`` on the CPU; on the card ``flat`` or
    ``zmap``, each child's stats pass (``pieces``, ``runs`` or
    ``strided``) and each zmap child's logits route (``group`` or
    ``warp``).  A strided child's pass and the logits route depend on the
    streams (whether its rows meet across bases; how they group), so the
    plan reads the owner plan the step would build, from the functions the
    wrappers launch by: plan and dispatch cannot drift;
  - the **bytes** of the token-plate substep: ``hbm_fused`` is
    :func:`zstats_bytes`, the least the kernel must move on these streams
    (the byte count ``chip_smoke.py``'s bounds divide by), and
    ``hbm_unfused`` the plain version's chain, which writes and reads its
    (N, K) intermediates;
  - the Hopper footprints: the Elog tables against the 50 MB L2 (for
    information: the passes gather from device memory at any size) and the
    owner plan's host bytes;
  - the estimated per-step **working set** vs the corpus size;
  - the per-host partition summary (shards, docs, bytes) when a sharded
    corpus and ``n_hosts`` are given.

What the TPU planner reported instead (the 8 MiB VMEM budget, streamed
tiles, the ref fallback) has no Hopper meaning and is gone.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis.explain --model lda \\
        --docs 2000 --vocab 10000 --topics 64 --engine svi --backend cuda
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from ..kernels.work import counted, gathered_bytes, zstats_bytes

__all__ = ["explain_plan", "Plan", "KernelRoute", "synthesize_model",
           "routes_at", "zstats_bytes", "gathered_bytes", "counted"]


class _ShapeOnly:
    """Stand-in of a table carrying just ``.shape``/``.dtype``: what
    ``routing`` and the owner plan read of a table, so no table is ever
    made."""
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype="float32"):
        self.shape = tuple(shape)
        self.dtype = dtype


@dataclasses.dataclass
class KernelRoute:
    """One plan row: the kernel route of one latent's ``zstats`` call."""
    latent: str
    prior_dir: str
    n_latent: int                   # latent instances the step sees (padded)
    n_tokens: int                   # observed child instances (padded)
    k: int
    table_shapes: dict              # dirichlet name -> (g, k) the step sees
    path: str                       # plain | flat | zmap
    backend: str                    # cuda | cpu
    table_dtype: str
    passes: tuple                   # per child: pieces | runs | strided
    logits: tuple                   # per zmap child: group | warp
    table_bytes: int                # the f32 Elog tables the passes gather
    l2_bytes: int                   # the card's L2, for information
    plan_bytes: int                 # the owner plan's host arrays
    reason: str
    hbm_unfused: int                # bytes/step, the plain version's chain
    hbm_fused: int                  # bytes/step, the kernel (zstats_bytes)

    @property
    def label(self) -> str:
        """``ops.route_label`` of this route (``"flat passes=pieces"``)."""
        from ..kernels.ops import route_label
        return route_label(self.path, self.passes, self.logits)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Plan:
    """The full EXPLAIN plan; ``render()`` for humans, ``to_json()`` for
    machines."""
    model: str
    engine: str                     # "vmp" (full batch) | "svi" | "gibbs"
    backend: str
    tables: str                     # zstats table mode the step uses
    diagnostics: list               # validate findings (errors stop the plan)
    caps: Optional[dict]            # padded-shape signature (sliced axes)
    signature: Optional[tuple]      # the SVI step-cache key, exactly
    routes: list                    # KernelRoute per latent
    hosts: Optional[list]           # per-host partition summary dicts
    working_set: Optional[dict]     # bytes: batch / tables / corpus
    notes: list

    def to_json(self, indent: int = 1) -> str:
        d = dataclasses.asdict(self)
        d["diagnostics"] = [dataclasses.asdict(x) for x in self.diagnostics]

        def _py(o):
            if isinstance(o, (np.integer,)):
                return int(o)
            if isinstance(o, (np.floating,)):
                return float(o)
            raise TypeError(f"not JSON-serializable: {o!r}")
        return json.dumps(d, indent=indent, default=_py)

    def render(self) -> str:
        out = [f"EXPLAIN {self.model} · engine={self.engine} "
               f"backend={self.backend} tables={self.tables}"]
        errs = [d for d in self.diagnostics if d.severity == "error"]
        for d in self.diagnostics:
            out.append(f"  {d}")
        if errs:
            out.append("  plan aborted: fix the errors above")
            return "\n".join(out)
        if self.caps:
            out.append("  step signature (padded-shape caps):")
            for name, cap in sorted(self.caps.items()):
                out.append(f"    {name:<12} {cap}")
        for r in self.routes:
            out.append(f"  latent {r.latent} (prior {r.prior_dir}): "
                       f"route={r.label}")
            tabs = ", ".join(f"{n}:{s[0]}x{s[1]}"
                             for n, s in r.table_shapes.items())
            out.append(f"    instances={r.n_latent} tokens={r.n_tokens} "
                       f"K={r.k} tables[{r.table_dtype}] {tabs}")
            out.append(f"    Elog tables {_fmt(r.table_bytes)} vs L2 "
                       f"{_fmt(r.l2_bytes)} (gathered from device memory "
                       f"at any size); owner plan {_fmt(r.plan_bytes)}")
            out.append(f"    {r.reason}")
            out.append(f"    HBM/step: fused {_fmt(r.hbm_fused)} vs "
                       f"unfused {_fmt(r.hbm_unfused)} "
                       f"({r.hbm_unfused / max(r.hbm_fused, 1):.1f}x)")
        if self.hosts:
            out.append("  host partition:")
            for h in self.hosts:
                out.append(f"    host {h['host']}: {h['shards']} shards, "
                           f"{h['docs']} docs, {_fmt(h['bytes'])}")
        if self.working_set:
            w = self.working_set
            out.append(f"  working set/step: batch {_fmt(w['batch_bytes'])} "
                       f"+ tables {_fmt(w['table_bytes'])}"
                       + (f" (corpus {_fmt(w['corpus_bytes'])}, "
                          f"{w['fraction']:.3f}x)"
                          if w.get("corpus_bytes") else ""))
        for n in self.notes:
            out.append(f"  note: {n}")
        return "\n".join(out)


def _fmt(b: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.1f}{unit}" if unit != "B" else f"{b}B"
        b /= 1024
    return f"{b}B"                                     # pragma: no cover


# ---------------------------------------------------------------------------
# caps prediction: replay the real sampler + the real slicer, in numpy
# ---------------------------------------------------------------------------

def _svi_caps(program, cfg):
    """The exact cap signature ``SVI.step(0)`` is built at, and batch 0's
    arrays: the same holdout split, the same ``batch_at(0)``, the same
    ``slice_arrays`` padding, all the actual code."""
    from ..core.compiler import slice_arrays
    from ..data.pipeline import MinibatchSampler, holdout_split

    n_groups = program.meta["pstar_size"]
    if cfg.holdout_frac > 0:
        train, _ = holdout_split(n_groups, cfg.holdout_frac, cfg.seed)
    else:
        train = np.arange(n_groups, dtype=np.int64)
    batch_size = min(cfg.batch_size, len(train))
    sampler = MinibatchSampler(groups=train, batch_size=batch_size,
                               seed=cfg.seed, shuffle=cfg.shuffle)

    def caps_fn(name, n):
        m = cfg.pad_multiple
        return n if not m else -(-max(n, 1) // m) * m

    arrays, dirs, caps, _ = slice_arrays(program, sampler.batch_at(0),
                                         caps_fn)
    batch_bytes = sum(a.nbytes for d in arrays.values()
                      for a in d.values() if a is not None)
    batch_bytes += sum(a.nbytes for d in dirs.values() for a in d.values())
    return caps, batch_bytes, arrays


def _full_caps(program):
    """Full-batch extents: the shapes a VMP/Gibbs step runs at, and the
    step's index streams (``vmp._program_arrays``, as CPU tensors)."""
    from ..core.vmp import _program_arrays
    caps = {}
    for spec in program.latents:
        caps[spec.name] = spec.n
        for f in spec.children:
            caps[f.x_name] = len(f.values)
    for s in program.statics:
        caps[s.x_name] = len(s.values)
    batch_bytes = sum(4 * caps[k] for k in caps)   # int32 index streams
    return caps, batch_bytes, _program_arrays(program, "cpu")


# ---------------------------------------------------------------------------
# per-latent kernel routes
# ---------------------------------------------------------------------------

def routes_at(program, arrays: dict, caps: dict, *, backend: str = "cuda",
              elog_dtype=None) -> list:
    """One :class:`KernelRoute` per latent of a step over ``arrays`` (the
    step's index streams: ``slice_arrays``' for a batch, the program's for
    full batch) at ``caps``, through ``kernels.ops.routing``.  Each table is
    a stand-in of the shape the step gives it (``caps[name]`` rows for a
    sliced local Dirichlet), as in ``vmp.owner_plans``."""
    from ..core.vmp import _latent_children
    from ..kernels.ops import routing

    tables = "elog" if elog_dtype is None else "alpha"
    dtype = "float32" if elog_dtype is None else \
        str(elog_dtype).replace("torch.", "")
    tabs = {n: _ShapeOnly((caps.get(n, d.g), d.k), dtype)
            for n, d in program.dirichlets.items()}
    out = []
    for spec in program.latents:
        k = program.dirichlets[spec.prior_dir].k
        nz = caps[spec.name]
        prior_rows = arrays[spec.name]["prior_rows"]
        zmask = arrays[spec.name].get("mask")
        children = _latent_children(spec, tabs, arrays)
        shapes = {spec.prior_dir: tabs[spec.prior_dir].shape}
        shapes.update({f.dir_name: tabs[f.dir_name].shape
                       for f in spec.children})
        n_tok = sum(caps[f.x_name] for f in spec.children)
        zmap_tok = sum(caps[f.x_name] for f in spec.children
                       if f.zmap is not None)
        n_tok = n_tok or nz           # childless latent: one row per instance
        r = routing(tabs[spec.prior_dir], prior_rows, children,
                    tables=tables, backend=backend)
        words = sum(g * kk for g, kk in shapes.values())
        if zmap_tok:
            unfused = 4 * (5 * n_tok * k + 4 * nz * k + 2 * words)
        else:
            unfused = 4 * (7 * n_tok * k + 2 * words)
        fused = zstats_bytes(tabs[spec.prior_dir], prior_rows, children,
                             zmask)
        out.append(KernelRoute(
            latent=spec.name, prior_dir=spec.prior_dir, n_latent=int(nz),
            n_tokens=int(n_tok), k=int(k), table_shapes=shapes,
            path=r.path, backend=r.backend, table_dtype=r.table_dtype,
            passes=r.passes, logits=r.logits, table_bytes=r.table_bytes,
            l2_bytes=r.l2_bytes, plan_bytes=r.plan_bytes, reason=r.reason,
            hbm_unfused=int(unfused), hbm_fused=int(fused)))
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def explain_plan(model, config=None, *, corpus=None, backend: str = "cuda",
                 n_hosts: Optional[int] = None) -> Plan:
    """Build the EXPLAIN plan for ``model`` under ``config``.

    ``model`` — a ``dsl.Model`` with observations bound (compile is pure
    numpy).  ``config`` — ``SVIConfig`` (minibatch plan), ``EngineConfig``
    (engine chosen by its ``backend`` field), or ``None`` (full-batch
    VMP).  ``corpus`` — optional ``ShardedCorpus`` for working-set and
    host-partition context.  ``backend`` — ``"cuda"`` (the default) plans
    the card's routes from anywhere, the CPU included; ``"cpu"`` plans the
    plain versions.  ``n_hosts`` — include the multi-host partition
    summary (with a ``corpus``).
    """
    from ..core.svi import SVIConfig
    from .validate import validate_model

    engine, svi_cfg, elog_dtype, notes = "vmp", None, None, []
    if isinstance(config, SVIConfig):
        engine, svi_cfg, elog_dtype = "svi", config, config.elog_dtype
    elif config is not None:                # EngineConfig (duck-typed)
        engine = getattr(config, "backend", "vmp")
        elog_dtype = getattr(config, "elog_dtype", None)
        if engine == "svi":
            from ..core.engine import _svi_config
            svi_cfg = _svi_config(config, full_batch=False, n_groups=0)
        elif engine == "gibbs":
            notes.append("gibbs runs full-batch sweeps; routes below are "
                         "the fold-in scorer's (zstats) view")

    diags = validate_model(model)
    name = getattr(getattr(model, "net", model), "name", "?")
    plan = Plan(model=name, engine=engine, backend=backend,
                tables="elog" if elog_dtype is None else "alpha",
                diagnostics=diags, caps=None, signature=None, routes=[],
                hosts=None, working_set=None, notes=notes)
    if any(d.severity == "error" for d in diags):
        return plan

    program = model.compile()
    if svi_cfg is not None:
        if program.meta.get("pstar") is None:
            plan.notes.append("model has no '?' partition plate; SVI "
                              "unavailable — planning full batch instead")
            svi_cfg = None
    if svi_cfg is not None:
        caps, batch_bytes, arrays = _svi_caps(program, svi_cfg)
    else:
        caps, batch_bytes, arrays = _full_caps(program)
    plan.caps = dict(caps)
    plan.signature = tuple(sorted(caps.items()))
    plan.routes = routes_at(program, arrays, caps, backend=backend,
                            elog_dtype=elog_dtype)

    word = 2 if str(elog_dtype or "").endswith("bfloat16") else 4
    table_bytes = sum(word * d.g * d.k for d in program.dirichlets.values())
    ws = {"batch_bytes": int(batch_bytes), "table_bytes": int(table_bytes)}
    if corpus is not None:
        cb = int(getattr(corpus, "disk_bytes", 0) or 0)
        if cb:
            ws["corpus_bytes"] = cb
            ws["fraction"] = (batch_bytes + table_bytes) / cb
    plan.working_set = ws

    if n_hosts and corpus is not None:
        from ..data.store import doc_ownership, shard_ownership
        manifest = corpus.manifest
        owner = shard_ownership(len(manifest["shards"]), n_hosts)
        downer = doc_ownership(manifest, n_hosts)
        plan.hosts = []
        for h in range(n_hosts):
            sids = np.flatnonzero(owner == h)
            ndocs = int((downer == h).sum())
            nbytes = sum(int(manifest["shards"][int(s)].get("n_tokens", 0))
                         * 4 for s in sids)
            plan.hosts.append({"host": h, "shards": int(len(sids)),
                               "docs": ndocs, "bytes": int(nbytes)})
    return plan


# ---------------------------------------------------------------------------
# CLI: synthesize a zoo model from shape knobs and print its plan
# ---------------------------------------------------------------------------

def synthesize_model(name: str, *, docs: int, vocab: int, topics: int,
                     mean_len: int = 100, sents_per_doc: int = 8,
                     seed: int = 0):
    """A zoo model with synthetic observations at the given shapes, numpy
    only (the reference's draws, so both packages plan the same model)."""
    from ..core import models

    rng = np.random.default_rng(seed)
    n_tok = docs * mean_len
    toks = rng.integers(0, vocab, n_tok).astype(np.int32)
    doc_of_tok = np.repeat(np.arange(docs, dtype=np.int32), mean_len)
    if name in ("lda", "dcmlda"):
        m = models.make(name, alpha=0.1, beta=0.05, K=topics, V=vocab)
        m["x"].observe(toks, segment_ids=doc_of_tok)
    elif name == "slda":
        n_sents = docs * sents_per_doc
        per_sent = max(mean_len // sents_per_doc, 1)
        sent_of_tok = np.repeat(np.arange(n_sents, dtype=np.int32), per_sent)
        toks = rng.integers(0, vocab, len(sent_of_tok)).astype(np.int32)
        doc_of_sent = np.repeat(np.arange(docs, dtype=np.int32),
                                sents_per_doc)
        m = models.make("slda", alpha=0.1, beta=0.05, K=topics, V=vocab)
        m["x"].observe(toks, segment_ids=sent_of_tok)
        m.bind("sents", doc_of_sent)
    elif name == "naive_bayes":
        m = models.make("naive_bayes", alpha=0.1, beta=0.05, C=topics,
                        V=vocab)
        m["x"].observe(toks, segment_ids=doc_of_tok)
    elif name == "two_coins":
        m = models.make("two_coins", alpha=1.0, beta=1.0)
        m["x"].observe(rng.integers(0, 2, docs).astype(np.int32))
    else:
        raise ValueError(f"unknown zoo model {name!r}")
    return m


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.explain",
        description="Static inference EXPLAIN plan (no kernel, no device)")
    ap.add_argument("--model", default="lda",
                    help="zoo model: lda|slda|dcmlda|naive_bayes|two_coins")
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--vocab", type=int, default=10000)
    ap.add_argument("--topics", type=int, default=64)
    ap.add_argument("--mean-len", type=int, default=100)
    ap.add_argument("--engine", default="svi", choices=["vmp", "svi"])
    ap.add_argument("--batch-docs", type=int, default=64)
    ap.add_argument("--pad-multiple", type=int, default=256)
    ap.add_argument("--elog-dtype", default=None,
                    help="e.g. bfloat16 for narrow tables")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "cpu"],
                    help="plan for the card (default) or the CPU")
    ap.add_argument("--corpus-dir", default=None,
                    help="ShardedCorpus directory: plan against its real "
                         "manifest/lengths instead of --docs/--mean-len")
    ap.add_argument("--hosts", type=int, default=None,
                    help="include the n-host partition summary")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    corpus = None
    if args.corpus_dir:
        from ..core import models
        from ..data.store import ShardedCorpus
        corpus = ShardedCorpus.open(args.corpus_dir)
        m = models.make(args.model, alpha=0.1, beta=0.05, K=args.topics,
                        V=int(corpus.vocab))
        lengths = np.asarray(corpus.lengths, np.int64)
        doc_of_tok = np.repeat(np.arange(len(lengths), dtype=np.int32),
                               lengths)
        # extents, not values, decide the routes: zeros stand in for tokens
        m["x"].observe(np.zeros(int(lengths.sum()), np.int32),
                       segment_ids=doc_of_tok)
    else:
        m = synthesize_model(args.model, docs=args.docs, vocab=args.vocab,
                             topics=args.topics, mean_len=args.mean_len)

    cfg = None
    if args.engine == "svi":
        from ..core.svi import SVIConfig
        cfg = SVIConfig(batch_size=args.batch_docs,
                        pad_multiple=args.pad_multiple,
                        elog_dtype=args.elog_dtype)
    plan = explain_plan(m, cfg, corpus=corpus, backend=args.backend,
                        n_hosts=args.hosts)
    print(plan.to_json() if args.json else plan.render())
    return 1 if any(d.severity == "error" for d in plan.diagnostics) else 0


if __name__ == "__main__":          # pragma: no cover
    raise SystemExit(_main())
