"""The dry run: what one step of any (architecture x input shape x mesh)
cell costs on the H100, without running it.  ``repro.launch.dryrun`` on
the port.

For every cell the step is built through ``launch.steps`` (the train step,
on a mesh the sharded one; prefill; decode) with ``flash_kernel=True``,
the card's path, and traced once on ``meta`` tensors
(``launch.step_cost.count``) against the cell's inputs
(``models.input_specs``).  Per device it records the peak live bytes
(does the cell fit one H100's memory, ``roofline.HBM_BYTES``?), the
FLOPs and HBM bytes of the step, the collective bytes by kind and the
kernels' launches by route, and the three-term H100 roofline
(``launch.roofline``) with its bottleneck.

Meshes: ``--mesh single|multi|both`` are the reference's production
meshes, 16 x 16 and 2 x 16 x 16 (the pod folded into data), over a
``DryGroup``: the step of shard 0, as rank 0 of a process a shard would run
it, every exchange counted as that rank's gather (the port's collectives
gather every shard's part, then select); ``--mesh-shape DxM`` another
data x model grid, ``1x1`` one H100 (the one-device step, no exchange).
The paper's VMP step runs too (``--all``, or ``--arch vmp-lda-96x9040``):
LDA with K = 96 and V = 9,040 (the paper's Wikipedia setting) over a
synthetic corpus of 2,000 documents, the ``"inferspark"`` plan over every
shard, shard 0's owner plans built on the host; it asserts the paper's
structural claim that the statistic sum of phi is the only exchange above
1 MB and theta moves nothing.

Results land as JSON under ``experiments/dryrun_torch/`` (git-ignored);
the run is resumable (cells with existing JSON are skipped unless
``--force``).  Everything runs on the CPU of any host, the card's too.
``--table DIR ...`` prints the grid of the JSON in those directories as
one markdown table (``PERF.md``'s "Step costs"), each cell's fit read
against ``launch.roofline.HBM_BYTES``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape train_4k --mesh-shape 1x1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table DIR [DIR ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import traceback

import torch

from ..configs import ARCHS, SHAPES, RunConfig, cell_enabled, get_arch
from ..models import input_specs, make_model
from . import roofline as RL
from .dist import DryGroup
from .mesh import Mesh, make_production_mesh
from .step_cost import count
from .steps import (batch_to, build_decode_step, build_prefill_step,
                    build_train_step, place_batch)

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
VMP_ARCH, VMP_SHAPE = "vmp-lda-96x9040", "paper_wiki"
MB = 1_000_000
DEV = "meta"


def make_mesh(multi_pod: bool, mesh_shape: str = ""):
    """``(mesh or None, label)``: ``mesh_shape`` ``"DxM"`` (``"1x1"``: no
    mesh, one H100), else the production mesh; every mesh over a
    ``DryGroup``."""
    if mesh_shape:
        dims = tuple(int(x) for x in mesh_shape.split("x"))
        if dims == (1, 1):
            return None, mesh_shape
        n = math.prod(dims)
        return Mesh(dims, ("data", "model")[:len(dims)], DryGroup(n)), \
            mesh_shape
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod, DryGroup(n)), \
        "2x16x16" if multi_pod else "16x16"


def train_costs(cfg, run: RunConfig, mesh=None, batch=None, params=None):
    """The ``Costs`` of one train step of ``cfg`` under ``run`` on ``mesh``
    (None: one device), traced on ``meta`` tensors: the batch as
    ``launch.train`` hands it over (``batch``, stand-ins of the
    reference's; tokens and labels of ``run``'s shape by default), AdamW's
    zero state, the step number 0."""
    from ..optim import adamw_init
    from .train import to_mesh
    if batch is None:
        batch = {k: torch.empty((run.global_batch, run.seq_len),
                                dtype=torch.int32, device=DEV)
                 for k in ("tokens", "labels")}
    if params is None:
        params = make_model(cfg)["init"](run, device=DEV)
    built = build_train_step(cfg, run, DEV, mesh=mesh)
    if mesh is None:
        opt = adamw_init(list(params.parameters()))
        data = batch_to(batch, DEV)
    else:
        params, opt = to_mesh(built["layout"], params, None)
        data = place_batch(batch, mesh, built["rules"], DEV)
    return count(built["fn"], params, opt, data, 0,
                 group=mesh.group if mesh is not None else None)


def trace_cell(cfg, shape_name: str, run: RunConfig, mesh):
    """``(Costs, model FLOPs)`` of one step of the cell on ``mesh`` (None:
    one device), traced on ``meta`` tensors."""
    from ..models.parallel import ShardedParams
    kind, seq, batch = SHAPES[shape_name]
    specs = input_specs(cfg, shape_name, run)
    group = mesh.group if mesh is not None else None
    params = make_model(cfg)["init"](run, device=DEV)
    active = cfg.active_param_count()
    if kind == "train":
        return train_costs(cfg, run, mesh, specs["batch"], params), \
            RL.train_model_flops(active, batch * seq)
    if kind == "prefill":
        built = build_prefill_step(cfg, run, DEV, mesh=mesh)
        if mesh is not None:
            params = ShardedParams.from_module(built["server"].layout,
                                               params)
        costs = count(built["fn"], params, batch_to(specs["batch"], DEV),
                      group=group)
        return costs, 2.0 * active * batch * seq
    built = build_decode_step(cfg, run, DEV, mesh=mesh)
    cache = specs["cache"]
    if mesh is not None:
        params = ShardedParams.from_module(built["server"].layout, params)
        cache = built["server"].place_cache(cache, seq)
    costs = count(built["fn"], params, cache, batch_to(
        {"t": specs["tokens"]}, DEV)["t"], int(specs["pos"]), group=group)
    return costs, RL.decode_model_flops(active, batch)


def _summary(costs, n_chips: int, mflops: float) -> tuple:
    """(collectives with ``total_bytes``, roofline) of counted costs."""
    d = costs.as_dict()
    coll = dict(d["collectives"], total_bytes=d["collective_bytes"])
    roof = RL.roofline({"flops": d["flops"], "bytes accessed":
                        d["traffic_bytes"]},
                       {"total_bytes": d["collective_bytes"]}, n_chips,
                       model_flops=mflops)
    roof["dynamic_loops_hinted"] = d["dynamic_loops"]
    return coll, roof


def _line(name, shape, mesh_label, res) -> str:
    roof = res["roofline"]
    return (f"[dryrun] {name:22s} {shape:12s} {mesh_label:8s} OK  "
            f"mem/dev={res['memory']['peak_bytes'] / 1e9:9.2f}GB  "
            f"compute={roof['compute_s']:.3e}s "
            f"mem={roof['memory_s']:.3e}s "
            f"coll={roof['collective_s']:.3e}s "
            f"bott={roof['bottleneck']:10s} (trace {res['trace_s']:.1f}s)")


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             run: RunConfig | None = None, verbose: bool = True,
             mesh_shape: str = "") -> dict:
    """One cell's JSON record (the reference's keys; ``memory`` holds the
    peak bytes per device, ``trace_s`` the trace's seconds)."""
    cfg = get_arch(arch_name)
    kind, seq, batch = SHAPES[shape_name]
    run = run or RunConfig(seq_len=seq, global_batch=batch, remat="dots")
    run = dataclasses.replace(run, flash_kernel=True)
    mesh, label = make_mesh(multi_pod, mesh_shape)
    n_chips = mesh.size if mesh is not None else 1
    costs, mflops = trace_cell(cfg, shape_name, run, mesh)
    coll, roof = _summary(costs, n_chips, mflops)
    res = {
        "arch": arch_name, "shape": shape_name, "mesh": label,
        "n_chips": n_chips, "step_kind": kind,
        "seq_len": seq, "global_batch": batch,
        "run_config": {"remat": run.remat, "fsdp": run.fsdp,
                       "attn_chunk": run.attn_chunk,
                       "microbatch": run.microbatch, "dtype": run.dtype,
                       "moe_groups": run.moe_groups,
                       "act_shard": run.act_shard,
                       "flash_kernel": run.flash_kernel},
        "trace_s": round(costs.seconds, 2),
        "memory": {"peak_bytes": costs.peak_bytes,
                   "fits_h100": RL.fits(costs.peak_bytes)},
        "cost": {"flops": costs.flops, "bytes accessed": costs.traffic},
        "collectives": coll,
        "wire_bytes": mesh.group.wire_bytes if mesh is not None else 0,
        "launches": costs.launches,
        "roofline": roof,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if verbose:
        print(_line(arch_name, shape_name, label, res), flush=True)
    return res


def vmp_program(n_docs: int = 2000, k: int = 96, v: int = 9040):
    """The paper's LDA (its Wikipedia setting: K = 96, V = 9,040) over a
    synthetic corpus, compiled: ``(program, tokens)``."""
    from ..core import models
    from ..data import SyntheticCorpus
    corpus = SyntheticCorpus(n_docs=n_docs, vocab=v, n_topics=k,
                             mean_len=120, seed=0).generate()
    m = models.make("lda", alpha=0.1, beta=0.05, K=k, V=v)
    m["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    return m.compile(), len(corpus["tokens"])


def vmp_step(program, n_shards: int, group=None):
    """``(step, state)`` of one VMP iteration under ``ShardingPlan(
    n_shards, "inferspark")`` on ``meta`` over ``group`` (a
    ``DryGroup(n_shards)`` by default): the owner plans of the local shards
    built on the host, the state's local rows those shards' alone."""
    from ..core.partition import ShardingPlan, make_distributed_step
    plan = ShardingPlan(n_shards, "inferspark")
    plan.group = group if group is not None else DryGroup(n_shards)
    return make_distributed_step(program, plan, seed=0, device=DEV)


def run_vmp_cell(multi_pod: bool, verbose: bool = True,
                 mesh_shape: str = "") -> dict:
    """The paper's VMP step on the cell's shards (tokens shard over every
    axis), with the paper's claim checked: phi's statistic sum is the only
    exchange above 1 MB and theta moves no byte."""
    mesh, label = make_mesh(multi_pod, mesh_shape)
    n = mesh.size if mesh is not None else 1
    program, n_tokens = vmp_program()
    phi = program.dirichlets["phi"]            # (K topics, V words)
    step, state = vmp_step(program, n)
    costs = count(step, state, group=step.plan.group)
    # "model flops" for VMP: the z-update gather+softmax+stats ~ 10 flops
    # per (token, topic) per iteration
    coll, roof = _summary(costs, n, 10.0 * n_tokens * phi.g)
    payload = {}
    for (_, key, _), (_, nb) in costs.exchanges.items():
        payload[key] = payload.get(key, 0) + nb
    big = sorted(key for key, nb in payload.items() if nb > MB)
    if big != ["phi"] or payload.get("theta", 0):
        raise AssertionError(f"the paper's claim fails: exchanges above "
                             f"1 MB {big}, theta {payload.get('theta', 0)} "
                             f"bytes")
    res = {
        "arch": VMP_ARCH, "shape": VMP_SHAPE, "mesh": label,
        "n_chips": n, "step_kind": "vmp_iteration",
        "tokens": n_tokens, "topics": phi.g, "vocab": phi.k,
        "trace_s": round(costs.seconds, 2),
        "memory": {"peak_bytes": costs.peak_bytes,
                   "fits_h100": RL.fits(costs.peak_bytes)},
        "cost": {"flops": costs.flops, "bytes accessed": costs.traffic},
        "collectives": coll, "payload_by_key": payload,
        "wire_bytes": step.plan.group.wire_bytes,
        "launches": costs.launches, "roofline": roof,
    }
    if verbose:
        print(_line(VMP_ARCH, VMP_SHAPE, label, res), flush=True)
        print(f"  payload a step by key (MB): "
              f"{ {k_: round(v / MB, 3) for k_, v in payload.items()} }; "
              f"phi's table {phi.g * phi.k * 4 / MB:.2f} MB", flush=True)
    return res


def table(dirs) -> str:
    """The grid of the cells' JSON records in ``dirs`` as a markdown table:
    per device at 1 x 1, peak GB, PFLOP, TB and bottleneck; at 1 x 4, peak
    GB; at 16 x 16 and 2 x 16 x 16, peak GB, payload GB and bottleneck.
    A check mark follows each peak that fits one card (``roofline.fits``),
    "skip" stands for a cell without a record."""
    recs = {}
    for d in dirs:
        for name in sorted(os.listdir(d)):
            if name.endswith(".json"):
                with open(os.path.join(d, name)) as f:
                    r = json.load(f)
                recs[(r["arch"], r["shape"], r["mesh"])] = r
    order = {s: i for i, s in enumerate(list(SHAPES) + [VMP_SHAPE])}
    cells = sorted({k[:2] for k in recs}, key=lambda c: (
        c[0] == VMP_ARCH, c[0], order[c[1]]))
    bott = {"compute": "comp", "memory": "memo", "collective": "coll"}

    def gb(r):
        peak = r["memory"]["peak_bytes"]
        return f"{peak / 1e9:,.1f}" + (" ✓" if RL.fits(peak) else "")

    def mesh(r):
        return "skip" if r is None else (
            f"{gb(r)}; {r['collectives']['total_bytes'] / 1e9:,.4g}; "
            f"{bott[r['roofline']['bottleneck']]}")

    lines = ["| arch | shape | 1 × 1: GB; PFLOP; TB; bottleneck | 1 × 4: GB "
             "| 16 × 16: GB; payload GB; bottleneck | 2 × 16 × 16: GB; "
             "payload GB; bottleneck |", "|---|---|---|---|---|---|"]
    for arch, shape in cells:
        r1, r4, rs, rm = (recs.get((arch, shape, m)) for m in
                          ("1x1", "1x4", "16x16", "2x16x16"))
        one = "skip" if r1 is None else (
            f"{gb(r1)}; {r1['cost']['flops'] / 1e15:.3g}; "
            f"{r1['cost']['bytes accessed'] / 1e12:.3g}; "
            f"{bott[r1['roofline']['bottleneck']]}")
        lines.append(f"| {arch} | `{shape}` | {one} | "
                     f"{'skip' if r4 is None else gb(r4)} | {mesh(rs)} | "
                     f"{mesh(rm)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--moe-groups", type=int, default=0)
    ap.add_argument("--act-shard", default="none")
    ap.add_argument("--bf16-scores", action="store_true")
    ap.add_argument("--mesh-shape", default="",
                    help='a DxM grid instead of --mesh, e.g. "64x4"; "1x1" '
                         'is one H100')
    ap.add_argument("--tag", default="", help="suffix for output JSONs")
    ap.add_argument("--table", nargs="+", metavar="DIR",
                    help="print the JSON records in these directories as "
                         "one markdown table, and run nothing")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.table))
        return 0

    os.makedirs(args.out, exist_ok=True)
    vmp = args.all or args.arch == VMP_ARCH
    archs = [] if args.arch == VMP_ARCH else \
        [args.arch] if args.arch else sorted(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False] if args.mesh_shape else \
        {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    n_ok = n_skip = n_fail = 0

    def one(name, shape, mp, fn):
        nonlocal n_ok, n_skip, n_fail
        label = args.mesh_shape or ("multi" if mp else "single")
        tag = f"{name}__{shape}__{label}" + (f"__{args.tag}" if args.tag
                                             else "")
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            n_skip += 1
            return
        try:
            res = fn()
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            n_ok += 1
        except Exception as e:      # a failed cell is reported, not fatal
            n_fail += 1
            print(f"[dryrun] {name:22s} {shape:12s} {label:8s} FAIL  {e}")
            traceback.print_exc()

    for a in archs:
        cfg = ARCHS[a]
        for s in shapes:
            ok, why = cell_enabled(cfg, s)
            if not ok:
                print(f"[dryrun] {a:22s} {s:12s} SKIP   ({why})")
                n_skip += 1
                continue
            _, seq, batch = SHAPES[s]
            run = RunConfig(seq_len=seq, global_batch=batch,
                            remat=args.remat, fsdp=args.fsdp,
                            microbatch=args.microbatch,
                            moe_groups=args.moe_groups,
                            act_shard=args.act_shard,
                            attn_f32_scores=not args.bf16_scores)
            for mp in meshes:
                one(a, s, mp, lambda: run_cell(a, s, mp, run=run,
                                               mesh_shape=args.mesh_shape))
    if vmp:
        for mp in meshes:
            one(VMP_ARCH, VMP_SHAPE, mp, lambda: run_vmp_cell(
                mp, mesh_shape=args.mesh_shape))
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
