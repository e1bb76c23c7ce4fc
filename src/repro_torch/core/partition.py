"""The paper's partitioning strategy (section 4.4), in PyTorch: the port of
``repro.core.partition``.

InferSpark's insight: the message-passing graph of a mixture model decomposes
into independent trees rooted at the per-document posteriors, whose leaves
form a complete bipartite graph with a *small* set of shared posteriors.  So:
co-locate each tree (document: its theta row, its z's, its x's) in one
partition, and replicate only the small shared posteriors (phi) —
`E[N_xi] = 1`, `E[N_B] = 3N/M + K` (paper Tables 1-2).

A :class:`ShardingPlan` of ``n_shards`` shards takes the place of the
reference's JAX mesh:

  - the outermost ``?`` plate (documents) is the partition key;
  - documents are packed onto shards by greedy LPT on token counts
    (:func:`lpt_pack`, the reference's, op for op);
  - every "tree-local" array (tokens, latent rows, theta rows) is cut into
    one padded block per shard with that packing (:func:`build_layout`,
    whose arrays equal the reference's element for element);
  - Dirichlets whose plate chain is rooted at the partition plate are LOCAL
    (their stats never leave the shard); all others are GLOBAL (replicated,
    their stats summed over the shards once per iteration — the only place
    shards meet, ``launch.dist.ShardGroup``).

Each shard's step body runs the kernels of the one-device step on its own
block (``vmp._sharded_step_body``), with its own owner plans built from its
own streams: every shard shares one shadow program of equal shapes, so a
plan cached on the shadow would feed shard 1 the plan of shard 0.  Padded
blocks take the masked kernel route, and a local Dirichlet's padding rows
sit exactly at the prior.  The shards of a full-batch VMP run live in
one process (the shard group sums them on the device) or across
processes, each rank running its own shards and holding only their rows
of the local Dirichlets (:func:`make_distributed_step`); two ranks are
bitwise one process.  SVI's multi-process path is ``core/svi.py``'s
(``hosts=``).

``strategy="gspmd"`` is the flat baseline: the flat arrays cut into
contiguous padded blocks, every Dirichlet (theta too) replicated and its
stats summed — the reference's generic partitioner's math.
``strategy="replicated"`` is the single-device (Infer.NET) layout.

This module also carries the paper's analytic cost models (Tables 1-2).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from .compiler import VMPProgram
from .vmp import (VMPState, _sharded_step_body, init_state, owner_plans,
                  resolve_device)


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardingPlan:
    """``n_shards`` data shards under ``strategy`` (inferspark | gspmd |
    replicated).  ``group`` is the shard group the shards' stats meet in
    (``launch.dist.ShardGroup``), over the current process group: every
    shard virtual without one."""
    n_shards: int
    strategy: str = "inferspark"
    group: object = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        from ..launch.dist import ShardGroup
        if self.strategy not in ("inferspark", "gspmd", "replicated"):
            raise ValueError(f"unknown strategy {self.strategy!r}")
        self.group = ShardGroup(self.n_shards)


def lpt_pack(weights: np.ndarray, m: int) -> np.ndarray:
    """Greedy longest-processing-time packing: group -> shard.

    This is the load balancer: the paper's partitioner keeps each tree whole;
    we additionally equalize token mass so no shard straggles.
    """
    order = np.argsort(-weights, kind="stable")
    load = np.zeros(m, dtype=np.int64)
    assign = np.zeros(len(weights), dtype=np.int32)
    for g in order:
        s = int(np.argmin(load))
        assign[g] = s
        load[s] += int(weights[g])
    return assign


def _pack_indices(shard: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Given per-instance shard ids, build (gather (m, cap), mask (m, cap),
    local_index (n,)): stacked padded layout + inverse map.  Instance ``i``
    is the next free slot of its shard, in instance order (the reference's
    loop, vectorized: a stable sort by shard)."""
    shard = np.asarray(shard, np.int64)
    counts = np.bincount(shard, minlength=m)
    cap = max(1, int(counts.max()))
    order = np.argsort(shard, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    local = np.zeros(len(shard), dtype=np.int32)
    local[order] = np.arange(len(shard)) - np.repeat(starts, counts)
    gather = np.zeros((m, cap), dtype=np.int64)
    mask = np.zeros((m, cap), dtype=np.float32)
    gather[shard, local] = np.arange(len(shard))
    mask[shard, local] = 1.0
    return gather, mask, local


@dataclasses.dataclass
class _Layout:
    """All numpy metadata needed to run the explicit co-partitioned step."""
    m: int
    group_shard: np.ndarray                       # (n_groups,)
    local_dirs: frozenset
    dir_row: dict                                 # name -> dict(gather, mask, local, cap)
    lat: dict                                     # name -> dict(...)
    arrays: dict                                  # stacked (m, cap) arrays
    shadow: VMPProgram                            # program with local shapes


def build_layout(program: VMPProgram, m: int) -> _Layout:
    """The co-partitioned layout of ``program`` over ``m`` shards: the
    reference's, array for array, except that a flat child (no ``zmap``:
    its token ``i`` is latent instance ``i``) carries no ``zmap`` — the
    reference's is the identity on every shard — so that it takes the flat
    kernel route as on one device."""
    n_groups = program.meta.get("pstar_size")
    if n_groups is None:
        raise ValueError(
            f"model {program.name} has no '?' partition plate; use "
            f"strategy='replicated'")

    # token mass per group drives the packing
    weights = np.zeros(n_groups, dtype=np.int64)
    for spec in program.latents:
        if spec.group is None:
            raise ValueError(f"latent {spec.name} is not under the partition "
                             f"plate; use strategy='replicated'")
        for f in spec.children:
            tok_group = spec.group[f.zmap] if f.zmap is not None else spec.group
            weights += np.bincount(tok_group, minlength=n_groups)
    for s in program.statics:
        if s.group is not None:
            weights += np.bincount(s.group, minlength=n_groups)
    group_shard = lpt_pack(np.maximum(weights, 1), m)

    dc = dataclasses
    dir_row: dict[str, dict] = {}
    local_dirs = set()
    shadow_dirs = {}
    for name, d in program.dirichlets.items():
        if d.group_rows is not None:
            local_dirs.add(name)
            rs = group_shard[d.group_rows]
            gather, mask, local = _pack_indices(rs, m)
            dir_row[name] = {"gather": gather, "mask": mask, "local": local,
                             "cap": gather.shape[1]}
            shadow_dirs[name] = dc.replace(d, g=gather.shape[1])
        else:
            shadow_dirs[name] = d

    arrays: dict[str, dict] = {}
    lat: dict[str, dict] = {}
    shadow_lats = []
    for spec in program.latents:
        z_shard = group_shard[spec.group]
        z_gather, z_mask, z_local = _pack_indices(z_shard, m)
        cap_z = z_gather.shape[1]
        if spec.prior_dir in local_dirs:
            pr_local = dir_row[spec.prior_dir]["local"][spec.prior_rows]
        else:
            pr_local = spec.prior_rows
        arrays[spec.name] = {
            "prior_rows": pr_local[z_gather],         # (m, cap_z)
            "mask": z_mask,
        }
        lat[spec.name] = {"gather": z_gather, "mask": z_mask,
                          "local": z_local, "cap": cap_z}
        shadow_children = []
        for f in spec.children:
            if f.zmap is None:
                t_gather, t_mask, zmap = z_gather, z_mask, None
            else:
                t_gather, t_mask, _ = _pack_indices(z_shard[f.zmap], m)
                zmap = z_local[f.zmap][t_gather]
            base = f.base
            if base is not None and f.dir_name in local_dirs:
                base = dir_row[f.dir_name]["local"][base]
            arrays[f.x_name] = {
                "values": f.values[t_gather],
                "zmap": zmap,
                "base": None if base is None else base[t_gather],
                "mask": t_mask,
            }
            shadow_children.append(dc.replace(f, n_z=cap_z))
        shadow_lats.append(dc.replace(spec, n=cap_z, children=shadow_children))

    shadow_statics = []
    for s in program.statics:
        if s.group is None:
            raise ValueError(f"static factor {s.x_name} not partitionable")
        x_shard = group_shard[s.group]
        gather, mask, _ = _pack_indices(x_shard, m)
        rows = s.rows
        if s.dir_name in local_dirs:
            rows = dir_row[s.dir_name]["local"][rows]
        arrays[s.x_name] = {"rows": rows[gather], "values": s.values[gather],
                            "mask": mask}
        shadow_statics.append(s)

    # fresh meta: the full-batch owner plans cached on the program
    # (``vmp.program_plans``) hold its own streams and must not reach the
    # per-shard shadow, whose shards share one set of shapes
    meta = {k: v for k, v in program.meta.items() if k != "_zstats_plan"}
    shadow = dc.replace(program, dirichlets=shadow_dirs, latents=shadow_lats,
                        statics=shadow_statics, meta=meta)
    return _Layout(m, group_shard, frozenset(local_dirs), dir_row, lat,
                   arrays, shadow)


# ---------------------------------------------------------------------------
# the distributed step
# ---------------------------------------------------------------------------

def _shard_arrays(arrays: dict, s: int, device) -> dict:
    """Shard ``s``'s block of stacked ``(m, cap)`` arrays as tensors on
    ``device``: indices int32, masks f32."""
    def dev(a):
        if a is None:
            return None
        a = np.ascontiguousarray(a[s])
        return torch.from_numpy(a.astype(np.float32 if a.dtype == np.float32
                                         else np.int32)).to(device)
    return {name: {k: dev(v) for k, v in sub.items()}
            for name, sub in arrays.items()}


def scatter_state(program: VMPProgram, layout: _Layout,
                  state: VMPState) -> VMPState:
    """A one-device state in the layout: each local Dirichlet's rows
    stacked per shard ``(m, cap, k)``, its padding rows at the prior; the
    global Dirichlets as they are."""
    posts = {}
    for name, d in program.dirichlets.items():
        p = state.posteriors[name]
        if name in layout.local_dirs:
            info = layout.dir_row[name]
            idx = torch.from_numpy(info["gather"]).to(p.device)
            mask = torch.from_numpy(info["mask"]).to(p.device)[..., None] > 0
            prior = torch.from_numpy(np.asarray(d.prior, np.float32)) \
                .to(p.device)
            posts[name] = torch.where(mask, p[idx], prior)
        else:
            posts[name] = p
    return VMPState(posts, state.step)


def make_distributed_step(program: VMPProgram, plan: ShardingPlan,
                          seed: int = 0, elog_dtype=None, device=None,
                          state: Optional[VMPState] = None):
    """Returns ``(step_fn, initial_state)`` for the chosen strategy on
    ``device`` (``None`` means ``"cuda"``).  The initial state is ``state``
    (a one-device state, e.g. the reference's ``init_state`` through
    ``vmp.state_from_numpy``) or ``init_state(program, seed)``, laid out
    for the plan.  Each shard's step body runs the fused ``kops.zstats``
    substep on its block; the sum of the global stats in the plan's group
    is the only place shards meet.  ``step_fn.plan_ms`` holds the host ms
    of each shard's owner plans.  Over a group across processes (gloo, or
    a ``launch.dist.DryGroup``'s rank 0 on ``meta`` tensors) each rank runs
    its own shards (``group.local_shards``), builds their owner plans only
    and holds only their rows of the local Dirichlets, in that order; the
    ranks meet in the group's sums, so every rank's rows are bitwise those
    of one process running every shard."""
    from .runtime import _resolve_elog_dtype, make_step
    device = resolve_device(device)
    elog_dtype = _resolve_elog_dtype(elog_dtype)
    g0 = state if state is not None else init_state(program, seed,
                                                    device=device)
    g0 = VMPState({n: p.to(device) for n, p in g0.posteriors.items()},
                  g0.step)
    if plan.strategy == "replicated":
        return make_step(program, elog_dtype=elog_dtype, device=device), g0
    group = plan.group
    local = group.local_shards
    if plan.strategy == "gspmd":
        layout, local_dirs, state0 = None, frozenset(), g0
        shadow, arrays = _flat_blocks(program, plan.n_shards)
    else:
        layout = build_layout(program, plan.n_shards)
        local_dirs, shadow, arrays = (layout.local_dirs, layout.shadow,
                                      layout.arrays)
        state0 = scatter_state(program, layout, g0)
        if len(local) < plan.n_shards:
            state0 = VMPState({n: p[local] if n in local_dirs else p
                               for n, p in state0.posteriors.items()},
                              state0.step)

    shards, plan_ms = {}, {}
    for s in local:
        host = _shard_arrays(arrays, s, "cpu")
        t0 = time.perf_counter()
        plans = owner_plans(shadow, host, device)
        plan_ms[s] = (time.perf_counter() - t0) * 1e3
        shards[s] = ({n: {k: None if v is None else v.to(device)
                          for k, v in sub.items()}
                      for n, sub in host.items()},
                     {n: p.to(device) for n, p in plans.items()})

    def step(state: VMPState):
        by_shard = {s: (a, VMPState(
            {n: p[i] if n in local_dirs else p
             for n, p in state.posteriors.items()}, state.step), pl)
            for i, (s, (a, pl)) in enumerate(shards.items())}
        new, elbo = _sharded_step_body(shadow, by_shard, group, elog_dtype,
                                       local_dirs=local_dirs)
        posts = {n: (torch.stack([new[s].posteriors[n] for s in local])
                     if n in local_dirs else new[local[0]].posteriors[n])
                 for n in program.dirichlets}
        return VMPState(posts, state.step + 1), elbo

    step.layout = layout          # for gather_posterior
    step.plan = plan
    step.plan_ms = plan_ms
    return step, state0


def _flat_blocks(program: VMPProgram, m: int):
    """The flat baseline's layout: every latent's instances and its
    children's tokens (one per instance: a flat child), and every static,
    padded to a multiple of ``m`` and cut into ``m`` contiguous blocks with
    masks (the padded tail contributes nothing); every Dirichlet keeps its
    full table.  Returns the per-block shadow and the stacked arrays."""
    dc = dataclasses

    def blocks(a, n):
        pad = (-n) % m
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
        return a.reshape((m, -1) + a.shape[1:])

    def mask(n):
        return blocks(np.ones(n, np.float32), n)

    arrays, lats = {}, []
    for spec in program.latents:
        if any(f.zmap is not None for f in spec.children):
            raise ValueError(
                f"the flat baseline cuts the token plate into blocks; "
                f"{spec.name}'s segment children reach across them — use "
                f"strategy='inferspark'")
        n = spec.n
        arrays[spec.name] = {"prior_rows": blocks(spec.prior_rows, n),
                             "mask": mask(n)}
        for f in spec.children:
            arrays[f.x_name] = {
                "values": blocks(f.values, n), "zmap": None,
                "base": None if f.base is None else blocks(f.base, n),
                "mask": mask(n)}
        cap = -(-n // m)
        lats.append(dc.replace(spec, n=cap, children=[
            dc.replace(f, n_z=cap) for f in spec.children]))
    for s in program.statics:
        n = len(s.values)
        arrays[s.x_name] = {"rows": blocks(s.rows, n),
                            "values": blocks(s.values, n), "mask": mask(n)}
    meta = {k: v for k, v in program.meta.items() if k != "_zstats_plan"}
    return dc.replace(program, latents=lats, meta=meta), arrays


def gather_posterior(step, program: VMPProgram, state: VMPState, name: str):
    """Reassemble a Dirichlet posterior from a distributed state, as a
    numpy array.  A local Dirichlet needs every shard's rows: the state of
    a process that runs every shard."""
    layout: Optional[_Layout] = getattr(step, "layout", None)
    post = state.posteriors[name].detach().cpu().numpy()
    if layout is None or name not in layout.local_dirs:
        return post
    info = layout.dir_row[name]
    if len(post) != len(info["gather"]):
        raise ValueError(f"{name}: the state holds {len(post)} of "
                         f"{len(info['gather'])} shards' rows (this rank's); "
                         f"reassembling needs them all")
    g = program.dirichlets[name].g
    out = np.zeros((g, post.shape[-1]), post.dtype)
    flat_idx = info["gather"].reshape(-1)
    flat_mask = info["mask"].reshape(-1) > 0
    out[flat_idx[flat_mask]] = post.reshape(-1, post.shape[-1])[flat_mask]
    return out


# ---------------------------------------------------------------------------
# paper Tables 1-2: analytic strategy costs
# ---------------------------------------------------------------------------

def strategy_costs(n: int, d: int, k: int, m: int) -> dict[str, dict]:
    """Expected replications of a data vertex E[N_xi] and expected size of
    the largest edge partition E[N_B], for each partitioning strategy
    (paper section 4.4).  n=tokens, d=documents, k=shared posteriors,
    m=partitions."""
    eta = n / m
    out = {
        "1D":   {"E_Nxi": min(k + 1, m), "E_NB": float(n)},
        "2D":   {"E_Nxi": min(k + 1, math.sqrt(m)),
                 "E_NB": min(k + 1, math.sqrt(m)) * eta},
        "RVC":  {"E_Nxi": m * (1 - (1 - 1 / m) ** (k + 1)),
                 "E_NB": min(float(k) * eta + eta, float(n))},
        "CRVC": {"E_Nxi": m * (1 - (1 - 1 / m) ** (k + 1)),
                 "E_NB": min(float(k) * eta + eta, float(n))},
        "InferSpark": {"E_Nxi": 1.0, "E_NB": 3 * eta + k},
    }
    return out


def collective_bytes_per_iteration(program: VMPProgram, plan: ShardingPlan,
                                   bytes_per_el: int = 4) -> dict[str, int]:
    """Analytic per-iteration communication volume of the explicit layout:
    one all-reduce of every GLOBAL Dirichlet's (G, K) stats.  Local
    Dirichlets move zero bytes — the paper's zero-replication claim."""
    out = {}
    for name, dspec in program.dirichlets.items():
        if dspec.group_rows is None:
            # ring all-reduce moves ~2x the payload per participant
            out[name] = 2 * dspec.g * dspec.k * bytes_per_el
        else:
            out[name] = 0
    return out
