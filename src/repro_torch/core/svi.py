"""Streaming minibatch VMP: stochastic variational inference (SVI).

The port of ``repro.core.svi`` for one device and a resident corpus.  The
full-batch engine touches all N tokens every step, so corpus size is capped
by one step's working set.  SVI (Hoffman et al., *Stochastic Variational
Inference*, JMLR 2013) samples a minibatch B of partition-plate groups
(documents), coordinate-ascends the batch's LOCAL posteriors (theta rows),
and takes a natural-gradient step on every GLOBAL Dirichlet

    post <- (1 - rho_t) * post + rho_t * (prior + (G / |B|) * stats_B)

with the Robbins-Monro step size ``rho_t = (tau + t) ** -kappa``.  A
Dirichlet's natural parameter is its concentration vector, so the update is
plain SGD in natural-parameter space.

Degenerate case, held bitwise: with |B| = G (every group, exact caps) and
rho = 1 one SVI step IS one full-batch VMP step.

Each batch is sliced on the host (``compiler.slice_arrays``), and on CUDA
its kernels' owner plans are built there too, from the batch's own token
streams (``vmp.owner_plans``): the plan holds copies of those streams, and
batches padded to the same caps share every shape, so a plan kept across
batches would feed one batch's kernel another batch's tokens.

The corpus need not be resident: with ``SVI(corpus=...)`` a
:class:`repro_torch.data.ShardedCorpus` supplies each minibatch from its
memory-mapped disk shards (``data.store.slice_sharded``, the batch's owner
plans built after it), on a prefetch thread that builds batch t+1 while
batch t runs; the copy to the card stays on the caller's thread.  The
arrays, and so the plans and the kernels' routes, are bitwise those of the
resident path.  ``growing=True`` follows a corpus that a live writer keeps
appending to.  ``fit(checkpoint_dir=, resume_from=)`` commits resumable
sessions (``checkpoint/session.py``) and resumes bitwise.

Under a :class:`~repro_torch.core.partition.ShardingPlan` (``plan=``)
each shard receives its own sub-minibatch (the batch LPT-packed over the
shards by token mass, every shard padded to shared caps, with its own owner
plans), the global stats meet in the plan's shard group, and the local
rows merge as the reference's deltas.  With ``hosts=`` a
:class:`~repro_torch.data.HostAssignment` over a sharded corpus, each
document goes to the shards of the host that owns it: in one process the
hosts are virtual, and in a ``torch.distributed`` run (gloo) each process
is one host that reads only its own shards; a 2-process run is bitwise the
1-process run with 2 virtual hosts.

``build_local_scorer(extras=True)`` is the query layer's fold-in scorer
(``repro_torch.query.foldin``).  ``SVI(validate=True)`` runs the static
pre-flight (``repro_torch.analysis``) first.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from .. import trace
from ..data.pipeline import MinibatchSampler, holdout_split
from . import dists
from .compiler import (VMPProgram, check_resident, local_dirichlets,
                       slice_arrays, sliced_shadow)
from .runtime import _resolve_elog_dtype
from ..kernels import ops as kops
from .vmp import (VMPState, _elog_tables, _messages_to_latent,
                  _sharded_step_body, _step_body, init_state, owner_plans,
                  resolve_device, state_from_numpy, state_to_numpy)


@dataclasses.dataclass
class SVIConfig:
    """Knobs of the streaming engine (defaults follow Hoffman et al.)."""
    batch_size: int = 64           # documents (partition groups) per step
    kappa: float = 0.7             # Robbins-Monro forgetting rate, (0.5, 1]
    tau: float = 10.0              # Robbins-Monro delay (down-weights early steps)
    local_iters: int = 1           # local coordinate-ascent passes per batch
    pad_multiple: int = 256        # pad sliced axes up to a multiple (0 = exact)
    elog_dtype: object = None      # narrow the token plate's concentration
                                   # tables (e.g. "bfloat16")
    holdout_frac: float = 0.0      # fraction of groups held out for ELBO eval
    holdout_every: int = 10        # evaluate held-out ELBO every k steps
    holdout_local_iters: int = 10  # local passes when evaluating held-out docs
    shuffle: bool = True           # reshuffle group order every epoch
    rho: Optional[float] = None    # constant step size override (rho=1 +
                                   # batch_size=G == exact full-batch VMP)
    prefetch: bool = True          # sharded-corpus mode: build batch t+1
                                   # (shard I/O, owner plans) during step t
    growing: bool = False          # sharded-corpus mode: re-snapshot the doc
                                   # population every epoch (streaming
                                   # corpora; needs capacity_docs headroom)
    capacity_docs: int = 0         # growing mode: pre-allocated local-row
                                   # ceiling the corpus may grow into; 0 =
                                   # let the caller's template decide
    population_size: int = 0       # growing mode: fixed assumed population
                                   # for the stochastic scale G/|B|
    seed: int = 0

    def __post_init__(self):
        if self.rho is None and not (0.5 < self.kappa <= 1.0):
            raise ValueError(f"kappa must be in (0.5, 1], got {self.kappa}")
        if self.rho is not None and not (0.0 < self.rho <= 1.0):
            raise ValueError(f"constant rho must be in (0, 1] — rho > 1 "
                             f"overshoots the natural-gradient step and "
                             f"diverges silently — got {self.rho}")
        if self.tau < 0:
            raise ValueError("tau must be >= 0")
        if self.capacity_docs < 0 or self.population_size < 0:
            raise ValueError("capacity_docs / population_size must be >= 0")
        if (self.capacity_docs or self.population_size) and not self.growing:
            raise ValueError("capacity_docs / population_size only apply to "
                             "growing=True (streaming) mode")


def robbins_monro(t: int, tau: float = 10.0, kappa: float = 0.7) -> float:
    """Step size rho_t = min((tau + t) ** -kappa, 1.0); sum rho = inf,
    sum rho^2 < inf — the conditions for SVI convergence.  The clamp keeps
    ``rho_t <= 1`` for ``tau < 1`` (and ``tau = 0`` finite at t = 0)."""
    base = tau + t
    if base <= 0:
        return 1.0
    return float(min(base ** (-kappa), 1.0))


# ---------------------------------------------------------------------------
# the minibatch step
# ---------------------------------------------------------------------------

def _priors(program: VMPProgram, device) -> dict[str, torch.Tensor]:
    return {n: torch.from_numpy(np.asarray(d.prior, np.float32))
            .to(device)[None, :] for n, d in program.dirichlets.items()}


def _scalar(x, device) -> torch.Tensor:
    """A step scalar as the reference traces it: a 0-d f32 on ``device``."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def sliced_state(program: VMPProgram, state: VMPState, batch: dict,
                 priors: Optional[dict] = None) -> VMPState:
    """The state a batch's step starts from: each local Dirichlet's rows of
    the batch gathered from ``state`` (``batch["dirs"]``, on the state's
    device), its padding rows (the sentinel row g) exactly at the prior so
    that their ELBO terms and stats are zero; the global Dirichlets as they
    are.  ``priors`` — :func:`_priors` on the state's device, or None to
    make them here."""
    if priors is None:
        priors = _priors(program, state.device)
    local = local_dirichlets(program)
    sliced = {}
    for name, d in program.dirichlets.items():
        if name in local:
            rows = batch["dirs"][name]["rows"].long()
            mask = batch["dirs"][name]["mask"]
            got = state.posteriors[name][rows.clamp(0, d.g - 1)]
            sliced[name] = torch.where(mask[:, None] > 0, got, priors[name])
        else:
            sliced[name] = state.posteriors[name]
    return VMPState(sliced, state.step)


def make_svi_step(program: VMPProgram, caps: dict[str, int], plan=None,
                  local_iters: int = 1, elog_dtype=None):
    """Build ``step(state, batch, rho, scale) -> (state', batch_elbo)`` for
    batches padded to ``caps``.

    ``batch`` is the output of :func:`device_batch`; ``rho`` the step size;
    ``scale`` the stochastic-stats multiplier G/|B| (floats or 0-d tensors,
    taken as f32 on the state's device).  The batch's owner plans
    (``batch["plans"]``, empty off CUDA) go to every ``_step_body`` of the
    step; the program's cached plans are never read.

    With ``plan`` (a :class:`~repro_torch.core.partition.ShardingPlan`) the
    batch is ``{"shards": {shard: batch}}``, this process's shards: each
    runs its body on its own sub-batch, the global stats meet in the plan's
    group, and each shard's local rows merge as the reference's psum of
    deltas, ``state + delta`` (shards own disjoint rows).
    """
    local = local_dirichlets(program)
    shadow = sliced_shadow(program, caps)
    elog_dtype = _resolve_elog_dtype(elog_dtype)
    priors_on: dict = {}

    def refined(st, arrays, plans):
        """``st`` after ``local_iters - 1`` local passes: the local rows
        move, the global Dirichlets stay."""
        sliced = st.posteriors
        for _ in range(max(local_iters - 1, 0)):     # local refinement only
            ref, _ = _step_body(shadow, arrays, st, elog_dtype=elog_dtype,
                                plans=plans)
            st = VMPState({n: (ref.posteriors[n] if n in local else sliced[n])
                           for n in sliced}, st.step)
        return st

    def natural_gradient(state, new, priors, rho, scale):
        # natural gradient: target = prior + scale * stats_B; the
        # where()s keep the |B|=G, rho=1 case bitwise equal to the
        # full-batch VMP update (no x-p+p float round-trip)
        posts = {}
        for name in program.dirichlets:
            if name in local:
                continue
            target = priors[name] + scale * (new[name] - priors[name])
            target = torch.where(scale == 1.0, new[name], target)
            blend = (1.0 - rho) * state.posteriors[name] + rho * target
            posts[name] = torch.where(rho == 1.0, target, blend)
        return posts

    def step(state: VMPState, batch: dict, rho, scale):
        device = state.device
        if device not in priors_on:
            priors_on[device] = _priors(program, device)
        priors = priors_on[device]
        rho, scale = _scalar(rho, device), _scalar(scale, device)
        plans = batch["plans"]
        st = refined(sliced_state(program, state, batch, priors),
                     batch["arrays"], plans)
        new, elbo = _step_body(shadow, batch["arrays"], st,
                               elog_dtype=elog_dtype, plans=plans)
        posts = natural_gradient(state, new.posteriors, priors, rho, scale)
        for name, d in program.dirichlets.items():
            if name in local:
                # the batch's rows are unique; its padding rows all land in
                # a scratch row g, which is cut off
                rows = batch["dirs"][name]["rows"].long()
                out = torch.empty((d.g + 1, d.k), dtype=torch.float32,
                                  device=device)
                out[:d.g] = state.posteriors[name]
                out.index_copy_(0, rows, new.posteriors[name])
                posts[name] = out[:d.g]
        return VMPState({n: posts[n] for n in program.dirichlets},
                        state.step + 1), elbo

    def sharded_step(state: VMPState, batch: dict, rho, scale):
        device = state.device
        if device not in priors_on:
            priors_on[device] = _priors(program, device)
        priors = priors_on[device]
        rho, scale = _scalar(rho, device), _scalar(scale, device)
        group = plan.group
        sliced = {s: sliced_state(program, state, b, priors)
                  for s, b in batch["shards"].items()}
        shards = {s: (b["arrays"],
                      refined(sliced[s], b["arrays"], b["plans"]),
                      b["plans"])
                  for s, b in batch["shards"].items()}
        new, elbo = _sharded_step_body(shadow, shards, group, elog_dtype,
                                       local_dirs=local)
        any_new = new[group.local_shards[0]].posteriors
        posts = natural_gradient(state, any_new, priors, rho, scale)
        names = [n for n in program.dirichlets if n in local]
        # each shard's rows and deltas, every shard's in shard order
        got = group.gather({s: [t for n in names for t in (
            batch["shards"][s]["dirs"][n]["rows"].long(),
            new[s].posteriors[n] - sliced[s].posteriors[n])]
            for s in batch["shards"]}, [n for n in names for _ in range(2)])
        for i, name in enumerate(names):
            d = program.dirichlets[name]
            base = torch.empty((d.g + 1, d.k), dtype=torch.float32,
                               device=device)
            base[:d.g] = state.posteriors[name]
            out = base.clone()
            for shard in got:
                rows, delta = shard[2 * i], shard[2 * i + 1]
                # padding rows (the sentinel g) carry a zero delta into the
                # scratch row g, which is cut off
                out.index_copy_(0, rows, base[rows] + delta)
            posts[name] = out[:d.g]
        return VMPState({n: posts[n] for n in program.dirichlets},
                        state.step + 1), elbo

    return step if plan is None else sharded_step


# ---------------------------------------------------------------------------
# one batch, from the host to the device
# ---------------------------------------------------------------------------

def host_batch(program: VMPProgram, groups, caps_fn=None, plan=None, *,
               device=None, slicer=None,
               group_weights: Optional[np.ndarray] = None, caps_probe=None):
    """Build one minibatch's host-side (numpy) arrays for ``device``
    (``None`` means ``"cuda"``; no card is needed, as nothing is placed).

    Returns ``(batch, caps, n_tokens)`` where ``batch = {"arrays", "dirs",
    "plans"}``: numpy leaves and the batch's kernel owner plans, built from
    its own streams (``vmp.owner_plans``, empty unless ``device`` is CUDA).
    Pure host work, no CUDA call, so it can run on a prefetch thread:
    :func:`device_put_batch` places the result on a device.  The slicing
    and the plans are the spans ``svi.slice`` and ``svi.plan``
    (``repro_torch.trace``), on the thread that builds the batch.
    ``slicer(groups, caps_fn) -> (arrays, dirs, caps, n_tokens)`` selects
    the corpus view: by default ``compiler.slice_arrays`` over the resident
    ``program``; the out-of-core path binds ``data.store.slice_sharded``
    (the same contract, reading only the shards the batch touches).

    With ``plan`` the batch's groups are LPT-packed into ``plan.n_shards``
    sub-minibatches by token mass (``group_weights``), each padded to
    shared caps, and ``batch`` is ``{"shards": {shard: batch}}`` for the
    shards of this process (``plan.group.local_shards``; ``n_tokens``
    counts theirs), each with its own owner plans.  ``caps_probe(groups)
    -> caps`` — a cheap predictor of the caps ``slicer(groups, None)``
    would realize (``data.store.sharded_caps``); without it every
    sub-minibatch is sliced twice.
    """
    if slicer is None:
        slicer = functools.partial(slice_arrays, program)
    device = torch.device("cuda" if device is None else device)
    if plan is not None:
        from .partition import lpt_pack
        groups = np.asarray(groups, np.int64)
        m = plan.n_shards
        w = (group_weights[groups] if group_weights is not None
             else np.ones(len(groups), np.int64))
        shard_of = lpt_pack(np.maximum(w, 1), m)
        parts = [groups[shard_of == s] for s in range(m)]
        caps = shared_caps(parts, caps_probe or (
            lambda p: slicer(p, None)[2]), caps_fn)
        batch, n_tok = shard_batches(program, parts, plan.group.local_shards,
                                     caps, slicer, device)
        return batch, caps, n_tok
    with trace.span("svi.slice"):
        arrays, dirs, caps, n_tok = slicer(groups, caps_fn)
    with trace.span("svi.plan"):
        plans = owner_plans(program, arrays, device, caps)
    return {"arrays": arrays, "dirs": dirs, "plans": plans}, caps, n_tok


def shared_caps(parts, probe, caps_fn=None) -> dict[str, int]:
    """The caps every shard's sub-minibatch is padded to: each axis's
    largest exact cap over ``parts`` (``probe(groups) -> caps``), then
    ``caps_fn``'s padding policy."""
    caps: dict[str, int] = {}
    for p in parts:
        for k, v in probe(p).items():
            caps[k] = max(caps.get(k, 1), int(v))
    if caps_fn is not None:
        caps = {k: max(int(caps_fn(k, v)), v) for k, v in caps.items()}
    return caps


def spread_padding(program: VMPProgram, arrays: dict, dirs: dict) -> None:
    """Point a padded slice's masked instances and tokens at distinct rows,
    in place.  The slicer pads with 0, so every padding instance reads row
    0 of its prior and every padding token value 0, and the owner plan
    gives one owner all of them: under shared caps a small part's padding
    (a third of the part, say) would walk in series.  Here padding
    instances go round-robin over their prior's padding rows (the sentinel
    rows; every row when there are none) and the padding tokens of a flat
    child over its table's values.  Masked, they add exact zeros wherever
    they land, so only the plan's balance changes; a segment child's
    padding is left as sliced."""
    for spec in program.latents:
        a = arrays[spec.name]
        pad = np.flatnonzero(a["mask"] == 0)
        if len(pad):
            rows = a["prior_rows"]
            d = dirs.get(spec.prior_dir)
            free = (np.flatnonzero(d["mask"] == 0) if d is not None
                    else np.arange(0))
            if not len(free):
                free = np.arange(len(d["mask"]) if d is not None
                                 else program.dirichlets[spec.prior_dir].g)
            rows[pad] = free[np.arange(len(pad)) % len(free)]
        for f in spec.children:
            if f.zmap is not None:
                continue
            x = arrays[f.x_name]
            pad = np.flatnonzero(x["mask"] == 0)
            x["values"][pad] = (np.arange(len(pad))
                                % program.dirichlets[f.dir_name].k)


def shard_batches(program: VMPProgram, parts, shards, caps: dict, slicer,
                  device):
    """``({"shards": {shard: batch}}, n_tokens)``: each of ``shards``'
    groups (``parts[shard]``) sliced at ``caps``, its padding spread
    (:func:`spread_padding`), with the owner plans of its own streams —
    the shards share every shape, so no shard may read another's plan.
    Each shard's slicing and plans are the spans ``svi.slice`` and
    ``svi.plan``."""
    out, n_tok = {}, 0
    for s in shards:
        with trace.span("svi.slice"):
            arrays, dirs, _, nt = slicer(parts[s], lambda name, n: caps[name])
            spread_padding(program, arrays, dirs)
        with trace.span("svi.plan"):
            plans = owner_plans(program, arrays, device, caps)
        out[s] = {"arrays": arrays, "dirs": dirs, "plans": plans}
        n_tok += nt
    return {"shards": out}, n_tok


def _put(a, device):
    return None if a is None else torch.from_numpy(a).to(device)


def device_put_batch(batch: dict, device) -> dict:
    """A :func:`host_batch` result on ``device``: every numpy leaf as a
    tensor (``None`` passes through), every owner plan with its device
    copy; a sharded batch shard by shard."""
    if "shards" in batch:
        return {"shards": {s: device_put_batch(b, device)
                           for s, b in batch["shards"].items()}}
    out = {part: {k: {kk: _put(vv, device) for kk, vv in v.items()}
                  for k, v in batch[part].items()}
           for part in ("arrays", "dirs")}
    out["plans"] = {n: p.to(device) for n, p in batch["plans"].items()}
    return out


def device_batch(program: VMPProgram, groups, caps_fn=None, device=None):
    """Slice one minibatch and place it on ``device`` (``None`` means
    ``"cuda"``), with its owner plans:
    :func:`host_batch` + :func:`device_put_batch`.  Returns ``(batch, caps,
    n_tokens)``."""
    device = resolve_device(device)
    batch, caps, n_tok = host_batch(program, groups, caps_fn, device=device)
    return device_put_batch(batch, device), caps, n_tok


# ---------------------------------------------------------------------------
# held-out ELBO
# ---------------------------------------------------------------------------

def segment_index(seg, n_seg: int) -> tuple[np.ndarray, np.ndarray]:
    """The host-side plan of a deterministic segment sum over one axis:
    ``(order, lengths)`` — the axis positions whose group id lies in
    ``[0, n_seg)``, stably sorted by it (ids outside, the padding sentinel
    ``n_seg`` among them, are dropped), and each group's count.  On the
    device :func:`segment_sum` then reduces every group in a fixed order,
    where a scatter-add of floats on CUDA would not."""
    seg = np.asarray(seg, np.int64)
    keep = np.flatnonzero((seg >= 0) & (seg < n_seg))
    order = keep[np.argsort(seg[keep], kind="stable")]
    return order, np.bincount(seg[order], minlength=n_seg)


def segment_sum(values: torch.Tensor, plan) -> torch.Tensor:
    """Per-group sums of ``values`` along its first axis by a
    :func:`segment_index` plan (on ``values``' device): ``(n_seg, ...)``."""
    order, lengths = plan
    return torch.segment_reduce(values[order], "sum", lengths=lengths,
                                axis=0)


def build_local_scorer(program: VMPProgram, caps: dict[str, int],
                       inner_iters: int, *, extras: bool = False,
                       n_seg: int = 0):
    """The frozen-globals local-inference evaluator ``fn(posteriors,
    arrays, plans) -> elbo`` (a 0-d f32 tensor): fresh local
    posteriors start at the prior, take ``inner_iters`` coordinate-ascent
    passes with the global Dirichlets frozen at the caller's values, and
    the global Dirichlets' KL terms (training-objective bookkeeping, not
    predictive quality) are excluded from the score.  ``posteriors`` need
    only hold the global Dirichlets; ``plans`` are the arrays' owner plans
    (:func:`host_batch`), as in ``_step_body``.

    ``extras=True`` (the fold-in path) returns ``fn(posteriors, arrays,
    plans, seg) -> (elbo, locals, group_elbo)`` where ``elbo`` is the same
    scalar (identical ops, so it stays bitwise with the extras=False build
    at matching caps/iters), ``locals`` maps each local Dirichlet to its
    fitted ``(caps[name], k)`` posterior concentrations (MAP mixtures after
    normalization), and ``group_elbo`` is the ``(n_seg,)``
    per-partition-group decomposition of the score: per-instance logsumexp
    terms plus each group's local-Dirichlet ELBO terms, summed per group
    by ``seg`` (per latent / static / local Dirichlet, the
    :func:`segment_index` plan of its group ids, on the arrays' device).
    ``group_elbo.sum()`` equals ``elbo`` up to float reassociation.  The
    per-group pass reads the latent's owner plan from ``plans``, never
    from a cache: the scorer serves every request of its caps, and each
    request brings its own plans.
    """
    local = local_dirichlets(program)
    shadow = sliced_shadow(program, caps)

    def _fit_locals(posteriors, arrays, plans):
        device = next(iter(posteriors.values())).device
        priors = _priors(program, device)
        posts = {name: (priors[name].expand(caps[name], d.k).contiguous()
                        if name in local else posteriors[name])
                 for name, d in program.dirichlets.items()}
        st = VMPState(posts, 0)
        for _ in range(inner_iters):
            new, _ = _step_body(shadow, arrays, st, plans=plans,
                                local_dirs=local, global_terms=False)
            st = VMPState({n: (new.posteriors[n] if n in local
                               else posts[n]) for n in posts}, st.step)
        # the global Dirichlets' terms are left out, not added and then
        # subtracted: two f32 sums of a (K, V) term cancel only to a few
        # nats, which a short request's score cannot carry
        _, elbo = _step_body(shadow, arrays, st, plans=plans,
                             local_dirs=local, global_terms=False)
        return st, elbo, priors

    if not extras:
        def fn(posteriors, arrays, plans):
            return _fit_locals(posteriors, arrays, plans)[1]

        return fn

    def fn_extras(posteriors, arrays, plans, seg):
        st, elbo, priors = _fit_locals(posteriors, arrays, plans)
        # per-group decomposition: an explicit (materializing) pass at the
        # fitted locals — the fused elbo above stays the bitwise artifact
        elog = _elog_tables(shadow, st)
        grp = torch.zeros((n_seg,), dtype=torch.float32, device=elbo.device)
        for spec in shadow.latents:
            logits = _messages_to_latent(shadow, spec, elog, arrays,
                                         plans.get(spec.name))
            _, lse = kops.zstep(logits)
            m = arrays[spec.name].get("mask")
            if m is not None:
                lse = lse * m
            grp = grp + segment_sum(lse, seg[spec.name])
        for s in shadow.statics:
            a = arrays[s.x_name]
            e = elog[s.dir_name][a["rows"].long(), a["values"].long()]
            if a.get("mask") is not None:
                e = e * a["mask"]
            grp = grp + segment_sum(e, seg[s.x_name])
        for name in sorted(local):
            post = st.posteriors[name]
            prior = torch.broadcast_to(priors[name], post.shape)
            term = dists.dirichlet_log_norm(post) \
                - dists.dirichlet_log_norm(prior) \
                + ((prior - post) * elog[name]).sum(dim=-1)
            grp = grp + segment_sum(term, seg[name])
        return elbo, {n: st.posteriors[n] for n in local}, grp

    return fn_extras


def build_sharded_scorer(program: VMPProgram, caps: dict[str, int],
                         inner_iters: int, plan):
    """Distributed counterpart of :func:`build_local_scorer`
    (extras=False): ``fn(posteriors, shards) -> elbo`` with ``shards =
    {shard: (arrays, plans)}`` of this process.  Each shard fits fresh
    local posteriors on its *own* held-out sub-slice with the global
    Dirichlets frozen, and the shards' scores are summed in the plan's
    group, in shard order, so every rank reads the same scalar.

    The sum is the score of the union: a shard's score holds no global
    Dirichlet's term — only per-instance logsumexp terms (masked) and its
    local Dirichlets' terms, whose padding rows sit exactly at the prior
    and contribute 0."""
    fn = build_local_scorer(program, caps, inner_iters)

    def sharded(posteriors, shards):
        return plan.group.sum({s: [fn(posteriors, arrays, plans)]
                               for s, (arrays, plans) in shards.items()},
                              ["heldout"])[0]

    return sharded


def heldout_elbo(program: VMPProgram, state: VMPState, groups,
                 inner_iters: int = 10, cache: Optional[dict] = None,
                 slicer=None) -> float:
    """Per-token ELBO on held-out groups under the current global
    posteriors (:func:`build_local_scorer`): comparable across engines and
    batch sizes, the convergence metric of the streaming engine.  Returns a
    python float (nats/token); NaN when the groups hold no tokens.

    ``cache`` (a caller-owned dict, e.g. the :class:`SVI` instance's) keeps
    per (groups, inner_iters, device) the evaluator with the groups' slice
    and owner plans on the device: the held-out groups never change, so
    they are sliced and planned once.  ``slicer`` as in :func:`host_batch`
    (the out-of-core path reads the held-out documents from their
    shards)."""
    groups = np.asarray(groups, np.int64)
    device = state.device
    key = (groups.tobytes(), inner_iters, str(device))
    entry = cache.get(key) if cache is not None else None
    if entry is None:
        batch, caps, n_tok = host_batch(program, groups, device=device,
                                        slicer=slicer)
        entry = (None, None, None, 0)
        if n_tok:
            batch = device_put_batch(batch, device)
            entry = (build_local_scorer(program, caps, inner_iters),
                     batch["arrays"], batch["plans"], n_tok)
        if cache is not None:
            cache[key] = entry
    fn, arrays, plans, n_tok = entry
    if n_tok == 0:
        return float("nan")
    return float(fn(state.posteriors, arrays, plans)) / n_tok


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class SVI:
    """Streaming minibatch inference over a compiled :class:`VMPProgram`,
    on one device (``device=None`` means ``"cuda"``)::

        svi = SVI(program, SVIConfig(batch_size=128, holdout_frac=0.05))
        state, history = svi.fit(steps=500)

    ``history["elbo"]`` is the per-step batch ELBO (a stochastic estimate
    at batch scale); ``history["heldout"]`` is the per-token held-out ELBO
    trace ``[(step, value), ...]`` (the convergence signal).

    **Out-of-core mode**: pass ``corpus=`` a
    :class:`~repro_torch.data.store.ShardedCorpus` and, as the first
    argument, either an unobserved :class:`~repro_torch.core.dsl.Model` (it
    is compiled into a full-size template by
    :func:`repro_torch.data.store.sharded_template`) or such a template.
    Minibatches are read from the corpus's shards, each batch's slice and
    owner plans are built on a prefetch thread (``SVIConfig.prefetch``),
    and the resident corpus state is the lengths array and two batches'
    buffers.  The holdout split, the minibatch permutation and every
    batch's arrays equal resident mode's, so the fitted posteriors are
    **bitwise equal** (``tests/test_torch_store.py``)::

        corpus = ShardedCorpus.open("/data/corpus")
        svi = SVI(models.make("lda", ...), SVIConfig(batch_size=256),
                  corpus=corpus)
    """

    def __init__(self, program, config: SVIConfig = None, plan=None,
                 corpus=None, hosts=None, validate=False, device=None):
        self.cfg = config or SVIConfig()
        if validate:
            # opt-in pre-flight: structural diagnostics + rebuild-hazard
            # audit, before any template/device work
            from ..analysis.audit import audit_config
            from ..analysis.validate import PreflightError, preflight
            diags = list(preflight(program)) if not isinstance(
                program, VMPProgram) else []
            diags += audit_config(
                self.cfg, n_docs=corpus.n_docs if corpus is not None
                else None,
                n_hosts=hosts.n_hosts if hosts is not None else None)
            if any(d.severity == "error" for d in diags):
                raise PreflightError(diags)
        self.device = resolve_device(device)
        self.plan = plan
        self.corpus = corpus
        self.hosts = hosts
        self._multiproc = False
        self._slicer = None
        self._caps_probe = None
        if self.cfg.growing and corpus is None:
            raise ValueError("growing=True needs corpus= (a ShardedCorpus "
                             "being appended to by a live writer)")
        if hosts is not None:
            self._init_hosts()
        if corpus is not None:
            from ..data import store as _store
            if not isinstance(program, VMPProgram):
                cap = None
                if self.cfg.growing:
                    cap = self.cfg.capacity_docs
                    if not cap:
                        raise ValueError(
                            "growing=True needs capacity_docs — the "
                            "pre-allocated local-row ceiling the corpus "
                            "may grow into (or pass a sharded_template "
                            "built with capacity_docs=)")
                program = _store.sharded_template(program, corpus,
                                                  capacity_docs=cap)
            if self.cfg.growing and (program.meta.get("capacity_docs", 0)
                                     <= program.meta.get("pstar_size", 0)):
                raise ValueError(
                    "growing=True but the template has no growth headroom; "
                    "build it with sharded_template(..., capacity_docs=N) "
                    "for some N above the current document count")
            if not program.meta.get("sharded"):
                raise ValueError(
                    "corpus= needs a sharded template program; build one "
                    "with repro_torch.data.store.sharded_template(model, "
                    "corpus)")
            self._slicer = functools.partial(_store.slice_sharded, program,
                                             corpus)
            self._caps_probe = functools.partial(_store.sharded_caps,
                                                 program, corpus)
        else:
            check_resident(program, "SVI without corpus=")
        self.program = program
        if program.meta.get("pstar") is None:
            raise ValueError("SVI needs a '?' partition plate "
                             "(documents) to sample minibatches over")
        n_groups = program.meta["pstar_size"]
        if self.cfg.holdout_frac == 0:
            self.train = np.arange(n_groups, dtype=np.int64)
            self.holdout = np.zeros(0, np.int64)
        else:
            self.train, self.holdout = holdout_split(
                n_groups, self.cfg.holdout_frac, self.cfg.seed)
        batch_size = min(self.cfg.batch_size, len(self.train))
        if corpus is not None:
            from ..data.store import ShardedMinibatchSampler
            self._weights = np.asarray(corpus.lengths, np.int64)
            self.sampler = ShardedMinibatchSampler(
                corpus=corpus, groups=self.train, batch_size=batch_size,
                seed=self.cfg.seed, shuffle=self.cfg.shuffle,
                loader=(self._load_groups_hosts if hosts is not None
                        else self._load_groups),
                prefetch=self.cfg.prefetch,
                grow=self.cfg.growing,
                exclude=self.holdout if self.cfg.growing else None,
                max_group=(program.meta["capacity_docs"]
                           if self.cfg.growing else None))
        else:
            self.sampler = MinibatchSampler(
                groups=self.train, batch_size=batch_size,
                seed=self.cfg.seed, shuffle=self.cfg.shuffle)
            self._weights = self._group_token_weights()
        self._steps: dict = {}
        self._heldout_cache: dict = {}

    def _group_token_weights(self) -> np.ndarray:
        """Per-group observed-token counts ``(pstar_size,) int64``: the
        LPT packing weights of a sharded batch."""
        n = self.program.meta["pstar_size"]
        w = np.zeros(n, np.int64)
        for spec in self.program.latents:
            for f in spec.children:
                g = spec.group if f.zmap is None else spec.group[f.zmap]
                w += np.bincount(g, minlength=n)
        for s in self.program.statics:
            if s.group is not None:
                w += np.bincount(s.group, minlength=n)
        return w

    def _caps_fn(self, name, n):
        m = self.cfg.pad_multiple
        return n if not m else -(-max(n, 1) // m) * m

    def _load_groups(self, groups):
        """Host batch of one group set for the engine's device: runs on the
        prefetch thread in corpus mode (numpy and host plans only).  Returns
        ``(batch, caps, n_tokens, n_groups)``."""
        if self.cfg.growing:
            # refresh() rebinds corpus.lengths wholesale; re-fetch so the
            # weights cover newly committed documents
            self._weights = np.asarray(self.corpus.lengths, np.int64)
        hb, caps, n_tok = host_batch(self.program, groups, self._caps_fn,
                                     plan=self.plan, device=self.device,
                                     slicer=self._slicer,
                                     group_weights=self._weights,
                                     caps_probe=self._caps_probe)
        return hb, caps, n_tok, len(groups)

    # -- multi-host partitioned batching ----------------------------------

    def _init_hosts(self):
        """Validate the topology and build the shard -> host map.

        ``hosts`` (a :class:`repro_torch.data.HostAssignment`) turns the
        plan path into ownership-partitioned batching: documents go to the
        shards of the host that *owns* them (``doc_ownership``), not to
        whichever shard the global LPT pack prefers.  In a
        ``torch.distributed`` run of several processes the shards of host
        ``h`` are those of rank ``h`` (``plan.group``) and the corpus must
        be opened with the matching host view; in one process the same
        ``n_hosts`` are *virtual* — the shards split into ``n_hosts``
        contiguous blocks — which gives the multi-process run's every sum,
        in its order (bitwise 2 processes = 2 virtual hosts).
        """
        from ..data import store as _store
        hosts = self.hosts
        if self.corpus is None or self.plan is None:
            raise ValueError("hosts= needs both corpus= (a partitioned "
                             "ShardedCorpus) and plan= (a ShardingPlan)")
        if self.cfg.growing:
            raise NotImplementedError(
                "growing corpora are single-host for now: a multi-host "
                "epoch snapshot needs a refresh barrier so every host "
                "adopts the same commit")
        group = self.plan.group
        m = self.plan.n_shards
        if group.world_size > 1:
            self._multiproc = True
            if hosts.n_hosts != group.world_size:
                raise ValueError(
                    f"hosts.n_hosts={hosts.n_hosts} but this is a "
                    f"{group.world_size}-process run")
            if hosts.host_id != group.rank:
                raise ValueError(
                    f"hosts.host_id={hosts.host_id} but this process is "
                    f"rank {group.rank}")
            if (self.corpus.hosts is None
                    or self.corpus.hosts.host_id != hosts.host_id
                    or self.corpus.hosts.n_hosts != hosts.n_hosts):
                raise ValueError(
                    "in a multi-process run the corpus must be opened with "
                    "the matching host view: ShardedCorpus.open(path, "
                    "hosts=HostAssignment(n_hosts, host_id, seed))")
            self._shard_host = group.shard_rank
        else:
            if self.corpus.hosts is not None:
                raise ValueError("virtual-host mode (single process) needs "
                                 "an unrestricted corpus — all shards are "
                                 "local")
            if m % hosts.n_hosts:
                raise ValueError(f"{m} shards do not split evenly into "
                                 f"{hosts.n_hosts} virtual hosts")
            self._shard_host = np.repeat(
                np.arange(hosts.n_hosts, dtype=np.int32), m // hosts.n_hosts)
        ownership_seed = (self.corpus.hosts.seed
                          if self.corpus.hosts is not None else hosts.seed)
        self._doc_owner = _store.doc_ownership(
            self.corpus.manifest, hosts.n_hosts, ownership_seed)

    def _host_parts(self, groups: np.ndarray) -> list:
        """Partition one *global* batch onto the shards: each document goes
        to its owner host (``doc_ownership`` — the only host that can read
        it), then LPT-packs by token mass across that host's shards.  A
        pure function of (lengths, manifest, seed, plan), so every host
        computes the identical global partition with no communication."""
        from .partition import lpt_pack
        owner = self._doc_owner[groups]
        parts: list = [None] * len(self._shard_host)
        for h in range(self.hosts.n_hosts):
            gh = groups[owner == h]
            sids = np.flatnonzero(self._shard_host == h)
            shard_of = lpt_pack(np.maximum(self._weights[gh], 1), len(sids))
            for j, s in enumerate(sids):
                parts[int(s)] = gh[shard_of == j]
        return parts

    def _host_slices(self, groups, caps_fn):
        """The shards of this process, each sliced from its part of
        ``groups`` (:meth:`_host_parts`) at caps agreed from the
        lengths-only probe of **every** shard's part — no cross-host
        traffic, no shard I/O — so all hosts pad to identical shapes.
        Returns ``(batch, caps)``."""
        parts = self._host_parts(groups)
        caps = shared_caps(parts, self._caps_probe, caps_fn)
        batch, _ = shard_batches(self.program, parts,
                                 self.plan.group.local_shards, caps,
                                 self._slicer, self.device)
        return batch, caps

    def _load_groups_hosts(self, groups):
        """Multi-host loader: the *schedule* stays the global ``(seed,
        epoch)`` permutation (every host computes the same ``batch_at``);
        only the slicing is partitioned (:meth:`_host_slices`)."""
        groups = np.unique(np.asarray(groups, np.int64))
        batch, caps = self._host_slices(groups, self._caps_fn)
        n_tok = int(np.asarray(self.corpus.lengths)[groups].sum())
        return batch, caps, n_tok, len(groups)

    def step(self, t: int, state: VMPState):
        """One SVI step at schedule position ``t``; returns (state', elbo).
        The caller's wait for a prefetched batch (corpus mode) and the
        batch's host-to-device copy are the spans ``svi.wait`` and
        ``svi.h2d``."""
        if self.corpus is not None:
            with trace.span("svi.wait"):
                hb, caps, _, n_b = self.sampler.host_batch_at(t)
        else:
            hb, caps, _, n_b = self._load_groups(self.sampler.batch_at(t))
        with trace.span("svi.h2d"):
            batch = device_put_batch(hb, self.device)
        sig = tuple(sorted(caps.items()))
        if sig not in self._steps:
            self._steps[sig] = make_svi_step(
                self.program, caps, plan=self.plan,
                local_iters=self.cfg.local_iters,
                elog_dtype=self.cfg.elog_dtype)
        rho = (self.cfg.rho if self.cfg.rho is not None
               else robbins_monro(t, self.cfg.tau, self.cfg.kappa))
        # n_b is the true batch size (the epoch's tail batch may be short).
        # The stochastic scale G/|B|: G is the training population — fixed
        # in batch mode, the epoch snapshot size under a growing corpus, or
        # a pinned assumed population (population-VI) for unbounded streams
        if self.cfg.growing:
            n_pop = (self.cfg.population_size
                     or self.sampler.population_at(t))
        else:
            n_pop = len(self.train)
        scale = n_pop / n_b
        return self._steps[sig](state, batch, _scalar(rho, self.device),
                                _scalar(scale, self.device))

    def heldout_elbo(self, state: VMPState) -> float:
        """Per-token held-out ELBO at ``state`` (NaN without a holdout)."""
        if len(self.holdout) == 0:
            return float("nan")
        if self.hosts is not None:
            return self._heldout_hosts(state)
        return heldout_elbo(self.program, state, self.holdout,
                            self.cfg.holdout_local_iters,
                            cache=self._heldout_cache, slicer=self._slicer)

    def _heldout_hosts(self, state: VMPState) -> float:
        """Multi-host held-out ELBO: the holdout is partitioned by document
        ownership exactly like a training batch (each host reads only its
        shards), scored per shard with frozen globals, and summed in the
        plan's group (:func:`build_sharded_scorer`).  Every host returns
        the identical scalar.  The held-out slices, plans and scorer are
        built once and kept."""
        entry = self._heldout_cache.get("hosts")
        if entry is None:
            groups = np.asarray(self.holdout, np.int64)
            batch, caps = self._host_slices(groups, None)
            n_tok = int(np.asarray(self.corpus.lengths)[groups].sum())
            shards = {s: (b["arrays"], b["plans"]) for s, b in
                      device_put_batch(batch, self.device)["shards"].items()}
            entry = (build_sharded_scorer(self.program, caps,
                                          self.cfg.holdout_local_iters,
                                          self.plan), shards, n_tok)
            self._heldout_cache["hosts"] = entry
        fn, shards, n_tok = entry
        if n_tok == 0:
            return float("nan")
        return float(fn(state.posteriors, shards)) / n_tok

    def close(self):
        """Stop the sharded sampler's prefetch thread (no-op in resident
        mode; further ``fit`` calls restart prefetching lazily)."""
        if hasattr(self.sampler, "close"):
            self.sampler.close()

    # -- crash-safe sessions -------------------------------------------------

    def _fingerprint(self) -> dict:
        from ..checkpoint.session import session_fingerprint
        return session_fingerprint(self.program, self.cfg,
                                   batch_size=self.sampler.batch_size)

    def _snapshot_session(self, state: VMPState, history: dict):
        """Host-side resumable snapshot of the fit at ``state.step``."""
        from ..checkpoint.session import TrainSession
        epochs = []
        snap = getattr(self.sampler, "epoch_snapshots", None)
        if snap is not None:
            epochs = snap()
        corpus = None
        if self.corpus is not None:
            corpus = {"n_docs": int(self.corpus.n_docs),
                      "n_tokens": int(self.corpus.n_tokens),
                      "n_shards": int(self.corpus.n_shards)}
        return TrainSession(
            posteriors=state_to_numpy(state)[0], t=int(state.step),
            history={"elbo": list(history["elbo"]),
                     "heldout": list(history["heldout"])},
            epochs=epochs, holdout=np.asarray(self.holdout, np.int64),
            corpus=corpus, fingerprint=self._fingerprint())

    def _adopt_session(self, sess, where: str):
        """Rebuild (state, history) from a session; reseats the sampler
        cursor and the held-out split so the continuation is bitwise."""
        from ..checkpoint.session import check_fingerprint
        check_fingerprint(sess.fingerprint, self._fingerprint(), where)
        if self.corpus is not None and sess.corpus:
            self.corpus.refresh()
            if int(self.corpus.n_docs) < int(sess.corpus["n_docs"]):
                raise ValueError(
                    f"refusing to resume from {where}: corpus has "
                    f"{self.corpus.n_docs} docs but the session saw "
                    f"{sess.corpus['n_docs']} — append-only stores never "
                    f"shrink; is this the right corpus directory?")
        hold = np.asarray(sess.holdout, np.int64)
        if self.cfg.growing:
            # the split was drawn against the corpus size at first build;
            # adopt it (and the epoch snapshots) rather than re-deriving
            self.holdout = hold
            self.sampler.exclude = hold
            self.sampler.restore_epochs(sess.epochs)
        elif not np.array_equal(hold, self.holdout):
            raise ValueError(
                f"refusing to resume from {where}: held-out split differs "
                f"from the session's (corpus or seed changed?)")
        state = state_from_numpy(sess.posteriors, sess.t, device=self.device)
        history = {"elbo": list(sess.history["elbo"]),
                   "heldout": list(sess.history["heldout"])}
        return state, history

    def fit(self, steps: int, state: Optional[VMPState] = None,
            callback=None, *, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 10, checkpoint_keep: int = 3,
            resume_from=None):
        """Run ``steps`` minibatch updates; resumes the schedule from
        ``state.step``.  ``state`` may come from another device (e.g. the
        JAX package's ``init_state`` through ``vmp.state_from_numpy``): it
        is moved to the engine's.  ``callback(t, batch_elbo) -> False``
        stops early.

        **Crash safety**: with ``checkpoint_dir`` a resumable
        :class:`~repro_torch.checkpoint.TrainSession` is committed (async,
        self-validating) every ``checkpoint_every`` steps and at the end of
        the run.  ``resume_from=`` a directory (or ``True`` for
        ``checkpoint_dir`` itself) restores the newest valid session and
        continues bitwise-identically: state, Robbins-Monro position,
        sampler cursor, held-out split, and the accumulated history all
        carry over; a session written by a mismatched model/config is
        refused.  ``resume_from=True`` with no session yet is a cold start.
        ``steps`` counts the updates *this call* runs (on resume: the
        remaining budget).
        """
        from ..checkpoint import CheckpointStore
        from ..checkpoint import session as _session
        from ..testing import faults

        store = None
        if checkpoint_dir is not None:
            store = CheckpointStore(checkpoint_dir,
                                    every=max(1, checkpoint_every),
                                    keep=checkpoint_keep)
            if self._multiproc and self.plan.group.rank != 0:
                # one writer per cluster: the state is replicated, so rank
                # 0 persists for everyone (every rank reads on resume — a
                # shared filesystem is the multi-host contract)
                store = None
        resume_dir = None
        if resume_from is True:
            if checkpoint_dir is None:
                raise ValueError("resume_from=True needs checkpoint_dir=")
            resume_dir = checkpoint_dir
        elif resume_from:
            resume_dir = str(resume_from)
        history = {"elbo": [], "heldout": []}
        if resume_dir is not None:
            if state is not None:
                raise ValueError("pass state= or resume_from=, not both")
            try:
                sess = _session.load_session(resume_dir)
            except FileNotFoundError:
                if resume_from is not True:
                    raise
                sess = None                      # cold start of the loop
            if sess is not None:
                state, history = self._adopt_session(sess, resume_dir)
        if state is None:
            state = init_state(self.program, self.cfg.seed,
                               device=self.device)
        elif state.device != self.device:
            state = VMPState({n: p.to(self.device)
                              for n, p in state.posteriors.items()},
                             state.step)
        start = int(state.step)
        try:
            for t in range(start, start + steps):
                faults.trip("svi.step")
                state, elbo = self.step(t, state)
                elbo_f = float(elbo)
                history["elbo"].append(elbo_f)
                if (len(self.holdout) and self.cfg.holdout_every
                        and ((t + 1) % self.cfg.holdout_every == 0
                             or t == start + steps - 1)):
                    history["heldout"].append((t, self.heldout_elbo(state)))
                if store is not None and (
                        (t + 1) % store.every == 0 or t == start + steps - 1):
                    _session.save_session(
                        store, self._snapshot_session(state, history),
                        force=True)
                if callback is not None and callback(t, elbo_f) is False:
                    break
        finally:
            if store is not None:
                store.wait()
        return state, history
