"""The VMP engine: one update step per iteration, in PyTorch.

The port of ``repro.core.vmp``.  For the conjugate class InferSpark supports,
VMP coincides with coordinate ascent variational inference: messages into a
latent Categorical are Dirichlet log-expectation gathers, the latent's update
is a softmax, and each Dirichlet's update is its prior plus
(responsibility-weighted) count statistics.  One step runs

    Elog tables -> latent responsibilities -> sufficient stats -> posteriors

and returns the exact ELBO at the step's input posteriors: with
responsibilities at their coordinate optimum the latent+likelihood
contribution collapses to ``sum_i logsumexp_k(logits_i)``.

The state lives on one device.  On CUDA each latent's token plate is one
call of the ``zstats`` kernel (``fused_zmap`` for a segment latent), whose
owner plan is built on the host (:func:`owner_plans`): once per program and
cached in ``program.meta`` on the full-batch path (:func:`program_plans`),
once per minibatch under SVI (``svi.host_batch``).  :func:`_step_body`
takes the plans from its caller.  Every reduction on the
card runs in a fixed order, so two runs from the same state are bitwise
equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops as kops
from . import dists
from .compiler import VMPProgram, check_resident


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device without a card raises: the
    entry points never drop to the CPU unless asked for ``device="cpu"``."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


@dataclasses.dataclass
class VMPState:
    """Inference state: posterior concentrations of every Dirichlet node.

    Latent responsibilities are *not* state — they are recomputed from the
    posteriors each iteration (they are the messages, not the marginals),
    which keeps the state small: O(sum G_d * K_d), independent of N.
    """
    posteriors: dict[str, torch.Tensor]
    step: int                            # iteration counter

    @property
    def device(self) -> torch.device:
        return next(iter(self.posteriors.values())).device


def init_state(program: VMPProgram, seed: int = 0, device=None) -> VMPState:
    """Prior + multiplicative noise: symmetry breaking is required for any
    mixture (all-equal posteriors are a saddle point of the ELBO).

    The noise is uniform(0.5, 1.5) from a CPU ``torch.Generator`` seeded with
    ``seed``, drawn per Dirichlet in sorted name order, so a seed gives the
    same state on every device.  It is not the JAX package's threefry noise;
    :func:`state_from_numpy` carries that state across instead.
    """
    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    posts = {}
    for name, d in sorted(program.dirichlets.items()):
        noise = torch.rand((d.g, d.k), generator=gen, dtype=torch.float32) + 0.5
        prior = torch.from_numpy(np.asarray(d.prior, np.float32))[None, :]
        posts[name] = (prior * torch.ones((d.g, 1)) + noise).to(device)
    return VMPState(posts, 0)


def state_from_numpy(posteriors: dict, step: int = 0, device=None) -> VMPState:
    """A state from numpy posteriors (e.g. the JAX package's ``VMPState``
    converted with ``np.asarray``), on ``device``."""
    device = resolve_device(device)
    return VMPState({n: torch.from_numpy(np.array(p, np.float32)).to(device)
                     for n, p in posteriors.items()}, int(step))


def state_to_numpy(state: VMPState) -> tuple[dict, int]:
    """``(posteriors as float32 numpy arrays, step)``."""
    return ({n: p.detach().cpu().numpy() for n, p in state.posteriors.items()},
            int(state.step))


# ---------------------------------------------------------------------------
# message computation
# ---------------------------------------------------------------------------

def _messages_to_latent(program, spec, elog, arrays):
    """Sum of prior + child messages -> logits (n, K).  The children with a
    ``zmap`` (a segment latent's) are summed per instance by
    ``kops.zmap_logits``, in a fixed order on every device, and added last."""
    logits = elog[spec.prior_dir][arrays[spec.name]["prior_rows"].long()]
    for f in spec.children:
        a = arrays[f.x_name]
        if a.get("zmap") is not None:
            continue
        vals = a["values"].long()
        if f.specialized:
            e = elog[f.dir_name][:, vals].T
        else:
            kk = torch.arange(spec.k, dtype=torch.int64, device=vals.device)
            base = a["base"].long()[:, None] if a.get("base") is not None else 0
            e = elog[f.dir_name][base + f.stride * kk[None, :], vals[:, None]]
        if a.get("mask") is not None:
            e = e * a["mask"][:, None]
        logits = logits + e
    children = _latent_children(spec, elog, arrays)
    zkids = tuple(c for c in children if c.zmap is not None)
    if zkids:
        plan = program_plans(program, arrays).get(spec.name)
        logits = logits + kops.zmap_logits(zkids, spec.n, spec.k, plan=plan)
    return logits.contiguous()


def _elog_tables(program: VMPProgram, state: VMPState) -> dict:
    """Each Dirichlet's Elog table, made once (``kops.dirichlet_expectation``).
    The table of a specialized child (phi for LDA) is made as (V, K), the
    layout the kernels read, and used through its (K, V) transpose."""
    transposed = {f.dir_name for spec in program.latents
                  for f in spec.children if f.specialized}
    return {n: kops.dirichlet_expectation(p, transpose=True).T
            if n in transposed else kops.dirichlet_expectation(p)
            for n, p in state.posteriors.items()}


def _latent_children(spec, tabs: dict, arrays: dict) -> tuple:
    """The latent's children as kernel-level ``ZChild``s over ``tabs``."""
    return tuple(
        kops.ZChild(elog=tabs[f.dir_name], values=arrays[f.x_name]["values"],
                    stride=f.stride, zmap=arrays[f.x_name].get("zmap"),
                    base=arrays[f.x_name].get("base"),
                    mask=arrays[f.x_name].get("mask"))
        for f in spec.children)


def owner_plans(program: VMPProgram, arrays: dict, device,
                caps: dict | None = None) -> dict:
    """``{latent name: owner plan}`` of the ``zstats`` kernels for these
    ``arrays``' index streams (numpy arrays or tensors), built on the host
    (``kops.host_plan``) and not yet moved to ``device``.  This is the one
    place that decides whether a step gets plans: off CUDA no kernel reads
    one, and the result is ``{}``.  A plan reads only its tables' shapes: a
    Dirichlet has ``caps[name]`` rows where ``caps`` names it (a minibatch's
    local one), else its own ``g``, so each table is a zero-byte stand-in of
    that shape."""
    if torch.device(device).type != "cuda":
        return {}
    caps = caps or {}
    tabs = {n: np.broadcast_to(np.float32(0), (caps.get(n, d.g), d.k))
            for n, d in program.dirichlets.items()}
    return {spec.name: kops.host_plan(
                tabs[spec.prior_dir].shape, arrays[spec.name]["prior_rows"],
                _latent_children(spec, tabs, arrays))
            for spec in program.latents}


def program_plans(program: VMPProgram, arrays: dict) -> dict:
    """The full-batch path's owner plans (:func:`owner_plans`) for the
    program's own arrays (:func:`_program_arrays`), on their device.  They
    depend only on the program's static index streams, so they are built
    once and cached on the program, per device.  Minibatches share the
    program and not its streams: the SVI path never comes here, and
    ``compiler.sliced_shadow`` drops the cache from the shadow's meta."""
    if not program.latents:
        return {}
    device = arrays[program.latents[0].name]["prior_rows"].device
    cache = program.meta.setdefault("_zstats_plan", {})
    if str(device) not in cache:
        cache[str(device)] = {n: p.to(device) for n, p in owner_plans(
            program, arrays, device).items()}
    return cache[str(device)]


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

def _program_arrays(program: VMPProgram, device) -> dict:
    """Device constants: observed values, maps, static rows (paper: the MPG's
    edge structure, here dense index tensors)."""
    check_resident(program, "full-batch VMP")

    def dev(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a, np.int32)).to(device)
    arrays: dict[str, dict] = {}
    for spec in program.latents:
        arrays[spec.name] = {"prior_rows": dev(spec.prior_rows)}
        for f in spec.children:
            arrays[f.x_name] = {"values": dev(f.values), "zmap": dev(f.zmap),
                                "base": dev(f.base), "mask": None}
    for s in program.statics:
        arrays[s.x_name] = {"rows": dev(s.rows), "values": dev(s.values),
                            "mask": None}
    return arrays


def _step_body(program: VMPProgram, arrays: dict, state: VMPState,
               elog_dtype=None, *, plans: dict):
    """One VMP iteration: ``(new_state, elbo)``, the ELBO a 0-d f32 tensor.

    Each Dirichlet's Elog table is made once (:func:`_elog_tables`) and read
    by the token plate, the statics and the Dirichlet ELBO terms.  Per
    latent, the fused ``kops.zstats`` substep gathers the Elog messages,
    takes the softmax/logsumexp and scatters the sufficient statistics, so
    the token plate's (N, K) responsibilities are never materialized (a
    segment latent's (n_latent, K) ones are).  ``elog_dtype`` (e.g. ``torch.bfloat16``) instead hands
    the token plate the posterior *concentrations* narrowed to that type
    (``tables="alpha"``), while the digamma, softmax, stats and the Dirichlet
    ELBO terms stay f32.

    ``plans`` — ``{latent name: owner plan}`` for exactly these ``arrays``
    (:func:`owner_plans`): the program's cached ones (:func:`program_plans`)
    on the full-batch path, a minibatch's own under SVI
    (``svi.host_batch``).  On CUDA every latent needs its plan; elsewhere
    the mapping is empty.
    """

    device = state.device
    elog = _elog_tables(program, state)
    if elog_dtype is None:
        tabs, tables = elog, "elog"
    else:
        tabs, tables = {n: p.to(elog_dtype)
                        for n, p in state.posteriors.items()}, "alpha"
    elbo = torch.zeros((), dtype=torch.float32, device=device)
    stats = {n: torch.zeros((d.g, d.k), dtype=torch.float32, device=device)
             for n, d in program.dirichlets.items()}

    for spec in program.latents:
        children = _latent_children(spec, tabs, arrays)
        plan = plans.get(spec.name)
        if plan is None and device.type == "cuda":
            raise ValueError(f"no owner plan for latent {spec.name!r}: pass "
                             f"the step's plans (vmp.owner_plans)")
        lse_sum, pstats, cstats = kops.zstats(
            tabs[spec.prior_dir], arrays[spec.name]["prior_rows"], children,
            zmask=arrays[spec.name].get("mask"), tables=tables, plan=plan)
        elbo = elbo + lse_sum
        # prior-factor stats (theta <- z)
        stats[spec.prior_dir] = stats[spec.prior_dir] + pstats
        # child-factor stats (phi <- x weighted by r)
        for f, cs in zip(spec.children, cstats):
            stats[f.dir_name] = stats[f.dir_name] + cs

    for s in program.statics:
        a = arrays[s.x_name]
        d = program.dirichlets[s.dir_name]
        rows, vals = a["rows"].long(), a["values"].long()
        e = elog[s.dir_name][rows, vals]
        ones = torch.ones(vals.shape, dtype=torch.float32, device=device)
        if a.get("mask") is not None:
            e = e * a["mask"]
            ones = ones * a["mask"]
        elbo = elbo + e.sum()
        # counts of 1.0 are exact in f32 in any order: deterministic
        add = torch.zeros(d.g * d.k, dtype=torch.float32,
                          device=device).index_add_(0, rows * d.k + vals, ones)
        stats[s.dir_name] = stats[s.dir_name] + add.reshape(d.g, d.k)

    # Dirichlet ELBO terms + posterior updates
    new_posts = {}
    for name, d in program.dirichlets.items():
        prior = torch.from_numpy(np.asarray(d.prior, np.float32)).to(device)[None, :]
        elbo = elbo + dists.dirichlet_elbo_term(prior, state.posteriors[name],
                                                elog[name])
        new_posts[name] = prior * torch.ones_like(stats[name]) + stats[name]
    return VMPState(new_posts, state.step + 1), elbo


def latent_responsibilities(program: VMPProgram, state: VMPState, name: str):
    """Recompute q(z) for one latent from the current posteriors.

    The only path that materializes explicit (N, K) responsibilities — the
    step body streams them through ``kops.zstats`` without storing them, so
    callers who want q(z) itself pay for it here, on demand.
    """
    arrays = _program_arrays(program, state.device)
    elog = _elog_tables(program, state)
    for spec in program.latents:
        if spec.name == name:
            logits = _messages_to_latent(program, spec, elog, arrays)
            r, _ = kops.zstep(logits)
            return r
    raise KeyError(name)


def full_elbo(program: VMPProgram, state: VMPState) -> float:
    """ELBO at the current posteriors with optimal responsibilities."""
    arrays = _program_arrays(program, state.device)
    _, elbo = _step_body(program, arrays, state,
                         plans=program_plans(program, arrays))
    return float(elbo)
