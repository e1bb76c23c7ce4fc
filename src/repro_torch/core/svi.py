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

What needs a later slice of the port raises ``NotImplementedError`` naming
it: out-of-core and growing corpora (``corpus=``, ``growing=True``), the
distributed path (``plan=``, ``hosts=``), checkpoints (``fit(checkpoint_dir=,
resume_from=)``), the static pre-flight (``validate=True``) and fold-in
(``build_local_scorer(extras=True)``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..data.pipeline import MinibatchSampler, holdout_split
from . import dists
from .compiler import (VMPProgram, local_dirichlets, slice_arrays,
                       sliced_shadow)
from .runtime import _resolve_elog_dtype
from .vmp import (VMPState, _step_body, init_state, owner_plans,
                  resolve_device)


def later_slice(what: str, slice_name: str):
    """Raise ``NotImplementedError`` for a feature of a later slice."""
    raise NotImplementedError(f"{what} arrives with the {slice_name} slice "
                              f"of the port")


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
    prefetch: bool = True          # out-of-core mode (a later slice): overlap
                                   # batch t+1's shard I/O with step t
    growing: bool = False          # out-of-core mode (a later slice):
                                   # re-snapshot the doc population every epoch
    capacity_docs: int = 0         # growing mode: pre-allocated local-row
                                   # ceiling the corpus may grow into
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


def make_svi_step(program: VMPProgram, caps: dict[str, int],
                  local_iters: int = 1, elog_dtype=None):
    """Build ``step(state, batch, rho, scale) -> (state', batch_elbo)`` for
    batches padded to ``caps``.

    ``batch`` is the output of :func:`device_batch`; ``rho`` the step size;
    ``scale`` the stochastic-stats multiplier G/|B| (floats or 0-d tensors,
    taken as f32 on the state's device).  The batch's owner plans
    (``batch["plans"]``, empty off CUDA) go to every ``_step_body`` of the
    step; the program's cached plans are never read.
    """
    local = local_dirichlets(program)
    shadow = sliced_shadow(program, caps)
    elog_dtype = _resolve_elog_dtype(elog_dtype)
    priors_on: dict = {}

    def step(state: VMPState, batch: dict, rho, scale):
        device = state.device
        if device not in priors_on:
            priors_on[device] = _priors(program, device)
        priors = priors_on[device]
        rho, scale = _scalar(rho, device), _scalar(scale, device)
        plans = batch["plans"]
        st = sliced_state(program, state, batch, priors)
        sliced = st.posteriors
        for _ in range(max(local_iters - 1, 0)):     # local refinement only
            ref, _ = _step_body(shadow, batch["arrays"], st,
                                elog_dtype=elog_dtype, plans=plans)
            st = VMPState({n: (ref.posteriors[n] if n in local else sliced[n])
                           for n in sliced}, state.step)
        new, elbo = _step_body(shadow, batch["arrays"], st,
                               elog_dtype=elog_dtype, plans=plans)

        posts = {}
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
            else:
                # natural gradient: target = prior + scale * stats_B; the
                # where()s keep the |B|=G, rho=1 case bitwise equal to the
                # full-batch VMP update (no x-p+p float round-trip)
                target = priors[name] + scale * \
                    (new.posteriors[name] - priors[name])
                target = torch.where(scale == 1.0, new.posteriors[name],
                                     target)
                blend = (1.0 - rho) * state.posteriors[name] + rho * target
                posts[name] = torch.where(rho == 1.0, target, blend)
        return VMPState(posts, state.step + 1), elbo

    return step


# ---------------------------------------------------------------------------
# one batch, from the host to the device
# ---------------------------------------------------------------------------

def host_batch(program: VMPProgram, groups, caps_fn=None, plan=None, *,
               device=None, times: Optional[dict] = None):
    """Build one minibatch's host-side (numpy) arrays for ``device``
    (``None`` means ``"cuda"``; no card is needed, as nothing is placed).

    Returns ``(batch, caps, n_tokens)`` where ``batch = {"arrays", "dirs",
    "plans"}``: numpy leaves (``compiler.slice_arrays``) and the batch's
    kernel owner plans, built from its own streams (``vmp.owner_plans``,
    empty unless ``device`` is CUDA).  Pure host work:
    :func:`device_put_batch` places the result on a device.  ``times`` (a
    dict) gets the host ms of the slicing and of the plans under
    ``"slice"`` and ``"plan"``.  ``plan`` (a sharding plan) belongs to the
    distributed slice.
    """
    if plan is not None:
        later_slice("a sharded batch (plan=)", "distributed")
    device = torch.device("cuda" if device is None else device)
    t0 = time.perf_counter()
    arrays, dirs, caps, n_tok = slice_arrays(program, groups, caps_fn)
    t1 = time.perf_counter()
    batch = {"arrays": arrays, "dirs": dirs,
             "plans": owner_plans(program, arrays, device, caps)}
    if times is not None:
        times.update(slice=(t1 - t0) * 1e3,
                     plan=(time.perf_counter() - t1) * 1e3)
    return batch, caps, n_tok


def _put(a, device):
    return None if a is None else torch.from_numpy(a).to(device)


def device_put_batch(batch: dict, device) -> dict:
    """A :func:`host_batch` result on ``device``: every numpy leaf as a
    tensor (``None`` passes through), every owner plan with its device
    copy."""
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
    (:func:`host_batch`), as in ``_step_body``.  ``extras=True`` (the
    fold-in path) belongs to the query slice.
    """
    if extras:
        later_slice("build_local_scorer(extras=True) (fold-in)", "query")
    local = local_dirichlets(program)
    shadow = sliced_shadow(program, caps)

    def fn(posteriors, arrays, plans):
        device = next(iter(posteriors.values())).device
        priors = _priors(program, device)
        posts = {name: (priors[name].expand(caps[name], d.k).contiguous()
                        if name in local else posteriors[name])
                 for name, d in program.dirichlets.items()}
        st = VMPState(posts, 0)
        for _ in range(inner_iters):
            new, _ = _step_body(shadow, arrays, st, plans=plans)
            st = VMPState({n: (new.posteriors[n] if n in local
                               else posts[n]) for n in posts}, st.step)
        _, elbo = _step_body(shadow, arrays, st, plans=plans)
        for name in program.dirichlets:
            if name not in local:
                elbo = elbo - dists.dirichlet_elbo_term(priors[name],
                                                        posteriors[name])
        return elbo

    return fn


def heldout_elbo(program: VMPProgram, state: VMPState, groups,
                 inner_iters: int = 10, cache: Optional[dict] = None) -> float:
    """Per-token ELBO on held-out groups under the current global
    posteriors (:func:`build_local_scorer`): comparable across engines and
    batch sizes, the convergence metric of the streaming engine.  Returns a
    python float (nats/token); NaN when the groups hold no tokens.

    ``cache`` (a caller-owned dict, e.g. the :class:`SVI` instance's) keeps
    per (groups, inner_iters, device) the evaluator with the groups' slice
    and owner plans on the device: the held-out groups never change, so
    they are sliced and planned once."""
    groups = np.asarray(groups, np.int64)
    device = state.device
    key = (groups.tobytes(), inner_iters, str(device))
    entry = cache.get(key) if cache is not None else None
    if entry is None:
        batch, caps, n_tok = host_batch(program, groups, device=device)
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
    trace ``[(step, value), ...]`` (the convergence signal).  The corpus is
    resident: the program holds every token.
    """

    def __init__(self, program, config: SVIConfig = None, plan=None,
                 corpus=None, hosts=None, validate=False, device=None):
        self.cfg = config or SVIConfig()
        if validate:
            later_slice("validate=True (the static pre-flight)", "analysis")
        if plan is not None:
            later_slice("a sharding plan (plan=)", "distributed")
        if hosts is not None:
            later_slice("multi-host corpora (hosts=)", "distributed")
        if corpus is not None:
            later_slice("an out-of-core corpus (corpus=)", "out-of-core")
        if self.cfg.growing:
            later_slice("a growing corpus (growing=True)", "out-of-core")
        self.device = resolve_device(device)
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
        self.sampler = MinibatchSampler(
            groups=self.train,
            batch_size=min(self.cfg.batch_size, len(self.train)),
            seed=self.cfg.seed, shuffle=self.cfg.shuffle)
        self._weights = self._group_token_weights()
        self._steps: dict = {}
        self._heldout_cache: dict = {}
        # a list to record, per step, the host ms of its slicing, owner
        # plans and host-to-device copy ({"slice", "plan", "h2d"})
        self.host_ms: Optional[list] = None

    def _group_token_weights(self) -> np.ndarray:
        """Per-group observed-token counts ``(pstar_size,) int64``: the
        packing weights of the distributed slice's batches."""
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

    def _load_groups(self, groups, times: Optional[dict] = None):
        """Host batch of one group set for the engine's device (``times``:
        as :func:`host_batch`'s).  Returns ``(batch, caps, n_tokens,
        n_groups)``."""
        hb, caps, n_tok = host_batch(self.program, groups, self._caps_fn,
                                     device=self.device, times=times)
        return hb, caps, n_tok, len(groups)

    def step(self, t: int, state: VMPState):
        """One SVI step at schedule position ``t``; returns (state', elbo)."""
        times = {} if self.host_ms is not None else None
        hb, caps, _, n_b = self._load_groups(self.sampler.batch_at(t), times)
        t0 = time.perf_counter()
        batch = device_put_batch(hb, self.device)
        if times is not None:
            times["h2d"] = (time.perf_counter() - t0) * 1e3
            self.host_ms.append(times)
        sig = tuple(sorted(caps.items()))
        if sig not in self._steps:
            self._steps[sig] = make_svi_step(
                self.program, caps, local_iters=self.cfg.local_iters,
                elog_dtype=self.cfg.elog_dtype)
        rho = (self.cfg.rho if self.cfg.rho is not None
               else robbins_monro(t, self.cfg.tau, self.cfg.kappa))
        # n_b is the true batch size (the epoch's tail batch may be short);
        # the stochastic scale is G/|B| over the training population
        scale = len(self.train) / n_b
        return self._steps[sig](state, batch, _scalar(rho, self.device),
                                _scalar(scale, self.device))

    def heldout_elbo(self, state: VMPState) -> float:
        """Per-token held-out ELBO at ``state`` (NaN without a holdout)."""
        if len(self.holdout) == 0:
            return float("nan")
        return heldout_elbo(self.program, state, self.holdout,
                            self.cfg.holdout_local_iters,
                            cache=self._heldout_cache)

    def close(self):
        """Release what the engine holds open: nothing in resident mode
        (the out-of-core slice's prefetch thread stops here)."""

    def fit(self, steps: int, state: Optional[VMPState] = None,
            callback=None, *, checkpoint_dir: Optional[str] = None,
            checkpoint_every: int = 10, checkpoint_keep: int = 3,
            resume_from=None):
        """Run ``steps`` minibatch updates; resumes the schedule from
        ``state.step``.  ``state`` may come from another device (e.g. the
        JAX package's ``init_state`` through ``vmp.state_from_numpy``): it
        is moved to the engine's.  ``callback(t, batch_elbo) -> False``
        stops early.  Checkpoints (``checkpoint_dir=``, ``resume_from=``)
        belong to the checkpoint slice."""
        if checkpoint_dir is not None or resume_from:
            later_slice("SVI checkpoints (checkpoint_dir=, resume_from=)",
                        "checkpoint")
        if state is None:
            state = init_state(self.program, self.cfg.seed,
                               device=self.device)
        elif state.device != self.device:
            state = VMPState({n: p.to(self.device)
                              for n, p in state.posteriors.items()},
                             state.step)
        history = {"elbo": [], "heldout": []}
        start = int(state.step)
        for t in range(start, start + steps):
            state, elbo = self.step(t, state)
            elbo_f = float(elbo)
            history["elbo"].append(elbo_f)
            if (len(self.holdout) and self.cfg.holdout_every
                    and ((t + 1) % self.cfg.holdout_every == 0
                         or t == start + steps - 1)):
                history["heldout"].append((t, self.heldout_elbo(state)))
            if callback is not None and callback(t, elbo_f) is False:
                break
        return state, history
