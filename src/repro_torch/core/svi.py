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

What needs a later slice of the port raises ``NotImplementedError`` naming
it: the distributed path (``plan=``, ``hosts=``), the static pre-flight
(``validate=True``) and fold-in (``build_local_scorer(extras=True)``).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from ..data.pipeline import MinibatchSampler, holdout_split
from . import dists
from .compiler import (VMPProgram, check_resident, local_dirichlets,
                       slice_arrays, sliced_shadow)
from .runtime import _resolve_elog_dtype
from .vmp import (VMPState, _step_body, init_state, owner_plans,
                  resolve_device, state_from_numpy, state_to_numpy)


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
               device=None, times: Optional[dict] = None, slicer=None):
    """Build one minibatch's host-side (numpy) arrays for ``device``
    (``None`` means ``"cuda"``; no card is needed, as nothing is placed).

    Returns ``(batch, caps, n_tokens)`` where ``batch = {"arrays", "dirs",
    "plans"}``: numpy leaves and the batch's kernel owner plans, built from
    its own streams (``vmp.owner_plans``, empty unless ``device`` is CUDA).
    Pure host work, no CUDA call, so it can run on a prefetch thread:
    :func:`device_put_batch` places the result on a device.  ``times`` (a
    dict) gets the host ms of the slicing and of the plans under
    ``"slice"`` and ``"plan"``.  ``slicer(groups, caps_fn) -> (arrays,
    dirs, caps, n_tokens)`` selects the corpus view: by default
    ``compiler.slice_arrays`` over the resident ``program``; the
    out-of-core path binds ``data.store.slice_sharded`` (the same contract,
    reading only the shards the batch touches).  ``plan`` (a sharding
    plan) belongs to the distributed slice.
    """
    if plan is not None:
        later_slice("a sharded batch (plan=)", "distributed")
    if slicer is None:
        slicer = functools.partial(slice_arrays, program)
    device = torch.device("cuda" if device is None else device)
    t0 = time.perf_counter()
    arrays, dirs, caps, n_tok = slicer(groups, caps_fn)
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
            later_slice("validate=True (the static pre-flight)", "analysis")
        if plan is not None:
            later_slice("a sharding plan (plan=)", "distributed")
        if hosts is not None:
            later_slice("multi-host corpora (hosts=)", "distributed")
        self.device = resolve_device(device)
        self.corpus = corpus
        self._slicer = None
        if self.cfg.growing and corpus is None:
            raise ValueError("growing=True needs corpus= (a ShardedCorpus "
                             "being appended to by a live writer)")
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
                loader=self._load_groups, prefetch=self.cfg.prefetch,
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
        # a list to record, per step, the host ms of its slicing, owner
        # plans and host-to-device copy ({"slice", "plan", "h2d"}), and in
        # corpus mode the caller's wait on the prefetcher ("wait")
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

    def _load_groups(self, groups):
        """Host batch of one group set for the engine's device: runs on the
        prefetch thread in corpus mode (numpy and host plans only).  Returns
        ``(batch, caps, n_tokens, n_groups, {"slice", "plan"} host ms)``."""
        if self.cfg.growing:
            # refresh() rebinds corpus.lengths wholesale; re-fetch so the
            # weights cover newly committed documents
            self._weights = np.asarray(self.corpus.lengths, np.int64)
        times: dict = {}
        hb, caps, n_tok = host_batch(self.program, groups, self._caps_fn,
                                     device=self.device, times=times,
                                     slicer=self._slicer)
        return hb, caps, n_tok, len(groups), times

    def step(self, t: int, state: VMPState):
        """One SVI step at schedule position ``t``; returns (state', elbo)."""
        t0 = time.perf_counter()
        if self.corpus is not None:
            hb, caps, _, n_b, times = self.sampler.host_batch_at(t)
        else:
            hb, caps, _, n_b, times = self._load_groups(
                self.sampler.batch_at(t))
        t1 = time.perf_counter()
        batch = device_put_batch(hb, self.device)
        if self.host_ms is not None:
            rec = dict(times, h2d=(time.perf_counter() - t1) * 1e3)
            if self.corpus is not None:
                rec["wait"] = (t1 - t0) * 1e3
            self.host_ms.append(rec)
        sig = tuple(sorted(caps.items()))
        if sig not in self._steps:
            self._steps[sig] = make_svi_step(
                self.program, caps, local_iters=self.cfg.local_iters,
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
        return heldout_elbo(self.program, state, self.holdout,
                            self.cfg.holdout_local_iters,
                            cache=self._heldout_cache, slicer=self._slicer)

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
