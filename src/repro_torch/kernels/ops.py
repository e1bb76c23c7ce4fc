"""Dispatch layer over the port's kernels.

Dispatch goes by the tensor's device, never by an environment variable, and
this module is the one place that looks: a CPU tensor runs the plain PyTorch
version from ``ref.py``, a ``meta`` tensor is counted (below), any other
tensor goes to the Hopper kernel's wrapper (CUDA C++ for ``zstats``,
``zstats_zmap``, ``zmap_logits`` and ``flash_attention``, Triton for
``dirichlet_expectation``, ``dirichlet_elbo_term``, ``dirichlet_update``
and ``zstep``).  The wrappers take CUDA tensors
only and raise on any other device: nothing on the card falls back to a
plain version.

``meta`` tensors stand in for the card's in a dry run
(``launch.step_cost.count``): there a kernel call returns empty ``meta``
outputs of the kernel's shapes and dtypes and hands the count its kernel,
the routes it would launch (those :func:`routing` names) and its work
(``kernels/work.py``), one launch; ``flash_attention``'s backward still
recomputes through the plain version, as on the card.  Outside a count a
``meta`` tensor raises.  Each kernel wrapper counts its launches and the
routes they took as counters of ``repro_torch.trace``
(``kernels.launches.<kernel>``, ``kernels.routes.<kernel>.<route>``), read
here by :func:`launch_counts` and :func:`route_counts`.
:func:`routing` says, before anything runs, which route a ``zstats`` call
takes, from the same functions the wrappers launch by.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple

import torch

from .. import trace
from . import dirichlet_expectation as _de
from . import dirichlet_terms as _dt
from . import flash_attention as _fa
from . import fused_zmap as _fzm
from . import fused_zstats as _fz
from . import ref
from . import vmp_zstep as _zs
from . import work as _work
from .ref import ZChild


def _plain(t: torch.Tensor) -> bool:
    """True where the plain version runs: on a CPU tensor."""
    return t.device.type == "cpu"


def _dry(t: torch.Tensor) -> bool:
    """True where a cost count takes the call: on a ``meta`` tensor."""
    return t.device.type == "meta"


def _sink(name: str):
    """The active cost count, which a kernel call on ``meta`` tensors needs:
    outside one it raises."""
    sink = _work.active()
    if sink is None:
        raise ValueError(f"{name}: a meta tensor runs no kernel; count the "
                         f"call inside launch.step_cost.count")
    return sink


def _count(name: str, routes: dict, work: tuple) -> None:
    """Hand one launch of kernel ``name`` to the active cost count."""
    _sink(name).kernel(name, routes, *work)


def dirichlet_expectation(alpha: torch.Tensor,
                          transpose: bool = False) -> torch.Tensor:
    """Rowwise expected log under a Dirichlet: ``digamma(alpha) -
    digamma(alpha.sum(-1, keepdim=True))`` of a ``(G, K)`` concentration
    table (f32 or bf16), as float32 ``(G, K)``, or ``(K, G)`` when
    ``transpose``.  The VMP step's Elog tables, which the token plate, the
    statics and the Dirichlet ELBO terms share."""
    if _dry(alpha):
        _count("dirichlet_expectation", {},
               _work.dirichlet_expectation(alpha))
        g, k = alpha.shape
        return alpha.new_empty((k, g) if transpose else (g, k),
                               dtype=torch.float32)
    if not _plain(alpha):
        return _de.dirichlet_expectation(alpha, transpose)
    out = ref.dirichlet_expectation(alpha.float())
    return out.T.contiguous() if transpose else out


def dirichlet_elbo_term(prior: torch.Tensor, post: torch.Tensor,
                        elog: torch.Tensor) -> torch.Tensor:
    """A Dirichlet's ELBO term, ``E_q[log p(theta)] - E_q[log q(theta)]``
    summed over the rows of a ``(G, K)`` f32 posterior table, as a 0-d f32
    tensor: ``prior`` is its ``(1, K)`` prior row, ``elog`` its Elog table
    (any strides: LDA's phi is a transposed view).  On the card each sum
    runs in a fixed order and the rows' sum in f64
    (``dirichlet_terms.elbo_term``)."""
    if _dry(post):
        g, k = post.shape
        plan = _dt.elbo_plan(g, k, _dt.transposed(elog))
        _count("dirichlet_elbo_term", {plan.route: 1},
               _work.dirichlet_elbo_term(post, elog))
        return post.new_empty((), dtype=torch.float32)
    if _plain(post):
        return ref.dirichlet_elbo_term(prior, post, elog)
    return _dt.elbo_term(prior, post, elog)


def dirichlet_update(prior: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """A Dirichlet's new posterior ``prior + stats``: the ``(1, K)``
    prior row added to each row of the ``(G, K)`` f32 stats, the same f32
    add on every device."""
    if _dry(stats):
        _count("dirichlet_update", {}, _work.dirichlet_update(stats))
        return stats.new_empty(stats.shape, dtype=torch.float32)
    if _plain(stats):
        return ref.dirichlet_update(prior, stats)
    return _dt.update(prior, stats)


def zstep(logits: torch.Tensor):
    """Rowwise softmax with its normalizer: ``(r, lse)`` where ``r`` is the
    ``(N, K)`` float32 responsibilities ``softmax(logits, -1)`` and ``lse``
    the ``(N,)`` float32 ``logsumexp(logits, -1)``."""
    if _dry(logits):
        _count("zstep", {}, _work.zstep(logits))
        return (logits.new_empty(logits.shape, dtype=torch.float32),
                logits.new_empty(logits.shape[:1], dtype=torch.float32))
    return ref.zstep(logits) if _plain(logits) else _zs.zstep(logits)


def _segmented(children) -> bool:
    """True for a segment latent: a child maps tokens to instances."""
    return any(c.zmap is not None for c in children)


def host_plan(prior_shape: tuple, prior_rows, children):
    """The kernel's owner plan for these index streams, built on the host:
    ``fused_zstats.ZPlan`` for a flat latent, ``fused_zmap.ZmapPlan`` for a
    segment latent, its ``.to(device)`` not yet taken.  The streams may be
    numpy arrays or tensors; of the tables (``prior_shape`` and each child's
    ``elog``) it reads only the shapes, so a child may carry a stand-in of
    its table's shape (``vmp.owner_plans``)."""
    build = _fzm.build_zmap_plan if _segmented(children) else _fz.build_plan
    return build(prior_rows, children, tuple(prior_shape))


def zstats_plan(table_prior, prior_rows, children):
    """The kernel's owner plan for these index streams (:func:`host_plan`),
    on their device; ``None`` on the CPU, where no kernel runs.  ``None`` is
    always safe to pass back as ``zstats(..., plan=)``."""
    if _plain(table_prior):
        return None
    return host_plan(table_prior.shape, prior_rows,
                     children).to(table_prior.device)


#: the H100's L2 cache (NVIDIA data sheet), set beside the Elog tables in a
#: route for information: the passes gather from device memory at any size
L2_BYTES = 50 * 2 ** 20


class RouteInfo(NamedTuple):
    """The route of one :func:`zstats` call, as metadata.  ``path`` is what
    runs:

      - ``"plain"`` -- ``ref.zstats``, on CPU tensors;
      - ``"flat"``  -- the owner passes of ``fused_zstats.launch_flat``;
      - ``"zmap"``  -- ``fused_zmap.zstats_zmap`` (a child has a zmap).

    ``passes`` names, per child in order, its stats pass on the card
    (``fused_zstats.pass_kind``: ``"pieces"``, ``"runs"`` or
    ``"strided"``, as the owner plan chose it); ``logits``,
    per child with a zmap, the route of phase 1 (``fused_zmap.logits_route``:
    ``"group"`` or ``"warp"``); both are empty for ``"plain"``.
    ``table_bytes`` is the f32 Elog tables the passes gather from, set
    against ``l2_bytes`` (:data:`L2_BYTES`) for information only;
    ``plan_bytes`` the owner plan's host arrays (``ZPlan.nbytes``);
    ``reason`` says why in one sentence.
    """
    path: str
    backend: str
    tables: str
    table_dtype: str
    passes: tuple
    logits: tuple
    table_bytes: int
    l2_bytes: int
    plan_bytes: int
    reason: str

    @property
    def label(self) -> str:
        """:func:`route_label` of this route."""
        return route_label(self.path, self.passes, self.logits)


def route_label(path: str, passes=(), logits=()) -> str:
    """A route in one word group: ``path``, then the passes and the logits
    routes where there are any (``"flat passes=pieces"``, ``"zmap
    passes=pieces logits=group"``, ``"plain"``)."""
    out = path
    if passes:
        out += " passes=" + ",".join(passes)
    if logits:
        out += " logits=" + ",".join(logits)
    return out


def routing(table_prior, prior_rows=None, children=(), *,
            tables: str = "elog", backend: str = "cuda",
            plan=None) -> RouteInfo:
    """The route a :func:`zstats` call on these arguments takes, without
    launching anything or touching a device.

    Of the tables (``table_prior`` and each child's ``elog``) only the
    shapes and dtype are read: real tensors or stand-ins of their shape.
    ``backend="cuda"`` (the default) plans the card's route from anywhere,
    the CPU included; ``"cpu"`` gives ``"plain"``.  On the card, phase 1's
    route depends on how the index streams group (``logits_route``: an
    instance of several pieces), not on shapes alone, so the route is read
    from the owner plan: ``plan`` (a :func:`host_plan` result), or one
    built here from ``prior_rows`` and the children's streams (numpy arrays
    or tensors).  So is a strided child's stats pass: ``"runs"`` where its
    rows ``base + stride * k`` are one to one over the bases its tokens
    use, else ``"strided"``.  The passes and the logits routes come from
    the plan and the functions the wrappers launch by, so this and the
    dispatch cannot drift.
    """
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"backend must be 'cuda' or 'cpu', not {backend!r}")
    dtype = str(getattr(table_prior, "dtype", "float32")).replace("torch.", "")
    shapes = [tuple(table_prior.shape)] + [tuple(c.elog.shape)
                                          for c in children]
    table_bytes = 4 * sum(math.prod(s) for s in shapes)

    def _route(path, passes=(), logits=(), plan_bytes=0, reason=""):
        return RouteInfo(path, backend, tables, dtype, tuple(passes),
                         tuple(logits), table_bytes, L2_BYTES, plan_bytes,
                         reason)

    if backend == "cpu":
        return _route("plain", reason="CPU tensors: the plain PyTorch "
                      "version (ref.zstats)")
    if plan is None:
        if prior_rows is None or any(c.values is None for c in children):
            raise ValueError("routing(backend='cuda') reads the owner plan: "
                             "pass the index streams or plan=")
        plan = host_plan(table_prior.shape, prior_rows, children)
    if _segmented(children):
        logits = [_fzm.logits_route(g) for g in plan.by_latent]
        return _route("zmap", _fzm.pass_kinds(children, plan), logits,
                      plan.nbytes,
                      "segment latent: phase 1 sums each instance's logits "
                      "over its tokens, then the flat passes and each zmap "
                      "child's stats pass (fused_zmap.zstats_zmap)")
    return _route("flat", plan.kinds, (), plan.nbytes,
                  "flat latent: owner passes over the tokens grouped by "
                  "prior row, then by each child's value, or by (base, "
                  "value) run on the runs pass (fused_zstats.launch_flat)")


def zstats(table_prior: torch.Tensor, prior_rows: torch.Tensor,
           children: tuple, zmask=None, *, tables: str = "elog", plan=None):
    """Fused token-plate substep: ``(lse_sum, prior_stats, child_stats)``.

    Inputs: ``table_prior`` — the ``(G, K)`` prior-Dirichlet table;
    ``prior_rows`` — ``(N,) int32`` row of each latent instance;
    ``children`` — a tuple of :class:`ZChild`; ``zmask`` — optional
    ``(n_latent,) float32`` validity mask.  With ``tables="elog"`` the
    tables hold Elog expectations; with ``tables="alpha"`` they hold
    Dirichlet concentrations (f32 or bf16) and the expectations are
    computed first.  Returns the scalar float32 sum of per-instance
    logsumexp, the ``(G, K)`` float32 prior stats, and per child a
    ``(Gc, Kc)`` float32 stats table.  ``plan`` — an optional
    :func:`zstats_plan` result for exactly these index streams: cached per
    program by ``core/vmp.py``, built per minibatch by ``core/svi.py``.

    On the CPU this is ``ref.zstats`` (flat and segment latents).  On CUDA
    a flat latent runs the ``fused_zstats`` kernel and a segment latent
    (a child with a ``zmap``) the ``fused_zmap`` kernel, both from
    ``csrc/zstats.cu``.
    """
    if _plain(table_prior):
        return ref.zstats(table_prior, prior_rows, children, zmask,
                          tables=tables)
    if _dry(table_prior):
        return _dry_zstats(table_prior, prior_rows, children, zmask, tables,
                           plan)
    run = _fzm.zstats_zmap if _segmented(children) else _fz.zstats
    return run(table_prior, prior_rows, children, zmask, tables=tables,
               plan=plan)


def zmap_logits(children: tuple, n_latent: int, k: int, *,
                tables: str = "elog", plan=None) -> torch.Tensor:
    """A segment latent's logits from its children with a ``zmap``: the
    ``(n_latent, K)`` float32 sum, over ``children`` in order, of each
    token's masked message into row ``zmap[t]``.  ``plan`` — the latent's
    :func:`zstats_plan` when ``children`` are all its children with a zmap,
    or None.  On the CPU ``ref.zmap_logits``; on CUDA phase 1 of the
    ``fused_zmap`` kernel."""
    if _plain(children[0].elog):
        return ref.zmap_logits(children, n_latent, k, tables=tables)
    if _dry(children[0].elog):
        _sink("zmap_logits")
        if plan is None:
            raise ValueError("zmap_logits on meta tensors reads its route "
                             "from the owner plan: pass plan=")
        _count("zmap_logits", dict(collections.Counter(
            _fzm.logits_route(g) for g in plan.by_latent)),
            _work.zmap_logits(children, n_latent, k))
        return children[0].elog.new_empty((n_latent, k), dtype=torch.float32)
    return _fzm.zmap_logits(children, n_latent, k, tables=tables, plan=plan)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Tiled attention ``softmax(q k^T / sqrt(Dh)) v`` without the (S, S)
    score matrix in device memory.  ``q`` is ``(BH, Sq, Dh)``, ``k``/``v``
    ``(BH, Sk, Dh)`` (batch and heads flattened together), bf16 or f32;
    returns ``q``'s shape and dtype.  ``causal`` applies the autoregressive
    mask ``kpos <= qpos``.  Differentiable.  On the CPU
    ``ref.flash_attention``; on CUDA the ``flash_attention`` kernel, whose
    backward recomputes through the plain version."""
    if _plain(q):
        return ref.flash_attention(q, k, v, causal=causal)
    if _dry(q):
        return _DryFlash.apply(q, k, v, causal)
    return _fa.flash_attention(q, k, v, causal=causal)


def _dry_zstats(table_prior, prior_rows, children, zmask, tables, plan):
    """:func:`zstats` on ``meta`` tensors: the kernel's outputs, empty, and
    its launch counted at the route of ``plan`` (which a call on meta
    tensors needs: its streams hold no values to plan from); with
    ``tables="alpha"`` the wrapper's Elog pass over each table too."""
    _sink("zstats")
    if plan is None:
        raise ValueError("zstats on meta tensors reads its route from the "
                         "owner plan: pass plan= (vmp.owner_plans builds it "
                         "on the host)")
    info = routing(table_prior, prior_rows, children, tables=tables,
                   plan=plan)
    if tables == "alpha":
        for t in (table_prior, *(c.elog for c in children)):
            _count("dirichlet_expectation", {},
                   _work.dirichlet_expectation(t))
    seg = _segmented(children)
    _count("zstats_zmap" if seg else "zstats",
           dict(collections.Counter(info.passes + info.logits)),
           (_work.zstats_zmap if seg else _work.zstats)(
               table_prior, prior_rows, children, zmask))
    f32 = dict(dtype=torch.float32)
    return (table_prior.new_empty((), **f32),
            table_prior.new_empty(table_prior.shape, **f32),
            tuple(c.elog.new_empty(c.elog.shape, **f32) for c in children))


class _DryFlash(_fa.FlashAttention):
    """The kernel's Function on ``meta`` tensors: the forward counts one
    launch at the inputs' route and returns an empty output; the backward
    is the kernel's, a recompute through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        _count("flash_attention", {_fa.route(q, k, v): 1},
               _work.flash_attention(q, k, v, causal))
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return torch.empty_like(q)


#: the routes of each kernel that has them, in :func:`route_counts`' order
_ROUTES = {"zstats": _fz.ROUTES, "zstats_zmap": _fzm.ROUTES,
           "zmap_logits": _fzm.LOGITS_ROUTES, "flash_attention": _fa.ROUTES,
           "dirichlet_elbo_term": _dt.ROUTES}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0, and its counts by route (the
    ``kernels.`` counters of ``repro_torch.trace``; its spans' totals
    stay)."""
    trace.reset("kernels.")


def launch_counts() -> dict:
    """Launches per kernel since the last :func:`reset_launch_counts`."""
    c = trace.counters()
    return {k: c.get(f"kernels.launches.{k}", 0) for k in (
        "zstats", "zstats_zmap", "zmap_logits", "dirichlet_expectation",
        "dirichlet_elbo_term", "dirichlet_update", "zstep",
        "flash_attention")}


def route_counts() -> dict:
    """Launches by route since the last :func:`reset_launch_counts`:
    ``zstats``' and ``zstats_zmap``'s child passes by kind (``"pieces"``,
    ``"runs"``, ``"strided"``), ``zstats_zmap``'s and ``zmap_logits``' zmap
    children's phase 1 by route (``"group"``, ``"warp"``), flash
    attention's kernel (``"wgmma"``, ``"mma"``), the Dirichlet ELBO term's
    tiles (``"rows"``, ``"chunks"``, as ``dirichlet_terms.elbo_plan`` cuts
    the table).  ``zstats``' are the routes :func:`routing` names."""
    c = trace.counters()
    return {k: {r: c.get(f"kernels.routes.{k}.{r}", 0) for r in routes}
            for k, routes in _ROUTES.items()}


__all__ = ["ZChild", "RouteInfo", "routing", "route_label", "L2_BYTES",
           "dirichlet_expectation", "dirichlet_elbo_term", "dirichlet_update",
           "zstep", "zstats", "host_plan",
           "zstats_plan", "zmap_logits", "flash_attention",
           "reset_launch_counts", "launch_counts", "route_counts"]
