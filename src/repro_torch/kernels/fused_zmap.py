"""CUDA kernel: the segment-latent substep (SLDA sentences, naive Bayes).

Replaces the Pallas TPU kernel ``repro/kernels/fused_zmap.py:zstats_zmap``
(``_phase_logits`` / ``_logits_kernel``, ``_phase_stats`` /
``_stats_kernel``, and its ``extra=`` / ``emit_r=`` use of
``fused_zstats._zstats_call``).  A segment latent owns a token plate nested
below its own: each child with a ``zmap`` maps token t to latent instance
``zmap[t]``, so the instance's logits need a sum over its tokens before the
softmax.  The kernel runs in three phases, all from ``csrc/zstats.cu`` (the
source note says what bounds them on the H100):

  1. ``zmap_logits``: per zmap child, in child order, each instance's row of
     the ``(n_latent, K)`` logits sums ``mask[t] * message(t)`` over its
     tokens, in f64 rounded once to f32 (a naive Bayes document's logits
     reach thousands of nats, where an f32 sum loses what decides r near a
     tie);
  2a. the flat kernel's passes (``fused_zstats.launch_flat``) over the
     latent instances, with those logits added after the prior row: the
     softmax, lse, prior stats and any child without a zmap, writing r;
  2b. per zmap child, ``stats[row(k), v_t] += mask[t] * r[zmap[t], k]``
     on the pass :func:`build_zmap_plan` chose (``ZmapPlan.kinds``):
     ``zmap_stats`` for a specialized child (SLDA's phi), ``zmap_runs`` for
     a strided child whose rows ``base + stride * k`` are one to one over
     its (base, k) (DCM-SLDA's per-document phi: a lane group a (base,
     value) run stores the run's K cells once), ``zmap_strided`` for one
     whose rows collide (a warp walks each value column).

Owner passes, as in ``fused_zstats``: the host groups each zmap child's
tokens by instance (phase 1) and by value, or by (base, value) run (phase
2b), once per program (:func:`build_zmap_plan`), so no float atomics run
and two calls are bitwise equal.  The plan also holds each pass's token
streams gathered into its piece order (:func:`zmap_streams`), so no pass
reads a permutation, and routes phase 1 (:func:`latent_route`): an
instance of one piece (an SLDA sentence) gets its logits row from that
piece, an instance of several (a naive Bayes document) from f64 partials
that a finishing pass adds in order.  What the TPU kernel did only for the
TPU is gone: the 8 MiB budget that sent SLDA at NYTimes widths to the
chunked oracle (``fusable_zmap``), the one-hot matmuls and the padding.
The plain version is ``ref.zstats`` (its segmented path); ``ops`` runs it
on the CPU.

Spans (``repro_torch.trace``): :func:`zstats_zmap` opens ``zmap.logits``
around phase 1, ``zmap.prior`` around phase 2a and ``zmap.stats`` around
phase 2b (every zmap child's pass, its zero fill included), children of
the caller's span (``vmp.token_plate`` in a VMP step).  They add no sync,
launch or allocation of their own; recorded on the card, each holds a CUDA
event pair.
"""

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import trace
from . import fused_zstats as _fz

#: a ``zmap_logits`` call's phase 1 by route (:func:`logits_route`),
#: counted as ``kernels.routes.zmap_logits.<route>`` with the call's
#: ``kernels.launches.zmap_logits`` (``trace.count``)
LOGITS_ROUTES = ("group", "warp")
#: a ``zstats_zmap`` call's child stats passes by kind (:func:`pass_kinds`)
#: and its zmap children's phase 1 by route, counted as
#: ``kernels.routes.zstats_zmap.<route>`` with ``kernels.launches.zstats_zmap``
ROUTES = _fz.ROUTES + LOGITS_ROUTES


@dataclasses.dataclass
class ZmapPlan:
    """The owner plan of one segment latent: phase 2a's flat plan (the
    prior rows over the latent instances, the children without a zmap), per
    zmap child its tokens grouped by instance and by value (by (base,
    value) run where its pass is ``"runs"``), :func:`zmap_streams`' arrays
    (each pass's streams in its piece order, phase 1's routes), and
    ``kinds``, per zmap child its phase 2b pass (``fused_zstats.pass_kind``).
    """
    flat: Optional[_fz.ZPlan]
    by_latent: tuple
    by_value: tuple
    device: Optional[torch.device] = None
    tensors: dict = dataclasses.field(default_factory=dict)
    streams: dict = dataclasses.field(default_factory=dict)
    kinds: tuple = ()

    def host_arrays(self) -> dict:
        """``{key: numpy array}`` of the zmap groupings and streams (the
        flat plan's are its own)."""
        named = [(f"latent{i}", g) for i, g in enumerate(self.by_latent)] + \
            [(f"value{i}", g) for i, g in enumerate(self.by_value)]
        arrays = _fz.grouping_arrays(named)
        arrays.update(self.streams)
        return arrays

    @property
    def nbytes(self) -> int:
        """Bytes of the plan's host arrays, the flat plan's included."""
        return sum(a.nbytes for a in self.host_arrays().values()) + \
            (self.flat.nbytes if self.flat is not None else 0)

    def to(self, device) -> "ZmapPlan":
        """A copy whose index arrays also live on ``device``."""
        device = _fz.placed(device)
        arrays = self.host_arrays()
        flat = self.flat.to(device) if self.flat is not None else None
        return ZmapPlan(flat, self.by_latent, self.by_value, device,
                        _fz.device_arrays(arrays, device), self.streams,
                        self.kinds)


def _split(children):
    """(children with a zmap, children without)."""
    return (tuple(c for c in children if c.zmap is not None),
            tuple(c for c in children if c.zmap is None))


def _by_latent(zkids, n_latent: int, piece: int) -> tuple:
    return tuple(_fz.group_tokens(_fz.host(c.zmap), n_latent, piece)
                 for c in zkids)


def latent_route(g: _fz.Grouping) -> dict:
    """Phase 1's route through a grouping by instance: ``slot`` (per piece:
    -1 where the piece is its instance's only one and writes the logits row
    itself, else its row of the f64 partials, consecutive per instance),
    ``fkeys`` (the instances the finishing pass writes: those of several
    pieces, and those of none, whose row is zero) and ``fstart`` (instance
    ``fkeys[m]`` adds partial rows ``fstart[m]:fstart[m + 1]``)."""
    n_per = np.diff(g.key_pieces)
    multi = n_per != 1
    in_multi = multi[g.piece_key]
    slot = np.where(in_multi, np.cumsum(in_multi) - 1, -1)
    fstart = np.zeros(int(multi.sum()) + 1, np.int64)
    np.cumsum(n_per[multi], out=fstart[1:])
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return {"slot": i32(slot), "fkeys": i32(np.flatnonzero(multi)),
            "fstart": i32(fstart)}


def _gathered(name: str, g: _fz.Grouping, c, fields) -> dict:
    """``{(name, field): array}``: child ``c``'s token streams ``fields``
    gathered into ``g``'s piece order; nothing where ``g`` keeps the
    call's order, so the pass reads the call's own arrays."""
    if g.identity:
        return {}
    return {(name, f): _fz.host(getattr(c, f))[g.perm] for f in fields
            if getattr(c, f) is not None}


def zmap_streams(zkids, by_latent, by_value, kinds=()) -> dict:
    """``{(pass, field): array}`` for the segment passes: phase 1's
    (``latent{j}``) values, base and mask of zmap child j in its grouping by
    instance, and its :func:`latent_route`; phase 2b's (``value{j}``) zmap,
    base and mask in its grouping by value, and its values too where its
    pass (``kinds[j]``) is ``"runs"``, whose runs read their value there."""
    out = {}
    for j, (c, g) in enumerate(zip(zkids, by_latent)):
        out.update(_gathered(f"latent{j}", g, c, ("values", "base", "mask")))
        out.update({(f"latent{j}", f): a for f, a in latent_route(g).items()})
    for j, (c, g) in enumerate(zip(zkids, by_value)):
        runs = j < len(kinds) and kinds[j] == "runs"
        out.update(_gathered(f"value{j}", g, c, ("zmap", "base", "mask")
                             + (("values",) if runs else ())))
    return out


def build_zmap_plan(prior_rows, children, prior_shape: tuple,
                    piece: int = _fz.PIECE,
                    per_column: bool = False) -> ZmapPlan:
    """The owner plan from the static index streams (tensors or arrays).
    Phase 2b groups a specialized zmap child's tokens by value (``"pieces"``),
    a strided one's by (base, value) run where its rows are one to one over
    its (base, k) (``fused_zstats.rows_one_to_one``: ``"runs"``), and any
    other's by value (``"strided"``).  ``per_column`` gives every strided
    zmap child the per-column ``"strided"`` pass, the route the runs pass
    replaced, so that the two can be held to each other and timed.  Raises
    on an index the kernel would read or write out of bounds, and when no
    child has a zmap."""
    zkids, flat = _split(children)
    if not zkids:
        raise ValueError("no child has a zmap; fused_zstats.build_plan "
                         "plans a flat latent")
    k = prior_shape[1]
    by_value, kinds = [], []
    for i, c in enumerate(zkids):
        _fz.check_strided_rows(i, c, k)
        base = _fz.host(c.base) if c.base is not None else None
        kinds.append(_fz.pass_kind(c, not c.specialized and not per_column
                                   and _fz.rows_one_to_one(base, c.stride, k)))
        values = _fz.host(c.values)
        by_value.append(
            _fz.group_runs(values, base, c.elog.shape[1])
            if kinds[-1] == "runs" else
            _fz.group_tokens(values, c.elog.shape[1], piece))
    by_latent = _by_latent(zkids, len(prior_rows), piece)
    by_value, kinds = tuple(by_value), tuple(kinds)
    return ZmapPlan(_fz.build_plan(prior_rows, flat, prior_shape, piece),
                    by_latent, by_value,
                    streams=zmap_streams(zkids, by_latent, by_value, kinds),
                    kinds=kinds)


def _check_device(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def _pass_args(base, plan: ZmapPlan, name: str, j: int):
    """The ZArgs of segment pass ``name`` over zmap child ``j``: ``base``
    with the child's streams in the pass's piece order in their place."""
    a = _fz._Args.from_buffer_copy(base)
    for f in ("values", "base", "mask", "zmap"):
        if (name, f) in plan.tensors:
            setattr(a.c[j], f, plan.tensors[name, f].data_ptr())
    return a


def pass_kinds(children, plan: ZmapPlan) -> tuple:
    """Per child in order, its stats pass as the plan chose it: a zmap
    child's phase 2b (``ZmapPlan.kinds``: ``"pieces"``, ``"runs"`` or
    ``"strided"``), a child without a zmap's in phase 2a's flat plan
    (``ZPlan.kinds``)."""
    zmap, flat = iter(plan.kinds), iter(plan.flat.kinds)
    return tuple(next(zmap) if c.zmap is not None else next(flat)
                 for c in children)


def logits_route(g: _fz.Grouping) -> str:
    """Phase 1's kernel for a grouping by instance: "warp" (a warp a piece)
    where instances are cut into several pieces (naive Bayes' documents),
    else "group" (a few lanes a piece: SLDA's sentences)."""
    return "warp" if g.n_pieces > g.n_keys else "group"


def _logits(lib, zargs, plan: ZmapPlan, n_latent: int, k: int, stream):
    """Phase 1: the ``(n_latent, K)`` f32 logits, zmap children in order,
    each instance's row written by its one piece or by the finish of its
    f64 partials."""
    dev = plan.device
    t = plan.tensors
    logits = torch.empty((n_latent, k), dtype=torch.float32, device=dev)
    for j, g in enumerate(plan.by_latent):
        name = f"latent{j}"
        fkeys = plan.streams[name, "fkeys"]
        partial = torch.empty((int(plan.streams[name, "fstart"][-1]), k),
                              dtype=torch.float64, device=dev)
        args = _pass_args(zargs, plan, name, j)
        _fz.check_launch(lib.zmap_logits(
            ctypes.addressof(args), j, t[name, "piece_key"].data_ptr(),
            t[name, "piece_start"].data_ptr(), t[name, "slot"].data_ptr(),
            g.n_pieces, partial.data_ptr(), logits.data_ptr(), int(j > 0),
            int(logits_route(g) == "warp"), stream), "zmap_logits")
        _fz.check_launch(lib.zstats_finish64(
            partial.data_ptr(), t[name, "fkeys"].data_ptr(),
            t[name, "fstart"].data_ptr(), len(fkeys), k, logits.data_ptr(), k,
            1, int(j > 0), stream), "finish64")
    return logits


def _stats_pass(lib, zargs, plan: ZmapPlan, j: int, c, r: torch.Tensor,
                stream) -> torch.Tensor:
    """Phase 2b of zmap child ``j`` (``c``) on the pass the plan chose for
    it: its ``(Gf, Kf)`` f32 stats from the ``(n_latent, K)``
    responsibilities ``r``."""
    gf, kf = c.elog.shape
    k, dev, t = r.shape[1], r.device, plan.tensors
    g, name, kind = plan.by_value[j], f"value{j}", plan.kinds[j]
    args = _pass_args(zargs, plan, name, j)
    if kind == "pieces":
        cs = torch.empty((gf, kf), dtype=torch.float32, device=dev)
        partial = torch.empty((g.n_pieces, k), dtype=torch.float32,
                              device=dev)
        _fz.check_launch(lib.zmap_stats(
            ctypes.addressof(args), j, r.data_ptr(),
            t[name, "piece_start"].data_ptr(), g.n_pieces,
            partial.data_ptr(), stream), "zmap_stats")
        _fz.finish(lib, partial, t, name, kf, k, cs, 1, kf, stream)
        return cs
    # the cells that no token reaches stay 0
    cs = torch.zeros((gf, kf), dtype=torch.float32, device=dev)
    launch = lib.zmap_runs if kind == "runs" else lib.zmap_strided
    _fz.check_launch(launch(
        ctypes.addressof(args), j, r.data_ptr(),
        t[name, "key_start"].data_ptr(), g.n_keys, cs.data_ptr(), stream),
        f"zmap_{kind}")
    return cs


def zstats_zmap(table_prior: torch.Tensor, prior_rows: torch.Tensor,
                children: tuple, zmask: Optional[torch.Tensor] = None, *,
                tables: str = "elog", plan: Optional[ZmapPlan] = None):
    """Segment-latent substep: ``(lse_sum, prior_stats, child_stats)``.

    Arguments and results as ``ref.zstats``, where at least one child
    carries a ``zmap`` (its token streams have their own length).  ``plan``
    is :func:`build_zmap_plan`'s, built here when not given.  CUDA tensors
    only: the kernel runs or the call raises.
    """
    zkids, flat = _split(children)
    if not zkids:
        raise ValueError("no child has a zmap; fused_zstats.zstats takes a "
                         "flat latent")
    _check_device(table_prior)
    _fz.check_inputs(table_prior, prior_rows, children, zmask)
    dev = table_prior.device
    if plan is None:
        plan = build_zmap_plan(prior_rows, children, tuple(table_prior.shape))
    if plan.device != dev:
        plan = plan.to(dev)
    eprior, etabs = _fz.elog_tables(table_prior, children, tables)
    ztabs = [t for c, t in zip(children, etabs) if c.zmap is not None]
    ftabs = [t for c, t in zip(children, etabs) if c.zmap is None]
    lib = _fz.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_latent, k = prior_rows.shape[0], table_prior.shape[1]
    zargs = _fz.make_args(k, zkids, ztabs)

    with trace.span("zmap.logits"):
        logits = _logits(lib, zargs, plan, n_latent, k, stream)
    with trace.span("zmap.prior"):
        r = torch.empty((n_latent, k), dtype=torch.float32, device=dev)
        lse_sum, pstats, fstats = _fz.launch_flat(
            eprior, prior_rows, flat, ftabs, zmask, plan.flat, extra=logits,
            r_out=r)
    del logits

    with trace.span("zmap.stats"):
        zout = [_stats_pass(lib, zargs, plan, j, c, r, stream)
                for j, c in enumerate(zkids)]
    zit, fit = iter(zout), iter(fstats)
    cstats = tuple(next(zit) if c.zmap is not None else next(fit)
                   for c in children)
    trace.count("kernels.launches.zstats_zmap")
    for kind in pass_kinds(children, plan):
        trace.count(f"kernels.routes.zstats_zmap.{kind}")
    for g in plan.by_latent:
        trace.count(f"kernels.routes.zstats_zmap.{logits_route(g)}")
    return lse_sum, pstats, cstats


def zmap_logits(children: tuple, n_latent: int, k: int, *,
                tables: str = "elog", plan: Optional[ZmapPlan] = None):
    """Phase 1 alone: the ``(n_latent, K)`` f32 sum, over every child (each
    with a ``zmap``) in order, of ``mask[t] * message(t)`` into row
    ``zmap[t]``.  The plain version is ``ref.zmap_logits``.  ``plan`` — a
    :func:`build_zmap_plan` result whose zmap children are ``children``, or
    None to group them here.  CUDA tensors only."""
    if not children or any(c.zmap is None for c in children):
        raise ValueError("zmap_logits takes children that all have a zmap")
    _check_device(children[0].elog)
    if not 1 <= k <= _fz._MAX_K or len(children) > _fz._MAX_CHILDREN:
        raise ValueError(f"zmap_logits takes 1 <= K <= {_fz._MAX_K} and at "
                         f"most {_fz._MAX_CHILDREN} children")
    dev = children[0].elog.device
    checks = []
    for i, c in enumerate(children):
        checks += _fz.child_checks(i, c, k, n_latent)
    _fz.check_tensors(checks, dev)
    if plan is None:
        for i, c in enumerate(children):
            _fz.check_strided_rows(i, c, k)
        by_latent = _by_latent(children, n_latent, _fz.PIECE)
        plan = ZmapPlan(None, by_latent, (),
                        streams=zmap_streams(children, by_latent, ()))
    if plan.device != dev:
        plan = plan.to(dev)
    tabs = [_fz.elog_table(c.elog, tables, c.specialized) for c in children]
    zargs = _fz.make_args(k, children, tabs)
    out = _logits(_fz.library(), zargs, plan, n_latent, k,
                  torch.cuda.current_stream(dev).cuda_stream)
    trace.count("kernels.launches.zmap_logits")
    for g in plan.by_latent:
        trace.count(f"kernels.routes.zmap_logits.{logits_route(g)}")
    return out
