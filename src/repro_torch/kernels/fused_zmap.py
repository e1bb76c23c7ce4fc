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
  2b. ``zmap_stats`` / ``zmap_strided``: per zmap child,
     ``stats[row(k), v_t] += mask[t] * r[zmap[t], k]``.

Owner passes, as in ``fused_zstats``: the host groups each zmap child's
tokens by instance (phase 1) and by value (phase 2b) once per program
(:func:`build_zmap_plan`), so no float atomics run and two calls are
bitwise equal.  The plan also holds each pass's token streams gathered into
its piece order (:func:`zmap_streams`), so no pass reads a permutation, and
routes phase 1 (:func:`latent_route`): an instance of one piece (an SLDA
sentence) gets its logits row from that piece, an instance of several (a
naive Bayes document) from f64 partials that a finishing pass adds in
order.  What the TPU kernel did only for the TPU is gone: the
8 MiB budget that sent SLDA at NYTimes widths to the chunked oracle
(``fusable_zmap``), the one-hot matmuls and the padding.  The plain version
is ``ref.zstats`` (its segmented path); ``ops`` runs it on the CPU.
"""

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import fused_zstats as _fz

#: ``zstats_zmap`` calls that launched the kernel
launches = 0
#: ``zmap_logits`` calls that launched phase 1 alone
logits_launches = 0


@dataclasses.dataclass
class ZmapPlan:
    """The owner plan of one segment latent: phase 2a's flat plan (the
    prior rows over the latent instances, the children without a zmap), per
    zmap child its tokens grouped by instance and by value, and
    :func:`zmap_streams`' arrays (each pass's streams in its piece order,
    phase 1's routes)."""
    flat: Optional[_fz.ZPlan]
    by_latent: tuple
    by_value: tuple
    device: Optional[torch.device] = None
    tensors: dict = dataclasses.field(default_factory=dict)
    streams: dict = dataclasses.field(default_factory=dict)

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
                        _fz.device_arrays(arrays, device), self.streams)


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


def zmap_streams(zkids, by_latent, by_value) -> dict:
    """``{(pass, field): array}`` for the segment passes: phase 1's
    (``latent{j}``) values, base and mask of zmap child j in its grouping by
    instance, and its :func:`latent_route`; phase 2b's (``value{j}``) zmap,
    base and mask in its grouping by value."""
    out = {}
    for j, (c, g) in enumerate(zip(zkids, by_latent)):
        out.update(_gathered(f"latent{j}", g, c, ("values", "base", "mask")))
        out.update({(f"latent{j}", f): a for f, a in latent_route(g).items()})
    for j, (c, g) in enumerate(zip(zkids, by_value)):
        out.update(_gathered(f"value{j}", g, c, ("zmap", "base", "mask")))
    return out


def build_zmap_plan(prior_rows, children, prior_shape: tuple,
                    piece: int = _fz.PIECE) -> ZmapPlan:
    """The owner plan from the static index streams (tensors or arrays).
    Raises on an index the kernel would read or write out of bounds, and
    when no child has a zmap."""
    zkids, flat = _split(children)
    if not zkids:
        raise ValueError("no child has a zmap; fused_zstats.build_plan "
                         "plans a flat latent")
    k = prior_shape[1]
    for i, c in enumerate(zkids):
        _fz.check_strided_rows(i, c, k)
    by_latent = _by_latent(zkids, len(prior_rows), piece)
    by_value = tuple(_fz.group_tokens(_fz.host(c.values), c.elog.shape[1],
                                      piece) for c in zkids)
    return ZmapPlan(_fz.build_plan(prior_rows, flat, prior_shape, piece),
                    by_latent, by_value,
                    streams=zmap_streams(zkids, by_latent, by_value))


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


def zstats_zmap(table_prior: torch.Tensor, prior_rows: torch.Tensor,
                children: tuple, zmask: Optional[torch.Tensor] = None, *,
                tables: str = "elog", plan: Optional[ZmapPlan] = None):
    """Segment-latent substep: ``(lse_sum, prior_stats, child_stats)``.

    Arguments and results as ``ref.zstats``, where at least one child
    carries a ``zmap`` (its token streams have their own length).  ``plan``
    is :func:`build_zmap_plan`'s, built here when not given.  CUDA tensors
    only: the kernel runs or the call raises.
    """
    global launches
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

    logits = _logits(lib, zargs, plan, n_latent, k, stream)
    r = torch.empty((n_latent, k), dtype=torch.float32, device=dev)
    lse_sum, pstats, fstats = _fz.launch_flat(
        eprior, prior_rows, flat, ftabs, zmask, plan.flat, extra=logits,
        r_out=r)
    del logits

    zout = []
    t = plan.tensors
    for j, (c, g) in enumerate(zip(zkids, plan.by_value)):
        gf, kf = c.elog.shape
        name = f"value{j}"
        args = _pass_args(zargs, plan, name, j)
        if c.specialized:
            cs = torch.empty((gf, kf), dtype=torch.float32, device=dev)
            partial = torch.empty((g.n_pieces, k), dtype=torch.float32,
                                  device=dev)
            _fz.check_launch(lib.zmap_stats(
                ctypes.addressof(args), j, r.data_ptr(),
                t[name, "piece_start"].data_ptr(), g.n_pieces,
                partial.data_ptr(), stream), "zmap_stats")
            _fz.finish(lib, partial, t, name, kf, k, cs, 1, kf, stream)
        else:
            cs = torch.zeros((gf, kf), dtype=torch.float32, device=dev)
            _fz.check_launch(lib.zmap_strided(
                ctypes.addressof(args), j, r.data_ptr(),
                t[name, "key_start"].data_ptr(), kf, cs.data_ptr(), stream),
                "zmap_strided")
        zout.append(cs)
    zit, fit = iter(zout), iter(fstats)
    cstats = tuple(next(zit) if c.zmap is not None else next(fit)
                   for c in children)
    launches += 1
    return lse_sum, pstats, cstats


def zmap_logits(children: tuple, n_latent: int, k: int, *,
                tables: str = "elog", plan: Optional[ZmapPlan] = None):
    """Phase 1 alone: the ``(n_latent, K)`` f32 sum, over every child (each
    with a ``zmap``) in order, of ``mask[t] * message(t)`` into row
    ``zmap[t]``.  The plain version is ``ref.zmap_logits``.  ``plan`` — a
    :func:`build_zmap_plan` result whose zmap children are ``children``, or
    None to group them here.  CUDA tensors only."""
    global logits_launches
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
    logits_launches += 1
    return out
