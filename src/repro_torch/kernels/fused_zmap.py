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
bitwise equal.  What the TPU kernel did only for the TPU is gone: the
8 MiB budget that sent SLDA at NYTimes widths to the chunked oracle
(``fusable_zmap``), the one-hot matmuls and the padding.  The plain version
is ``ref.zstats`` (its segmented path); ``ops`` runs it on the CPU.
"""

import ctypes
import dataclasses
from typing import Optional

import torch

from . import fused_zstats as _fz

#: ``zstats_zmap`` calls that launched the kernel
launches = 0
#: ``zmap_logits`` calls that launched phase 1 alone
logits_launches = 0


@dataclasses.dataclass
class ZmapPlan:
    """The owner plan of one segment latent: phase 2a's flat plan (the
    prior rows over the latent instances, the children without a zmap), and
    per zmap child its tokens grouped by instance and by value."""
    flat: Optional[_fz.ZPlan]
    by_latent: tuple
    by_value: tuple
    device: Optional[torch.device] = None
    tensors: dict = dataclasses.field(default_factory=dict)

    def to(self, device) -> "ZmapPlan":
        """A copy whose index arrays also live on ``device``."""
        device = torch.device(device)
        named = [(f"latent{i}", g) for i, g in enumerate(self.by_latent)] + \
            [(f"value{i}", g) for i, g in enumerate(self.by_value)]
        flat = self.flat.to(device) if self.flat is not None else None
        return ZmapPlan(flat, self.by_latent, self.by_value, device,
                        _fz.device_arrays(_fz.grouping_arrays(named), device))


def _split(children):
    """(children with a zmap, children without)."""
    return (tuple(c for c in children if c.zmap is not None),
            tuple(c for c in children if c.zmap is None))


def _by_latent(zkids, n_latent: int, piece: int) -> tuple:
    return tuple(_fz.group_tokens(_fz.host(c.zmap), n_latent, piece)
                 for c in zkids)


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
    return ZmapPlan(
        _fz.build_plan(prior_rows, flat, prior_shape, piece),
        _by_latent(zkids, len(prior_rows), piece),
        tuple(_fz.group_tokens(_fz.host(c.values), c.elog.shape[1], piece)
              for c in zkids))


def _check_device(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def _logits(lib, zargs, plan: ZmapPlan, n_latent: int, k: int, stream):
    """Phase 1: the ``(n_latent, K)`` f32 logits, zmap children in order,
    each summed over f64 piece partials."""
    dev = plan.device
    logits = torch.empty((n_latent, k), dtype=torch.float32, device=dev)
    for j, g in enumerate(plan.by_latent):
        name = f"latent{j}"
        partial = torch.empty((g.n_pieces, k), dtype=torch.float64, device=dev)
        _fz.check_launch(lib.zmap_logits(
            ctypes.addressof(zargs), j, plan.tensors[name, "perm"].data_ptr(),
            plan.tensors[name, "piece_start"].data_ptr(), g.n_pieces,
            partial.data_ptr(), stream), "zmap_logits")
        _fz.finish(lib, partial, plan.tensors, name, n_latent, k, logits, k, 1,
                   stream, add=j > 0)
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
    for j, (c, g) in enumerate(zip(zkids, plan.by_value)):
        gf, kf = c.elog.shape
        t = plan.tensors
        name = f"value{j}"
        if c.specialized:
            cs = torch.empty((gf, kf), dtype=torch.float32, device=dev)
            partial = torch.empty((g.n_pieces, k), dtype=torch.float32,
                                  device=dev)
            _fz.check_launch(lib.zmap_stats(
                ctypes.addressof(zargs), j, r.data_ptr(),
                t[name, "perm"].data_ptr(), t[name, "piece_start"].data_ptr(),
                g.n_pieces, partial.data_ptr(), stream), "zmap_stats")
            _fz.finish(lib, partial, t, name, kf, k, cs, 1, kf, stream)
        else:
            cs = torch.zeros((gf, kf), dtype=torch.float32, device=dev)
            _fz.check_launch(lib.zmap_strided(
                ctypes.addressof(zargs), j, r.data_ptr(),
                t[name, "perm"].data_ptr(), t[name, "key_start"].data_ptr(),
                kf, cs.data_ptr(), stream), "zmap_strided")
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
        plan = ZmapPlan(None, _by_latent(children, n_latent, _fz.PIECE), ())
    if plan.device != dev:
        plan = plan.to(dev)
    tabs = [_fz.elog_table(c.elog, tables, c.specialized) for c in children]
    zargs = _fz.make_args(k, children, tabs)
    out = _logits(_fz.library(), zargs, plan, n_latent, k,
                  torch.cuda.current_stream(dev).cuda_stream)
    logits_launches += 1
    return out
