"""CUDA kernel: fused token-plate substep (gather -> softmax -> stats).

Replaces the Pallas TPU kernel ``repro/kernels/fused_zstats.py:zstats``
(``_zstats_call``, ``_kernel``, ``_block_step``), in both its resident and
its streamed layout: on Hopper a warp gathers straight from device memory at
any table size, so one kernel covers the small tables and the 102,660-word
vocabulary alike.  The source is ``csrc/zstats.cu``; it says what bounds the
kernel on the H100 and how its owner passes keep it free of float atomics.

This module holds the three parts around it:

  - :func:`group_tokens` / :func:`build_plan` — the host-side owner plan:
    the tokens grouped by key (the prior row, or a child's value) with a
    numpy stable argsort, each key's run cut into pieces of at most
    :data:`PIECE` tokens, each pass's token streams gathered into its piece
    order, and each token's slot in the softmax statistics that the prior's
    pass hands to the children's.  It depends only on the program's static
    index streams, so ``core/vmp.py`` builds it once per program.
  - the build: ``nvcc`` compiles ``csrc/zstats.cu`` into a shared library
    with a plain C interface under ``build/`` at the repo root (or
    ``$REPRO_TORCH_BUILD_DIR``) at the first launch, keyed by a hash of the
    source (``build.build_library``), and ``ctypes`` loads it.
  - :func:`zstats` — the wrapper, for CUDA tensors only: it launches the
    kernel or raises.  The plain version is ``ref.zstats``, which ``ops``
    runs on the CPU.  Its passes (:func:`launch_flat`) are also phase 2a of
    the segment-latent kernel in ``fused_zmap``, which shares the library.

The kernel reads f32 Elog tables, a specialized child's as (V, K) so that
one token's K-vector message is contiguous.  The VMP step hands them over
in that layout (``tables="elog"``); with ``tables="alpha"`` the Triton
``dirichlet_expectation`` kernel makes them here.  What the TPU kernel did
only for the TPU is gone: the 128-lane padding, the one-hot matmuls standing
in for gathers and scatters, the 8 MiB resident-or-streamed split with its
token bucketing by tile, and the stats carried across a sequential grid.
"""

import ctypes
import dataclasses
import functools
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from . import build as _build
from . import dirichlet_expectation as _de

#: calls that launched the kernel (one per wrapper call)
launches = 0

#: most tokens one warp sums before its partial goes to the finishing pass
PIECE = 256

_SRC = Path(__file__).resolve().parent / "csrc" / "zstats.cu"
_MAX_CHILDREN = 8
_MAX_K = 1024


# ---------------------------------------------------------------------------
# host-side owner plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Grouping:
    """Tokens grouped by key, each key's run cut into pieces.

    ``perm[key_start[s]:key_start[s+1]]`` are key ``s``'s tokens (in their
    original order, or by a secondary key: :func:`group_tokens`); piece
    ``p`` is ``perm[piece_start[p]:piece_start[p+1]]``, of key
    ``piece_key[p]``, and key ``s`` owns pieces
    ``key_pieces[s]:key_pieces[s+1]``.  ``identity``: ``perm`` keeps the
    original order.
    """
    perm: np.ndarray          # (N,) int32
    key_start: np.ndarray     # (n_keys + 1,) int32
    piece_start: np.ndarray   # (P + 1,) int32
    key_pieces: np.ndarray    # (n_keys + 1,) int32
    piece_key: np.ndarray     # (P,) int32
    identity: bool = False

    @property
    def n_keys(self) -> int:
        return len(self.key_start) - 1

    @property
    def n_pieces(self) -> int:
        return len(self.piece_start) - 1

    def arrays(self) -> dict:
        """``{field: array}`` of the index arrays."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), np.ndarray)}


def group_tokens(keys: np.ndarray, n_keys: int, piece: int = PIECE,
                 then: Optional[np.ndarray] = None) -> Grouping:
    """Group token indices by ``keys`` and cut each run into pieces of at
    most ``piece`` tokens.  A key's tokens keep their original order, or,
    given ``then``, are ordered by ``then`` first (stable): the prior's
    pass gathers the first child's rows, and a word's tokens next to each
    other in a document read its row once."""
    keys = np.asarray(keys, np.int64)
    if len(keys) and (keys.min() < 0 or keys.max() >= n_keys):
        raise ValueError(f"keys outside [0, {n_keys})")
    if then is not None:
        then = np.asarray(then, np.int64)
        span = int(then.max()) + 1 if len(then) else 1
        perm = np.argsort(keys * span + then, kind="stable")
        identity = bool(np.array_equal(perm, np.arange(len(keys))))
    else:
        identity = bool(np.all(keys[1:] >= keys[:-1]))
        perm = np.arange(len(keys), dtype=np.int64) if identity else \
            np.argsort(keys, kind="stable")
    counts = np.bincount(keys, minlength=n_keys)
    key_start = np.zeros(n_keys + 1, np.int64)
    np.cumsum(counts, out=key_start[1:])
    n_per_key = (counts + piece - 1) // piece
    key_pieces = np.zeros(n_keys + 1, np.int64)
    np.cumsum(n_per_key, out=key_pieces[1:])
    piece_key = np.repeat(np.arange(n_keys), n_per_key)
    j = np.arange(len(piece_key)) - key_pieces[piece_key]
    piece_start = np.append(key_start[piece_key] + j * piece, len(keys))
    i32 = lambda a: a.astype(np.int32)  # noqa: E731
    return Grouping(i32(perm), i32(key_start), i32(piece_start), i32(key_pieces),
                    i32(piece_key), identity)


@dataclasses.dataclass
class ZPlan:
    """The owner plan of one ``zstats`` call: the prior's grouping by row
    and each child's grouping by value, each pass's token streams gathered
    into its piece order (``streams``), and each pass's slots in the
    per-token softmax statistics that the prior pass hands to the
    children's (``"spos"`` in ``streams``), with their device copies."""
    prior: Grouping
    children: tuple
    streams: dict = dataclasses.field(default_factory=dict)
    device: Optional[torch.device] = None
    tensors: dict = dataclasses.field(default_factory=dict)

    def passes(self) -> list:
        """``[(name, grouping)]``: the prior's pass, then each child's."""
        return [("prior", self.prior)] + [
            (f"child{i}", g) for i, g in enumerate(self.children)]

    def host_arrays(self) -> dict:
        """``{key: numpy array}`` of the plan's groupings and streams."""
        arrays = grouping_arrays(self.passes())
        arrays.update(self.streams)
        return arrays

    @property
    def nbytes(self) -> int:
        """Bytes of the plan's host arrays (its share of a prefetched
        batch's host buffers)."""
        return sum(a.nbytes for a in self.host_arrays().values())

    def to(self, device) -> "ZPlan":
        """A copy whose index arrays also live on ``device``."""
        device = placed(device)
        arrays = self.host_arrays()
        return ZPlan(self.prior, self.children, self.streams, device,
                     device_arrays(arrays, device))


def placed(device) -> torch.device:
    """``device`` as a tensor placed there reports it: ``"cuda"`` names the
    current card (``cuda:0``).  A plan's device is compared with its call's
    tables' (:func:`launch_flat`), and a plan that compared unequal would be
    copied to the card again at every call."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_arrays(arrays: dict, device) -> dict:
    """``{key: tensor on device}`` for ``{key: numpy array}``."""
    return {key: torch.from_numpy(a).to(device) for key, a in arrays.items()}


def grouping_arrays(named: list) -> dict:
    """``{(name, field): array}`` for each named Grouping."""
    return {(name, f): a for name, g in named for f, a in g.arrays().items()}


def host(a) -> np.ndarray:
    """A tensor or array as a numpy array on the host."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def check_strided_rows(i: int, c, k: int):
    """Raise unless a strided child's rows base + stride * k lie inside its
    table."""
    if c.specialized or not len(c.values):
        return
    gf = c.elog.shape[0]
    base = host(c.base) if c.base is not None else np.zeros(1, np.int64)
    lo, hi = int(base.min()), int(base.max()) + int(c.stride) * (k - 1)
    if lo < 0 or hi >= gf:
        raise ValueError(f"child {i}: rows base + stride * k span "
                         f"[{lo}, {hi}], outside its table's {gf} rows")


def pass_streams(name: str, g: Grouping, prior_rows, children,
                 target: Optional[int]) -> dict:
    """``{(name, field): array}``: the token streams pass ``name`` (the
    prior's, ``target`` None, or child ``target``'s) reads, gathered into
    its piece order through ``g.perm``; nothing where ``g`` keeps the
    original order, so the pass reads the call's own arrays.  A pass does
    not read the stream of its own key (the prior rows in the prior's pass,
    a specialized child's values in its own)."""
    if g.identity:
        return {}
    out = {}
    if target is not None:
        out[name, "prior_rows"] = host(prior_rows)[g.perm]
    for i, c in enumerate(children):
        if i != target or not c.specialized:
            out[name, f"values{i}"] = host(c.values)[g.perm]
        for field in ("base", "mask"):
            if getattr(c, field) is not None:
                out[name, f"{field}{i}"] = host(getattr(c, field))[g.perm]
    return out


def stats_slots(plan_passes: list) -> dict:
    """``{(name, "spos"): array}``: for each pass, the slot of its t-th token
    in the softmax statistics, which lie in the first child's order (where
    that pass reads them at t, with no ``spos``)."""
    first = plan_passes[1][1]
    n = len(first.perm)
    inv = np.empty(n, np.int32)
    inv[first.perm] = np.arange(n, dtype=np.int32)
    out = {}
    for name, g in plan_passes:
        spos = inv[g.perm]
        if not np.array_equal(spos, np.arange(n, dtype=np.int32)):
            out[name, "spos"] = spos
    return out


def build_plan(prior_rows, children, prior_shape: tuple,
               piece: int = PIECE) -> ZPlan:
    """The owner plan from the static index streams (tensors or arrays):
    ``prior_rows`` grouped over the (G, K) prior's G rows, each row's
    tokens ordered by the first specialized child's value, and each child's
    ``values`` grouped over its parent table's value axis; each pass's
    streams (the children's values, base and mask, the prior rows) in its
    piece order.  Raises on an index the kernel would read or write out of
    bounds."""
    g, k = prior_shape
    first = next((c for c in children if c.specialized), None)
    prior = group_tokens(host(prior_rows), g, piece,
                         host(first.values) if first is not None else None)
    kids = []
    for i, c in enumerate(children):
        kids.append(group_tokens(host(c.values), c.elog.shape[1], piece))
        check_strided_rows(i, c, k)
    plan = ZPlan(prior, tuple(kids))
    streams = pass_streams("prior", prior, prior_rows, children, None)
    for i, gi in enumerate(kids):
        streams.update(pass_streams(f"child{i}", gi, prior_rows, children, i))
    if kids:
        streams.update(stats_slots(plan.passes()))
    plan.streams = streams
    return plan


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/zstats.cu`` for ``sm_90a`` unless a library built from
    the same source exists; returns (library path, compiler output)."""
    return _build.build_library(_SRC, "zstats", verbose)


class _ChildArgs(ctypes.Structure):
    _fields_ = [("table", ctypes.c_void_p), ("values", ctypes.c_void_p),
                ("base", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("zmap", ctypes.c_void_p),
                ("stride", ctypes.c_int), ("kf", ctypes.c_int),
                ("specialized", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("prior", ctypes.c_void_p), ("prior_rows", ctypes.c_void_p),
                ("zmask", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("r_out", ctypes.c_void_p), ("k", ctypes.c_int),
                ("n_children", ctypes.c_int),
                ("c", _ChildArgs * _MAX_CHILDREN),
                ("tok", ctypes.c_void_p), ("spos", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("vec", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zstats_pieces.argtypes = [p, i, p, p, i, p, p, p]
    lib.zstats_finish.argtypes = [p, p, i, i, p, ll, ll, i, p]
    lib.zstats_finish64.argtypes = [p, p, p, i, i, p, ll, ll, i, p]
    lib.zstats_strided.argtypes = [p, i, p, i, p, p]
    lib.zstats_sum.argtypes = [p, i, p, p]
    lib.zmap_logits.argtypes = [p, i, p, p, p, i, p, p, i, i, p]
    lib.zmap_stats.argtypes = [p, i, p, p, i, p, p]
    lib.zmap_strided.argtypes = [p, i, p, p, i, p, p]
    for fn in (lib.zstats_pieces, lib.zstats_finish, lib.zstats_finish64,
               lib.zstats_strided,
               lib.zstats_sum, lib.zmap_logits, lib.zmap_stats,
               lib.zmap_strided, lib.zstats_max_k, lib.zstats_max_children,
               lib.zstats_args_size):
        fn.restype = ctypes.c_int
    if lib.zstats_args_size() != ctypes.sizeof(_Args) or \
            lib.zstats_max_children() != _MAX_CHILDREN or \
            lib.zstats_max_k() != _MAX_K:
        raise RuntimeError("csrc/zstats.cu and its ctypes binding disagree")
    return lib


def check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"zstats kernel {what} failed to launch: CUDA error {err}")


def ptr(t: Optional[torch.Tensor]):
    """A tensor's device address for ctypes, or None."""
    return t.data_ptr() if t is not None else None


def make_args(k: int, children, tabs, prior=None, prior_rows=None, zmask=None,
              extra=None, r_out=None) -> _Args:
    """The kernel's ZArgs: ``children`` with their f32 Elog ``tabs`` in the
    kernel's layout, and the prior side where given."""
    args = _Args(prior=ptr(prior), prior_rows=ptr(prior_rows),
                 zmask=ptr(zmask), extra=ptr(extra), r_out=ptr(r_out), k=k,
                 n_children=len(children))
    for i, (c, tab) in enumerate(zip(children, tabs)):
        args.c[i] = _ChildArgs(
            table=tab.data_ptr(), values=c.values.data_ptr(), base=ptr(c.base),
            mask=ptr(c.mask), zmap=ptr(c.zmap), stride=int(c.stride),
            kf=c.elog.shape[1], specialized=int(c.specialized))
    # 16-byte loads of K-rows need K % 4 == 0 and aligned tables
    rows = [prior, extra, r_out] + [t for c, t in zip(children, tabs)
                                    if c.specialized]
    args.vec = int(k % 4 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in rows if t is not None))
    return args


def finish(lib, partial, tensors, name, n_keys, k, out, stride_key, stride_k,
           stream):
    """Add each key's f32 pieces of ``partial`` in order into its row or
    column of ``out``."""
    check_launch(lib.zstats_finish(
        partial.data_ptr(), tensors[name, "key_pieces"].data_ptr(), n_keys, k,
        out.data_ptr(), stride_key, stride_k, 0, stream), "finish")


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def check_inputs(table_prior, prior_rows, children, zmask):
    """Raise on inputs the kernel does not take."""
    dev = table_prior.device
    k = table_prior.shape[1] if table_prior.ndim == 2 else -1
    if table_prior.ndim != 2 or not 1 <= k <= _MAX_K:
        raise ValueError(f"zstats kernel takes a (G, K) prior with 1 <= K <= "
                         f"{_MAX_K}, got shape {tuple(table_prior.shape)}")
    if len(children) > _MAX_CHILDREN:
        raise ValueError(f"zstats kernel takes at most {_MAX_CHILDREN} "
                         f"children, got {len(children)}")
    n = prior_rows.shape[0]
    # tables may come in any layout: elog_tables lays them out for the
    # kernel (a no-op for one already in its layout)
    checks = [("prior table", table_prior, None, (torch.float32, torch.bfloat16)),
              ("prior_rows", prior_rows, (n,), (torch.int32,)),
              ("zmask", zmask, (n,), (torch.float32,))]
    for i, c in enumerate(children):
        checks += child_checks(i, c, k, n)
    check_tensors(checks, dev)


def child_checks(i: int, c, k: int, n: int) -> list:
    """The checks of one child's table and token streams: of length ``n``
    (the latent instances), or, for a child with a zmap, of its own token
    count."""
    if c.elog.ndim != 2 or (c.specialized and c.elog.shape[0] != k):
        raise ValueError(f"child {i}: table shape {tuple(c.elog.shape)} "
                         f"does not fit K = {k}")
    nt = (c.values.shape[0],) if c.zmap is not None else (n,)
    return [(f"child {i} table", c.elog, None, (torch.float32, torch.bfloat16)),
            (f"child {i} values", c.values, nt, (torch.int32,)),
            (f"child {i} zmap", c.zmap, nt, (torch.int32,)),
            (f"child {i} base", c.base, nt, (torch.int32,)),
            (f"child {i} mask", c.mask, nt, (torch.float32,))]


def check_tensors(checks: list, dev):
    """Raise on a tensor off ``dev``, of another dtype or shape, or not
    contiguous; ``checks`` holds ``(name, tensor or None, shape or None,
    dtypes)``."""
    for name, t, shape, dtypes in checks:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the prior on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if shape is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def elog_table(table: torch.Tensor, tables: str, transpose: bool = False):
    """One table as f32 Elog values, contiguous, transposed if asked: the
    Triton ``dirichlet_expectation`` of concentrations (``"alpha"``), or the
    table itself (``"elog"``)."""
    if tables == "alpha":
        return _de.dirichlet_expectation(table, transpose=transpose)
    if tables != "elog":
        raise ValueError(f"tables must be 'elog' or 'alpha', not {tables!r}")
    return (table.float().T if transpose else table.float()).contiguous()


def elog_tables(table_prior, children, tables: str):
    """f32 Elog tables in the kernel's layout: the prior (G, K), a
    specialized child (Kf, K), a strided child (Gf, Kf).  With ``"elog"`` a
    specialized child's table handed over as the transpose of a contiguous
    (Kf, K) one is read in place."""
    return (elog_table(table_prior, tables),
            [elog_table(c.elog, tables, c.specialized) for c in children])


def zstats(table_prior: torch.Tensor, prior_rows: torch.Tensor,
           children: tuple, zmask: Optional[torch.Tensor] = None, *,
           tables: str = "elog", plan: Optional[ZPlan] = None):
    """Fused token-plate substep: ``(lse_sum, prior_stats, child_stats)``.

    Arguments and results as ``ref.zstats``.  ``plan`` is the owner plan of
    these index streams (:func:`build_plan`), built here when not given.
    CUDA tensors only: the kernel runs or the call raises.  Segment latents
    (a child with a ``zmap``) belong to ``fused_zmap.zstats_zmap``.
    """
    global launches
    if any(c.zmap is not None for c in children):
        raise ValueError("a child with a zmap makes a segment latent; "
                         "fused_zmap.zstats_zmap takes it")
    if table_prior.device.type != "cuda":
        raise ValueError(f"no kernel for device {table_prior.device}")
    check_inputs(table_prior, prior_rows, children, zmask)
    if plan is None:
        plan = build_plan(prior_rows, children, tuple(table_prior.shape))
    eprior, etabs = elog_tables(table_prior, children, tables)
    out = launch_flat(eprior, prior_rows, children, etabs, zmask, plan)
    launches += 1
    return out


def pass_args(base: _Args, plan: ZPlan, name: str, g: Grouping, n_children,
              zmask, stats) -> _Args:
    """The ZArgs of pass ``name``: ``base`` (the call's arrays) with the
    pass's piece-ordered streams in their place, ``zmask`` in the pass's
    order (the prior's pass; the children's read it folded into the
    softmax statistics ``stats``), and the pass's slots in ``stats``."""
    t = plan.tensors
    a = _Args.from_buffer_copy(base)
    if (name, "prior_rows") in t:
        a.prior_rows = t[name, "prior_rows"].data_ptr()
    for i in range(n_children):
        for field in ("values", "base", "mask"):
            if (name, f"{field}{i}") in t:
                setattr(a.c[i], field, t[name, f"{field}{i}"].data_ptr())
    a.zmask = ptr(zmask)
    if base.extra and not g.identity:
        a.tok = t[name, "perm"].data_ptr()
    a.spos = ptr(t.get((name, "spos")))
    a.stats = ptr(stats)
    return a


def launch_flat(eprior, prior_rows, children, etabs, zmask, plan: ZPlan,
                extra=None, r_out=None):
    """Launch the flat passes on f32 Elog tables in the kernel's layout:
    the prior pass over the latent instances (adding ``extra`` (N, K)
    logits after the prior row and writing r into ``r_out`` where given),
    the lse sum, and each child's pass.  Returns ``(lse_sum, prior_stats,
    child_stats)``."""
    dev = eprior.device
    if plan.device != dev:
        plan = plan.to(dev)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    g, k = eprior.shape
    base = make_args(k, children, etabs, eprior, prior_rows, zmask, extra,
                     r_out)
    t = plan.tensors
    f32 = dict(dtype=torch.float32, device=dev)
    # each token's (max, zmask / sum), from the prior pass to the children's
    stats = torch.empty((prior_rows.shape[0], 2), **f32) if children else None
    # zmask is a call argument, not a stream of the plan: gathered here
    # where the prior's pass leaves the call's order
    if zmask is not None and not plan.prior.identity:
        zmask = zmask[t["prior", "perm"].long()].contiguous()

    def pieces_then_finish(target, name, grp, out, stride_key, stride_k):
        n_keys = out.shape[0] if target < 0 else out.shape[1]
        partial = torch.empty((grp.n_pieces, k), **f32)
        lse_part = torch.empty((grp.n_pieces if target < 0 else 0,), **f32)
        args = pass_args(base, plan, name, grp, len(children),
                         zmask if target < 0 else None, stats)
        check_launch(lib.zstats_pieces(
            ctypes.addressof(args), target, t[name, "piece_key"].data_ptr(),
            t[name, "piece_start"].data_ptr(), grp.n_pieces,
            partial.data_ptr(), lse_part.data_ptr(), stream), "pieces")
        finish(lib, partial, t, name, n_keys, k, out, stride_key, stride_k,
               stream)
        return lse_part

    pstats = torch.empty((g, k), **f32)
    lse_part = pieces_then_finish(-1, "prior", plan.prior, pstats, k, 1)
    lse_sum = torch.empty((), **f32)
    check_launch(lib.zstats_sum(lse_part.data_ptr(), lse_part.shape[0],
                                lse_sum.data_ptr(), stream), "sum")
    cstats = []
    for i, (c, grp) in enumerate(zip(children, plan.children)):
        gf, kf = c.elog.shape
        if c.specialized:
            cs = torch.empty((gf, kf), **f32)
            pieces_then_finish(i, f"child{i}", grp, cs, 1, kf)
        else:
            cs = torch.zeros((gf, kf), **f32)
            args = pass_args(base, plan, f"child{i}", grp, len(children),
                             None, stats)
            check_launch(lib.zstats_strided(
                ctypes.addressof(args), i, t[f"child{i}", "key_start"].data_ptr(),
                kf, cs.data_ptr(), stream), "strided")
        cstats.append(cs)
    return lse_sum, pstats, tuple(cstats)
