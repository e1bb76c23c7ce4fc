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
    numpy stable argsort, and each key's run cut into pieces of at most
    :data:`PIECE` tokens.  It depends only on the program's static index
    streams, so ``core/vmp.py`` builds it once per program.
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

    ``perm[key_start[s]:key_start[s+1]]`` are key ``s``'s tokens in their
    original order; piece ``p`` is ``perm[piece_start[p]:piece_start[p+1]]``
    and key ``s`` owns pieces ``key_pieces[s]:key_pieces[s+1]``.
    """
    perm: np.ndarray          # (N,) int32
    key_start: np.ndarray     # (n_keys + 1,) int32
    piece_start: np.ndarray   # (P + 1,) int32
    key_pieces: np.ndarray    # (n_keys + 1,) int32

    @property
    def n_keys(self) -> int:
        return len(self.key_start) - 1

    @property
    def n_pieces(self) -> int:
        return len(self.piece_start) - 1


def group_tokens(keys: np.ndarray, n_keys: int, piece: int = PIECE) -> Grouping:
    """Group token indices by ``keys`` (stable) and cut each run into pieces
    of at most ``piece`` tokens."""
    keys = np.asarray(keys, np.int64)
    if len(keys) and (keys.min() < 0 or keys.max() >= n_keys):
        raise ValueError(f"keys outside [0, {n_keys})")
    if np.all(keys[1:] >= keys[:-1]):
        perm = np.arange(len(keys), dtype=np.int64)
    else:
        perm = np.argsort(keys, kind="stable")
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
    return Grouping(i32(perm), i32(key_start), i32(piece_start), i32(key_pieces))


@dataclasses.dataclass
class ZPlan:
    """The owner plan of one ``zstats`` call: the prior's grouping by row
    and each child's grouping by value, with their device copies."""
    prior: Grouping
    children: tuple
    device: Optional[torch.device] = None
    tensors: dict = dataclasses.field(default_factory=dict)

    def to(self, device) -> "ZPlan":
        """A copy whose index arrays also live on ``device``."""
        device = torch.device(device)
        named = [("prior", self.prior)] + [
            (f"child{i}", g) for i, g in enumerate(self.children)]
        return ZPlan(self.prior, self.children, device,
                     device_arrays(named, device))


def device_arrays(named: list, device) -> dict:
    """``{(name, field): tensor on device}`` for each named Grouping."""
    return {(name, field.name): torch.from_numpy(getattr(g, field.name)).to(device)
            for name, g in named for field in dataclasses.fields(g)}


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


def build_plan(prior_rows, children, prior_shape: tuple,
               piece: int = PIECE) -> ZPlan:
    """The owner plan from the static index streams (tensors or arrays):
    ``prior_rows`` grouped over the (G, K) prior's G rows, and each child's
    ``values`` grouped over its parent table's value axis.  Raises on an
    index the kernel would read or write out of bounds."""
    g, k = prior_shape
    prior = group_tokens(host(prior_rows), g, piece)
    kids = []
    for i, c in enumerate(children):
        kids.append(group_tokens(host(c.values), c.elog.shape[1], piece))
        check_strided_rows(i, c, k)
    return ZPlan(prior, tuple(kids))


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
                ("c", _ChildArgs * _MAX_CHILDREN)]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zstats_pieces.argtypes = [p, i, p, p, i, p, p, p]
    lib.zstats_finish.argtypes = [p, p, i, i, p, ll, ll, i, p]
    lib.zstats_finish64.argtypes = [p, p, i, i, p, ll, ll, i, p]
    lib.zstats_strided.argtypes = [p, i, p, p, i, p, p]
    lib.zstats_sum.argtypes = [p, i, p, p]
    lib.zmap_logits.argtypes = [p, i, p, p, i, p, p]
    lib.zmap_stats.argtypes = [p, i, p, p, p, i, p, p]
    lib.zmap_strided.argtypes = [p, i, p, p, p, i, p, p]
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
    return args


def finish(lib, partial, tensors, name, n_keys, k, out, stride_key, stride_k,
           stream, add=False):
    """Add each key's pieces of ``partial`` (f32, or f64 for phase 1 of a
    segment latent) in order into its row or column of ``out`` (``add``:
    onto what is there), rounded once to f32."""
    fn = lib.zstats_finish64 if partial.dtype == torch.float64 \
        else lib.zstats_finish
    check_launch(fn(
        partial.data_ptr(), tensors[name, "key_pieces"].data_ptr(), n_keys, k,
        out.data_ptr(), stride_key, stride_k, int(add), stream), "finish")


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
    args = make_args(k, children, etabs, eprior, prior_rows, zmask, extra, r_out)
    pargs = ctypes.addressof(args)
    t = plan.tensors
    f32 = dict(dtype=torch.float32, device=dev)

    def pieces_then_finish(target, name, out, stride_key, stride_k):
        n_pieces = plan.prior.n_pieces if target < 0 else \
            plan.children[target].n_pieces
        n_keys = out.shape[0] if target < 0 else out.shape[1]
        partial = torch.empty((n_pieces, k), **f32)
        lse_part = torch.empty((n_pieces if target < 0 else 0,), **f32)
        check_launch(lib.zstats_pieces(
            pargs, target, t[name, "perm"].data_ptr(),
            t[name, "piece_start"].data_ptr(), n_pieces, partial.data_ptr(),
            lse_part.data_ptr(), stream), "pieces")
        finish(lib, partial, t, name, n_keys, k, out, stride_key, stride_k,
               stream)
        return lse_part

    pstats = torch.empty((g, k), **f32)
    lse_part = pieces_then_finish(-1, "prior", pstats, k, 1)
    lse_sum = torch.empty((), **f32)
    check_launch(lib.zstats_sum(lse_part.data_ptr(), lse_part.shape[0],
                                lse_sum.data_ptr(), stream), "sum")
    cstats = []
    for i, c in enumerate(children):
        gf, kf = c.elog.shape
        if c.specialized:
            cs = torch.empty((gf, kf), **f32)
            pieces_then_finish(i, f"child{i}", cs, 1, kf)
        else:
            cs = torch.zeros((gf, kf), **f32)
            check_launch(lib.zstats_strided(
                pargs, i, t[f"child{i}", "perm"].data_ptr(),
                t[f"child{i}", "key_start"].data_ptr(), kf,
                cs.data_ptr(), stream), "strided")
        cstats.append(cs)
    return lse_sum, pstats, tuple(cstats)
