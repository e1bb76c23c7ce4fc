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
    source, and ``ctypes`` loads it.
  - :func:`zstats` — the wrapper, for CUDA tensors only: it launches the
    kernel or raises.  The plain version is ``ref.zstats``, which ``ops``
    runs on the CPU.

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
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

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
        tensors = {}
        for name, g in [("prior", self.prior)] + [
                (f"child{i}", g) for i, g in enumerate(self.children)]:
            for field in dataclasses.fields(g):
                tensors[name, field.name] = torch.from_numpy(
                    getattr(g, field.name)).to(device)
        return ZPlan(self.prior, self.children, device, tensors)


def build_plan(prior_rows, children, prior_shape: tuple,
               piece: int = PIECE) -> ZPlan:
    """The owner plan from the static index streams (tensors or arrays):
    ``prior_rows`` grouped over the (G, K) prior's G rows, and each child's
    ``values`` grouped over its parent table's value axis.  Raises on an
    index the kernel would read or write out of bounds."""
    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    g, k = prior_shape
    prior = group_tokens(host(prior_rows), g, piece)
    kids = []
    for i, c in enumerate(children):
        gf, kf = c.elog.shape
        kids.append(group_tokens(host(c.values), kf, piece))
        if not c.specialized and len(c.values):
            base = host(c.base) if c.base is not None else np.zeros(1, np.int64)
            lo, hi = int(base.min()), int(base.max()) + int(c.stride) * (k - 1)
            if lo < 0 or hi >= gf:
                raise ValueError(f"child {i}: rows base + stride * k span "
                                 f"[{lo}, {hi}], outside its table's {gf} rows")
    return ZPlan(prior, tuple(kids))


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------

def build_dir() -> Path:
    """Where the shared library is built: ``$REPRO_TORCH_BUILD_DIR`` or
    ``build/`` at the repo root."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build"


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/zstats.cu`` for ``sm_90a`` unless a library built from
    the same source exists; returns (library path, compiler output)."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    out = build_dir() / f"libzstats-{tag}.so"
    if out.exists() and not verbose:
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    cmd = [str(nvcc) if nvcc.exists() else "nvcc",
           "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(_SRC)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr


class _ChildArgs(ctypes.Structure):
    _fields_ = [("table", ctypes.c_void_p), ("values", ctypes.c_void_p),
                ("base", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("stride", ctypes.c_int), ("kf", ctypes.c_int),
                ("specialized", ctypes.c_int)]


class _Args(ctypes.Structure):
    _fields_ = [("prior", ctypes.c_void_p), ("prior_rows", ctypes.c_void_p),
                ("zmask", ctypes.c_void_p), ("k", ctypes.c_int),
                ("n_children", ctypes.c_int),
                ("c", _ChildArgs * _MAX_CHILDREN)]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.zstats_pieces.argtypes = [p, i, p, p, i, p, p, p]
    lib.zstats_finish.argtypes = [p, p, i, i, p, ll, ll, p]
    lib.zstats_strided.argtypes = [p, i, p, p, i, p, p]
    lib.zstats_sum.argtypes = [p, i, p, p]
    for fn in (lib.zstats_pieces, lib.zstats_finish, lib.zstats_strided,
               lib.zstats_sum, lib.zstats_max_k, lib.zstats_max_children,
               lib.zstats_args_size):
        fn.restype = ctypes.c_int
    if lib.zstats_args_size() != ctypes.sizeof(_Args) or \
            lib.zstats_max_children() != _MAX_CHILDREN or \
            lib.zstats_max_k() != _MAX_K:
        raise RuntimeError("csrc/zstats.cu and its ctypes binding disagree")
    return lib


def _check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"zstats kernel {what} failed to launch: CUDA error {err}")


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _check_inputs(table_prior, prior_rows, children, zmask):
    dev = table_prior.device
    k = table_prior.shape[1] if table_prior.ndim == 2 else -1
    if table_prior.ndim != 2 or not 1 <= k <= _MAX_K:
        raise ValueError(f"zstats kernel takes a (G, K) prior with 1 <= K <= "
                         f"{_MAX_K}, got shape {tuple(table_prior.shape)}")
    if len(children) > _MAX_CHILDREN:
        raise ValueError(f"zstats kernel takes at most {_MAX_CHILDREN} "
                         f"children, got {len(children)}")
    n = prior_rows.shape[0]
    # tables may come in any layout: _elog_tables lays them out for the
    # kernel (a no-op for one already in its layout)
    checks = [("prior table", table_prior, None, (torch.float32, torch.bfloat16)),
              ("prior_rows", prior_rows, (n,), (torch.int32,)),
              ("zmask", zmask, (n,), (torch.float32,))]
    for i, c in enumerate(children):
        if c.elog.ndim != 2 or (c.specialized and c.elog.shape[0] != k):
            raise ValueError(f"child {i}: table shape {tuple(c.elog.shape)} "
                             f"does not fit K = {k}")
        checks += [(f"child {i} table", c.elog, None,
                    (torch.float32, torch.bfloat16)),
                   (f"child {i} values", c.values, (n,), (torch.int32,)),
                   (f"child {i} base", c.base, (n,), (torch.int32,)),
                   (f"child {i} mask", c.mask, (n,), (torch.float32,))]
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


def _elog_tables(table_prior, children, tables: str):
    """f32 Elog tables in the kernel's layout: the prior (G, K), a
    specialized child (Kf, K), a strided child (Gf, Kf).  With ``"elog"`` a
    specialized child's table handed over as the transpose of a contiguous
    (Kf, K) one is read in place."""
    if tables == "alpha":
        return (_de.dirichlet_expectation(table_prior),
                [_de.dirichlet_expectation(c.elog, transpose=c.specialized)
                 for c in children])
    if tables != "elog":
        raise ValueError(f"tables must be 'elog' or 'alpha', not {tables!r}")
    return (table_prior.float().contiguous(),
            [(c.elog.float().T if c.specialized else c.elog.float()).contiguous()
             for c in children])


def zstats(table_prior: torch.Tensor, prior_rows: torch.Tensor,
           children: tuple, zmask: Optional[torch.Tensor] = None, *,
           tables: str = "elog", plan: Optional[ZPlan] = None):
    """Fused token-plate substep: ``(lse_sum, prior_stats, child_stats)``.

    Arguments and results as ``ref.zstats``.  ``plan`` is the owner plan of
    these index streams (:func:`build_plan`), built here when not given.
    CUDA tensors only: the kernel runs or the call raises.  Segment latents
    (a child with a ``zmap``) raise ``NotImplementedError``: they belong to
    the ``fused_zmap`` kernel of a later slice.
    """
    global launches
    if any(c.zmap is not None for c in children):
        raise NotImplementedError(
            "the zstats kernel covers flat latents; a segment latent (a "
            "child with a zmap, as in SLDA and naive Bayes) needs the "
            "fused_zmap kernel, which arrives in a later slice of the port")
    if table_prior.device.type != "cuda":
        raise ValueError(f"no kernel for device {table_prior.device}")
    _check_inputs(table_prior, prior_rows, children, zmask)
    dev = table_prior.device
    if plan is None:
        plan = build_plan(prior_rows, children, tuple(table_prior.shape))
    if plan.device != dev:
        plan = plan.to(dev)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    g, k = table_prior.shape
    eprior, etabs = _elog_tables(table_prior, children, tables)

    args = _Args(prior=eprior.data_ptr(), prior_rows=prior_rows.data_ptr(),
                 zmask=zmask.data_ptr() if zmask is not None else None,
                 k=k, n_children=len(children))
    for i, (c, tab) in enumerate(zip(children, etabs)):
        args.c[i] = _ChildArgs(
            table=tab.data_ptr(), values=c.values.data_ptr(),
            base=c.base.data_ptr() if c.base is not None else None,
            mask=c.mask.data_ptr() if c.mask is not None else None,
            stride=int(c.stride), kf=c.elog.shape[1],
            specialized=int(c.specialized))
    pargs = ctypes.addressof(args)
    f32 = dict(dtype=torch.float32, device=dev)

    def pieces_then_finish(target, name, out, stride_key, stride_k):
        t = plan.tensors
        n_pieces = plan.prior.n_pieces if target < 0 else \
            plan.children[target].n_pieces
        n_keys = out.shape[0] if target < 0 else out.shape[1]
        partial = torch.empty((n_pieces, k), **f32)
        lse_part = torch.empty((n_pieces if target < 0 else 0,), **f32)
        _check_launch(lib.zstats_pieces(
            pargs, target, t[name, "perm"].data_ptr(),
            t[name, "piece_start"].data_ptr(), n_pieces, partial.data_ptr(),
            lse_part.data_ptr(), stream), "pieces")
        _check_launch(lib.zstats_finish(
            partial.data_ptr(), t[name, "key_pieces"].data_ptr(), n_keys, k,
            out.data_ptr(), stride_key, stride_k, stream), "finish")
        return lse_part

    pstats = torch.empty((g, k), **f32)
    lse_part = pieces_then_finish(-1, "prior", pstats, k, 1)
    lse_sum = torch.empty((), **f32)
    _check_launch(lib.zstats_sum(lse_part.data_ptr(), lse_part.shape[0],
                                 lse_sum.data_ptr(), stream), "sum")
    cstats = []
    for i, c in enumerate(children):
        gf, kf = c.elog.shape
        if c.specialized:
            cs = torch.empty((gf, kf), **f32)
            pieces_then_finish(i, f"child{i}", cs, 1, kf)
        else:
            cs = torch.zeros((gf, kf), **f32)
            _check_launch(lib.zstats_strided(
                pargs, i, plan.tensors[f"child{i}", "perm"].data_ptr(),
                plan.tensors[f"child{i}", "key_start"].data_ptr(), kf,
                cs.data_ptr(), stream), "strided")
        cstats.append(cs)
    launches += 1
    return lse_sum, pstats, tuple(cstats)
