"""CUDA kernels: flash attention, forward, with a recomputing backward.

Replace the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_kernel``, ``_flash_fwd_impl`` and its ``pallas_call``, and the
``_flash_vjp`` custom VJP).  The source is ``csrc/flash_attention.cu``; it
says what bounds the kernels on the H100 and how one thread block per query
tile keeps the softmax statistics on chip.  ``block_q``, ``block_k`` and
``interpret`` were Pallas details and are gone: the kernels pick their own
tiles and mask the ragged edge themselves, so together they take every
shape the plain version takes (bf16 or f32, ``Sq`` may differ from ``Sk``,
any ``Dh`` that is a multiple of 8 up to 256).  Two kernels share the work,
chosen by :func:`route` on dtype and ``Dh`` alone:

  - ``"wgmma"``: bf16 at ``Dh`` 64, 128 or 256 (the LM trainer's path), a
    Hopper kernel with TMA loads, a producer warpgroup and two consumer
    warpgroups running ``wgmma`` (kv tiles of 128 keys, 64 at ``Dh`` 256);
  - ``"mma"``: every other input (f32, other ``Dh``), an ``mma.sync``
    kernel for bf16 and an FMA kernel for f32.

This module holds the parts around them:

  - the build: ``nvcc`` compiles the source into ``libflash_attention-<hash>
    .so`` under ``build/`` (``build.build_library``), and ``ctypes`` loads it;
  - :func:`launch`, which allocates the output and launches the kernel of
    the input's route on PyTorch's current stream, counting each launch as
    ``kernels.launches.flash_attention`` and
    ``kernels.routes.flash_attention.<route>`` (``trace.count``);
  - :class:`FlashAttention`, the ``torch.autograd.Function``: its forward
    launches the kernel and saves only q, k and v; its backward recomputes
    attention through ``ref.flash_attention`` and returns the gradient of
    that, as the reference's ``_flash_bwd`` does.  No O(S^2) residual is
    saved;
  - :func:`flash_attention`, the wrapper, for CUDA tensors only: it launches
    the kernel or raises.  ``ops.flash_attention`` runs the plain version on
    the CPU.
"""

import ctypes
import functools
from pathlib import Path

import torch

from .. import trace
from . import build as _build
from . import ref

#: the kernels, by route
ROUTES = ("wgmma", "mma")

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 256
#: head dims of the "wgmma" route (bf16 only)
WGMMA_DH = (64, 128, 256)


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/flash_attention.cu`` for ``sm_90a`` unless a library
    built from the same source exists; returns (library path, compiler
    output)."""
    return _build.build_library(_SRC, "flash_attention", verbose)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    lib.flash_attention_fwd_wgmma.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.flash_attention_fwd_wgmma.restype = ctypes.c_int
    lib.flash_attention_wgmma_smem.argtypes = [i]
    lib.flash_attention_wgmma_smem.restype = ctypes.c_int
    return lib


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these inputs, from dtype and ``Dh`` alone:
    ``"wgmma"`` for bf16 at ``Dh`` 64, 128 or 256, ``"mma"`` for the
    rest."""
    if q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_DH:
        return "wgmma"
    return "mma"


_route_of = route


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Raise on inputs the kernel does not take: shapes, dtypes, ``Dh`` and
    contiguity, then the device and the alignment."""
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"expected q (BH, Sq, Dh) and k, v (BH, Sk, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    dh = q.shape[2]
    if dh % 8 or not 8 <= dh <= MAX_DH:
        raise ValueError(f"flash kernel takes Dh a multiple of 8 up to "
                         f"{MAX_DH}, got {dh}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes bf16 or f32 q, k, v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("flash kernel needs Sq >= 1 and Sk >= 1")
    qkv = (("q", q), ("k", k), ("v", v))
    for name, t in qkv:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    for name, t in qkv:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, route: str = None) -> torch.Tensor:
    """Launch the kernel of the inputs' :func:`route` on checked inputs:
    ``(BH, Sq, Dh)`` in q's dtype.  ``route`` forces one kernel, for timing
    both on one input; one that cannot take the input raises."""
    want = _route_of(q, k, v)
    route = route or want
    if route not in ROUTES or (route == "wgmma" and want != "wgmma"):
        raise ValueError(f"route {route!r} does not take {q.dtype} at Dh "
                         f"{q.shape[2]}")
    bh, sq, dh = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if route == "wgmma":
        err = library().flash_attention_fwd_wgmma(
            *ptrs, bh, sq, k.shape[1], dh, int(causal), stream)
    else:
        err = library().flash_attention_fwd(
            *ptrs, bh, sq, k.shape[1], dh, int(causal), _DTYPES[q.dtype],
            stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel ({route}) failed to "
                           f"launch: CUDA error {err}")
    trace.count("kernels.launches.flash_attention")
    trace.count(f"kernels.routes.flash_attention.{route}")
    return out


class FlashAttention(torch.autograd.Function):
    """The kernel's forward; the backward recomputes through the plain
    version (the flash backward identity: no residual beyond q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ref.flash_attention(*qkv, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """``softmax(q k^T / sqrt(Dh) + mask) v`` for q ``(BH, Sq, Dh)`` and k, v
    ``(BH, Sk, Dh)``, in q's dtype; differentiable.  CUDA tensors only: the
    kernel runs or the call raises."""
    check_inputs(q, k, v)
    return FlashAttention.apply(q, k, v, causal)
