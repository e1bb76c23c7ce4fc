"""The flash-attention kernel's surroundings in the port, on the CPU: the
plain version against the JAX reference's ``ref.flash_attention`` and its
Pallas kernel in interpret mode, the ``torch.autograd.Function``'s backward
against ``jax.grad``, the wrappers' device rules, and the shared ``nvcc``
build helper.

Tolerances, each with its reason:

- f32 outputs: rtol 2e-4, atol 2e-5, the reference's own kernel tolerance
  (``tests/test_kernels.py``): the score and PV sums run in another order;
- bf16 outputs: rtol = atol = 2**-7, two bf16 ulps: both versions compute
  in f32 and round the output to bf16 once, so a sum order can move it by an
  ulp;
- gradients: rtol 2e-4, atol 2e-6, ``tests/test_flash_integration.py``'s
  gradient tolerance.

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it to
the plain version, checks two launches bitwise and the Function's gradients
bitwise against the plain version's.
"""

import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch import trace
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import fused_zstats as tfz
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2**-7, atol=2**-7)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)

# the reference's FLASH_SHAPES (bh, s, dh), as (bh, sq, sk, dh, causal)
FLASH_SHAPES = [(1, 32, 16), (2, 64, 16), (1, 100, 32), (3, 96, 8), (2, 48, 64)]
CASES = [(bh, s, s, dh, True) for bh, s, dh in FLASH_SHAPES] + [
    (2, 48, 100, 32, True),       # Sq < Sk
    (2, 100, 48, 16, True),       # Sq > Sk: rows past Sk see every key
    (3, 70, 100, 32, False),      # non-causal, ragged Sk
    (2, 64, 64, 80, False)]       # Dh = 80


def _qkv(bh, sq, sk, dh, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed + bh * 1000 + sq + 7 * sk + dh)
    return (rng.normal(size=(bh, sq, dh)).astype(dtype),
            rng.normal(size=(bh, sk, dh)).astype(dtype),
            rng.normal(size=(bh, sk, dh)).astype(dtype))


def _ids(cases):
    return [f"bh{c[0]}-sq{c[1]}-sk{c[2]}-dh{c[3]}-{'causal' if c[4] else 'full'}"
            for c in cases]


@pytest.mark.parametrize("bh,sq,sk,dh,causal", CASES, ids=_ids(CASES))
def test_plain_flash_matches_reference_ref(bh, sq, sk, dh, causal):
    q, k, v = _qkv(bh, sq, sk, dh)
    got = tref.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal)
    want = jref.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (bh, sq, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("bh,sq,sk,dh,causal", CASES, ids=_ids(CASES))
def test_plain_flash_matches_pallas_interpret(bh, sq, sk, dh, causal,
                                              monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_PALLAS", "1")
    jops.reset_backend_cache()
    q, k, v = _qkv(bh, sq, sk, dh, seed=1)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal)
    got = tops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


BF16_CASES = [(2, 64, 64, 16, True), (2, 48, 100, 32, True),
              (3, 70, 100, 32, False)]


@pytest.mark.parametrize("bh,sq,sk,dh,causal", BF16_CASES, ids=_ids(BF16_CASES))
def test_plain_flash_bf16_matches_reference(bh, sq, sk, dh, causal):
    q, k, v = _qkv(bh, sq, sk, dh, seed=2)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tref.flash_attention(tq, tk, tv, causal=causal)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jref.flash_attention(jq, jk, jv, causal=causal)
    interp = jflash(jq, jk, jv, causal=causal, block_q=sq, block_k=sk,
                    interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    for w in (want, interp):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(w, np.float32), **BF16_TOL)


# ---------------------------------------------------------------------------
# the autograd Function, with its forward swapped for the plain version
# ---------------------------------------------------------------------------

GRAD_CASES = [(2, 32, 32, 16, True), (1, 100, 100, 32, True),
              (2, 48, 100, 32, True), (3, 40, 64, 16, False)]


@pytest.mark.parametrize("bh,sq,sk,dh,causal", GRAD_CASES, ids=_ids(GRAD_CASES))
def test_function_backward_matches_jax_grad(bh, sq, sk, dh, causal,
                                            monkeypatch):
    """The Function's backward recomputes through ``ref.flash_attention``:
    the same cotangent gives the reference's ``jax.vjp`` of its Pallas
    kernel (whose backward recomputes through its own ``ref``).  Only q, k
    and v are saved for the backward."""
    monkeypatch.setattr(tfa, "launch", lambda q, k, v, causal:
                        tref.flash_attention(q, k, v, causal=causal))
    q, k, v = _qkv(bh, sq, sk, dh, seed=3)
    g = np.random.default_rng(4).normal(size=(bh, sq, dh)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = tfa.FlashAttention.apply(tq, tk, tv, causal)
    assert saved == [q.shape, k.shape, v.shape]
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    jout, vjp = jax.vjp(lambda a, b, c: jflash(
        a, b, c, causal=causal, block_q=sq, block_k=sk, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **F32_TOL)
    for got, want in zip(grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


def test_function_backward_is_the_plain_versions_gradient(monkeypatch):
    """In the port the same ops run: the Function's gradients equal
    ``torch.autograd.grad`` of ``ref.flash_attention`` bit for bit."""
    monkeypatch.setattr(tfa, "launch", lambda q, k, v, causal:
                        tref.flash_attention(q, k, v, causal=causal))
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(2, 40, 40, 16, seed=5))
    g = torch.randn(2, 40, 16, generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(tfa.FlashAttention.apply(q, k, v, True),
                              (q, k, v), g)
    want = torch.autograd.grad(tref.flash_attention(q, k, v, causal=True),
                               (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the wrappers' device rules
# ---------------------------------------------------------------------------

def test_kernel_wrapper_raises_on_cpu_tensors():
    before = tops.launch_counts()["flash_attention"]
    q, k, v = map(torch.from_numpy, _qkv(2, 16, 16, 16))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tfa.flash_attention(q, k, v)
    assert tops.launch_counts()["flash_attention"] == before


@pytest.mark.parametrize("shapes,dtype,error,match", [
    (((2, 8, 12), (2, 8, 12), (2, 8, 12)), torch.float32, ValueError, "Dh"),
    (((2, 8, 264), (2, 8, 264), (2, 8, 264)), torch.float32, ValueError, "Dh"),
    (((2, 8, 16), (2, 9, 16), (2, 8, 16)), torch.float32, ValueError, "expected"),
    (((8, 16), (8, 16), (8, 16)), torch.float32, ValueError, "expected"),
    (((2, 8, 16), (2, 8, 16), (2, 8, 16)), torch.float16, TypeError, "bf16"),
    (((2, 0, 16), (2, 8, 16), (2, 8, 16)), torch.float32, ValueError, "Sq"),
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(shapes, dtype,
                                                              error, match):
    q, k, v = (torch.zeros(s, dtype=dtype, device="meta") for s in shapes)
    with pytest.raises(error, match=match):
        tfa.flash_attention(q, k, v)


def test_kernel_wrapper_rejects_non_contiguous():
    q = torch.zeros(2, 16, 8, device="meta").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q, q.contiguous(), q.contiguous())


def test_ops_dispatch_by_device(monkeypatch):
    """A CPU tensor takes the plain version, bit for bit and without a
    launch; a meta tensor is a dry run's, which raises outside a cost count;
    any other device goes to the kernel's wrapper, which raises where there
    is no kernel (no fallback): meta tensors stand in for such a device
    once the dry run's branch is switched off."""
    q, k, v = map(torch.from_numpy, _qkv(2, 24, 24, 16))
    tops.reset_launch_counts()
    for causal in (True, False):
        assert torch.equal(tops.flash_attention(q, k, v, causal=causal),
                           tref.flash_attention(q, k, v, causal=causal))
    assert tops.launch_counts()["flash_attention"] == 0
    meta = [t.to("meta") for t in (q, k, v)]
    with pytest.raises(ValueError, match="meta tensor runs no kernel"):
        tops.flash_attention(*meta)
    monkeypatch.setattr(tops, "_dry", lambda t: False)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tops.flash_attention(*meta)


# ---------------------------------------------------------------------------
# the choice of kernel
# ---------------------------------------------------------------------------

def _meta(bh, sq, sk, dh, dtype):
    return (torch.zeros(bh, sq, dh, dtype=dtype, device="meta"),
            torch.zeros(bh, sk, dh, dtype=dtype, device="meta"),
            torch.zeros(bh, sk, dh, dtype=dtype, device="meta"))


@pytest.mark.parametrize("bh,sq,sk,dh", [
    (64, 2048, 2048, 128), (64, 2048, 2048, 64),     # the trainer's shape
    (2, 257, 257, 128), (2, 48, 300, 128),           # ragged Sq, Sq < Sk
    (2, 300, 200, 64), (3, 70, 333, 128), (1, 1, 1, 64),
    (2, 300, 300, 256), (2, 100, 77, 256),           # Dh 256: ragged, Sq > Sk
    (32, 2048, 2048, 256)])                          # gemma3-4b under lm_train
def test_route_takes_bf16_dh64_128_and_256_to_wgmma(bh, sq, sk, dh):
    assert tfa.route(*_meta(bh, sq, sk, dh, torch.bfloat16)) == "wgmma"


@pytest.mark.parametrize("bh,sq,sk,dh,dtype", [
    (64, 2048, 2048, 128, torch.float32), (2, 48, 300, 64, torch.float32),
    (2, 130, 130, 80, torch.bfloat16), (2, 300, 300, 256, torch.float32),
    (3, 96, 96, 8, torch.bfloat16), (2, 64, 96, 32, torch.bfloat16)])
def test_route_takes_the_rest_to_mma(bh, sq, sk, dh, dtype):
    assert tfa.route(*_meta(bh, sq, sk, dh, dtype)) == "mma"


def test_route_answers_every_input_check_inputs_takes():
    """``route`` decides on dtype and Dh alone and raises on nothing that
    ``check_inputs`` lets through (here everything up to the device)."""
    for dtype in (torch.float32, torch.bfloat16):
        for dh in range(8, tfa.MAX_DH + 1, 8):
            for sq, sk in ((1, 1), (5, 300), (300, 5)):
                q, k, v = (torch.zeros(1, n, dh, dtype=dtype)
                           for n in (sq, sk, sk))
                with pytest.raises(ValueError, match="no kernel for device"):
                    tfa.check_inputs(q, k, v)
                want = "wgmma" if dtype == torch.bfloat16 and \
                    dh in (64, 128, 256) else "mma"
                assert tfa.route(q, k, v) == want


@pytest.mark.parametrize("dtype,dh,forced", [
    (torch.float32, 128, "wgmma"), (torch.bfloat16, 80, "wgmma"),
    (torch.bfloat16, 128, "tensor-cores")])
def test_launch_refuses_a_route_that_cannot_take_the_input(dtype, dh, forced):
    """A forced route must take the input; the refusal comes before any
    library is built or kernel launched, and counts nothing."""
    before = tops.route_counts()["flash_attention"]
    q, k, v = (torch.zeros(2, 16, dh, dtype=dtype) for _ in range(3))
    with pytest.raises(ValueError, match="does not take"):
        tfa.launch(q, k, v, True, route=forced)
    assert tops.route_counts()["flash_attention"] == before


def test_reset_launch_counts_clears_the_route_counts():
    """The route counts are counters of the port's tracer: a reset of
    the launch counts clears them and leaves the spans' totals."""
    trace.count("kernels.routes.flash_attention.wgmma", 3)
    with trace.span("test.kept"):
        pass
    assert tops.route_counts()["flash_attention"]["wgmma"] >= 3
    tops.reset_launch_counts()
    assert tops.route_counts()["flash_attention"] == {"wgmma": 0, "mma": 0}
    assert trace.totals()["test.kept"]["calls"] >= 1


# ---------------------------------------------------------------------------
# the shared nvcc build helper
# ---------------------------------------------------------------------------

def _fake_nvcc(calls):
    def run(cmd, capture_output, text):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")
    return run


def test_both_libraries_build_from_one_nvcc_command(tmp_path, monkeypatch):
    """``fused_zstats`` and ``flash_attention`` build through
    ``build.build_library``: ``lib<name>-<sha256[:12]>.so`` under
    ``$REPRO_TORCH_BUILD_DIR``, by the command the zstats library always
    used; a second call reuses the library, ``verbose`` adds ``-Xptxas -v``
    and rebuilds."""
    import hashlib
    calls = []
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tbuild.subprocess, "run", _fake_nvcc(calls))
    for mod, name in ((tfz, "zstats"), (tfa, "flash_attention")):
        tag = hashlib.sha256(mod._SRC.read_bytes()).hexdigest()[:12]
        lib, out = mod.build()
        assert lib == tmp_path / f"lib{name}-{tag}.so" and lib.exists()
        tmp = calls[-1][calls[-1].index("-o") + 1]
        assert calls[-1][1:] == [
            "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(mod._SRC)]
        assert Path(calls[-1][0]).name == "nvcc"
        n = len(calls)
        assert mod.build() == (lib, "") and len(calls) == n
        assert mod.build(verbose=True) == (lib, "ptxas info")
        assert calls[-1][1:3] == ["-Xptxas", "-v"]


def test_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tbuild.subprocess, "run", lambda cmd, **kw:
                        subprocess.CompletedProcess(cmd, 2, "", "bad asm"))
    with pytest.raises(RuntimeError, match="bad asm"):
        tfa.build()
