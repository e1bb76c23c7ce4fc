#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # the full check, on one card

Phases, each of which exits non-zero on a failed check:

  1. the card's name and power limit, as ``nvidia-smi`` reports them;
  2. the ``nvcc`` builds of ``src/repro_torch/kernels/csrc/zstats.cu`` and
     ``csrc/flash_attention.cu``, started together, with what ``-Xptxas
     -v`` says of each kernel (registers, spills) and the wgmma flash
     kernel's dynamic shared memory;
  3. every kernel (CUDA ``zstats``, ``zstats_zmap`` and ``zmap_logits``,
     Triton ``dirichlet_expectation`` and ``zstep``) against its plain
     PyTorch version on the card: the edge cases of the reference's kernel
     tests rebuilt from numpy seeds (K = 3, 130 and 2, strided with base,
     masked, several children, the V = 33,000 child, the G = 70,000 prior,
     and K = 100, 64 and 96 with masks, a strided child and long keys;
     for segment latents its ZMAP_KERNEL_CASES, its alpha "zmap" case, two
     zmap children, an unsorted zmap, an empty and an all-masked instance,
     instances of more than PIECE tokens, K = 1024), elog and alpha tables,
     bf16 tables, and each path's shapes;
  4. repeatability: two ``zstats`` calls, and two 3-step runs from one
     state, must be bitwise equal;
  5. the main path: LDA at the NYTimes bag-of-words widths (K = 100,
     V = 102,660, alpha = 0.1, beta = 0.05) over a planted corpus of 30,000
     documents of mean length 332 (about 10M tokens), through
     ``models.make`` -> ``observe`` -> ``Model.infer(steps=10)`` ->
     ``get_result``, with the launch counts set to 0 just before and read
     just after;
  6. times (CUDA events) of each kernel, its plain version and its bound at
     the main path's shapes (the Elog pass on phi also by its two Triton
     launches, row sums and elementwise), and the VMP step's ms and
     tokens/s;
  7. SVI (``core/svi.py``) over the main path's program, run after phase 6
     while it exists, with Hoffman et al.'s defaults (batches of 1,024
     documents, kappa 0.7, tau 10, padding to 256, 5% held out, evaluated
     every 10 steps with 10 local passes): one step at |B| = G, exact caps
     and rho = 1 bitwise one VMP step; a batch padded to 256 within 2e-5 of
     it at exact caps (the masked kernel route against the unmasked one);
     the documents outside a batch keep their theta rows bitwise; two
     5-step runs bitwise; the 30-step fit (launch counts set to 0 just
     before and read just after: ``zstats`` once a step and 11 times an
     evaluation), every ELBO finite and the held-out ELBO rising;
     ``zstats`` (masked) and the Elog pass at one batch's inputs against
     their plain versions; per step the host clock, tokens/s, and inside
     the same steps the ``slice_arrays``, owner-plan and host-to-device ms,
     device ms and idle share under the profiler, and the held-out
     evaluation's ms.  SLDA and naive Bayes (after their VMP phases) each
     hold batch 0 padded against exact caps within 2e-5 and run 5 padded
     SVI steps with a held-out evaluation through ``zstats_zmap`` (launch
     counts set to 0 just before and read just after), then hold
     ``zstats_zmap`` and ``zmap_logits`` against their plain versions at
     one padded batch's inputs; naive Bayes first holds one step at
     |B| = G bitwise against VMP.  Then the ``lda_ooc`` phase, while the
     main path's corpus exists: the corpus written to disk shards in a
     temporary directory (removed at exit) and streamed through
     ``SVI(sharded_template(...), corpus=, prefetch=True)``, whose slice
     (``slice_sharded``) and owner plans are built on the prefetch thread:
     the 30-step fit bitwise ``lda_svi``'s (its digest), the peak host
     buffers and shard bytes read, per step the host clock, tokens/s, the
     thread's slice and plan ms, the caller's wait and copy ms, device ms
     and idle share beside ``lda_svi``'s; 20 steps with a session every 5
     crashed by ``svi.step=raise@13`` and resumed, and run by a child
     process armed with ``REPRO_FAULTS="svi.step=kill@13"`` (it must die
     by SIGKILL), resumed here: both bitwise the uninterrupted 20 steps; a
     growing corpus (the first 20,000 documents, the rest appended after
     step 10): the population rises at the next epoch boundary, every ELBO
     finite, the held-out documents' theta rows untouched, and a crash at
     step 27 resumed bitwise; ``run_inference`` with checkpoints, half the
     main path's steps and a resume for the rest, bitwise its digest;
     ``zstats`` and the Elog pass at one out-of-core batch;
  8. the segment-latent path: SLDA at the same widths over the same corpus,
     cut into sentences of 7 tokens (about 1.44M sentences), through
     ``models.make("slda")`` -> ``observe`` + ``bind("sents")`` ->
     ``make_engine("vmp", steps=10).fit`` -> ``get_result("z")``, with the
     same checks and two bitwise repeats; then naive Bayes at the 20
     Newsgroups widths (C = 20, V = 61,188, 18,774 documents of mean length
     332), 5 steps, the same checks.  On each path every kernel it runs
     (``zstats_zmap``, ``zmap_logits``, ``dirichlet_expectation``,
     ``zstep``) is held against its plain version on the path's own inputs
     and timed beside its bound, with the path's launch counts;
  9. both ``flash_attention`` kernels against ``ref.flash_attention``: the
     reference's FLASH_SHAPES, Sq != Sk, a non-causal ragged Sk, Dh = 80 and
     256, ragged and multi-tile cases at Dh 64 and 128, and the trainer's
     shape (BH = 64, S = 2,048, Dh = 128), each in bf16 and f32 through the
     route ``flash_attention.route`` gives it (checked), the bf16 cases at
     Dh 64 and 128 also through the ``mma`` route; two launches of each
     route bitwise; the autograd Function's gradients bitwise those of the
     plain version for one cotangent; both routes timed in turns beside the
     bound, the plain version's and SDPA's (a yardstick the port never
     calls);
  10. the LM trainer: olmo-1b at full width and depth through
     ``launch.train.train`` (4 steps, batch 4 x 2,048 tokens, bf16 compute,
     f32 parameters from the port's own initialisation, attention through
     the kernel), with the kernel's launch count set to 0 just before and
     read just after (16 layers x 4 forwards, all on the wgmma route),
     step 0's loss at the chance level of the model's own initial logits
     and every loss finite and within 1.5 nats of it, every parameter moved, flash against dense attention on one batch,
     ms per step, tokens/s, the model flops' share of the bf16 peak, peak
     memory, and the device's idle share over 2 steps under the profiler.

Each VMP path, and the SVI fit, logs a sha256 of its final posteriors and
ELBO trace, so that two trees can be shown to give the same output bit for
bit.

The last two lines are a ``{"kernels": [...]}`` JSON object (one entry per
kernel and path, the path named in ``"path"``: lda, lda_svi, lda_ooc,
slda, naive_bayes, lm_train; the flash entry's ``"variant"`` names the kernel the path took and
``"mma_ms"`` is the other one's time in the same call; each
``dirichlet_expectation`` entry's ``"device_ms"`` is its time inside a CUDA
graph, where ``"ms"``, CUDA events around back-to-back calls, times the
host's launches of so small a kernel) and the
``{"ok": true, "device": {...}}`` JSON object.  A fuller report goes to
``chiprun_out/chip_smoke.json``.  The script imports the port only, never
JAX nor the JAX package.
"""

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
DIGAMMA_OPS = 30                # f32 operations of one digamma (shift-by-8 + series)

# the main path: LDA at the UCI NYTimes bag-of-words widths and the repo's
# LDA priors (examples/lda_topics.py), depth cut from 300,000 documents
TOPICS, VOCAB, MEAN_LEN, ALPHA, BETA, SEED = 100, 102660, 332, 0.1, 0.05, 0
REPORT = ROOT / "chiprun_out" / "chip_smoke.json"
# SLDA over the main path's corpus: sentences of 7 tokens inside each
# document (benchmarks/bench_vmp.py's convention)
SENT_LEN = 7
# naive Bayes at the 20 Newsgroups "bydate" widths (20 classes, 61,188
# words, 18,774 documents), the main path's priors and mean length
NB_CLASSES, NB_VOCAB, NB_DOCS, NB_STEPS = 20, 61188, 18774, 5

ZSTATS_TOL = dict(rtol=2e-4, atol=2e-4, lse_rtol=2e-5)
DE_TOL = dict(rtol=2e-4, atol=2e-4)
ZSTEP_TOL = dict(rtol=1e-5, atol=1e-6)

# (n, k, gp, [(gf, kf, stride, base?, mask?, zmap?)...], zmask, nz): the
# shapes of the reference's ZSTATS_CASES and ALPHA_CASES, plus K = 2
ZSTATS_CASES = {
    "k3": (64, 3, 5, [(3, 17, 1, False, False, False)], False, None),
    "k4": (300, 4, 20, [(4, 33, 1, False, False, False)], False, None),
    "k130": (129, 130, 7, [(130, 5, 1, False, False, False)], False, None),
    "masked": (200, 4, 12, [(4, 21, 1, False, True, False)], True, None),
    "strided-base": (150, 3, 9, [(30, 11, 3, True, False, False)], False, None),
    "strided-masked": (150, 3, 9, [(30, 11, 3, True, True, False)], True, None),
    "stride1-base": (100, 5, 8, [(5, 12, 1, True, False, False)], False, None),
    "multi-child": (120, 3, 6, [(3, 19, 1, False, False, False),
                                (21, 9, 7, True, True, False)], True, None),
    "k2": (500, 2, 1, [(2, 2, 1, False, False, False)], False, None),
    "k1024": (300, 1024, 9, [(1024, 50, 1, False, True, False)], True, None),
    "child-v33000": (4000, 4, 11, [(4, 33000, 1, False, False, False)], False,
                     None),
    "prior-g70000": (4000, 16, 70000, [(16, 33, 1, False, False, False)], True,
                     None),
    # K % 4 == 0 at the main path's lanes per token (4) and at 2: masks, a
    # strided child beside a specialized one, keys of several pieces
    "k100-masked": (300, 100, 20, [(100, 40, 1, False, True, False)], True,
                    None),
    "k100-multi": (250, 100, 9, [(100, 33, 1, False, False, False),
                                 (300, 11, 2, True, True, False)], True, None),
    "k64": (200, 64, 7, [(64, 21, 1, False, False, False)], False, None),
    "k96-long-pieces": (3000, 96, 3, [(96, 5, 1, False, False, False)], False,
                        None),
}
# segment latents: the reference's ZMAP_KERNEL_CASES (masked specialized,
# strided with base, zmap child beside a flat child), two zmap children,
# naive Bayes' long instances (about 500 tokens each, over PIECE) and K = 1024
ZMAP_CASES = {
    "zmap-masked": (240, 3, 10, [(3, 15, 1, False, True, True)], True, 40),
    "zmap-strided": (200, 3, 9, [(30, 11, 3, True, True, True)], False, 35),
    "zmap+flat": (300, 3, 8, [(3, 12, 1, False, False, True),
                              (21, 9, 7, True, True, False)], True, 50),
    "two-zmap": (400, 4, 6, [(4, 20, 1, False, True, True),
                             (4, 9, 1, False, False, True)], False, 60),
    "long-instances": (2000, 5, 1, [(5, 300, 1, False, True, True)], False, 4),
    "zmap-k1024": (3000, 1024, 9, [(1024, 50, 1, False, True, True)], True,
                   300),
    "zmap-k100": (3000, 100, 9, [(100, 50, 1, False, True, True),
                                 (300, 11, 2, True, True, False)], True, 300),
}
# the reference's ALPHA_CASES "zmap" (seed 24, concentration tables)
ZMAP_ALPHA_CASE = (24, 240, 3, 10, [(3, 15, 1, False, True, True)], True, 40)
# the LM trainer: olmo-1b (arXiv:2402.00838), the default --arch of the
# trainer and the server, at full width and depth; batch 4 x 2,048 tokens
LM_ARCH, LM_SEQ, LM_BATCH, LM_STEPS = "olmo-1b", 2048, 4, 4
LM_BH = LM_BATCH * 16           # batch x heads: the flash kernel's batch dim
DEV = "cuda"                    # the LM phases' device
BF16_PEAK = 989e12              # H100 SXM dense bf16 tensor-core rate
# the reference's flash kernel tolerance (tests/test_kernels.py): f32 sums
# in another order
FLASH_F32_TOL = dict(rtol=2e-4, atol=2e-5)
# two bf16 ulps: the output is rounded to bf16 on both sides, and the kernel
# rounds the softmax weights P to bf16 for the tensor cores' P v
FLASH_BF16_TOL = dict(rtol=2**-7, atol=2**-7)
# flash against dense attention on one batch, in nats: the dense path rounds
# its scores and weights to bf16, the kernel keeps scores in f32; over 8,192
# tokens the per-token differences average out to well under 1e-2
LM_LOSS_TOL = 1e-2
# a batch's loss against the chance level of its own logits, in nats: ten
# times the spread of a mean over 8,192 tokens of per-token CEs of spread ~1
CHANCE_TOL = 0.1
# the reference's FLASH_SHAPES (bh, s, dh)
FLASH_SHAPES = [(1, 32, 16), (2, 64, 16), (1, 100, 32), (3, 96, 8), (2, 48, 64)]
# (bh, sq, sk, dh, causal) at the wgmma route's head dims: one row, a
# ragged query tile, Sq < Sk and Sq > Sk across kv tiles, a non-causal
# ragged Sk, several full tiles
FLASH_WGMMA_CASES = [(1, 1, 1, 64, True), (2, 257, 257, 128, True),
                     (2, 48, 300, 128, True), (2, 300, 200, 64, True),
                     (3, 70, 333, 128, False), (2, 512, 512, 64, True)]
SHAPES = [(1, 2), (3, 5), (7, 128), (33, 96), (128, 130), (257, 4),
          (64, 300), (1000, 3), (5, 102660), (70000, 16)]


class CheckFailed(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def log(*a):
    print(*a, flush=True)


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


# ---------------------------------------------------------------------------
# inputs and comparisons
# ---------------------------------------------------------------------------

def zcase(seed, n, k, gp, cfgs, zmask=False, nz=None, positive=False,
          dtype=torch.float32, device="cuda"):
    """The reference's ``_zcase`` draws (and ``_gamma_case`` concentrations
    when ``positive``), as port inputs on ``device``."""
    return to_port(zcase_np(seed, n, k, gp, cfgs, zmask, nz, positive),
                   dtype, device)


def zcase_np(seed, n, k, gp, cfgs, zmask=False, nz=None, positive=False):
    """The draws of :func:`zcase` as numpy: ``(prior table, prior rows,
    [(table, values, stride, zmap, base, mask)...], zmask)``."""
    rng = np.random.default_rng(seed)
    nz = nz or n
    et = rng.normal(size=(gp, k)).astype(np.float32)
    rows = rng.integers(0, gp, nz).astype(np.int32)
    raw = []
    for (gf, kf, stride, has_base, has_mask, has_zmap) in cfgs:
        nt = n if has_zmap else nz
        vals = rng.integers(0, kf, nt).astype(np.int32)
        base = rng.integers(0, max(gf - stride * (k - 1), 1), nt).astype(
            np.int32) if has_base else None
        mask = (rng.random(nt) > 0.25).astype(np.float32) if has_mask else None
        zmap = np.sort(rng.integers(0, nz, nt)).astype(np.int32) \
            if has_zmap else None
        tab = rng.normal(size=(gf, kf)).astype(np.float32)
        raw.append((tab, vals, stride, zmap, base, mask))
    zm = (rng.random(nz) > 0.15).astype(np.float32) if zmask else None
    if positive:
        prng = np.random.default_rng(101)

        def pos(t):
            return (prng.gamma(1.0, 1.0, t.shape) + 1e-2).astype(np.float32)
        et = pos(et)
        raw = [(pos(r[0]),) + r[1:] for r in raw]
    return et, rows, raw, zm


def to_port(case, dtype=torch.float32, device="cuda"):
    """A numpy case as the port's ``(table_prior, prior_rows, children,
    zmask)`` on ``device``, tables in ``dtype``."""
    from repro_torch.kernels.ref import ZChild
    et, rows, raw, zm = case

    def dev(a, dt=None):
        if a is None:
            return None
        t = torch.from_numpy(a).to(device)
        return t.to(dt) if dt is not None else t

    children = tuple(ZChild(dev(t, dtype), dev(v), s, dev(z), dev(b), dev(m))
                     for t, v, s, z, b, m in raw)
    return dev(et, dtype), dev(rows), children, dev(zm)


def errors(got, want):
    got, want = got.double(), want.double()
    abs_err = (got - want).abs()
    rel = abs_err / want.abs().clamp_min(1e-30)
    return float(abs_err.max()) if abs_err.numel() else 0.0, \
        float(rel.max()) if rel.numel() else 0.0


def within(got, want, rtol, atol):
    return bool(torch.all((got.double() - want.double()).abs()
                          <= atol + rtol * want.double().abs()))


def compare_zstats(label, got, want, tol=ZSTATS_TOL, name="zstats"):
    """Max abs / rel error of the kernel's outputs against the plain
    version's; fails outside the tolerance."""
    ok = within(got[0], want[0], tol["lse_rtol"], tol["atol"])
    worst = [errors(got[0], want[0])]
    for g, w in [(got[1], want[1])] + list(zip(got[2], want[2])):
        ok &= g.shape == w.shape and within(g, w, tol["rtol"], tol["atol"])
        worst.append(errors(g, w))
    ab, rel = max(e[0] for e in worst), max(e[1] for e in worst)
    log(f"  {name} {label:<28} max_abs {ab:.3e} max_rel {rel:.3e} "
        f"(rtol {tol['rtol']}, atol {tol['atol']}, lse rtol {tol['lse_rtol']}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {label} disagrees with its plain version")
    return ab


def compare(name, label, got, want, tol):
    ab, rel = errors(got, want)
    ok = got.shape == want.shape and within(got, want, tol["rtol"], tol["atol"])
    log(f"  {name} {label:<24} max_abs {ab:.3e} max_rel {rel:.3e} "
        f"(rtol {tol['rtol']}, atol {tol['atol']}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {label} disagrees with its plain version")
    return ab


def output_digest(posteriors, trace):
    """sha256 of the posteriors' f32 bytes (in name order) and the ELBO
    trace's f64 bytes: two runs with one digest gave the same output bit for
    bit."""
    h = hashlib.sha256()
    for n in sorted(posteriors):
        h.update(np.ascontiguousarray(posteriors[n], np.float32).tobytes())
    h.update(np.asarray(trace, np.float64).tobytes())
    return h.hexdigest()


def bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def time_ms(fn, reps, warmup=1):
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(report):
    """Build both CUDA libraries at once (one ``nvcc`` per source, started
    together), print what ``-Xptxas -v`` says of each kernel, and load
    them."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import flash_attention, fused_zstats
    mods = (fused_zstats, flash_attention)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as ex:
        futs = [ex.submit(m.build, verbose=True) for m in mods]
        built = [f.result() for f in futs]
    secs = time.perf_counter() - t0
    for m, (lib, out) in zip(mods, built):
        log(f"[build] nvcc {m._SRC.relative_to(ROOT)} -> {lib.name}")
        entry = ""
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or " 0 bytes spill stores" not in line \
                    and "spill" in line:
                log(f"  {entry[:48]:<48} {line.split(':', 1)[-1].strip()}")
        m.library()
    for dh in flash_attention.WGMMA_DH:
        log(f"  flash_wgmma_kernel<{dh}> dynamic shared memory "
            f"{flash_attention.library().flash_attention_wgmma_smem(dh)} bytes")
    log(f"[build] both libraries in {secs:.2f} s")
    report["build_s"] = secs


def de_plain(a, transpose=False):
    """``dirichlet_expectation``'s plain version, in the kernel's layout."""
    from repro_torch.kernels import ref
    out = ref.dirichlet_expectation(a.float())
    return out.T if transpose else out


def phase_kernels_vs_plain(report):
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zstats as fz
    from repro_torch.kernels import ref
    from repro_torch.kernels import vmp_zstep as zs
    log("[kernels vs plain] edge cases")
    for i, (label, case) in enumerate(ZSTATS_CASES.items()):
        for tables in ("elog", "alpha"):
            args = zcase(100 + i, *case, positive=tables == "alpha")
            compare_zstats(f"{label}/{tables}",
                           fz.zstats(*args, tables=tables),
                           ref.zstats(*args, tables=tables))
    for label in ("k4", "strided-masked", "child-v33000"):
        for tables in ("elog", "alpha"):
            args = zcase(200, *ZSTATS_CASES[label], positive=tables == "alpha",
                         dtype=torch.bfloat16)
            compare_zstats(f"{label}/{tables}/bf16",
                           fz.zstats(*args, tables=tables),
                           ref.zstats(*args, tables=tables))
    for shape in SHAPES:
        rng = np.random.default_rng(shape[0] * 7 + shape[1])
        a = torch.from_numpy((rng.gamma(1.0, 1.0, size=shape) + 1e-2)
                             .astype(np.float32)).cuda()
        compare("dirichlet_expectation", f"{shape}", de.dirichlet_expectation(a),
                de_plain(a), DE_TOL)
        compare("dirichlet_expectation", f"{shape}/T",
                de.dirichlet_expectation(a, transpose=True),
                de_plain(a, transpose=True), DE_TOL)
        ab = a.to(torch.bfloat16)
        compare("dirichlet_expectation", f"{shape}/bf16",
                de.dirichlet_expectation(ab), de_plain(ab), DE_TOL)
        if shape[1] <= 8192:
            x = torch.from_numpy((rng.normal(size=shape) * 4)
                                 .astype(np.float32)).cuda()
            r, lse = zs.zstep(x)
            rp, lp = ref.zstep(x)
            compare("zstep", f"{shape} r", r, rp, ZSTEP_TOL)
            compare("zstep", f"{shape} lse", lse, lp,
                    dict(rtol=1e-5, atol=1e-5))
    torch.cuda.synchronize()


def zmap_variants():
    """(label, numpy case, tables) of every segment-latent case: the cases
    above in elog and alpha mode, the reference's alpha "zmap" case, an
    unsorted zmap, an instance with no tokens beside one whose tokens are
    all masked."""
    out = []
    for i, (label, case) in enumerate(ZMAP_CASES.items()):
        for tables in ("elog", "alpha"):
            out.append((f"{label}/{tables}",
                        zcase_np(400 + i, *case, positive=tables == "alpha"),
                        tables))
    out.append(("alpha-zmap/alpha", zcase_np(*ZMAP_ALPHA_CASE, positive=True),
                "alpha"))
    et, rows, raw, zm = zcase_np(410, *ZMAP_CASES["zmap+flat"])
    perm = np.random.default_rng(411).permutation(len(raw[0][1]))
    tab, vals, stride, zmap, base, mask = raw[0]
    raw[0] = (tab, vals[perm], stride, zmap[perm], base, mask)
    out.append(("unsorted-zmap/elog", (et, rows, raw, zm), "elog"))
    et, rows, raw, zm = zcase_np(412, *ZMAP_CASES["zmap-masked"])
    tab, vals, stride, zmap, base, mask = raw[0]
    zmap = np.where(zmap == 0, 1, zmap).astype(np.int32)     # instance 0: empty
    mask = np.where(zmap == 2, 0.0, mask).astype(np.float32)  # 2: all masked
    raw[0] = (tab, vals, stride, zmap, base, mask)
    out.append(("empty+masked-instance/elog", (et, rows, raw, zm), "elog"))
    return out


def phase_zmap_kernels():
    """``zstats_zmap`` and ``zmap_logits`` against ``ref.zstats`` and
    ``ref.zmap_logits`` on every segment-latent case, f32 and bf16 tables;
    a plan from ``ops.zstats_plan`` and a repeated call change no bit."""
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ops, ref
    log("[kernels vs plain] segment latents (zstats_zmap, zmap_logits)")
    worst = {"zstats_zmap": 0.0, "zmap_logits": 0.0}
    bf16 = ("zmap-masked", "zmap-strided", "zmap+flat")
    for label, case, tables in zmap_variants():
        dtypes = [torch.float32]
        if label.split("/")[0] in bf16:
            dtypes.append(torch.bfloat16)
        for dt in dtypes:
            tag = label + ("/bf16" if dt == torch.bfloat16 else "")
            args = to_port(case, dt)
            worst["zstats_zmap"] = max(worst["zstats_zmap"], compare_zstats(
                tag, fzm.zstats_zmap(*args, tables=tables),
                ref.zstats(*args, tables=tables), name="zstats_zmap"))
            zkids = tuple(c for c in args[2] if c.zmap is not None)
            nz, k = args[1].shape[0], args[0].shape[1]
            worst["zmap_logits"] = max(worst["zmap_logits"], compare(
                "zmap_logits", tag,
                fzm.zmap_logits(zkids, nz, k, tables=tables),
                ref.zmap_logits(zkids, nz, k, tables=tables),
                dict(rtol=ZSTATS_TOL["rtol"], atol=ZSTATS_TOL["atol"])))
    args = to_port(zcase_np(420, *ZMAP_CASES["zmap+flat"]))
    plan = ops.zstats_plan(*args[:3])
    a = fzm.zstats_zmap(*args, plan=plan)
    b = fzm.zstats_zmap(*args)
    check(bitwise((a[0], a[1], *a[2]), (b[0], b[1], *b[2])),
          "zstats_zmap with and without a plan differ")
    log("  zstats_zmap with ops.zstats_plan's plan and without: bitwise equal")
    torch.cuda.synchronize()
    return worst


def make_main_model(args):
    from repro_torch.core import models
    from repro_torch.data import SyntheticCorpus
    t0 = time.perf_counter()
    corpus = SyntheticCorpus(n_docs=args.docs, vocab=VOCAB, n_topics=TOPICS,
                             alpha=ALPHA, beta=BETA, mean_len=MEAN_LEN,
                             seed=SEED).generate()
    m = models.make("lda", alpha=ALPHA, beta=BETA, K=TOPICS, V=VOCAB)
    m["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    prog = m.compile()
    log(f"[main] corpus D={args.docs} V={VOCAB} K={TOPICS} "
        f"N={len(corpus['tokens'])} tokens, made and compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    return corpus, m, prog


def phase_main(args, report, corpus, m, prog):
    from repro_torch.kernels import ops
    n = len(corpus["tokens"])
    steps = args.steps
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.infer(steps=steps, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    after_infer = ops.launch_counts()
    r = m["z"].get_result()
    counts = ops.launch_counts()
    trace = m.elbo_trace
    log(f"[main] infer(steps={steps}) {infer_s:.2f} s (first step builds the "
        f"owner plan); ELBO {trace[0]:.6e} -> {trace[-1]:.6e}")
    log(f"[main] launches: {counts}")
    check(after_infer["zstats"] == steps,
          f"zstats launched {after_infer['zstats']} times in {steps} steps")
    check(counts["dirichlet_expectation"] > 0 and counts["zstep"] == 1,
          f"get_result('z') did not run the Triton kernels: {counts}")
    scale = abs(trace[-1])
    diffs = np.diff(trace)
    check(bool((diffs >= -1e-6 * scale).all()),
          f"ELBO not monotone within 1e-6 relative: {diffs.tolist()}")
    posts = {n: m[n].get_result() for n in ("theta", "phi")}
    digest = output_digest(posts, trace)
    log(f"[main] sha256 of the final posteriors and ELBO trace: {digest}")
    theta, phi = (posts[n].astype(np.float64) for n in ("theta", "phi"))
    sums = {"theta": theta.sum() - theta.size * ALPHA,
            "phi": phi.sum() - phi.size * BETA}
    for name, s in sums.items():
        log(f"[main] sum of {name} stats {s:.1f} vs N = {n} "
            f"(rel {abs(s - n) / n:.2e}, tol 1e-5)")
        check(abs(s - n) <= 1e-5 * n, f"{name} stats do not sum to N")
    row_err = float(np.abs(r.sum(axis=1, dtype=np.float64) - 1.0).max())
    log(f"[main] q(z) {r.shape}: max |row sum - 1| = {row_err:.2e} (tol 1e-5)")
    check(r.shape == (n, TOPICS) and np.isfinite(r).all()
          and row_err <= 1e-5, "q(z) rows do not sum to 1")
    from repro_torch.core.metrics import aligned_tv
    tv = aligned_tv(phi / phi.sum(-1, keepdims=True), corpus["true_phi"])
    log(f"[main] aligned_tv(phi, planted) = {tv:.4f} after {steps} steps")
    report.update(elbo_trace=trace, launches=counts, aligned_tv=tv,
                  infer_s=infer_s, stats_sums=sums, n_tokens=n, digest=digest)
    return counts


def phase_repeat_and_time(args, report, m, prog, counts):
    from repro_torch.core import runtime, vmp
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zstats as fz
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import vmp_zstep as zs
    steps = args.steps
    state = m._state
    spec = prog.latents[0]
    arrays = vmp._program_arrays(prog, state.device)
    f = spec.children[0]
    theta, phi = state.posteriors["theta"], state.posteriors["phi"]
    # zstats' inputs as the VMP step hands them over: Elog tables, phi's
    # made as (V, K) and passed as its (K, V) transpose
    e_theta = de.dirichlet_expectation(theta)
    e_phi = de.dirichlet_expectation(phi, transpose=True).T
    child = ops.ZChild(elog=e_phi, values=arrays[f.x_name]["values"])
    rows = arrays[spec.name]["prior_rows"]
    plan = ops.zstats_plan(e_theta, rows, (child,))
    n = rows.shape[0]

    log("[repeat] bitwise repeatability")
    a = fz.zstats(e_theta, rows, (child,), plan=plan)
    b = fz.zstats(e_theta, rows, (child,), plan=plan)
    check(bitwise((a[0], a[1], *a[2]), (b[0], b[1], *b[2])),
          "two zstats calls on the same inputs differ")
    posts, step = vmp.state_to_numpy(state)
    runs = [runtime.run_inference(prog, steps=3, device="cuda",
                                  state=vmp.state_from_numpy(posts, step, "cuda"))
            for _ in range(2)]
    check(runs[0][1] == runs[1][1] and all(
        torch.equal(runs[0][0].posteriors[k], runs[1][0].posteriors[k])
        for k in posts), "two 3-step runs from one state differ")
    log("  two zstats calls and two 3-step runs from one state: bitwise equal")

    log("[kernels vs plain] main path shapes")
    want = ref.zstats(e_theta, rows, (child,))
    zs_err = compare_zstats("main path", a, want)
    de_err = max(compare("dirichlet_expectation", "theta (D, K)",
                         e_theta, de_plain(theta), DE_TOL),
                 compare("dirichlet_expectation", "phi (K, V) as (V, K)",
                         e_phi.T, de_plain(phi, transpose=True), DE_TOL))
    elog = {"theta": e_theta, "phi": e_phi}
    logits = vmp._messages_to_latent(prog, spec, elog, arrays)
    del elog
    r, lse = zs.zstep(logits)
    rp, lp = ref.zstep(logits)
    zstep_err = max(compare("zstep", "main path r", r, rp, ZSTEP_TOL),
                    compare("zstep", "main path lse", lse, lp,
                            dict(rtol=1e-5, atol=1e-5)))
    del r, lse, rp, lp
    torch.cuda.synchronize()

    log("[times] CUDA events at the main path's shapes")
    g, k = theta.shape
    v = phi.shape[1]
    t_z = time_ms(lambda: fz.zstats(e_theta, rows, (child,), plan=plan),
                  reps=10)
    t_zp = time_ms(lambda: ref.zstats(e_theta, rows, (child,)), reps=3)
    z_bytes = n * 8 + (g * k + k * v) * 4 * 2 + 4
    z_ops = 8 * n * k
    t_de = time_ms(lambda: de.dirichlet_expectation(phi, transpose=True), reps=20)
    t_de_dev = device_ms(lambda: de.dirichlet_expectation(phi, transpose=True))
    t_dep = time_ms(lambda: de_plain(phi, transpose=True).contiguous(), reps=5)
    d_bytes = k * v * 8
    d_ops = DIGAMMA_OPS * k * v
    t_de_theta = time_ms(lambda: de.dirichlet_expectation(theta), reps=20)
    t_s = time_ms(lambda: zs.zstep(logits), reps=5)
    t_sp = time_ms(lambda: ref.zstep(logits), reps=3)
    t_softmax = time_ms(lambda: torch.softmax(logits, dim=-1), reps=5)
    s_bytes = n * k * 8 + n * 4
    s_ops = 5 * n * k
    del logits
    # VMP step: host clock around steps that end in a synchronize
    t_step, step, st = time_steps(prog, state)

    trace = phase_trace(step, st)
    per_step = {name: counts[name] / steps for name in counts}
    kernels = []
    for name, route, src, rep, ms, pms, (bms, by), err in [
        ("zstats", "cuda", "src/repro_torch/kernels/csrc/zstats.cu",
         "src/repro/kernels/fused_zstats.py:685", t_z, t_zp,
         bound(z_bytes, z_ops), zs_err),
        ("dirichlet_expectation", "triton",
         "src/repro_torch/kernels/dirichlet_expectation.py",
         "src/repro/kernels/dirichlet_expectation.py:52", t_de, t_dep,
         bound(d_bytes, d_ops), de_err),
        ("zstep", "triton", "src/repro_torch/kernels/vmp_zstep.py",
         "src/repro/kernels/vmp_zstep.py:40", t_s, t_sp,
         bound(s_bytes, s_ops), zstep_err),
    ]:
        kernels.append(kernel_entry("lda", name, route, src, rep, counts[name],
                                    err, ms, pms, bms, by))
        log(f"  {name:<22} {ms:9.4f} ms  plain {pms:9.4f} ms  bound "
            f"{bms:8.4f} ms ({by})  launches {counts[name]} "
            f"({per_step[name]:.1f} per step)")
    # the Elog pass is small enough that CUDA events around its calls time
    # the host's launches: its entry also carries its device time
    next(e for e in kernels if e["name"] == "dirichlet_expectation")[
        "device_ms"] = t_de_dev
    log(f"  dirichlet_expectation on phi as (V, K): device time {t_de_dev:.4f} "
        f"ms a call (CUDA graph of 20 calls)")
    log(f"  dirichlet_expectation at theta's (D, K) = ({g}, {k}): "
        f"{t_de_theta:.4f} ms, bound {g * k * 8 / HBM_BYTES_PER_S * 1e3:.4f} ms")
    de_split = {"phi": de_passes("phi", phi), "theta": de_passes(
        "theta", theta, transpose=False)}
    log(f"  torch.softmax beside zstep (not used by the port): "
        f"{t_softmax:.4f} ms")
    log(f"  VMP step: {t_step:.2f} ms, {n / t_step * 1e3:.4e} tokens/s "
        f"(N = {n})")
    report.update(kernels=kernels, step_ms=t_step,
                  tokens_per_s=n / t_step * 1e3, softmax_ms=t_softmax,
                  de_theta_ms=t_de_theta, de_passes=de_split,
                  launches_per_step=per_step,
                  trace=trace)
    return kernels


def device_ms(fn, reps=20):
    """Device time per call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph's replays timed with CUDA events.  CUDA events around
    back-to-back calls of a small kernel measure the host's launch cost
    instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, reps=3) / reps
    del graph
    return ms


def de_passes(label, alpha, transpose=True):
    """Log the Elog pass's two Triton launches on ``alpha`` timed apart
    (the row sums into chunk partials, the elementwise pass), each by CUDA
    events and by device time; returns them."""
    from repro_torch.kernels import dirichlet_expectation as de
    part = de.row_sums(alpha)
    runs = {"rowsum": lambda: de.row_sums(alpha),
            "elementwise": lambda: de.elog_from_sums(alpha, part, transpose)}
    out = {"chunks": part.shape[1]}
    for name, fn in runs.items():
        out[f"{name}_ms"] = time_ms(fn, reps=20)
        out[f"{name}_device_ms"] = device_ms(fn)
    log(f"  dirichlet_expectation {label} {tuple(alpha.shape)} by launch "
        f"(events / device): row sums ({part.shape[1]} chunks a row) "
        f"{out['rowsum_ms']:.4f} / {out['rowsum_device_ms']:.4f} ms, "
        f"elementwise{' (transposed)' if transpose else ''} "
        f"{out['elementwise_ms']:.4f} / {out['elementwise_device_ms']:.4f} ms")
    return out


def bound(nbytes, nops, peak=None):
    """(least ms on the card, "bytes" or "operations"): the larger of the
    bytes over the memory rate and the operations over their peak rate (f32
    outside the tensor cores unless ``peak`` is given)."""
    peak = peak or F32_OPS_PER_S
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def kernel_entry(path, name, route, src, replaces, launches, err, ms, plain_ms,
                 bound_ms, bound_by, library_ms=None):
    """One entry of the kernels line; ``path`` names the path (lda, slda,
    naive_bayes) whose run gave ``launches`` and whose shapes were timed."""
    return {"path": path, "name": name, "route": route, "source": src,
            "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def time_steps(prog, state, reps=5):
    """ms per VMP step (host clock around ``reps`` steps, each ending in the
    ELBO's ``float``, after one warm-up step) and the state after them."""
    from repro_torch.core import runtime, vmp
    posts, _ = vmp.state_to_numpy(state)
    step = runtime.make_step(prog, device="cuda")
    st, _ = step(vmp.state_from_numpy(posts, step=0, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        st, elbo = step(st)
        float(elbo)
    return (time.perf_counter() - t0) / reps * 1e3, step, st


# ---------------------------------------------------------------------------
# segment latents: SLDA and naive Bayes through make_engine("vmp")
# ---------------------------------------------------------------------------

def sentences(corpus):
    """Each document cut into sentences of SENT_LEN tokens, the last one
    shorter; no sentence straddles two documents.  Returns (sentence of each
    token, document of each sentence)."""
    lengths, doc_ids = corpus["lengths"], corpus["doc_ids"]
    per_doc = (lengths + SENT_LEN - 1) // SENT_LEN
    first_tok = np.cumsum(lengths) - lengths
    first_sent = np.cumsum(per_doc) - per_doc
    pos = np.arange(len(doc_ids)) - first_tok[doc_ids]
    tok_sent = (first_sent[doc_ids] + pos // SENT_LEN).astype(np.int32)
    sent_doc = np.repeat(np.arange(len(lengths), dtype=np.int32), per_doc)
    return tok_sent, sent_doc


def make_slda(corpus):
    """SLDA at the main path's widths over the main path's corpus."""
    from repro_torch.core import models
    t0 = time.perf_counter()
    tok_sent, sent_doc = sentences(corpus)
    m = models.make("slda", alpha=ALPHA, beta=BETA, K=TOPICS, V=VOCAB)
    m["x"].observe(corpus["tokens"], segment_ids=tok_sent)
    m.bind("sents", sent_doc)
    m.compile()
    log(f"[slda] {len(sent_doc)} sentences of <= {SENT_LEN} tokens over "
        f"{len(corpus['lengths'])} documents, N = {len(tok_sent)}; observed "
        f"and compiled in {time.perf_counter() - t0:.1f} s")
    return m


def make_naive_bayes(args):
    """Naive Bayes at the 20 Newsgroups "bydate" widths over a planted
    corpus of the main path's mean length (depth scaled with --docs)."""
    from repro_torch.core import models
    from repro_torch.data import SyntheticCorpus
    t0 = time.perf_counter()
    docs = max(NB_DOCS * args.docs // 30000, 100)
    corpus = SyntheticCorpus(n_docs=docs, vocab=NB_VOCAB, n_topics=NB_CLASSES,
                             alpha=ALPHA, beta=BETA, mean_len=MEAN_LEN,
                             seed=SEED).generate()
    m = models.make("naive_bayes", alpha=ALPHA, beta=BETA, C=NB_CLASSES,
                    V=NB_VOCAB)
    m["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    m.compile()
    log(f"[naive_bayes] C={NB_CLASSES} V={NB_VOCAB} D={docs} "
        f"N={len(corpus['tokens'])} tokens, made and compiled in "
        f"{time.perf_counter() - t0:.1f} s")
    return m


def phase_segment(label, m, steps, latent, report):
    """One segment-latent path through ``make_engine("vmp").fit`` and
    ``get_result``, launch counts set to 0 just before and read just after,
    with the checks of the main path and two bitwise repeats."""
    from repro_torch.core import make_engine, runtime, vmp
    from repro_torch.kernels import ops
    prog = m.compile()
    spec = prog.latents[0]
    n_inst, n_tok = spec.n, len(spec.children[0].values)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = make_engine("vmp", steps=steps, seed=SEED, device="cuda").fit(m)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_counts = ops.launch_counts()
    r = m[latent].get_result()
    r_again = m[latent].get_result()
    counts = ops.launch_counts()
    trace = res.elbo_trace
    log(f"[{label}] make_engine('vmp', steps={steps}).fit {fit_s:.2f} s "
        f"(first step builds the owner plan); ELBO {trace[0]:.6e} -> "
        f"{trace[-1]:.6e}")
    log(f"[{label}] launches: {counts}")
    check(fit_counts["zstats_zmap"] == steps and fit_counts["zstats"] == 0,
          f"{label}: zstats_zmap launched {fit_counts['zstats_zmap']} times "
          f"in {steps} steps (flat zstats {fit_counts['zstats']})")
    check(counts["zmap_logits"] == 2 and counts["zstep"] == 2,
          f"{label}: get_result did not run zmap_logits and zstep: {counts}")
    diffs = np.diff(trace)
    check(bool((diffs >= -1e-6 * abs(trace[-1])).all()),
          f"{label}: ELBO not monotone within 1e-6 relative: {diffs.tolist()}")
    want = {spec.prior_dir: n_inst, spec.children[0].dir_name: n_tok}
    sums = {}
    for name, n in want.items():
        prior = prog.dirichlets[name].prior.astype(np.float64)
        sums[name] = float((res.posteriors[name].astype(np.float64)
                            - prior[None, :]).sum())
        log(f"[{label}] sum of {name} stats {sums[name]:.1f} vs {n} "
            f"(rel {abs(sums[name] - n) / n:.2e}, tol 1e-5)")
        check(abs(sums[name] - n) <= 1e-5 * n,
              f"{label}: {name} stats do not sum to {n}")
    row_err = float(np.abs(r.sum(axis=1, dtype=np.float64) - 1.0).max())
    log(f"[{label}] q({latent}) {r.shape}: max |row sum - 1| = {row_err:.2e} "
        f"(tol 1e-5)")
    check(r.shape == (n_inst, spec.k) and np.isfinite(r).all()
          and row_err <= 1e-5, f"{label}: q({latent}) rows do not sum to 1")
    check(np.array_equal(r, r_again),
          f"{label}: two get_result('{latent}') calls differ")
    posts, step = vmp.state_to_numpy(m._state)
    runs = [runtime.run_inference(prog, steps=3, device="cuda",
                                  state=vmp.state_from_numpy(posts, step, "cuda"))
            for _ in range(2)]
    check(runs[0][1] == runs[1][1] and all(
        torch.equal(runs[0][0].posteriors[k], runs[1][0].posteriors[k])
        for k in posts), f"{label}: two 3-step runs from one state differ")
    log(f"[{label}] two get_result('{latent}') calls and two 3-step runs "
        f"from one state: bitwise equal")
    _, t16 = runtime.run_inference(prog, steps=3, device="cuda",
                                   state=vmp.state_from_numpy(posts, step, "cuda"),
                                   elog_dtype="bfloat16")
    rel = max(abs(a - b) / abs(b) for a, b in zip(t16, runs[0][1]))
    log(f"[{label}] 3 steps on bf16 concentration tables: ELBO within "
        f"{rel:.2e} of f32 (tol 2e-2, the tables' bf16 rounding)")
    check(rel <= 2e-2, f"{label}: bf16 tables move the ELBO by {rel:.2e}")
    digest = output_digest(res.posteriors, trace)
    log(f"[{label}] sha256 of the final posteriors and ELBO trace: {digest}")
    report[label] = dict(elbo_trace=trace, launches=counts, fit_s=fit_s,
                         stats_sums=sums, n_tokens=n_tok, n_latent=n_inst,
                         digest=digest)
    return counts


def phase_segment_times(label, m, report, counts):
    """Every kernel of a segment-latent path against its plain version on
    the path's own inputs (``zstats_zmap``, ``zmap_logits``, the Elog pass
    on each Dirichlet's table, ``zstep`` on the latent's logits), their
    times and bounds, and the path's entries of the kernels line, with the
    path's ``counts``; then the path's step in ms and tokens/s and its
    trace."""
    from repro_torch.core import vmp
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ref
    from repro_torch.kernels import vmp_zstep as zs
    prog, state = m.compile(), m._state
    spec = prog.latents[0]
    n_inst, n_tok, k = spec.n, len(spec.children[0].values), spec.k
    log(f"[kernels vs plain] {label} shapes")
    arrays = vmp._program_arrays(prog, state.device)
    tabs = vmp._elog_tables(prog, state)
    children = vmp._latent_children(spec, tabs, arrays)
    rows = arrays[spec.name]["prior_rows"]
    plan = vmp.program_plans(prog, arrays)[spec.name]
    prior = tabs[spec.prior_dir]
    err = compare_zstats(f"{label} path", fzm.zstats_zmap(
        prior, rows, children, plan=plan), ref.zstats(prior, rows, children),
        name="zstats_zmap")
    lerr = compare("zmap_logits", f"{label} path",
                   fzm.zmap_logits(children, n_inst, k, plan=plan),
                   ref.zmap_logits(children, n_inst, k),
                   dict(rtol=ZSTATS_TOL["rtol"], atol=ZSTATS_TOL["atol"]))
    # the Elog pass as the step makes it: a specialized child's table as
    # (V, K), the others as they are
    child_dir = spec.children[0].dir_name
    de_err = 0.0
    for name, p in state.posteriors.items():
        tr = name == child_dir
        de_err = max(de_err, compare(
            "dirichlet_expectation", f"{label} {name} {tuple(p.shape)}"
            + (" as (V, K)" if tr else ""),
            de.dirichlet_expectation(p, transpose=tr),
            de_plain(p, transpose=tr), DE_TOL))
    logits = vmp._messages_to_latent(prog, spec, tabs, arrays)
    r, lse = zs.zstep(logits)
    rp, lp = ref.zstep(logits)
    zstep_err = max(compare("zstep", f"{label} r {tuple(logits.shape)}", r,
                            rp, ZSTEP_TOL),
                    compare("zstep", f"{label} lse", lse, lp,
                            dict(rtol=1e-5, atol=1e-5)))
    del r, lse, rp, lp
    torch.cuda.synchronize()

    phi = state.posteriors[child_dir]
    t_z = time_ms(lambda: fzm.zstats_zmap(prior, rows, children, plan=plan),
                  reps=10)
    t_zp = time_ms(lambda: ref.zstats(prior, rows, children), reps=3)
    t_l = time_ms(lambda: fzm.zmap_logits(children, n_inst, k, plan=plan),
                  reps=10)
    t_lp = time_ms(lambda: ref.zmap_logits(children, n_inst, k), reps=3)
    t_de = time_ms(lambda: de.dirichlet_expectation(phi, transpose=True),
                   reps=20)
    t_de_dev = device_ms(lambda: de.dirichlet_expectation(phi, transpose=True))
    t_dep = time_ms(lambda: de_plain(phi, transpose=True).contiguous(), reps=5)
    t_s = time_ms(lambda: zs.zstep(logits), reps=5)
    t_sp = time_ms(lambda: ref.zstep(logits), reps=3)
    del logits
    g = prior.shape[0]
    v = children[0].elog.shape[1]
    tables = (g * k + k * v) * 4
    z_bytes = n_tok * 8 + n_inst * 4 + tables * 2 + 4
    z_ops = 8 * n_inst * k + 4 * n_tok * k
    # logits and r (f32), and the f64 partials of the instances of several
    # pieces (phase 1 writes a one-piece instance's row itself), each
    # written and read once; the K-rows phases 1 and 2b gather, one each a
    # token (the message, r[zmap]), beside them
    n_parts = sum(int(plan.streams[f"latent{j}", "fstart"][-1])
                  for j in range(len(plan.by_latent)))
    inter = 2 * (2 * n_inst * k * 4 + n_parts * k * 8)
    gathered = 2 * n_tok * k * 4
    l_bytes = n_tok * 8 + k * v * 4 + n_inst * k * 4
    l_ops = 2 * n_tok * k
    d_bytes, d_ops = phi.numel() * 8, DIGAMMA_OPS * phi.numel()
    s_bytes, s_ops = n_inst * k * 8 + n_inst * 4, 5 * n_inst * k
    entries = []
    for name, route, src, rep, ms, pms, (bms, by), e in [
        ("zstats_zmap", "cuda", "src/repro_torch/kernels/csrc/zstats.cu",
         "src/repro/kernels/fused_zmap.py:236", t_z, t_zp,
         bound(z_bytes, z_ops), err),
        ("zmap_logits", "cuda", "src/repro_torch/kernels/csrc/zstats.cu",
         "src/repro/kernels/fused_zmap.py:150", t_l, t_lp,
         bound(l_bytes, l_ops), lerr),
        ("dirichlet_expectation", "triton",
         "src/repro_torch/kernels/dirichlet_expectation.py",
         "src/repro/kernels/dirichlet_expectation.py:52", t_de, t_dep,
         bound(d_bytes, d_ops), de_err),
        ("zstep", "triton", "src/repro_torch/kernels/vmp_zstep.py",
         "src/repro/kernels/vmp_zstep.py:40", t_s, t_sp,
         bound(s_bytes, s_ops), zstep_err),
    ]:
        entries.append(kernel_entry(label, name, route, src, rep,
                                    counts[name], e, ms, pms, bms, by))
        log(f"  {name:<22} {ms:9.4f} ms  plain {pms:9.4f} ms  bound "
            f"{bms:8.4f} ms ({by})  launches {counts[name]}")
    next(e for e in entries if e["name"] == "dirichlet_expectation")[
        "device_ms"] = t_de_dev
    log(f"  dirichlet_expectation on {child_dir} as (V, K): device time "
        f"{t_de_dev:.4f} ms a call (CUDA graph of 20 calls)")
    log(f"  zstats_zmap with its intermediates (f32 logits and r, "
        f"{n_parts} f64 partial rows of the logits, each written and read "
        f"once): {(z_bytes + inter) / HBM_BYTES_PER_S * 1e3:.4f} ms of "
        f"traffic; the K-rows that phases 1 and 2b gather (2 N K 4 bytes, "
        f"{gathered / 1e9:.2f} GB): "
        f"{gathered / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate")
    de_split = de_passes(f"{label} {child_dir}", phi)
    t_step, step, st = time_steps(prog, state)
    log(f"  {label} VMP step: {t_step:.2f} ms, {n_tok / t_step * 1e3:.4e} "
        f"tokens/s (N = {n_tok}, {n_inst} latent instances)")
    report[label].update(zstats_zmap_ms=t_z, zmap_logits_ms=t_l,
                         intermediate_bytes=inter, gathered_bytes=gathered,
                         partial_rows=n_parts, de_passes=de_split,
                         step_ms=t_step,
                         tokens_per_s=n_tok / t_step * 1e3,
                         trace=phase_trace(step, st))
    return entries


def phase_trace(step, st, n_steps=2):
    """Device time by kernel over ``n_steps`` VMP steps (torch.profiler),
    and the device's idle share of the steps' wall time."""
    def run():
        nonlocal st
        for _ in range(n_steps):
            st, elbo = step(st)
            float(elbo)
    return profile_steps(run, n_steps)


def profile_steps(run, n_steps, label="trace"):
    """Run ``run()`` (``n_steps`` steps, each ending in a host read of its
    result) under torch.profiler: device time by kernel per step and the
    device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        # kernels only: the aten ops that launch them carry the same time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / n_steps / 1e3, ev.count // n_steps, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    step_ms = wall_us / n_steps / 1e3
    idle = f"{1 - busy_ms / step_ms:.3f}" if rows else "not measured"
    log(f"[{label}] {n_steps} steps under torch.profiler: {step_ms:.3f} ms per "
        f"step, device busy {busy_ms:.3f} ms, idle share {idle}")
    for ms, cnt, key in rows[:12]:
        log(f"  {ms:9.4f} ms/step  x{cnt:<3} {key[:90]}")
    return {"step_ms": step_ms, "busy_ms": busy_ms,
            "kernels": [{"ms_per_step": ms, "calls_per_step": c, "name": k}
                        for ms, c, k in rows]}


# ---------------------------------------------------------------------------
# SVI: minibatches of the main path's program, and of SLDA's and naive Bayes'
# ---------------------------------------------------------------------------

# Hoffman et al. (JMLR 2013)'s defaults, as the reference's SVIConfig carries
# them, at a batch of 1,024 documents (about 340k of the main path's tokens);
# 30 steps are about one epoch of the 28,500 training documents
SVI_BATCH, SVI_STEPS, SVI_REPEAT_STEPS, SVI_SEGMENT_STEPS = 1024, 30, 5, 5
SVI_TIMED_STEPS = 5
# padding leaves the update unchanged up to the order of f32 sums (the
# reference's own bound, tests/test_svi.py)
SVI_PAD_TOL = dict(rtol=2e-5, atol=2e-5, elbo_rtol=1e-5)


def svi_config(**kw):
    from repro_torch.core.svi import SVIConfig
    return SVIConfig(**{**dict(batch_size=SVI_BATCH, kappa=0.7, tau=10.0,
                               pad_multiple=256, holdout_frac=0.05,
                               holdout_every=10, holdout_local_iters=10,
                               seed=SEED), **kw})


def svi_equals_vmp(label, prog):
    """One SVI step at |B| = G, exact caps, rho = 1 and the documents in
    order, from the path's initial state, against one full-batch VMP step
    (``runtime.make_step``): every posterior and the ELBO, bitwise."""
    from repro_torch.core import runtime, vmp
    from repro_torch.core.svi import SVI
    g = prog.meta["pstar_size"]
    s0 = vmp.init_state(prog, SEED, device="cuda")
    want, e_want = runtime.make_step(prog, device="cuda")(s0)
    svi = SVI(prog, svi_config(batch_size=g, rho=1.0, pad_multiple=0,
                               shuffle=False, holdout_frac=0.0),
              device="cuda")
    got, e_got = svi.step(0, s0)
    ok = float(e_got) == float(e_want) and all(
        torch.equal(got.posteriors[n], want.posteriors[n])
        for n in want.posteriors)
    log(f"[{label}] one SVI step at |B| = G = {g}, rho = 1, exact caps, "
        f"against one VMP step: {'bitwise equal' if ok else 'DIFFERENT'} "
        f"(ELBO {float(e_got):.9e} / {float(e_want):.9e})")
    check(ok, f"{label}: SVI at |B| = G, rho = 1 is not bitwise VMP")


def svi_fit_checks(label, cfg, hist, counts, latent_kernel, steps):
    """Every batch ELBO finite, every held-out ELBO finite, and the latent's
    kernel launched ``local_iters`` times a step and ``holdout_local_iters
    + 1`` times an evaluation."""
    evals = len(hist["heldout"])
    want = steps * cfg.local_iters + evals * (cfg.holdout_local_iters + 1)
    log(f"[{label}] batch ELBO {hist['elbo'][0]:.6e} -> "
        f"{hist['elbo'][-1]:.6e}; held-out per token "
        f"{[round(v, 6) for _, v in hist['heldout']]} at steps "
        f"{[t for t, _ in hist['heldout']]}")
    log(f"[{label}] launches: {counts}")
    check(len(hist["elbo"]) == steps and np.isfinite(hist["elbo"]).all(),
          f"{label}: a batch ELBO is not finite")
    check(evals > 0 and np.isfinite([v for _, v in hist["heldout"]]).all(),
          f"{label}: a held-out ELBO is not finite")
    check(counts[latent_kernel] == want,
          f"{label}: {latent_kernel} launched {counts[latent_kernel]} times, "
          f"not {want} ({steps} steps, {evals} held-out evaluations)")
    check(counts["dirichlet_expectation"] > 0,
          f"{label}: the Elog pass did not launch")


def svi_batch_inputs(fit, state, t):
    """The inputs the step hands its latent's kernel on batch ``t``: the
    batch's slice, owner plan and masks on the card, the step's own sliced
    state (``svi.sliced_state``: the batch's local rows, padding rows at the
    prior) and its Elog tables.  Returns (n_tokens, sliced state, (args of
    zstats), plan, the shadow's latent)."""
    from repro_torch.core import compiler, vmp
    from repro_torch.core import svi as svi_mod
    prog = fit.program
    hb, caps, n_tok = fit._load_groups(fit.sampler.batch_at(t))[:3]
    batch = svi_mod.device_put_batch(hb, "cuda")
    shadow = compiler.sliced_shadow(prog, caps)
    st = svi_mod.sliced_state(prog, state, batch)
    tabs = vmp._elog_tables(shadow, st)
    spec = shadow.latents[0]
    a = batch["arrays"]
    args = (tabs[spec.prior_dir], a[spec.name]["prior_rows"],
            vmp._latent_children(spec, tabs, a), a[spec.name]["mask"])
    return n_tok, st, args, batch["plans"][spec.name], spec


def svi_pad_check(label, prog, fit, s0):
    """Batch 0 of ``fit`` at exact caps against the same batch padded to
    the fit's caps (the masked kernel route against the unmasked one), one
    step at rho 0.5 and scale 2 from ``s0``: every posterior within
    SVI_PAD_TOL and the ELBO within its rtol.  Returns (the batch's groups,
    the padded step's state, the largest posterior difference)."""
    from repro_torch.core import svi as svi_mod
    groups = fit.sampler.batch_at(0)
    stepped = {}
    for kind, caps_fn in (("exact", None), ("padded", fit._caps_fn)):
        batch, caps, n_tok = svi_mod.device_batch(prog, groups, caps_fn,
                                                  "cuda")
        stepped[kind] = svi_mod.make_svi_step(prog, caps)(s0, batch, 0.5, 2.0)
    (se, ee), (sp, ep) = stepped["exact"], stepped["padded"]
    tol = SVI_PAD_TOL
    ok = abs(float(ep) - float(ee)) <= tol["elbo_rtol"] * abs(float(ee))
    worst = 0.0
    for n in se.posteriors:
        ok &= within(sp.posteriors[n], se.posteriors[n], tol["rtol"],
                     tol["atol"])
        worst = max(worst, errors(sp.posteriors[n], se.posteriors[n])[0])
    log(f"[{label}] batch 0 ({len(groups)} documents, {n_tok} tokens) padded "
        f"to caps {caps} against exact caps, rho 0.5, scale 2: posteriors "
        f"max_abs {worst:.3e}, ELBO {float(ep):.9e} / {float(ee):.9e} (rtol "
        f"{tol['rtol']}, atol {tol['atol']}, ELBO rtol {tol['elbo_rtol']}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: padding changes the update")
    return groups, sp, worst


def phase_lda_svi(report, prog):
    """SVI over the main path's program: bitwise VMP at |B| = G, padding
    invariance, untouched rows, two bitwise 5-step runs, the 30-step fit
    with its launch counts, ``zstats`` (masked route) and the Elog pass
    against their plain versions at one batch's inputs, and the step's time
    split between the host (slicing, owner plan, copy) and the card."""
    from repro_torch.core import vmp
    from repro_torch.core import svi as svi_mod
    from repro_torch.kernels import ops
    label = "lda_svi"
    out = report[label] = {}
    svi_equals_vmp(label, prog)
    g = prog.meta["pstar_size"]
    s0 = vmp.init_state(prog, SEED, device="cuda")
    cfg = svi_config()
    fit = svi_mod.SVI(prog, cfg, device="cuda")

    groups, sp, worst = svi_pad_check(label, prog, fit, s0)
    rest = torch.from_numpy(np.setdiff1d(np.arange(g), groups)).cuda()
    mine = torch.from_numpy(groups).cuda()
    theta0, theta1 = s0.posteriors["theta"], sp.posteriors["theta"]
    ok = torch.equal(theta1[rest], theta0[rest]) \
        and not torch.equal(theta1[mine], theta0[mine])
    log(f"[{label}] the {len(rest)} documents outside the batch keep their "
        f"theta rows bitwise, the batch's move: {'ok' if ok else 'FAIL'}")
    check(ok, f"{label}: a step wrote theta rows outside its batch")
    del sp

    digests = []
    for _ in range(2):
        st, hist = svi_mod.SVI(prog, cfg, device="cuda").fit(
            SVI_REPEAT_STEPS, state=s0)
        digests.append(output_digest(vmp.state_to_numpy(st)[0],
                                     hist["elbo"] + [v for _, v in
                                                     hist["heldout"]]))
    log(f"[{label}] two {SVI_REPEAT_STEPS}-step runs from one state: sha256 "
        f"{digests[0]} / {digests[1]}")
    check(digests[0] == digests[1], f"{label}: two runs from one state differ")

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = fit.fit(SVI_STEPS, state=s0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    svi_fit_checks(label, cfg, hist, counts, "zstats", SVI_STEPS)
    held = [v for _, v in hist["heldout"]]
    log(f"[{label}] fit({SVI_STEPS}) {fit_s:.2f} s; held-out per-token ELBO "
        f"{held[0]:.6f} -> {held[-1]:.6f}")
    check(held[-1] > held[0], f"{label}: the held-out ELBO did not rise")
    digest = output_digest(vmp.state_to_numpy(state)[0], hist["elbo"] + held)
    log(f"[{label}] sha256 of the final posteriors, batch and held-out ELBO "
        f"traces: {digest}")

    entries = svi_flat_kernels(label, fit, state, counts)
    out.update(svi_step_times(label, fit, state, report["device"]))
    out.update(elbo_trace=hist["elbo"], heldout=hist["heldout"],
               launches=counts, fit_s=fit_s, digest=digest,
               repeat_digests=digests, pad_max_abs=worst)
    return entries


def svi_flat_kernels(label, fit, state, counts):
    """``zstats`` (the masked flat route) and the Elog pass at the inputs
    of ``fit``'s batch SVI_STEPS from ``state``, held against their plain
    versions and timed beside their bound; the kernels-line entries of
    path ``label`` with the launch ``counts`` of its fit."""
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zstats as fz
    from repro_torch.kernels import ref
    log(f"[kernels vs plain] {label}: one batch's inputs (padded, masked)")
    n_tok, st_b, args, plan, _ = svi_batch_inputs(fit, state, SVI_STEPS)
    theta_b = st_b.posteriors["theta"]
    zerr = compare_zstats(f"{label} batch", fz.zstats(*args, plan=plan),
                          ref.zstats(*args))
    de_err = compare("dirichlet_expectation", f"{label} theta rows "
                     f"{tuple(theta_b.shape)}",
                     de.dirichlet_expectation(theta_b), de_plain(theta_b),
                     DE_TOL)
    t_z = time_ms(lambda: fz.zstats(*args, plan=plan), reps=20)
    t_zp = time_ms(lambda: ref.zstats(*args), reps=3)
    t_de = time_ms(lambda: de.dirichlet_expectation(theta_b), reps=20)
    t_de_dev = device_ms(lambda: de.dirichlet_expectation(theta_b))
    t_dep = time_ms(lambda: de_plain(theta_b).contiguous(), reps=5)
    cap, k = args[1].shape[0], theta_b.shape[1]
    v = args[2][0].elog.shape[1]
    # the prior rows, values, zmask and token mask each read once, both
    # tables read and both stats written once; the work of the batch's
    # real tokens
    z_bytes = cap * 16 + (theta_b.shape[0] * k + k * v) * 4 * 2 + 4
    z_ops = 8 * n_tok * k
    d_bytes, d_ops = theta_b.numel() * 8, DIGAMMA_OPS * theta_b.numel()
    entries = []
    for name, route, src, rep, ms, pms, (bms, by), e in [
        ("zstats", "cuda", "src/repro_torch/kernels/csrc/zstats.cu",
         "src/repro/kernels/fused_zstats.py:685", t_z, t_zp,
         bound(z_bytes, z_ops), zerr),
        ("dirichlet_expectation", "triton",
         "src/repro_torch/kernels/dirichlet_expectation.py",
         "src/repro/kernels/dirichlet_expectation.py:52", t_de, t_dep,
         bound(d_bytes, d_ops), de_err),
    ]:
        entries.append(kernel_entry(label, name, route, src, rep,
                                    counts[name], e, ms, pms, bms, by))
        log(f"  {name:<22} {ms:9.4f} ms  plain {pms:9.4f} ms  bound "
            f"{bms:8.4f} ms ({by})  launches {counts[name]}")
    entries[-1]["device_ms"] = t_de_dev
    log(f"  dirichlet_expectation on the batch's theta rows: device time "
        f"{t_de_dev:.4f} ms a call (CUDA graph of 20 calls)")
    del args, plan, theta_b, st_b
    return entries


def svi_step_times(label, fit, state, dev_line, warm=0):
    """Per step, over SVI_TIMED_STEPS steps after the fit (and ``warm``
    untimed ones): host-clock ms of ``SVI.step`` (each ending in the ELBO's
    ``float``) and tokens/s, and inside those same steps the host ms of the
    slicing, of the owner plans and of the host-to-device copy
    (``SVI.host_ms``; out of core the first two on the prefetch thread, and
    the caller's wait for the batch); device ms and idle share under
    torch.profiler over the next SVI_TIMED_STEPS steps; the held-out
    evaluation's ms, cold (slice and plan) and cached."""
    from repro_torch.core import svi as svi_mod
    prog = fit.program
    st = state
    for t in range(SVI_STEPS, SVI_STEPS + warm):
        st, elbo = fit.step(t, st)
        float(elbo)
    t_first = SVI_STEPS + warm
    steps = range(t_first, t_first + SVI_TIMED_STEPS)
    tokens = float(np.mean([fit._weights[fit.sampler.batch_at(t)].sum()
                            for t in steps]))
    fit.host_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in steps:
        st, elbo = fit.step(t, st)
        float(elbo)
    step_ms = (time.perf_counter() - t0) / len(steps) * 1e3
    parts, fit.host_ms = fit.host_ms, None
    ms = {k: float(np.mean([p[k] for p in parts])) for k in parts[0]}
    st2 = st

    def run():
        nonlocal st2
        for t in range(t_first + SVI_TIMED_STEPS,
                       t_first + 2 * SVI_TIMED_STEPS):
            st2, elbo = fit.step(t, st2)
            float(elbo)
    trace = profile_steps(run, SVI_TIMED_STEPS, label=f"{label} trace")
    t0 = time.perf_counter()
    svi_mod.heldout_elbo(prog, st, fit.holdout, fit.cfg.holdout_local_iters,
                         cache={}, slicer=fit._slicer)
    cold_ms = (time.perf_counter() - t0) * 1e3
    fit.heldout_elbo(st)
    t0 = time.perf_counter()
    fit.heldout_elbo(st)
    held_ms = (time.perf_counter() - t0) * 1e3
    host = ms["slice"] + ms["plan"] + ms["h2d"]
    idle = (f"{1 - trace['busy_ms'] / trace['step_ms']:.3f}"
            if trace["busy_ms"] > 0 else "not measured")
    if "wait" in ms:
        caller = ms["wait"] + ms["h2d"]
        split = (f"slice_sharded {ms['slice']:.2f} ms and owner plan "
                 f"{ms['plan']:.2f} ms on the prefetch thread; on the "
                 f"caller's thread the wait for the batch {ms['wait']:.2f} "
                 f"ms, H2D {ms['h2d']:.2f} ms ({caller:.2f} ms before the "
                 f"kernels, {step_ms - caller:.2f} ms the rest)")
    else:
        split = (f"slice_arrays {ms['slice']:.2f} ms, owner plan "
                 f"{ms['plan']:.2f} ms, H2D {ms['h2d']:.2f} ms ({host:.2f} "
                 f"ms of host work before the kernels, {step_ms - host:.2f} "
                 f"ms the rest)")
    log(f"[{label} times] {dev_line}: per step over {len(steps)} steps of "
        f"{tokens:.0f} tokens: {step_ms:.2f} ms host clock, "
        f"{tokens / step_ms * 1e3:.4e} tokens/s; inside those steps "
        f"{split}; device "
        f"{trace['busy_ms']:.3f} ms a step, idle share {idle}; held-out "
        f"evaluation ({len(fit.holdout)} documents, "
        f"{fit.cfg.holdout_local_iters + 1} step bodies) {held_ms:.2f} ms "
        f"cached, {cold_ms:.2f} ms cold")
    return dict(step_ms=step_ms, tokens_per_step=tokens,
                tokens_per_s=tokens / step_ms * 1e3, slice_ms=ms["slice"],
                plan_ms=ms["plan"], h2d_ms=ms["h2d"],
                wait_ms=ms.get("wait"), host_parts=parts,
                heldout_ms=held_ms, heldout_cold_ms=cold_ms, trace=trace,
                idle_share=(1 - trace["busy_ms"] / trace["step_ms"]
                            if trace["busy_ms"] > 0 else None))


# ---------------------------------------------------------------------------
# out of core: the main path's corpus on disk, streamed; sessions and
# crash-resume; a growing corpus; VMP checkpoints
# ---------------------------------------------------------------------------

# 20 steps with a session every 5, the crash entering step 12 (the 13th
# trip of "svi.step"); the growing run: the first two thirds of the
# documents (20,000 of 30,000), the rest appended after step 10, a crash
# entering step 27
OOC_STEPS, OOC_EVERY, OOC_CRASH_AT = 20, 5, 13
GROW_APPEND_AFTER, GROW_CRASH_AT = 10, 28
CHILD_TIMEOUT = 600

# the child of the SIGKILL check: the 20 out-of-core steps with sessions,
# armed through REPRO_FAULTS; it loads the kernel library the parent built
OOC_CHILD = """
import sys
sys.path.insert(0, {src!r})
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from repro_torch.core import models
from repro_torch.core.svi import SVI, SVIConfig
from repro_torch.data import ShardedCorpus, sharded_template
corpus = ShardedCorpus.open({path!r})
model = models.make("lda", alpha={alpha!r}, beta={beta!r}, K={k!r}, V={v!r})
fit = SVI(sharded_template(model, corpus), SVIConfig(**{cfg!r}),
          corpus=corpus, device="cuda")
fit.fit({steps!r}, checkpoint_dir={ck!r}, checkpoint_every={every!r},
        callback=lambda t, e: print(f"STEP {{t}}", flush=True))
print("DONE", flush=True)
"""


def ooc_config(**kw):
    """:func:`svi_config` as keyword values (the child rebuilds it)."""
    cfg = svi_config(**kw)
    return {f: getattr(cfg, f) for f in (
        "batch_size", "kappa", "tau", "pad_multiple", "holdout_frac",
        "holdout_every", "holdout_local_iters", "seed", "growing",
        "capacity_docs", "prefetch")}


def states_bitwise(a, b, ha, hb):
    """Posteriors and step of two SVI states, and their histories (batch
    and held-out ELBO), all equal bit for bit."""
    return int(a.step) == int(b.step) and ha == hb and all(
        torch.equal(a.posteriors[n], b.posteriors[n]) for n in a.posteriors)


def ooc_sessions(label, tmp, tmpl, path):
    """Crash-resume out of core: the uninterrupted OOC_STEPS; the same run
    with ``svi.step`` armed to raise entering step OOC_CRASH_AT - 1,
    resumed in this process from its newest session; a child process with
    the same steps armed through REPRO_FAULTS to SIGKILL itself there, the
    parent resuming from its newest valid session.  Both resumes must end
    bitwise at the uninterrupted run."""
    import os
    from repro_torch.checkpoint import latest_session_step
    from repro_torch.core.svi import SVI
    from repro_torch.data import ShardedCorpus
    from repro_torch.testing import faults
    cfg = svi_config()

    def svi():
        return SVI(tmpl, cfg, corpus=ShardedCorpus.open(path), device="cuda")

    t0 = time.perf_counter()
    ref = svi()
    want, want_h = ref.fit(OOC_STEPS)
    ref.close()
    ck = str(tmp / "ck_raise")
    crash = svi()
    with faults.inject("svi.step", nth=OOC_CRASH_AT):
        try:
            crash.fit(OOC_STEPS, checkpoint_dir=ck, checkpoint_every=OOC_EVERY)
            raised = False
        except faults.InjectedCrash:
            raised = True
    crash.close()
    step = latest_session_step(ck)
    again = svi()
    got, got_h = again.fit(OOC_STEPS - (step or 0), checkpoint_dir=ck,
                           resume_from=True)
    again.close()
    ok = raised and step == 10 and states_bitwise(got, want, got_h, want_h)
    log(f"[{label}] crash-resume in one process: svi.step=raise@"
        f"{OOC_CRASH_AT} {'raised' if raised else 'DID NOT RAISE'}, newest "
        f"session at step {step}, resumed {OOC_STEPS - (step or 0)} steps: "
        f"{'bitwise the uninterrupted run' if ok else 'DIFFERENT'} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(ok, f"{label}: in-process crash-resume is not bitwise")

    t0 = time.perf_counter()
    ck = str(tmp / "ck_kill")
    code = OOC_CHILD.format(src=str(ROOT / "src"), path=path, alpha=ALPHA,
                            beta=BETA, k=TOPICS, v=VOCAB, cfg=ooc_config(),
                            steps=OOC_STEPS, ck=ck, every=OOC_EVERY)
    env = dict(os.environ, **{faults.ENV_VAR: f"svi.step=kill@{OOC_CRASH_AT}"})
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True,
                         timeout=CHILD_TIMEOUT)
    done = [int(line.split()[1]) for line in res.stdout.splitlines()
            if line.startswith("STEP ")]
    step = latest_session_step(ck)
    log(f"[{label}] SIGKILL child: exit {res.returncode} after "
        f"{time.perf_counter() - t0:.1f} s, steps {done[:1]}..{done[-1:]} "
        f"done, newest valid session at step {step}")
    if res.returncode != -9:
        log(res.stderr[-4000:])
    check(res.returncode == -9 and done == list(range(OOC_CRASH_AT - 1))
          and step is not None,
          f"{label}: the child did not die by SIGKILL entering step "
          f"{OOC_CRASH_AT - 1} with a session")
    again = svi()
    got, got_h = again.fit(OOC_STEPS - step, checkpoint_dir=ck,
                           resume_from=True)
    again.close()
    ok = states_bitwise(got, want, got_h, want_h)
    log(f"[{label}] resumed the killed child's run from step {step}: "
        f"{'bitwise the uninterrupted run' if ok else 'DIFFERENT'}")
    check(ok, f"{label}: resume after SIGKILL is not bitwise")
    return {"crash_session_step": 10, "kill_session_step": step}


def ooc_growing(label, tmp, corpus):
    """A growing corpus: the first two thirds of the documents on disk, a
    template with room for all, SVI_STEPS steps with growing=True and a
    session every OOC_EVERY; a callback appends the rest and commits after
    step GROW_APPEND_AFTER.  The population rises at the next epoch
    boundary (the epochs snapshotted before the append hold the first
    documents less their holdout, those after it all documents less the
    same holdout), every ELBO is finite, the held-out documents' theta
    rows keep their initial values; the same run with ``svi.step`` armed
    to raise entering step GROW_CRASH_AT - 1, resumed from its newest
    session (whose epoch snapshots span the growth), ends bitwise at the
    uninterrupted one.  Each run grows its own copy of the first
    documents' shards."""
    from repro_torch.checkpoint import latest_session_step, load_session
    from repro_torch.core import models, vmp
    from repro_torch.core.svi import SVI
    from repro_torch.data import (ShardedCorpus, ShardedCorpusWriter,
                                  sharded_template)
    from repro_torch.testing import faults
    tokens, lengths = corpus["tokens"], corpus["lengths"]
    n_docs = len(lengths)
    grow_docs = n_docs * 2 // 3
    cut = int(lengths[:grow_docs].sum())
    cfg = svi_config(growing=True, capacity_docs=n_docs)

    def start(name):
        w = ShardedCorpusWriter(str(tmp / name), vocab=VOCAB)
        w.add_docs(tokens[:cut], lengths[:grow_docs])
        sc = w.commit()
        model = models.make("lda", alpha=ALPHA, beta=BETA, K=TOPICS, V=VOCAB)
        return w, sharded_template(model, sc, capacity_docs=n_docs), sc

    def append_after(w):
        def cb(t, elbo):
            if t == GROW_APPEND_AFTER:
                w.add_docs(tokens[cut:], lengths[grow_docs:])
                w.close()
        return cb

    t0 = time.perf_counter()
    w, tmpl, sc = start("grow_ref")
    s0 = vmp.init_state(tmpl, SEED, device="cuda")
    fit = SVI(tmpl, cfg, corpus=sc, device="cuda")
    want, want_h = fit.fit(SVI_STEPS, state=s0, callback=append_after(w),
                           checkpoint_dir=str(tmp / "ck_grow_ref"),
                           checkpoint_every=OOC_EVERY)
    fit.close()
    epochs = fit.sampler._inner.epoch_log()
    n_hold = len(fit.holdout)
    pre, post = grow_docs - n_hold, n_docs - n_hold
    grown = [s for s, n in epochs if s >= GROW_APPEND_AFTER + 2]
    pop_ok = bool(grown) and all(
        n == pre for s, n in epochs if s <= GROW_APPEND_AFTER) and all(
        n == post for s, n in epochs if s >= GROW_APPEND_AFTER + 2)
    pops = [fit.sampler.population_at(t) for t in (0, grown[0] - 1,
                                                   grown[0])] \
        if grown else []
    hold = torch.from_numpy(fit.holdout).cuda()
    held_ok = torch.equal(want.posteriors["theta"][hold],
                          s0.posteriors["theta"][hold])
    finite = bool(np.isfinite(want_h["elbo"]).all()) and bool(
        np.isfinite([v for _, v in want_h["heldout"]]).all())
    log(f"[{label}] growing: {grow_docs} documents, {n_docs - grow_docs} "
        f"appended after step {GROW_APPEND_AFTER}; epochs (start step, "
        f"population) {epochs}: population {pops[:1]} at step 0, "
        f"{pops[1:]} on each side of the first boundary after the append; "
        f"every ELBO finite: {finite}; the {n_hold} held-out documents' "
        f"theta rows at their initial values: {held_ok} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(pop_ok, f"{label}: the population did not grow from {pre} to "
          f"{post} at the epoch boundary")
    check(finite, f"{label}: a growing-run ELBO is not finite")
    check(held_ok, f"{label}: a held-out document's theta row moved")

    t0 = time.perf_counter()
    w, tmpl, sc = start("grow_crash")
    ck = str(tmp / "ck_grow")
    crash = SVI(tmpl, cfg, corpus=sc, device="cuda")
    with faults.inject("svi.step", nth=GROW_CRASH_AT):
        try:
            crash.fit(SVI_STEPS, callback=append_after(w), checkpoint_dir=ck,
                      checkpoint_every=OOC_EVERY)
            raised = False
        except faults.InjectedCrash:
            raised = True
    crash.close()
    step = latest_session_step(ck)
    sizes = [len(g) for _, g in load_session(ck).epochs]
    again = SVI(tmpl, cfg, corpus=ShardedCorpus.open(str(tmp / "grow_crash")),
                device="cuda")
    got, got_h = again.fit(SVI_STEPS - (step or 0), checkpoint_dir=ck,
                           resume_from=True)
    again.close()
    ok = raised and states_bitwise(got, want, got_h, want_h)
    log(f"[{label}] growing crash-resume: svi.step=raise@{GROW_CRASH_AT} "
        f"{'raised' if raised else 'DID NOT RAISE'}, newest session at step "
        f"{step} with epoch snapshots of {sizes} documents, resumed: "
        f"{'bitwise the uninterrupted run' if ok else 'DIFFERENT'} "
        f"({time.perf_counter() - t0:.1f} s)")
    check(sizes == [n for _, n in epochs][:len(sizes)] and post in sizes,
          f"{label}: the session lost the epoch snapshots across the growth")
    check(ok, f"{label}: growing crash-resume is not bitwise")
    return {"epochs": epochs, "populations": pops, "session_epochs": sizes,
            "session_step": step, "elbo_trace": want_h["elbo"],
            "heldout": want_h["heldout"]}


def ooc_vmp_checkpoints(label, tmp, prog, report):
    """``run_inference`` on the main path's program with a checkpoint every
    half of its steps: the first half, then a call that resumes from the
    directory for the rest; the whole trace and the final posteriors must
    be the main path's (phase 5's digest)."""
    from repro_torch.core import runtime, vmp
    ck = str(tmp / "ck_vmp")
    total = len(report["elbo_trace"])
    half = total // 2
    t0 = time.perf_counter()
    _, first = runtime.run_inference(prog, half, seed=SEED,
                                     checkpoint_every=half,
                                     checkpoint_dir=ck, device="cuda")
    state, second = runtime.run_inference(prog, total - half, seed=SEED,
                                          checkpoint_every=half,
                                          checkpoint_dir=ck, device="cuda")
    digest = output_digest(vmp.state_to_numpy(state)[0], first + second)
    ok = first + second == report["elbo_trace"] and digest == report["digest"]
    log(f"[{label}] VMP checkpoints: {half} steps, then {total - half} "
        f"resumed from step {int(state.step) - len(second)}: sha256 "
        f"{digest} {'==' if ok else '!='} the main path's "
        f"({time.perf_counter() - t0:.1f} s)")
    check(ok, f"{label}: VMP checkpoint resume is not bitwise the main path")
    return digest


def phase_lda_ooc(report, corpus, prog):
    """The main path's LDA out of core: the corpus written to shards in a
    temporary directory (removed at exit) and streamed through
    ``SVI(sharded_template(...), corpus=, prefetch=True)``.  The 30-step fit
    must be bitwise ``lda_svi``'s; its step's time split beside
    ``lda_svi``'s; crash-resume in one process and after a SIGKILL; a
    growing corpus and its resume; VMP checkpoints; ``zstats`` and the Elog
    pass at one out-of-core batch against their plain versions."""
    import tempfile
    from repro_torch.core import models, vmp
    from repro_torch.core.svi import SVI
    from repro_torch.data import sharded_template, write_sharded_corpus
    from repro_torch.kernels import ops
    label = "lda_ooc"
    out = report[label] = {}
    with tempfile.TemporaryDirectory(prefix="lda_ooc-") as tmpdir:
        tmp = Path(tmpdir)
        t0 = time.perf_counter()
        sc = write_sharded_corpus(corpus, str(tmp / "corpus"))
        write_s = time.perf_counter() - t0
        model = models.make("lda", alpha=ALPHA, beta=BETA, K=TOPICS, V=VOCAB)
        tmpl = sharded_template(model, sc)
        log(f"[{label}] {sc.n_docs} documents, {sc.n_tokens} tokens in "
            f"{sc.n_shards} shards ({sc.disk_bytes} bytes) written in "
            f"{write_s:.2f} s")
        cfg = svi_config()
        fit = SVI(tmpl, cfg, corpus=sc, device="cuda")
        s0 = vmp.init_state(tmpl, SEED, device="cuda")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, hist = fit.fit(SVI_STEPS, state=s0)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        svi_fit_checks(label, cfg, hist, counts, "zstats", SVI_STEPS)
        held = [v for _, v in hist["heldout"]]
        digest = output_digest(vmp.state_to_numpy(state)[0],
                               hist["elbo"] + held)
        want = report["lda_svi"]["digest"]
        log(f"[{label}] fit({SVI_STEPS}) out of core {fit_s:.2f} s; sha256 "
            f"{digest} {'==' if digest == want else '!='} lda_svi's; peak "
            f"host buffers {fit.sampler.peak_buffer_bytes} bytes (two "
            f"batches with their owner plans); shard bytes read "
            f"{sc.bytes_read} in {sc.reads} reads")
        check(digest == want, f"{label}: the out-of-core fit is not bitwise "
              f"lda_svi's")
        entries = svi_flat_kernels(label, fit, state, counts)
        out.update(svi_step_times(label, fit, state, report["device"],
                                  warm=1))
        fit.close()
        res = report["lda_svi"]
        log(f"[{label} vs lda_svi] {report['device']}: step "
            f"{out['step_ms']:.2f} against {res['step_ms']:.2f} ms, "
            f"{out['tokens_per_s']:.4e} against {res['tokens_per_s']:.4e} "
            f"tokens/s, device {out['trace']['busy_ms']:.3f} against "
            f"{res['trace']['busy_ms']:.3f} ms a step, idle share "
            f"{out['idle_share']} against {res['idle_share']}")
        out.update(elbo_trace=hist["elbo"], heldout=hist["heldout"],
                   launches=counts, fit_s=fit_s, digest=digest,
                   write_s=write_s, disk_bytes=sc.disk_bytes,
                   peak_buffer_bytes=fit.sampler.peak_buffer_bytes,
                   bytes_read=sc.bytes_read, reads=sc.reads)
        del fit, state, s0
        out["sessions"] = ooc_sessions(label, tmp, tmpl, str(tmp / "corpus"))
        out["growing"] = ooc_growing(label, tmp, corpus)
        out["vmp_checkpoint_digest"] = ooc_vmp_checkpoints(label, tmp, prog,
                                                           report)
    return entries


def phase_segment_svi(label, m, report, bitwise_vmp):
    """SVI of a segment-latent path: with ``bitwise_vmp`` first one step at
    |B| = G against VMP; padding invariance on batch 0; SVI_SEGMENT_STEPS
    padded steps with a held-out evaluation (the reference's
    ``test_slda_minibatch_runs`` at the path's widths), their launch counts
    set to 0 just before and read just after; then ``zstats_zmap`` and its
    phase 1 alone (``zmap_logits``) against their plain versions at one
    padded batch's inputs, whose padding tokens map to instance 0 and whose
    padding instances hold no tokens.  Returns the path's kernels entry."""
    from repro_torch.core import vmp
    from repro_torch.core.svi import SVI
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ops, ref
    prog = m.compile()
    name = f"{label}_svi"
    if bitwise_vmp:
        svi_equals_vmp(name, prog)
    cfg = svi_config(holdout_every=SVI_SEGMENT_STEPS)
    svi = SVI(prog, cfg, device="cuda")
    s0 = vmp.init_state(prog, SEED, device="cuda")
    _, _, worst = svi_pad_check(name, prog, svi, s0)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, hist = svi.fit(SVI_SEGMENT_STEPS, state=s0)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"[{name}] fit({SVI_SEGMENT_STEPS}) of batches of "
        f"{svi.sampler.batch_size} documents: {fit_s:.2f} s")
    svi_fit_checks(name, cfg, hist, counts, "zstats_zmap", SVI_SEGMENT_STEPS)
    check(counts["zstats"] == 0, f"{name}: the flat zstats launched")

    log(f"[kernels vs plain] {name}: one batch's inputs (padded, masked)")
    n_tok, _, args, plan, spec = svi_batch_inputs(svi, state,
                                                  SVI_SEGMENT_STEPS)
    prior, _, children, zmask = args
    check(all(c.zmap is not None for c in children),
          f"{name}: a child of the segment latent has no zmap")
    n_z, k = spec.n, spec.k
    n_real = int(zmask.sum())
    n_parts = sum(int(plan.streams[f"latent{j}", "fstart"][-1])
                  for j in range(len(plan.by_latent)))
    err = compare_zstats(f"{name} batch", fzm.zstats_zmap(*args, plan=plan),
                         ref.zstats(*args), name="zstats_zmap")
    lerr = compare("zmap_logits", f"{name} batch",
                   fzm.zmap_logits(children, n_z, k, plan=plan),
                   ref.zmap_logits(children, n_z, k),
                   dict(rtol=ZSTATS_TOL["rtol"], atol=ZSTATS_TOL["atol"]))
    t_z = time_ms(lambda: fzm.zstats_zmap(*args, plan=plan), reps=20)
    t_zp = time_ms(lambda: ref.zstats(*args), reps=3)
    # the prior rows and zmask, each child's token streams (values, zmap,
    # mask, base) each read once; every table read and its stats written
    # once; the work of the batch's real instances and tokens
    streams = sum(len(c.values) * 4 * sum(
        a is not None for a in (c.values, c.zmap, c.mask, c.base))
        for c in children)
    tables = (prior.numel() + sum(c.elog.numel() for c in children)) * 4
    z_bytes = n_z * 8 + streams + tables * 2 + 4
    z_ops = 8 * n_real * k + 4 * n_tok * k
    bms, by = bound(z_bytes, z_ops)
    entry = kernel_entry(name, "zstats_zmap", "cuda",
                         "src/repro_torch/kernels/csrc/zstats.cu",
                         "src/repro/kernels/fused_zmap.py:236",
                         counts["zstats_zmap"], err, t_z, t_zp, bms, by)
    log(f"  zstats_zmap            {t_z:9.4f} ms  plain {t_zp:9.4f} ms  "
        f"bound {bms:8.4f} ms ({by})  launches {counts['zstats_zmap']} "
        f"({n_real} of {n_z} instances real, {n_tok} tokens, {n_parts} "
        f"partial rows); zmap_logits at the same inputs max_abs {lerr:.3e} "
        f"(the step does not launch it apart)")
    del args, plan, children, prior
    report[name] = dict(elbo_trace=hist["elbo"], heldout=hist["heldout"],
                        launches=counts, fit_s=fit_s, pad_max_abs=worst,
                        zstats_zmap_ms=t_z, zmap_logits_max_abs=lerr,
                        partial_rows=n_parts)
    return [entry]


# ---------------------------------------------------------------------------
# the LM trainer: olmo-1b at full width and depth, attention through the
# flash_attention kernel
# ---------------------------------------------------------------------------

def flash_inputs(bh, sq, sk, dh, dtype, seed):
    """q (bh, sq, dh) and k, v (bh, sk, dh) from a numpy seed, on the card."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(bh, n, dh)).astype(
        np.float32)).to(DEV, dtype) for n in (sq, sk, sk))


def flash_ops(bh, sq, sk, dh, causal):
    """Flops of Q k^T and P v over the (query, key) pairs the mask keeps."""
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    return 4 * bh * dh * pairs


def phase_flash(report):
    """``flash_attention`` against ``ref.flash_attention`` on the card: the
    reference's FLASH_SHAPES, Sq != Sk, a non-causal ragged Sk, Dh = 80 and
    256, ragged and multi-tile cases at Dh 64 and 128, and the trainer's
    shape, in bf16 and f32, each through the route ``route()`` gives it (and
    checked to have taken it), and the bf16 cases at Dh 64 and 128 also
    through the "mma" route; two launches of each route bitwise; the
    Function's gradients bitwise those of the plain version for one g; both
    routes timed in turns at the trainer's shape beside the bound, the plain
    version and SDPA (a yardstick the port never calls)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    log("[flash] flash_attention against ref.flash_attention")
    bh, s, dh = LM_BH, LM_SEQ, 128
    cases = [(b, n, n, d, True) for b, n, d in FLASH_SHAPES] + [
        (2, 48, 100, 32, True), (2, 100, 48, 16, True), (3, 70, 100, 32, False),
        (2, 130, 130, 80, True), (2, 64, 96, 80, False), (2, 300, 300, 256, True),
        (2, 100, 77, 256, False)] + FLASH_WGMMA_CASES + [(bh, s, s, dh, True)]
    worst = {}
    for i, (b, sq, sk, d, causal) in enumerate(cases):
        for dt, tol in ((torch.bfloat16, FLASH_BF16_TOL),
                        (torch.float32, FLASH_F32_TOL)):
            q, k, v = flash_inputs(b, sq, sk, d, dt, 500 + i)
            want = ref.flash_attention(q, k, v, causal=causal)
            rt = fa.route(q, k, v)
            label = (f"({b},{sq},{sk},{d}) {'causal' if causal else 'full'} "
                     f"{str(dt)[6:]}")
            before = dict(fa.route_launches)
            got = fa.flash_attention(q, k, v, causal=causal)
            check(fa.route_launches[rt] == before[rt] + 1 and
                  sum(fa.route_launches.values()) == sum(before.values()) + 1,
                  f"flash_attention {label} did not take route {rt}")
            worst[label] = compare("flash_attention", f"{label} {rt}", got,
                                   want, tol)
            if rt == "wgmma":
                worst[label + " mma"] = compare(
                    "flash_attention", f"{label} mma",
                    fa.launch(q, k, v, causal, route="mma"), want, tol)
            del q, k, v, want, got
    q, k, v = flash_inputs(bh, s, s, dh, torch.bfloat16, 600)
    check(fa.route(q, k, v) == "wgmma", "the trainer's shape is not on the "
          "wgmma route")
    for rt in ("wgmma", "mma"):
        a = fa.launch(q, k, v, True, route=rt)
        check(torch.equal(a, fa.launch(q, k, v, True, route=rt)),
              f"two flash_attention launches ({rt}) on one input differ")
    log("  two launches of each route at the trainer's shape: bitwise equal")
    for b, n, dt in ((bh, s, torch.bfloat16), (4, 256, torch.float32)):
        qg, kg, vg = (t.requires_grad_() for t in flash_inputs(
            b, n, n, dh, dt, 601))
        g = torch.from_numpy(np.random.default_rng(602).normal(
            size=(b, n, dh)).astype(np.float32)).to(DEV, dt)
        got = torch.autograd.grad(fa.flash_attention(qg, kg, vg), (qg, kg, vg), g)
        want = torch.autograd.grad(ref.flash_attention(qg, kg, vg),
                                   (qg, kg, vg), g)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"Function gradients at ({b},{n},{dh}) {dt} differ from ref's")
        log(f"  Function gradients at ({b},{n},{n},{dh}) {str(dt)[6:]}: "
            f"bitwise those of ref.flash_attention for one g")
        del qg, kg, vg, g, got, want
    torch.cuda.synchronize()

    log("[times] flash_attention at the trainer's shape "
        f"({bh}, {s}, {dh}) bf16, causal; the two routes in turns")
    turns = {"mma": [], "wgmma": []}
    for rt in ("mma", "wgmma", "wgmma", "mma"):
        turns[rt].append(time_ms(lambda: fa.launch(q, k, v, True, route=rt),
                                 reps=20))
    t_k, t_m = (sum(turns[r]) / 2 for r in ("wgmma", "mma"))
    t_p = time_ms(lambda: ref.flash_attention(q, k, v), reps=5)
    q4, k4, v4 = (t.view(LM_BATCH, bh // LM_BATCH, s, dh) for t in (q, k, v))
    t_l = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), reps=20)
    nbytes = 4 * bh * s * dh * 2
    flops = flash_ops(bh, s, s, dh, True)
    bms, by = bound(nbytes, flops, BF16_PEAK)
    for name, t in (("wgmma", t_k), ("mma", t_m), ("SDPA", t_l)):
        log(f"  {name:<6} {t:9.4f} ms  {flops / t / 1e9:8.1f} TFLOP/s  "
            f"{bms / t:.3f} of the bound")
    log(f"  turns (ms): mma {turns['mma']}, wgmma {turns['wgmma']}")
    log(f"  plain {t_p:9.4f} ms  bound {bms:8.4f} ms ({by})")
    check(t_k < t_m, f"the wgmma kernel ({t_k:.4f} ms) is not faster than "
          f"the mma kernel ({t_m:.4f} ms)")
    err = worst[f"({bh},{s},{s},{dh}) causal bfloat16"]
    out = dict(ms=t_k, mma_ms=t_m, turns=turns, plain_ms=t_p, library_ms=t_l,
               bound_ms=bms, bound_by=by, err=err, mma_err=worst[
                   f"({bh},{s},{s},{dh}) causal bfloat16 mma"])
    report["flash"] = dict(out, cases=worst)
    return out


def leaf_sums(module):
    """Per parameter, the f64 sum and sum of squares: a change of any
    element moves them."""
    return [(float(p.detach().double().sum()),
             float(p.detach().double().square().sum()))
            for p in module.parameters()]


def chance_level(params, cfg, run, batch):
    """The model's expected CE on ``batch``'s positions under labels drawn
    uniformly from the vocabulary: the mean of ``logsumexp(z) - mean(z)``
    over the V real columns of its logits.  TokenStream's labels are
    uniform, so the loss of parameters that have not seen them lies within
    noise of this (0.01 nats at 8,192 tokens); a label that leaks from the
    input scores far below it."""
    from repro_torch.models import transformer as T
    with torch.no_grad():
        x = T._embed(params, batch["tokens"], cfg, run)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        z = T._logits(params, T._apply_stack(params, x, cfg, run, pos), cfg,
                      run)[..., :cfg.vocab]
        return float((torch.logsumexp(z, -1) - z.mean(-1)).mean())


def phase_lm_train(report, flash):
    """olmo-1b at full width and depth through ``launch.train.train``: 4
    steps at batch 4 x 2,048 tokens, bf16 compute, f32 parameters from the
    port's own initialisation, attention through the flash kernel; the
    launch count, the losses, the parameters' movement, flash against dense
    attention on one batch, step time, tokens/s, the model flops' share of
    the bf16 peak, peak memory, and a profile of two steps."""
    import dataclasses
    from repro_torch.configs import RunConfig, get_arch
    from repro_torch.data import TokenStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import batch_to, build_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import make_model
    cfg = get_arch(LM_ARCH)
    run = RunConfig(seq_len=LM_SEQ, global_batch=LM_BATCH, flash_kernel=True)
    n_params = cfg.param_count()
    log(f"[lm_train] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab} (padded {cfg.vocab_padded}), {n_params / 1e9:.3f}B "
        f"parameters; batch {LM_BATCH} x {LM_SEQ}, {run.dtype} compute")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, losses, tel = train(cfg, run, LM_STEPS, device=DEV,
                                     log_every=1)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lm_train] train(steps={LM_STEPS}) {train_s:.2f} s (init included); "
        f"losses {losses}")
    log(f"[lm_train] launches: {counts}")
    want = cfg.n_layers * LM_STEPS
    routes = dict(fa.route_launches)
    log(f"[lm_train] flash_attention launches by route: {routes}")
    check(counts["flash_attention"] == want,
          f"flash_attention launched {counts['flash_attention']} times, not "
          f"{want} ({cfg.n_layers} layers x {LM_STEPS} forwards)")
    check(routes == {"wgmma": want, "mma": 0},
          f"flash_attention's {want} launches did not all take the wgmma "
          f"route: {routes}")
    check(opt["count"] == LM_STEPS, f"AdamW count {opt['count']}")
    stream = TokenStream(vocab=cfg.vocab, seq_len=LM_SEQ, batch=LM_BATCH,
                         seed=run.seed)
    batch = batch_to(stream.batch_at(0), DEV)
    # the initialisation again (one generator seed gives the same draws)
    fresh = make_model(cfg)["init"](run, device=DEV)
    moved = [a != b for a, b in zip(leaf_sums(params), leaf_sums(fresh))]
    chance = chance_level(fresh, cfg, run, batch)
    del fresh
    check(all(moved), f"{moved.count(False)} of {len(moved)} parameters "
                      f"unchanged after {LM_STEPS} steps")
    log(f"[lm_train] all {len(moved)} parameters moved from the "
        f"initialisation (the schedule gives lr 0 at step 0, so steps 1-3 "
        f"moved them)")
    ln_v = float(np.log(cfg.vocab))
    log(f"[lm_train] chance level of the initial logits on batch 0: "
        f"{chance:.4f} nats (ln V = {ln_v:.4f}: the tied embedding gives each "
        f"input token a large logit of its own); step 0's loss lies "
        f"{abs(losses[0] - chance):.2e} from it (tol {CHANCE_TOL})")
    check(abs(losses[0] - chance) <= CHANCE_TOL,
          f"step 0's loss {losses[0]} is not the chance level {chance} of "
          f"its logits")
    check(all(np.isfinite(losses)) and
          all(abs(x - chance) <= 1.5 for x in losses),
          f"losses {losses} not finite within 1.5 nats of the chance level "
          f"{chance:.4f}")
    log("[lm_train] every loss finite and within 1.5 nats of the chance level")

    model = make_model(cfg)
    with torch.no_grad():
        l_flash = float(model["train_loss"](params, batch, run))
        l_dense = float(model["train_loss"](
            params, batch, dataclasses.replace(run, flash_kernel=False)))
    log(f"[lm_train] batch 0 after training: loss {l_flash:.6f} through the "
        f"flash kernel, {l_dense:.6f} through _sdpa_dense (|diff| "
        f"{abs(l_flash - l_dense):.2e}, tol {LM_LOSS_TOL} nats)")
    check(abs(l_flash - l_dense) <= LM_LOSS_TOL,
          "flash and dense attention give losses more than "
          f"{LM_LOSS_TOL} nats apart")

    summ = tel.summary()
    step_s = summ["mean_s"]
    tokens = LM_BATCH * LM_SEQ
    attn_flops = 3 * cfg.n_layers * flash_ops(LM_BH, LM_SEQ, LM_SEQ,
                                              cfg.head_dim_, True)
    model_flops = 6 * n_params * tokens + attn_flops
    mfu = model_flops / step_s / BF16_PEAK
    log(f"[lm_train] step {step_s * 1e3:.2f} ms (mean of steps 1-"
        f"{LM_STEPS - 1}), {tokens / step_s:.4e} tokens/s; 6*N*tokens + "
        f"attention = {model_flops:.4e} flops, {mfu:.4f} of the bf16 peak; "
        f"peak memory {peak_gb:.2f} GB")
    built = build_train_step(cfg, run, device=DEV)
    nxt = [LM_STEPS]

    def two_steps():
        nonlocal params, opt
        for _ in range(2):
            b = batch_to(stream.batch_at(nxt[0]), DEV)
            params, opt, m = built["fn"](params, opt, b, nxt[0])
            float(m["loss"])
            nxt[0] += 1
    trace = profile_steps(two_steps, 2, label="lm_train trace")
    report["lm_train"] = dict(
        arch=cfg.name, seq=LM_SEQ, batch=LM_BATCH, steps=LM_STEPS,
        losses=losses, launches=counts, train_s=train_s, step_ms=step_s * 1e3,
        step_times_s=tel.times, tokens_per_s=tokens / step_s,
        model_flops=model_flops, bf16_peak_share=mfu, peak_memory_gb=peak_gb,
        loss_flash=l_flash, loss_dense=l_dense, chance_level=chance,
        trace=trace)
    del params, opt
    torch.cuda.empty_cache()
    entry = kernel_entry(
        "lm_train", "flash_attention", "cuda",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:106",
        counts["flash_attention"], flash["err"], flash["ms"],
        flash["plain_ms"], flash["bound_ms"], flash["bound_by"],
        flash["library_ms"])
    # the kernel the path took, and the mma.sync kernel's time in this call
    entry.update(variant="wgmma", mma_ms=flash["mma_ms"])
    return [entry]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--docs", type=int, default=30000,
                   help="documents of the main path's corpus (depth)")
    p.add_argument("--steps", type=int, default=10,
                   help="VMP steps of the main path")
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    dev_line = device_line()
    log(f"[device] {dev_line}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    report = {"device": dev_line, "args": vars(args)}
    svi_s = report["svi_phase_s"] = {}

    def svi_phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        svi_s[name] = time.perf_counter() - t0
        return out

    phase_build(report)
    phase_kernels_vs_plain(report)
    report["zmap_edge_max_abs"] = phase_zmap_kernels()
    corpus, m, prog = make_main_model(args)
    counts = phase_main(args, report, corpus, m, prog)
    kernels = phase_repeat_and_time(args, report, m, prog, counts)
    kernels += svi_phase("lda_svi", phase_lda_svi, report, prog)
    kernels += svi_phase("lda_ooc", phase_lda_ooc, report, corpus, prog)
    del m, prog
    slda = make_slda(corpus)
    del corpus
    counts = phase_segment("slda", slda, args.steps, "z", report)
    kernels += phase_segment_times("slda", slda, report, counts)
    kernels += svi_phase("slda_svi", phase_segment_svi, "slda", slda, report,
                         bitwise_vmp=False)
    del slda
    nb = make_naive_bayes(args)
    counts = phase_segment("naive_bayes", nb, NB_STEPS, "c", report)
    kernels += phase_segment_times("naive_bayes", nb, report, counts)
    kernels += svi_phase("naive_bayes_svi", phase_segment_svi, "naive_bayes",
                         nb, report, bitwise_vmp=True)
    del nb
    kernels += phase_lm_train(report, phase_flash(report))
    report["seconds"] = time.perf_counter() - t_start
    REPORT.parent.mkdir(parents=True, exist_ok=True)
    REPORT.write_text(json.dumps(report, indent=1, default=float))
    log(f"[done] {report['seconds']:.1f} s (kernel builds "
        f"{report['build_s']:.1f} s, SVI phases {sum(svi_s.values()):.1f} s: "
        f"{', '.join(f'{k} {v:.1f}' for k, v in svi_s.items())}); report in "
        f"{REPORT}")
    print(dev_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
