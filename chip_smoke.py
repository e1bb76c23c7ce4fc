#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py            # the full check, on one card

Phases, each of which exits non-zero on a failed check:

  1. the card's name and power limit, as ``nvidia-smi`` reports them;
  2. the ``nvcc`` build of ``src/repro_torch/kernels/csrc/zstats.cu``;
  3. every kernel (CUDA ``zstats``, Triton ``dirichlet_expectation`` and
     ``zstep``) against its plain PyTorch version on the card: the edge cases
     of the reference's kernel tests rebuilt from numpy seeds (K = 3, 130 and
     2, strided with base, masked, several children, the V = 33,000 child,
     the G = 70,000 prior), bf16 tables, and the main path's shapes;
  4. repeatability: two ``zstats`` calls, and two 3-step runs from one
     state, must be bitwise equal;
  5. the main path: LDA at the NYTimes bag-of-words widths (K = 100,
     V = 102,660, alpha = 0.1, beta = 0.05) over a planted corpus of 30,000
     documents of mean length 332 (about 10M tokens), through
     ``models.make`` -> ``observe`` -> ``Model.infer(steps=10)`` ->
     ``get_result``, with the launch counts set to 0 just before and read
     just after;
  6. times (CUDA events) of each kernel, its plain version and its bound at
     the main path's shapes, and the VMP step's ms and tokens/s.

The last two lines are a ``{"kernels": [...]}`` JSON object and the
``{"ok": true, "device": {...}}`` JSON object.  A fuller report goes to
``chiprun_out/chip_smoke.json``.  The script imports the port only, never
JAX nor the JAX package.
"""

import argparse
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
}
ZMAP_CASE = (240, 3, 10, [(3, 15, 1, False, True, True)], True, 40)
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
    from repro_torch.kernels.ref import ZChild
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


def compare_zstats(label, got, want, tol=ZSTATS_TOL):
    """Max abs / rel error of the kernel's outputs against the plain
    version's; fails outside the tolerance."""
    ok = within(got[0], want[0], tol["lse_rtol"], tol["atol"])
    worst = [errors(got[0], want[0])]
    for g, w in [(got[1], want[1])] + list(zip(got[2], want[2])):
        ok &= g.shape == w.shape and within(g, w, tol["rtol"], tol["atol"])
        worst.append(errors(g, w))
    ab, rel = max(e[0] for e in worst), max(e[1] for e in worst)
    log(f"  zstats {label:<28} max_abs {ab:.3e} max_rel {rel:.3e} "
        f"(rtol {tol['rtol']}, atol {tol['atol']}, lse rtol {tol['lse_rtol']}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"zstats {label} disagrees with its plain version")
    return ab


def compare(name, label, got, want, tol):
    ab, rel = errors(got, want)
    ok = got.shape == want.shape and within(got, want, tol["rtol"], tol["atol"])
    log(f"  {name} {label:<24} max_abs {ab:.3e} max_rel {rel:.3e} "
        f"(rtol {tol['rtol']}, atol {tol['atol']}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name} {label} disagrees with its plain version")
    return ab


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
    from repro_torch.kernels import fused_zstats
    t0 = time.perf_counter()
    lib, out = fused_zstats.build(verbose=True)
    secs = time.perf_counter() - t0
    log(f"[build] nvcc {fused_zstats._SRC.relative_to(ROOT)} -> "
        f"{lib.name} in {secs:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line.lower():
            log("  " + line.strip())
    fused_zstats.library()
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
    try:
        fz.zstats(*zcase(300, *ZMAP_CASE))
        raise CheckFailed("a zmap latent on CUDA did not raise")
    except NotImplementedError:
        log("  zstats zmap latent on CUDA raises NotImplementedError: ok")
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
    theta = m["theta"].get_result().astype(np.float64)
    phi = m["phi"].get_result().astype(np.float64)
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
                  infer_s=infer_s, stats_sums=sums, n_tokens=n)
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
    step = runtime.make_step(prog, device="cuda")
    st = vmp.state_from_numpy(posts, step=0, device="cuda")
    st, _ = step(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        st, elbo = step(st)
        float(elbo)
    step_ms = (time.perf_counter() - t0) / 5 * 1e3

    def bound(nbytes, nops):
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

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
        kernels.append({"name": name, "route": route, "source": src,
                        "replaces": rep, "launches": counts[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": bms, "bound_by": by, "library_ms": None})
        log(f"  {name:<22} {ms:9.4f} ms  plain {pms:9.4f} ms  bound "
            f"{bms:8.4f} ms ({by})  launches {counts[name]} "
            f"({per_step[name]:.1f} per step)")
    log(f"  dirichlet_expectation at theta's (D, K) = ({g}, {k}): "
        f"{t_de_theta:.4f} ms, bound {g * k * 8 / HBM_BYTES_PER_S * 1e3:.4f} ms")
    log(f"  torch.softmax beside zstep (not used by the port): "
        f"{t_softmax:.4f} ms")
    log(f"  VMP step: {step_ms:.2f} ms, {n / step_ms * 1e3:.4e} tokens/s "
        f"(N = {n})")
    report.update(kernels=kernels, step_ms=step_ms,
                  tokens_per_s=n / step_ms * 1e3, softmax_ms=t_softmax,
                  de_theta_ms=t_de_theta, launches_per_step=per_step,
                  trace=trace)
    return kernels


def phase_trace(step, st, n_steps=2):
    """Device time by kernel over ``n_steps`` VMP steps (torch.profiler),
    and the device's idle share of the steps' wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            st, elbo = step(st)
            float(elbo)
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
    log(f"[trace] {n_steps} steps under torch.profiler: {step_ms:.3f} ms per "
        f"step, device busy {busy_ms:.3f} ms, idle share {idle}")
    for ms, cnt, key in rows[:12]:
        log(f"  {ms:9.4f} ms/step  x{cnt:<3} {key[:90]}")
    return {"step_ms": step_ms, "busy_ms": busy_ms,
            "kernels": [{"ms_per_step": ms, "calls_per_step": c, "name": k}
                        for ms, c, k in rows]}


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
    phase_build(report)
    phase_kernels_vs_plain(report)
    corpus, m, prog = make_main_model(args)
    counts = phase_main(args, report, corpus, m, prog)
    kernels = phase_repeat_and_time(args, report, m, prog, counts)
    report["seconds"] = time.perf_counter() - t_start
    REPORT.parent.mkdir(parents=True, exist_ok=True)
    REPORT.write_text(json.dumps(report, indent=1, default=float))
    log(f"[done] {report['seconds']:.1f} s; report in {REPORT}")
    print(dev_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
