#!/usr/bin/env python3
"""Numerical checks of the PyTorch port on one NVIDIA H100, beside
``chip_smoke.py``.

    python3 scripts/torch_numerics.py digest [TREE]
    python3 scripts/torch_numerics.py zmap-precision [TREE]
    python3 scripts/torch_numerics.py ab-zstats PARENT [TREE ...]
    python3 scripts/torch_numerics.py ab-steps PARENT
    python3 scripts/torch_numerics.py ab-digests PARENT
    python3 scripts/torch_numerics.py ab-zmap PARENT [TREE ...]
    python3 scripts/torch_numerics.py ab-flash PARENT [TREE]
    python3 scripts/torch_numerics.py de-sweep
    python3 scripts/torch_numerics.py zstats-split [TREE]

TREE is a checkout of the repo (by default the one holding this script)
whose ``src/repro_torch`` runs; the inputs and the work come from this
checkout's ``chip_smoke.py``, so two trees run the same thing.

- ``digest``: ``chip_smoke.py``'s LDA main path (NYTimes widths, about 10M
  tokens, 10 VMP steps) on TREE's package, with the sha256 of its final
  posteriors and ELBO trace.  Two trees with one digest give the same output
  bit for bit.
- ``zmap-precision``: naive Bayes at ``chip_smoke.py``'s 20 Newsgroups
  widths after 5 VMP steps.  ``zstats_zmap`` and the plain ``ref.zstats``
  are held against the same sums in f64, in units of ``ZSTATS_TOL``: the
  worst error over its tolerance and the elements over it.  Also the
  logits' largest error, the documents within 8 nats of a tie, and an f32
  evaluation whose phase 1 is the f64 sum rounded once.
- ``ab-zstats``: ``zstats`` at the LDA main path's inputs (after 2 VMP
  steps), this checkout's kernel against the one of PARENT, a checkout of
  an earlier commit (say a ``git archive`` unpacked under ``build/``),
  loaded beside it as the package ``parent_repro_torch``.  The two are
  timed with CUDA events in turns (parent, this, this, parent, 10 calls
  each); it says whether their outputs are bitwise equal (a change of the
  sums' order makes them differ).  Then the same at the DCM-LDA inputs of
  ``chip_smoke.py`` (a strided child, 10,000 documents, after 2 VMP
  steps), each tree with its own owner plan, and again with a fractional
  mask on that child (each token weighted by a seeded draw in [0.05, 1),
  where a fused multiply-add and a multiply then an add round
  differently); at these two layouts also against each further checkout
  given after PARENT (say a variant of this one).
- ``ab-steps``: the VMP step of ``chip_smoke.py``'s three paths (LDA at the
  NYTimes widths, SLDA over the same corpus, naive Bayes at the 20
  Newsgroups widths), this checkout's package against PARENT's on one
  corpus each, after one warm-up step, timed on the host clock (each step
  ends in a host read of its ELBO, as ``chip_smoke.py`` times them) in
  turns (parent, this, this, parent, 10 steps each).
- ``ab-digests``: the five VMP paths of ``chip_smoke.py`` at its depths
  (LDA, SLDA and naive Bayes, DCM-LDA, DCM-SLDA) and its SVI fit
  (``lda_svi``: LDA's corpus, its batch and steps), fitted from the same
  corpora by this checkout's package and by PARENT's: whether each final
  posterior is bitwise the parent's, the largest per-step difference of
  the two ELBO traces, and both trees' sha256 (``chip_smoke.output_digest``,
  which hashes the posteriors and the ELBO trace).
- ``ab-zmap``: the segment-latent kernels and the Elog pass, this
  checkout's against PARENT's (and, for the segment-latent kernels, against
  each further checkout given after it, say variants of this one) on the
  same inputs: ``zstats_zmap`` and
  ``zmap_logits`` at the SLDA and naive Bayes inputs of ``chip_smoke.py``
  (after 2 VMP steps), and ``dirichlet_expectation`` on phi as (V, K) (the
  SLDA path's phi, also its two Triton passes timed apart in each tree).
  Timed with CUDA events in turns (parent, this, this, parent), each output
  said bitwise equal to the parent's or not; the Elog passes also by device
  time (``chip_smoke.device_ms``).  Then ``zstats_zmap`` at the DCM-SLDA
  inputs of ``chip_smoke.py`` (a strided zmap child, after 2 VMP steps),
  each tree with its own owner plan, without and with a fractional mask on
  that child, and at both this checkout's phase 2b on the "runs" pass
  against its per-column pass (a ``per_column`` plan).
- ``ab-flash``: ``flash_attention`` in bf16, causal, at AB_FLASH_SHAPES
  (the trainer's and qwen3-moe's Dh-128 shapes, a Dh-64 shape, gemma3-4b's
  Dh-256 global layer at batch 1 x 4,096 and 4 x 2,048): TREE's kernel
  (this checkout's by default) against PARENT's, each package building its
  library from its own ``csrc/flash_attention.cu`` and launching the route
  its own ``route()`` picks, on the same inputs, timed with CUDA events in
  turns (parent, this, this, parent, 20 calls each), each output said
  bitwise equal to the parent's or not; at Dh 256 also TREE's "mma" route
  against PARENT's.  It fails unless the Dh-64 and Dh-128 outputs are
  bitwise the parent's.  It also says, kernel by kernel, whether the two
  libraries' machine code (``cuobjdump -sass``) is identical.
- ``de-sweep``: the Elog pass's two launches on phi's shape (100 x
  102,660, as (V, K)) and theta's (30,000 x 100), by device time, over
  the module's knobs: the row-sum programs per SM (and so the chunks a
  row), and the transposed pass's tile and warps; each output held to the
  plain version at DE_TOL.
- ``zstats-split``: ``zstats`` at ``chip_smoke.py``'s DCM-LDA inputs
  (after 2 VMP steps) on TREE's package: the child's value columns and
  (base, value) runs counted, the call timed with CUDA events, its device
  time by kernel under torch.profiler (each launch of the call apart: the
  prior's pass, its finish, the lse sum, the zero fill, the child's pass),
  and the count of FFMA, FMUL and FADD in the machine code of the strided
  children's stats kernels (the flat passes' and a segment latent's phase
  2b).

Imports the port only, never JAX nor the JAX package.
"""

import argparse
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _setup(tree: Path):
    sys.path.insert(0, str(tree.resolve() / "src"))
    sys.path.insert(1, str(HERE))
    import chip_smoke  # noqa: E402
    import repro_torch  # noqa: E402
    print(f"package: {Path(repro_torch.__file__).parent}", flush=True)
    return chip_smoke


def digest(cs):
    args = argparse.Namespace(docs=30000, steps=10)
    corpus, m, prog = cs.make_main_model(args)
    cs.phase_main(args, {}, corpus, m, prog)       # logs the sha256


def _load_package(tree: Path, name: str):
    """TREE's ``src/repro_torch`` imported as the package ``name`` (its
    imports of itself are relative, so it runs beside this checkout's)."""
    import importlib.util
    src = tree.resolve() / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        name, src / "__init__.py", submodule_search_locations=[str(src)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def ab_zstats(cs, parent: Path, more=()):
    import importlib
    import numpy as np
    import torch
    from repro_torch.core import vmp
    from repro_torch.kernels import dirichlet_expectation as de
    from repro_torch.kernels import fused_zstats as fz
    from repro_torch.kernels import ops
    _load_package(parent, "parent_repro_torch")
    pfz = importlib.import_module("parent_repro_torch.kernels.fused_zstats")
    pref = importlib.import_module("parent_repro_torch.kernels.ref")
    print(f"parent package: {Path(pfz.__file__).parents[1]}", flush=True)
    args = argparse.Namespace(docs=30000, steps=2)
    _, m, prog = cs.make_main_model(args)
    m.infer(steps=args.steps, seed=cs.SEED, device="cuda")
    state, spec = m._state, prog.latents[0]
    arrays = vmp._program_arrays(prog, state.device)
    rows = arrays[spec.name]["prior_rows"]
    vals = arrays[spec.children[0].x_name]["values"]
    e_theta = de.dirichlet_expectation(state.posteriors["theta"])
    e_phi = de.dirichlet_expectation(state.posteriors["phi"], transpose=True).T
    child = ops.ZChild(elog=e_phi, values=vals)
    pchild = pref.ZChild(elog=e_phi, values=vals)
    t0 = time.perf_counter()
    plan = ops.zstats_plan(e_theta, rows, (child,))
    t1 = time.perf_counter()
    pplan = pfz.build_plan(rows, (pchild,), tuple(e_theta.shape)).to(
        rows.device)
    t2 = time.perf_counter()
    print(f"[ab-zstats] owner plan built in {t1 - t0:.2f} s (this), "
          f"{t2 - t1:.2f} s (parent)", flush=True)
    runs = {"this": lambda: fz.zstats(e_theta, rows, (child,), plan=plan),
            "parent": lambda: pfz.zstats(e_theta, rows, (pchild,),
                                         plan=pplan)}
    a, b = runs["this"](), runs["parent"]()
    same = all(torch.equal(x, y) for x, y in
               zip((a[0], a[1], *a[2]), (b[0], b[1], *b[2])))
    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        times[who].append(cs.time_ms(runs[who], reps=10))
    t_this, t_parent = (sum(times[w]) / 2 for w in ("this", "parent"))
    print(f"[ab-zstats] {cs.device_line()}; N = {rows.shape[0]}, K = "
          f"{e_theta.shape[1]}, V = {e_phi.shape[1]}")
    print(f"[ab-zstats] turns (ms): parent {times['parent']}, this "
          f"{times['this']}")
    print(f"[ab-zstats] parent {t_parent:.4f} ms, this {t_this:.4f} ms per "
          f"call: {t_parent / t_this:.2f}x; outputs bitwise equal: {same}",
          flush=True)
    del runs, plan, pplan, a, b
    torch.cuda.empty_cache()
    # DCM-LDA: a strided child, each tree with its own owner plan; then
    # with a fractional mask on the child
    mods = {"parent": (pfz, pref)}
    for i, tree in enumerate(more, 1):
        _load_package(Path(tree), f"tree{i}_repro_torch")
        mods[f"tree{i}"] = tuple(importlib.import_module(
            f"tree{i}_repro_torch.kernels.{n}") for n in ("fused_zstats",
                                                          "ref"))
        print(f"[ab-zstats] tree{i}: {tree}", flush=True)
    args, plan = _dcmlda_zstats(cs)
    c = args[2][0]
    rng = np.random.default_rng(cs.SEED)
    frac = torch.from_numpy(rng.uniform(0.05, 1.0, len(c.values)).astype(
        np.float32)).to(c.values.device)
    masked = (*args[:2], (c._replace(mask=frac), *args[2][1:]), args[3])
    layouts = (("dcmlda", args, plan),
               ("dcmlda fractional mask", masked,
                ops.zstats_plan(*masked[:3])))
    for label, a, pl in layouts:
        print(f"[ab-zstats] {label}: N = {a[1].shape[0]}, child table "
              f"{tuple(a[2][0].elog.shape)}; passes: this "
              f"{ops.routing(a[0], plan=pl, children=a[2]).label}",
              flush=True)
        for who, (wfz, wref) in mods.items():
            wa = (*a[:2], tuple(wref.ZChild(*x) for x in a[2]), a[3])
            wplan = wfz.build_plan(wa[1], wa[2], tuple(a[0].shape)).to(
                a[0].device)
            tag = "" if who == "parent" else f" against {who}"
            _ab(cs, f"zstats {label}{tag}", {
                "this": lambda a=a, pl=pl: fz.zstats(*a[:3], a[3], plan=pl),
                "parent": lambda f=wfz, wa=wa, wp=wplan: f.zstats(
                    *wa[:3], wa[3], plan=wp)}, tag="ab-zstats")
            del wplan
            torch.cuda.empty_cache()
    return 0


def _dcmlda_zstats(cs, steps=2):
    """The ``zstats`` call of ``chip_smoke.py``'s DCM-LDA path (its
    DCM_DOCS documents, K = 16, V = 2,000) at the last of ``steps`` VMP
    steps, as the step handed it: ``((table_prior, prior_rows, children,
    zmask), plan)``."""
    _, m, _ = cs.make_dcmlda()
    with cs.recording("zstats") as calls:
        m.infer(steps=steps, seed=cs.SEED, device="cuda")
    (a, kw, _), = calls.values()
    assert kw.get("tables", "elog") == "elog", kw.get("tables")
    return (*a, kw.get("zmask")), kw.get("plan")


def zstats_split(cs):
    import re
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import fused_zstats as fz
    from repro_torch.kernels import ops
    args, plan = _dcmlda_zstats(cs)
    c = args[2][0]
    vals = c.values.cpu().numpy().astype(np.int64)
    base = c.base.cpu().numpy().astype(np.int64)
    kf = c.elog.shape[1]
    col = np.bincount(vals, minlength=kf)
    _, run_len = np.unique(base * kf + vals, return_counts=True)
    print(f"[zstats-split] {cs.device_line()}; dcmlda N = {len(vals)}, "
          f"child table {tuple(c.elog.shape)}, stride {c.stride}, "
          f"{len(np.unique(base))} bases; route "
          f"{ops.routing(args[0], plan=plan, children=args[2]).label}",
          flush=True)
    print(f"[zstats-split] value columns: hottest {col.max()} tokens, "
          f"{(col >= 1000).sum()} of {kf} hold 1,000 or more; (base, value) "
          f"runs {len(run_len)}: longest {run_len.max()}, mean "
          f"{run_len.mean():.4f} tokens, {(run_len == 1).mean():.4f} of one "
          f"token", flush=True)

    def call():
        return fz.zstats(*args[:3], args[3], plan=plan)
    ms = cs.time_ms(call, reps=10)
    reps = 10
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and \
                ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total / reps / 1e3,
                         ev.count / reps, ev.key))
    rows.sort(reverse=True)
    print(f"[zstats-split] a call: {ms:.4f} ms (CUDA events, 10 calls); "
          f"device time by kernel under torch.profiler ({reps} calls), "
          f"{sum(r[0] for r in rows):.4f} ms in all:", flush=True)
    for t, n, key in rows:
        print(f"  {t:9.4f} ms  x{n:g}  {key[:100]}", flush=True)
    # the stats passes' adds at K = 16 (a lane holds four topics): what
    # computes each stored value, a fused multiply-add or a multiply and an
    # add
    for name, code in sorted(_sass(fz.build()[0]).items()):
        if not name.startswith(("_Z14strided_kernelILi1E",
                                "_Z11runs_kernelILi1E",
                                "_Z19zmap_strided_kernelILi1E",
                                "_Z16zmap_runs_kernelILi1E")):
            continue
        ins = [x for x in re.findall(r"/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", code)
               if x]
        opc = [x.split()[1] if x.startswith("@") else x.split()[0]
               for x in ins]
        print(f"[zstats-split] SASS {name}: " + ", ".join(
            f"{op} {sum(o.startswith(op) for o in opc)}"
            for op in ("FFMA", "FMUL", "FADD", "STG")), flush=True)
        for j, o in enumerate(opc):
            if o.startswith("STG"):
                arith = [ins[i] for i in range(max(0, j - 8), j)
                         if opc[i].startswith(("FFMA", "FMUL", "FADD"))]
                print(f"    {ins[j]}  <- {arith[-2:]}", flush=True)
    return 0


def _ab(cs, label, runs, reps=10, tag="ab-zmap"):
    """Time ``runs["parent"]`` and ``runs["this"]`` in turns (parent, this,
    this, parent) after one call of each, and say whether their outputs (a
    tensor or a tuple of tensors, nested) are bitwise equal."""
    import torch

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        return [t for y in x for t in flat(y)]
    a, b = flat(runs["this"]()), flat(runs["parent"]())
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    times = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        times[who].append(cs.time_ms(runs[who], reps=reps))
    t_this, t_parent = (sum(times[w]) / 2 for w in ("this", "parent"))
    print(f"[{tag}] {label}: parent {t_parent:.4f} ms, this {t_this:.4f} ms "
          f"per call ({t_parent / t_this:.2f}x); outputs bitwise equal: "
          f"{same}; turns (ms) parent {times['parent']}, this "
          f"{times['this']}", flush=True)
    return t_this, t_parent, same


# (bh, s, dh) of ab-flash, bf16 and causal
AB_FLASH_SHAPES = [(64, 2048, 128), (128, 2048, 128), (56, 2048, 64),
                   (8, 4096, 256), (32, 2048, 256)]


def _sass(lib: Path) -> dict:
    """``{kernel: its SASS}`` of a built library, from ``cuobjdump``."""
    import os
    import re
    import subprocess
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / \
        "cuobjdump"
    out = subprocess.run([str(tool) if tool.exists() else "cuobjdump",
                          "-sass", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    return dict(zip(parts[1::2], parts[2::2]))


def ab_flash(cs, parent: Path, tree: Path = HERE):
    import importlib
    import torch
    _load_package(parent, "parent_repro_torch")
    pkgs = {"parent": "parent_repro_torch", "this": "repro_torch"}
    if tree.resolve() != HERE:
        _load_package(tree, "tree_repro_torch")
        pkgs["this"] = "tree_repro_torch"
    fa = {w: importlib.import_module(p + ".kernels.flash_attention")
          for w, p in pkgs.items()}
    for w, m in fa.items():
        print(f"[ab-flash] {w}: {m._SRC} -> {m.build()[0].name}", flush=True)
    sass = {w: _sass(m.build()[0]) for w, m in fa.items()}
    for name in sorted(sass["parent"].keys() | sass["this"].keys()):
        if name in sass["parent"] and name in sass["this"]:
            print(f"[ab-flash] {name}: machine code identical to the "
                  f"parent's: {sass['parent'][name] == sass['this'][name]}")
        else:
            print(f"[ab-flash] {name}: only in "
                  f"{'parent' if name in sass['parent'] else 'this'}")
    print(f"[ab-flash] {cs.device_line()}", flush=True)
    same_64_128 = True
    for bh, s, dh in AB_FLASH_SHAPES:
        q, k, v = cs.flash_inputs(bh, s, s, dh, torch.bfloat16, 604)
        routes = {w: m.route(q, k, v) for w, m in fa.items()}
        runs = {w: (lambda m=m: m.launch(q, k, v, True)) for w, m in fa.items()}
        label = (f"({bh}, {s}, {dh}) parent {routes['parent']}, this "
                 f"{routes['this']}")
        t_this, t_parent, same = _ab(cs, label, runs, reps=20, tag="ab-flash")
        if dh in (64, 128):
            same_64_128 &= same
        else:
            _ab(cs, f"({bh}, {s}, {dh}) mma route in both", {
                w: (lambda m=m: m.launch(q, k, v, True, route="mma"))
                for w, m in fa.items()}, reps=20, tag="ab-flash")
        del q, k, v
        torch.cuda.empty_cache()
    print(f"[ab-flash] Dh 64 and 128 outputs bitwise the parent's: "
          f"{same_64_128}", flush=True)
    return 0 if same_64_128 else 1


def _parent_de_passes(pde, alpha):
    """The parent's two Elog passes on ``alpha`` transposed, launched as its
    wrapper launches them: (row sums, elementwise) callables."""
    import torch
    import triton
    if hasattr(pde, "row_sums"):
        part = pde.row_sums(alpha)
        return (lambda: pde.row_sums(alpha),
                lambda: pde.elog_from_sums(alpha, part, True))
    rowsum_digamma, elog = pde._kernels()
    g, k = alpha.shape
    bk = min(triton.next_power_of_2(k), pde._MAX_BLOCK_K)
    br = pde._MAX_BLOCK_K // bk
    dg = torch.empty((g,), dtype=torch.float32, device=alpha.device)
    out = torch.empty((k, g), dtype=torch.float32, device=alpha.device)
    return (lambda: rowsum_digamma[(triton.cdiv(g, br),)](
                alpha, dg, g, k, alpha.stride(0), BLOCK_R=br, BLOCK_K=bk),
            lambda: elog[(triton.cdiv(g, 32), triton.cdiv(k, 64))](
                alpha, dg, out, g, k, alpha.stride(0), 1, g, BLOCK_R=32,
                BLOCK_K=64))


def _segment_inputs(pkg: str, m, tabs=None):
    """Package ``pkg``'s kernel inputs of model ``m``'s segment latent:
    (prior table, prior rows, children, plan, n_latent, K), on the Elog
    tables ``tabs`` (made by this checkout's step when None)."""
    import importlib
    vmp = importlib.import_module(pkg + ".core.vmp")
    kops = importlib.import_module(pkg + ".kernels.ops")
    prog, state = m.compile(), m._state
    spec = prog.latents[0]
    arrays = vmp._program_arrays(prog, state.device)
    tabs = tabs if tabs is not None else vmp._elog_tables(prog, state)
    children = vmp._latent_children(spec, tabs, arrays)
    rows = arrays[spec.name]["prior_rows"]
    prior = tabs[spec.prior_dir]
    plan = kops.zstats_plan(prior, rows, children)
    return prior, rows, children, plan, spec.n, spec.k, tabs


def ab_zmap(cs, parent: Path, more=()):
    import importlib
    import torch
    from repro_torch.data import SyntheticCorpus
    from repro_torch.kernels import dirichlet_expectation as de
    trees = {"parent": parent}
    trees.update({f"tree{i}": Path(t) for i, t in enumerate(more, 1)})
    mods = {"this": {n: importlib.import_module(f"repro_torch.kernels.{n}")
                     for n in ("fused_zmap", "dirichlet_expectation")}}
    for who, tree in trees.items():
        _load_package(tree, f"{who}_repro_torch")
        mods[who] = {n: importlib.import_module(
            f"{who}_repro_torch.kernels.{n}")
            for n in ("fused_zmap", "dirichlet_expectation")}
        print(f"[ab-zmap] {who}: {tree}", flush=True)
    print(f"[ab-zmap] {cs.device_line()}", flush=True)
    corpus = SyntheticCorpus(n_docs=30000, vocab=cs.VOCAB, n_topics=cs.TOPICS,
                             alpha=cs.ALPHA, beta=cs.BETA,
                             mean_len=cs.MEAN_LEN, seed=cs.SEED).generate()
    models = (("slda", cs.make_slda(corpus)),
              ("naive_bayes", cs.make_naive_bayes(
                  argparse.Namespace(docs=30000))))
    del corpus
    phi = None
    for label, m in models:
        m.infer(steps=2, seed=cs.SEED, device="cuda")
        inputs = {"this": _segment_inputs("repro_torch", m)}
        for who in trees:
            inputs[who] = _segment_inputs(f"{who}_repro_torch", m,
                                          inputs["this"][-1])
        a = inputs["this"]
        print(f"[ab-zmap] {label}: {a[4]} instances, K = {a[5]}, N = "
              f"{len(a[2][0].values)}", flush=True)
        for who in trees:
            tag = "" if who == "parent" else f" against {who}"
            runs = {w: (lambda f=mods[k]["fused_zmap"], a=inputs[k]:
                        f.zstats_zmap(*a[:3], plan=a[3]))
                    for w, k in (("this", "this"), ("parent", who))}
            _ab(cs, f"zstats_zmap {label}{tag}", runs)
            runs = {w: (lambda f=mods[k]["fused_zmap"], a=inputs[k]:
                        f.zmap_logits(a[2], a[4], a[5], plan=a[3]))
                    for w, k in (("this", "this"), ("parent", who))}
            _ab(cs, f"zmap_logits {label}{tag}", runs)
        if label == "slda":
            child_dir = m.compile().latents[0].children[0].dir_name
            phi = m._state.posteriors[child_dir]
        del inputs, runs
        torch.cuda.empty_cache()
    pde = mods["parent"]["dirichlet_expectation"]
    runs = {"this": lambda: de.dirichlet_expectation(phi, transpose=True),
            "parent": lambda: pde.dirichlet_expectation(phi, transpose=True)}
    _ab(cs, f"dirichlet_expectation phi {tuple(phi.shape)} as (V, K)", runs,
        reps=20)
    part = de.row_sums(phi)
    pr, pe = _parent_de_passes(pde, phi)
    for name, this_fn, parent_fn in (
            ("whole call", runs["this"], runs["parent"]),
            ("row sums", lambda: de.row_sums(phi), pr),
            ("elementwise", lambda: de.elog_from_sums(phi, part, True), pe)):
        t = {"parent": [], "this": []}
        d = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            fn = this_fn if who == "this" else parent_fn
            t[who].append(cs.time_ms(fn, reps=20))
            d[who].append(cs.device_ms(fn))
        print(f"[ab-zmap] dirichlet_expectation phi, {name}: parent "
              f"{sum(t['parent']) / 2:.4f} ms (device "
              f"{sum(d['parent']) / 2:.4f}), this {sum(t['this']) / 2:.4f} "
              f"ms (device {sum(d['this']) / 2:.4f}); turns (ms) parent "
              f"{t['parent']}, this {t['this']}; device {d['parent']}, "
              f"{d['this']}", flush=True)
    del runs, phi, part
    torch.cuda.empty_cache()
    _ab_dcmslda(cs, mods, trees)
    return 0


def _ab_dcmslda(cs, mods, trees):
    """``zstats_zmap`` at ``chip_smoke.py``'s DCM-SLDA inputs (after 2 VMP
    steps), this checkout's against each tree's, each with its own owner
    plan (this one's phase 2b on "runs"), and again with a fractional
    mask on phi's child (a seeded draw in [0.05, 1) a token); at both,
    this checkout's "runs" pass against its per-column one."""
    import importlib
    import numpy as np
    import torch
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ops
    _, _, m, _ = cs.make_dcmslda()
    with cs.recording("zstats") as calls:
        m.infer(steps=2, seed=cs.SEED, device="cuda")
    (a, kw, _), = calls.values()
    args, plan = (*a, kw.get("zmask")), kw.get("plan")
    del m, calls
    c = args[2][0]
    rng = np.random.default_rng(cs.SEED)
    frac = torch.from_numpy(rng.uniform(0.05, 1.0, len(c.values)).astype(
        np.float32)).to(c.values.device)
    masked = (*args[:2], (c._replace(mask=frac),), args[3])
    for label, a, pl in (("dcmslda", args, plan),
                         ("dcmslda fractional mask", masked,
                          ops.zstats_plan(*masked[:3]))):
        col = fzm.build_zmap_plan(a[1], a[2], tuple(a[0].shape),
                                  per_column=True).to(a[0].device)
        print(f"[ab-zmap] {label}: N = {len(a[2][0].values)}, "
              f"{a[1].shape[0]} sentences, child table "
              f"{tuple(a[2][0].elog.shape)}; this "
              f"{ops.routing(a[0], plan=pl, children=a[2]).label}",
              flush=True)
        _ab(cs, f"zstats_zmap {label}: per column (as 'parent') against "
            f"runs", {"this": lambda a=a, pl=pl: fzm.zstats_zmap(*a, plan=pl),
                      "parent": lambda a=a, col=col: fzm.zstats_zmap(
                          *a, plan=col)})
        for who in trees:
            wfzm = mods[who]["fused_zmap"]
            wref = importlib.import_module(f"{who}_repro_torch.kernels.ref")
            wa = (*a[:2], tuple(wref.ZChild(*x) for x in a[2]), a[3])
            wplan = wfzm.build_zmap_plan(wa[1], wa[2], tuple(a[0].shape)).to(
                a[0].device)
            tag = "" if who == "parent" else f" against {who}"
            _ab(cs, f"zstats_zmap {label}{tag}", {
                "this": lambda a=a, pl=pl: fzm.zstats_zmap(*a, plan=pl),
                "parent": lambda f=wfzm, wa=wa, wp=wplan: f.zstats_zmap(
                    *wa, plan=wp)})
            del wplan
        del col
        torch.cuda.empty_cache()



def de_sweep(cs):
    import numpy as np
    import torch
    from repro_torch.kernels import dirichlet_expectation as de
    print(f"[de-sweep] {cs.device_line()}", flush=True)
    rng = np.random.default_rng(0)
    knobs = ("_WAVES", "_T_TILE", "_T_WARPS")
    default = {n: getattr(de, n) for n in knobs}
    for shape, transpose in (((100, 102660), True), ((30000, 100), False)):
        a = torch.from_numpy((rng.gamma(1.0, 1.0, size=shape) + 1e-2)
                             .astype(np.float32)).cuda()
        want = cs.de_plain(a, transpose)
        variants = [dict(_WAVES=w) for w in (4, 8, 16)]
        if transpose:
            variants += [dict(_T_TILE=t, _T_WARPS=w)
                         for t, w in (((8, 256), 4), ((8, 256), 2),
                                      ((8, 512), 4), ((8, 512), 8),
                                      ((16, 128), 4), ((8, 128), 4),
                                      ((16, 256), 8), ((32, 64), 4))]
        for v in variants:
            for n in knobs:
                setattr(de, n, v.get(n, default[n]))
            try:
                got = de.dirichlet_expectation(a, transpose)
                err = cs.errors(got, want)[0]
                ok = cs.within(got, want, **cs.DE_TOL)
                part = de.row_sums(a)
                t_rows = cs.device_ms(lambda: de.row_sums(a))
                t_elem = cs.device_ms(lambda: de.elog_from_sums(
                    a, part, transpose))
                t_call = cs.time_ms(lambda: de.dirichlet_expectation(
                    a, transpose), reps=20)
            except Exception as exc:        # a variant that does not compile
                print(f"[de-sweep] {shape} {v}: failed: {exc!r}"[:400],
                      flush=True)
                continue
            print(f"[de-sweep] {shape}{' as (K, G)' if transpose else ''} "
                  f"{v}: {part.shape[1]} chunks; device ms row sums "
                  f"{t_rows:.4f}, elementwise {t_elem:.4f}, sum "
                  f"{t_rows + t_elem:.4f}; call (events) {t_call:.4f}; "
                  f"max_abs {err:.3e}, within DE_TOL: {ok}", flush=True)
    for n in knobs:
        setattr(de, n, default[n])
    return 0


def _path_steps(pkg: str, cs, corpus, nb_corpus) -> dict:
    """{path: [step, state]} of package ``pkg``'s three VMP paths, each
    after one step of ``Model.infer`` (which builds the owner plan)."""
    import importlib
    models = importlib.import_module(pkg + ".core.models")
    runtime = importlib.import_module(pkg + ".core.runtime")
    vmp = importlib.import_module(pkg + ".core.vmp")
    lda = models.make("lda", alpha=cs.ALPHA, beta=cs.BETA, K=cs.TOPICS,
                      V=cs.VOCAB)
    lda["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    tok_sent, sent_doc = cs.sentences(corpus)
    slda = models.make("slda", alpha=cs.ALPHA, beta=cs.BETA, K=cs.TOPICS,
                       V=cs.VOCAB)
    slda["x"].observe(corpus["tokens"], segment_ids=tok_sent)
    slda.bind("sents", sent_doc)
    nb = models.make("naive_bayes", alpha=cs.ALPHA, beta=cs.BETA,
                     C=cs.NB_CLASSES, V=cs.NB_VOCAB)
    nb["x"].observe(nb_corpus["tokens"], segment_ids=nb_corpus["doc_ids"])
    out = {}
    for name, m in (("lda", lda), ("slda", slda), ("naive_bayes", nb)):
        prog = m.compile()
        m.infer(steps=1, seed=cs.SEED, device="cuda")
        posts, _ = vmp.state_to_numpy(m._state)
        step = runtime.make_step(prog, device="cuda")
        st, _ = step(vmp.state_from_numpy(posts, step=0, device="cuda"))
        out[name] = [step, st]
    return out


def ab_steps(cs, parent: Path):
    import torch
    from repro_torch.data import SyntheticCorpus
    _load_package(parent, "parent_repro_torch")
    corpus = SyntheticCorpus(n_docs=30000, vocab=cs.VOCAB, n_topics=cs.TOPICS,
                             alpha=cs.ALPHA, beta=cs.BETA,
                             mean_len=cs.MEAN_LEN, seed=cs.SEED).generate()
    nb_corpus = SyntheticCorpus(n_docs=cs.NB_DOCS, vocab=cs.NB_VOCAB,
                                n_topics=cs.NB_CLASSES, alpha=cs.ALPHA,
                                beta=cs.BETA, mean_len=cs.MEAN_LEN,
                                seed=cs.SEED).generate()
    trees = {who: _path_steps(pkg, cs, corpus, nb_corpus) for who, pkg in
             (("parent", "parent_repro_torch"), ("this", "repro_torch"))}

    def run(entry, reps=10):
        step, st = entry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            st, elbo = step(st)
            float(elbo)
        entry[1] = st
        return (time.perf_counter() - t0) / reps * 1e3

    print(f"[ab-steps] {cs.device_line()}")
    for path in ("lda", "slda", "naive_bayes"):
        times = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            times[who].append(run(trees[who][path]))
        t_this, t_parent = (sum(times[w]) / 2 for w in ("this", "parent"))
        print(f"[ab-steps] {path}: parent {t_parent:.3f} ms, this "
              f"{t_this:.3f} ms per step ({t_parent / t_this:.2f}x); turns "
              f"(ms) parent {times['parent']}, this {times['this']}",
              flush=True)
    return 0


def _fits(pkg: str, cs, corpora: dict) -> dict:
    """{path: (posteriors as numpy, ELBO trace)} of package ``pkg``'s five
    VMP fits and its SVI fit at ``chip_smoke.py``'s depths and seeds (the
    SVI fit's trace: the batch ELBOs, then the held-out ones)."""
    import dataclasses
    import importlib
    models = importlib.import_module(pkg + ".core.models")
    core = importlib.import_module(pkg + ".core")
    corpus, nb_corpus, dcm = corpora["lda"], corpora["nb"], corpora["dcm"]
    out = {}

    def infer(name, m, steps):
        m.infer(steps=steps, seed=cs.SEED, device="cuda")
        out[name] = ({n: m[n].get_result() for n in ("theta", "phi")},
                     list(m.elbo_trace))

    def fit(name, m, steps):
        res = core.make_engine("vmp", steps=steps, seed=cs.SEED,
                               device="cuda").fit(m)
        out[name] = (res.posteriors, list(res.elbo_trace))

    lda = models.make("lda", alpha=cs.ALPHA, beta=cs.BETA, K=cs.TOPICS,
                      V=cs.VOCAB)
    lda["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    infer("main", lda, 10)
    # SVI at lda_svi's settings over the main path's program, from its
    # initial state
    svi = importlib.import_module(pkg + ".core.svi")
    vmp = importlib.import_module(pkg + ".core.vmp")
    prog = lda.compile()
    state, hist = svi.SVI(
        prog, svi.SVIConfig(**dataclasses.asdict(cs.svi_config())),
        device="cuda").fit(cs.SVI_STEPS,
                           state=vmp.init_state(prog, cs.SEED, device="cuda"))
    out["lda_svi"] = (vmp.state_to_numpy(state)[0],
                      hist["elbo"] + [v for _, v in hist["heldout"]])
    tok_sent, sent_doc = cs.sentences(corpus)
    slda = models.make("slda", alpha=cs.ALPHA, beta=cs.BETA, K=cs.TOPICS,
                       V=cs.VOCAB)
    slda["x"].observe(corpus["tokens"], segment_ids=tok_sent)
    slda.bind("sents", sent_doc)
    fit("slda", slda, 10)
    nb = models.make("naive_bayes", alpha=cs.ALPHA, beta=cs.BETA,
                     C=cs.NB_CLASSES, V=cs.NB_VOCAB)
    nb["x"].observe(nb_corpus["tokens"], segment_ids=nb_corpus["doc_ids"])
    fit("naive_bayes", nb, cs.NB_STEPS)
    dl = models.make("dcmlda", alpha=cs.ALPHA, beta=cs.BETA,
                     K=cs.DCM_TOPICS, V=cs.DCM_VOCAB)
    dl["x"].observe(dcm["tokens"], segment_ids=dcm["doc_ids"])
    infer("dcmlda", dl, cs.DCM_STEPS)
    tok_sent, sent_doc = cs.sentences(dcm)
    # this checkout's DSL lines, so a tree whose make lacks the model fits
    # the same one
    from repro_torch.core.models import dcmslda
    ds = models.Model(dcmslda, alpha=cs.ALPHA, beta=cs.BETA,
                      K=cs.DCM_TOPICS, V=cs.DCM_VOCAB)
    ds["x"].observe(dcm["tokens"], segment_ids=tok_sent)
    ds.bind("sents", sent_doc)
    infer("dcmslda", ds, cs.DCM_STEPS)
    return out


def ab_digests(cs, parent: Path):
    import numpy as np
    from repro_torch.data import SyntheticCorpus
    _load_package(parent, "parent_repro_torch")
    corpora = {
        "lda": SyntheticCorpus(n_docs=30000, vocab=cs.VOCAB,
                               n_topics=cs.TOPICS, alpha=cs.ALPHA,
                               beta=cs.BETA, mean_len=cs.MEAN_LEN,
                               seed=cs.SEED).generate(),
        "nb": SyntheticCorpus(n_docs=cs.NB_DOCS, vocab=cs.NB_VOCAB,
                              n_topics=cs.NB_CLASSES, alpha=cs.ALPHA,
                              beta=cs.BETA, mean_len=cs.MEAN_LEN,
                              seed=cs.SEED).generate(),
        "dcm": SyntheticCorpus(n_docs=cs.DCM_DOCS, vocab=cs.DCM_VOCAB,
                               n_topics=cs.DCM_TOPICS,
                               mean_len=cs.DCM_MEAN_LEN,
                               seed=cs.SEED).generate()}
    fits = {who: _fits(pkg, cs, corpora) for who, pkg in
            (("parent", "parent_repro_torch"), ("this", "repro_torch"))}
    print(f"[ab-digests] {cs.device_line()}")
    same = True
    for path, (posts, trace) in fits["this"].items():
        p_posts, p_trace = fits["parent"][path]
        bitwise = {n: bool(np.array_equal(np.asarray(posts[n]),
                                          np.asarray(p_posts[n])))
                   for n in sorted(posts)}
        diff = np.abs(np.asarray(trace) - np.asarray(p_trace))
        rel = diff / np.abs(np.asarray(p_trace))
        same &= all(bitwise.values())
        print(f"[ab-digests] {path}: posteriors bitwise the parent's "
              f"{bitwise}; ELBO trace largest step difference "
              f"{diff.max():.6e} ({rel.max():.3e} relative, step "
              f"{int(diff.argmax())}); sha256 parent "
              f"{cs.output_digest(p_posts, p_trace)}, this "
              f"{cs.output_digest(posts, trace)}", flush=True)
    return 0 if same else 1


def _worst(tag, got, want, tol):
    """Worst |got - want| / (atol + rtol |want|) of the stats, and the lse's
    relative error."""
    for name, g, w in [("prior stats", got[1], want[1]),
                       ("child stats", got[2][0], want[2][0])]:
        g, w = g.double(), w.double()
        ratio = (g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())
        print(f"  {tag:<34} {name}: worst err/tol {float(ratio.max()):.3g}, "
              f"{int((ratio > 1).sum())} elements over", flush=True)
    lse = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    print(f"  {tag:<34} lse relative error {lse:.3g}", flush=True)


def zmap_precision(cs):
    import torch
    from repro_torch.core import make_engine, vmp
    from repro_torch.kernels import fused_zmap as fzm
    from repro_torch.kernels import ref
    m = cs.make_naive_bayes(argparse.Namespace(docs=30000))
    make_engine("vmp", steps=cs.NB_STEPS, seed=cs.SEED, device="cuda").fit(m)
    prog, state = m.compile(), m._state
    spec = prog.latents[0]
    arrays = vmp._program_arrays(prog, state.device)
    tabs = vmp._elog_tables(prog, state)
    children = vmp._latent_children(spec, tabs, arrays)
    rows = arrays[spec.name]["prior_rows"].long()
    plan = vmp.program_plans(prog, arrays)[spec.name]
    prior, ch = tabs[spec.prior_dir], children[0]
    dev = prior.device
    kern = fzm.zstats_zmap(prior, rows.int(), children, plan=plan)
    plain = ref.zstats(prior, rows.int(), children)
    klog = fzm.zmap_logits(children, spec.n, spec.k, plan=plan)
    plog = ref.zmap_logits(children, spec.n, spec.k)

    # the same sums in f64
    e64, v, z = ch.elog.double(), ch.values.long(), ch.zmap.long()
    seg = torch.zeros((spec.n, spec.k), dtype=torch.float64,
                      device=dev).index_add_(0, z, e64[:, v].T)
    logits = prior.double()[rows] + seg

    def stats(x):
        r = torch.softmax(x, -1)
        ps = torch.zeros(prior.shape, dtype=torch.float64,
                         device=dev).index_add_(0, rows, r.double())
        cs_ = torch.zeros((e64.shape[1], e64.shape[0]), dtype=torch.float64,
                          device=dev).index_add_(0, v, r[z].double()).T
        return torch.logsumexp(x, -1).sum(), ps, (cs_,)

    truth = stats(logits)
    print(f"[zmap-precision] naive Bayes, {spec.n} documents, N = {len(v)}, "
          f"K = {spec.k}; units of ZSTATS_TOL (rtol {cs.ZSTATS_TOL['rtol']}, "
          f"atol {cs.ZSTATS_TOL['atol']})")
    _worst("kernel vs plain", kern, plain, cs.ZSTATS_TOL)
    _worst("kernel vs f64", kern, truth, cs.ZSTATS_TOL)
    _worst("plain vs f64", plain, truth, cs.ZSTATS_TOL)
    _worst("f64 phase 1 rounded once vs f64",
           stats(prior[rows] + seg.float()), truth, cs.ZSTATS_TOL)
    top2 = torch.topk(logits, 2, -1).values
    gap = top2[:, 0] - top2[:, 1]
    print(f"  largest |logit| {float(logits.abs().max()):.1f}; documents "
          f"within 8 nats of a tie: {int((gap < 8).sum())}")
    print(f"  logits' largest error against f64: kernel "
          f"{float((klog.double() - seg).abs().max()):.3g}, plain "
          f"{float((plog.double() - seg).abs().max()):.3g}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("check", choices=["digest", "zmap-precision",
                                      "ab-zstats", "ab-steps", "ab-digests",
                                      "ab-zmap", "ab-flash", "de-sweep",
                                      "zstats-split"])
    p.add_argument("tree", nargs="?", default=str(HERE),
                   help="checkout whose src/repro_torch runs (ab-zstats, "
                        "ab-steps, ab-digests, ab-zmap, ab-flash: the "
                        "parent's, beside this checkout's)")
    p.add_argument("more", nargs="*",
                   help="ab-zmap, ab-zstats: further checkouts (variants), "
                        "each timed against this one; ab-flash: the "
                        "checkout timed against the parent (this one by "
                        "default)")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_numerics: no CUDA device", file=sys.stderr)
        return 2
    ab = {"ab-zstats": ab_zstats, "ab-steps": ab_steps,
          "ab-digests": ab_digests, "ab-zmap": ab_zmap, "ab-flash": ab_flash}
    if args.check in ab:
        if Path(args.tree).resolve() == HERE:
            p.error(f"{args.check} needs the parent's checkout")
        if args.check in ("ab-zmap", "ab-zstats"):
            return ab[args.check](_setup(HERE), Path(args.tree), args.more)
        if args.check == "ab-flash":
            if len(args.more) > 1:
                p.error("ab-flash takes PARENT and at most one TREE")
            return ab_flash(_setup(HERE), Path(args.tree),
                            Path(args.more[0]) if args.more else HERE)
        return ab[args.check](_setup(HERE), Path(args.tree))
    cs = _setup(Path(args.tree))
    if args.check == "de-sweep":
        return de_sweep(cs)
    if args.check == "zstats-split":
        return zstats_split(cs)
    (digest if args.check == "digest" else zmap_precision)(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
