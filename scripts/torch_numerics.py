#!/usr/bin/env python3
"""Numerical checks of the PyTorch port on one NVIDIA H100, beside
``chip_smoke.py``.

    python3 scripts/torch_numerics.py digest [TREE]
    python3 scripts/torch_numerics.py zmap-precision [TREE]

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

Imports the port only, never JAX nor the JAX package.
"""

import argparse
import sys
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
    plan = vmp._latent_plan(prog, spec, tabs, arrays, children)
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
    p.add_argument("check", choices=["digest", "zmap-precision"])
    p.add_argument("tree", nargs="?", default=str(HERE),
                   help="checkout whose src/repro_torch runs")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_numerics: no CUDA device", file=sys.stderr)
        return 2
    cs = _setup(Path(args.tree))
    (digest if args.check == "digest" else zmap_precision)(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
