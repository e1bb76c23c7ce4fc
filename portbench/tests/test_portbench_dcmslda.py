"""DCM-SLDA in the benchmark (``dcmslda-nips.vmp``), on the CPU unless
marked: a throwaway ``tiny-dcmslda.vmp`` (the model at a few hundred
tokens, held to the real cell's limits) added to ``tiny_root``'s copy from
files and entries alone; the port's fit against ``reference/dcmslda.py``,
its bfloat16 control and the faults; the reference against a hand-worked
step; the frozen step count against the port's; and the new readers."""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.append(str(BENCH.parent / "src"))
import check  # noqa: E402
import harness  # noqa: E402
from reference import dcmslda, segment  # noqa: E402
from work import vmp_step  # noqa: E402

REAL = "dcmslda-nips.vmp"
TINY = "tiny-dcmslda.vmp"
SIZES = dict(K=3, V=40, docs=30, mean_len=25)
SEED = 2 ** 31 + 303
NEW_READERS = ("zmap_logits_ms", "zmap_stats_ms", "zmap_runs_roofline")


def add_tiny_cell(tiny_root: Path) -> Path:
    """``tiny_root`` with ``tiny-dcmslda.vmp`` added: the real cell's
    configuration at :data:`SIZES` (its sentences of 7 kept), its limits,
    and every per-layer metric that lists the real cell."""
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    w = next(x for x in bench["workloads"] if x["name"] == REAL)
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg = json.loads((tiny_root / entry["file"]).read_text())
    cfg["dsl"].update(K=SIZES["K"], V=SIZES["V"])
    cfg["corpus"].update(topics=SIZES["K"], vocab=SIZES["V"],
                         docs=SIZES["docs"], mean_len=SIZES["mean_len"])
    cname = TINY.rsplit(".", 1)[0]
    (tiny_root / "portbench" / "configs" / f"{cname}.json").write_text(
        json.dumps(cfg))
    bench["configs"].append(dict(entry, name=cname,
                                 file=f"portbench/configs/{cname}.json"))
    bench["workloads"].append(dict(w, name=TINY, config=cname))
    limits = tiny_root / "portbench" / "limits"
    (limits / f"{TINY}.json").write_text((limits / f"{REAL}.json")
                                         .read_text())
    for m in bench["per_layer"]:
        if REAL in m.get("workloads", ()) or m["name"] == "tiny_steps":
            m["workloads"].append(TINY)
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    return tiny_root


@pytest.fixture
def root(tiny_root):
    return add_tiny_cell(tiny_root)


def run(root, trace=False, **kw):
    return harness.run_cell(root, TINY, SEED, 0.2, trace, device="cpu", **kw)


def test_tiny_cell_follows_the_reference_within_the_limits(root):
    """The port's DCM-SLDA (``models.make("dcmslda")``, ``observe``,
    ``bind``, ``compile``, ``run_inference`` on its plain path) against
    ``reference/dcmslda.py`` over the checked steps, judged by the real
    cell's limits; a traced run reads the new span metrics as nothing on
    the CPU."""
    r = run(root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"], name
    assert set(r["metrics"]) == {"tokens_per_s", "step_ms_p95",
                                 "peak_mem_gib", "setup_s"}
    t = run(root, trace=True)
    assert t["correct"]
    # the real cell's per-layer metrics are the three new ones; on the CPU
    # none finds anything to read
    names = {m["name"] for m in harness.load_cell(root, TINY)["per_layer"]}
    assert names == set(NEW_READERS) | {"tiny_steps"}
    assert set(t["metrics"]) == {"tiny_steps"}


def test_control_is_not_correct(root):
    """The port's own bfloat16 tables fail the cell's limits."""
    r = run(root, elog_dtype="bfloat16")
    assert not r["correct"], r["checks"]


def _broken(monkeypatch, kind):
    """The timed path broken underneath: the state left unchanged; every
    other token left out and the rest doubled; topic 0's statistics
    doubled where they are produced."""
    from repro_torch.core import runtime, vmp
    from repro_torch.kernels import ops
    if kind == "unchanged":
        body = runtime._step_body

        def stuck(program, arrays, state, *a, **kw):
            _, elbo = body(program, arrays, state, *a, **kw)
            return vmp.VMPState(dict(state.posteriors), state.step + 1), elbo
        monkeypatch.setattr(runtime, "_step_body", stuck)
        return
    real = ops.zstats

    def broken(table_prior, prior_rows, children, zmask=None, **kw):
        if kind == "half":
            kids = tuple(c._replace(values=c.values[::2], zmap=c.zmap[::2],
                                    base=c.base[::2]) for c in children)
            lse, ps, cs = real(table_prior, prior_rows, kids, zmask, **kw)
            return 2 * lse, 2 * ps, tuple(2 * c for c in cs)
        lse, ps, cs = real(table_prior, prior_rows, children, zmask, **kw)
        cs = tuple(c.clone() for c in cs)
        for c in cs:
            c[::table_prior.shape[1]] *= 2
        return lse, ps, cs
    monkeypatch.setattr(ops, "zstats", broken)


@pytest.mark.parametrize("kind", ["unchanged", "half", "topic"])
def test_broken_step_is_not_correct(root, kind, monkeypatch):
    _broken(monkeypatch, kind)
    r = run(root)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["half", "topic"])
def test_reference_fault_is_not_correct(root, fault):
    """Each fault of the reference step (the calibration's upper readings)
    fails the cell's limits against the clean reference."""
    cell = harness.load_cell(root, TINY)
    host = harness.make_inputs(cell, SEED, "cpu", False)["host"]
    clean = harness.reference_readings(cell, host, SEED, "cpu")
    bad = harness.reference_readings(cell, host, SEED, "cpu", fault=fault)
    ok, checks = check.judge(check.compare(bad, clean), cell["limits"])
    assert not ok, checks


def test_cell_takes_the_segment_step():
    cell = harness.load_cell(BENCH.parent, REAL)
    assert cell["reference"] is dcmslda
    assert harness.reference_step(cell) == (segment.step, segment.FAULTS)


# ---------------------------------------------------------------------------
# the reference against loops
# ---------------------------------------------------------------------------

def _digamma(x: float) -> float:
    return float(torch.special.digamma(torch.tensor(x, dtype=torch.float64)))


def hand_step(post, prior, sent_doc, seg, words, k):
    """One DCM-SLDA step by loops in float64: a topic per sentence, its
    logits its document's theta plus, over its words, phi's row
    ``doc * K + k`` at the word."""
    e = {n: [[_digamma(a) - _digamma(sum(r)) for a in r] for r in p]
         for n, p in post.items()}
    stats = {n: [[0.0] * len(r) for r in p] for n, p in post.items()}
    lse_total = 0.0
    for s, d in enumerate(sent_doc):
        toks = [i for i, x in enumerate(seg) if x == s]
        logits = [e["theta"][d][t] + sum(e["phi"][d * k + t][words[i]]
                                         for i in toks) for t in range(k)]
        m = max(logits)
        lse = m + math.log(sum(math.exp(x - m) for x in logits))
        lse_total += lse
        for t in range(k):
            r = math.exp(logits[t] - lse)
            stats["theta"][d][t] += r
            for i in toks:
                stats["phi"][d * k + t][words[i]] += r
    elbo = lse_total
    for n, p in post.items():
        a0 = prior[n]
        for r, er in zip(p, e[n]):
            elbo += (sum(math.lgamma(a) for a in r) - math.lgamma(sum(r))
                     - len(r) * math.lgamma(a0) + math.lgamma(len(r) * a0)
                     + sum((a0 - a) * x for a, x in zip(r, er)))
    new = {n: [[a0 + s for s in r] for r in stats[n]]
           for n, a0 in prior.items()}
    return elbo, new


@pytest.mark.parametrize("block", [3, 1 << 22])
def test_reference_step_matches_hand(block):
    """3 documents, 6 sentences, 11 words, a word repeated in a sentence
    and across documents; blocks of whole sentences of any size."""
    k, v = 3, 5
    sent_doc = [0, 0, 1, 2, 2, 2]
    seg = [0, 0, 0, 1, 2, 2, 3, 4, 4, 5, 5]
    words = [0, 3, 3, 1, 2, 0, 1, 1, 3, 4, 0]
    cfg = {"dsl": {"K": k, "V": v, "alpha": 0.3, "beta": 0.2},
           "corpus": {"docs": 3}}
    dirs = dcmslda.dirichlets(cfg)
    assert dirs["phi"][:2] == (3 * k, v)
    post = {n: (torch.arange(g * kk, dtype=torch.float32).view(g, kk) * 0.29
                + 0.7 + p) for n, (g, kk, p) in dirs.items()}
    corpus = {"tokens": torch.tensor(words, dtype=torch.int32),
              "sent_ids": torch.tensor(seg, dtype=torch.int32),
              "sent_doc": torch.tensor(sent_doc, dtype=torch.int32)}
    elbo, new = dcmslda.step(dcmslda.model(cfg, corpus), post, block=block)
    want_elbo, want = hand_step(
        {n: p.double().tolist() for n, p in post.items()},
        {n: p for n, (_, _, p) in dirs.items()}, sent_doc, seg, words, k)
    assert elbo == pytest.approx(want_elbo, rel=1e-6)
    for n in post:
        assert torch.allclose(new[n].double(), torch.tensor(
            want[n], dtype=torch.float64), rtol=1e-6, atol=1e-6), n


# ---------------------------------------------------------------------------
# the step's work
# ---------------------------------------------------------------------------

def test_step_count_matches_the_ports():
    """``work.vmp_step.of_model`` of the reference model: each Dirichlet's
    frozen parts, and the plate counted as the port's own
    ``kernels/work.py:zstats_zmap`` counts the compiled program's call."""
    import corpus as corpus_mod
    from repro_torch.core import models
    from repro_torch.kernels import ops
    from repro_torch.kernels import work as port_work
    k, v = SIZES["K"], SIZES["V"]
    spec = dict(docs=12, topics=k, vocab=v, alpha=0.1, beta=0.05,
                mean_len=20, min_len=2, sentence_len=7)
    cfg = {"dsl": {"K": k, "V": v, "alpha": 0.1, "beta": 0.05},
           "corpus": spec}
    corp = corpus_mod.make(spec, SEED, "cpu")
    m = models.make("dcmslda", alpha=0.1, beta=0.05, K=k, V=v)
    m["x"].observe(corp["tokens"].numpy(),
                   segment_ids=corp["sent_ids"].numpy())
    m.bind("sents", corp["sent_doc"].numpy())
    prog = m.compile()
    (lat,) = prog.latents
    (f,) = lat.children
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    want = port_work.zstats_zmap(
        torch.zeros(spec["docs"], k), t(lat.prior_rows), (ops.ZChild(
            torch.zeros(spec["docs"] * k, v), t(f.values), stride=f.stride,
            zmap=t(f.zmap), base=t(f.base)),))
    dirs = dcmslda.dirichlets(cfg)
    parts = [vmp_step.dirichlet(g, kk) for g, kk, _ in dirs.values()]
    ops_, nbytes = vmp_step.of_model(dcmslda.model(cfg, corp))
    assert (ops_ - sum(o for o, _ in parts),
            nbytes - sum(b for _, b in parts)) == want


# ---------------------------------------------------------------------------
# the new readers
# ---------------------------------------------------------------------------

def _reader(name):
    return harness._load(BENCH / "metrics" / f"{name}.py",
                         f"dcmslda_test_metric_{name}")


@pytest.mark.parametrize("name", NEW_READERS)
def test_readers_read_nothing_on_the_cpu(name):
    ctx = SimpleNamespace(device=torch.device("cpu"), profile={},
                          wrapped={})
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("name", ["zmap_logits_ms", "zmap_stats_ms"])
def test_span_readers_read_nothing_without_their_spans(name, monkeypatch):
    from repro_torch import trace
    ctx = SimpleNamespace(device=torch.device("cuda"), profile={})
    monkeypatch.setattr(trace, "records", lambda: [
        SimpleNamespace(name="runtime.step", events=None),
        SimpleNamespace(name="vmp.token_plate", events=None)])
    assert _reader(name).read(ctx) is None
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "trace")
    assert _reader(name).read(ctx) is None


@pytest.mark.parametrize("name,span", [("zmap_logits_ms", "zmap.logits"),
                                       ("zmap_stats_ms", "zmap.stats")])
def test_span_readers_average_their_records_over_the_steps(name, span,
                                                           monkeypatch):
    from repro_torch import trace
    rec = lambda n, ms: SimpleNamespace(  # noqa: E731
        name=n, events=(), device_ms=ms)
    monkeypatch.setattr(trace, "records", lambda: [
        rec("runtime.step", 50.0), rec(span, 3.0), rec("zmap.prior", 9.0),
        rec("runtime.step", 50.0), rec(span, 5.0)])
    ctx = SimpleNamespace(device=torch.device("cuda"), profile={})
    assert _reader(name).read(ctx) == pytest.approx(4.0)


def test_runs_roofline_reads_only_strided_zmap_calls():
    """The calls whose zmap child carries a base, counted by
    ``count_zmap``; an SLDA call (no base) or a flat one reads nothing."""
    import peaks
    from work import zstats as work
    reader = _reader("zmap_runs_roofline")
    rows = torch.tensor([0, 0, 1], dtype=torch.int32)
    zmap = torch.tensor([0, 0, 1, 2, 2], dtype=torch.int32)
    words = torch.tensor([1, 2, 2, 4, 1], dtype=torch.int32)
    base = rows[zmap.long()] * 2
    strided = ((2, 2), rows, (work.Child((4, 6), words, base, zmap=zmap),),
               None)
    slda = ((2, 2), rows, (work.Child((2, 6), words, zmap=zmap),), None)
    flat = ((2, 2), zmap, (work.Child((2, 6), words),), None)
    cuda = torch.device("cuda")
    wrap = reader.WRAP
    ctx = SimpleNamespace(device=cuda, wrapped={
        wrap: [(strided, 2.0), (slda, 7.0), (strided, 2.0), (flat, 1.0)]})
    want = 100.0 * peaks.bound_s(*work.count_zmap(*strided))[0] / 2e-3
    assert reader.read(ctx) == pytest.approx(want)
    ctx.wrapped = {wrap: [(slda, 7.0), (flat, 1.0)]}
    assert reader.read(ctx) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
def test_tiny_cell_passes_and_control_fails_on_the_card(root, cuda):
    r = harness.run_cell(root, TINY, 2 ** 31 + 5, 0.5, True, device=cuda)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert set(r["metrics"]) == set(NEW_READERS) | {"tiny_steps"}
    assert 0 < r["metrics"]["zmap_runs_roofline"]["value"] <= 100
    for name in ("zmap_logits_ms", "zmap_stats_ms"):
        assert r["metrics"][name]["value"] > 0
    c = harness.run_cell(root, TINY, 2 ** 31 + 5, 0.2, False, device=cuda,
                         elog_dtype="bfloat16")
    assert not c["correct"], c["checks"]


def test_reference_imports_nothing_of_the_program():
    import subprocess
    code = ("import sys; sys.path.insert(0, %r); "
            "from reference import dcmslda; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
