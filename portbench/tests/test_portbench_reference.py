"""The plain reference against a hand-worked step, its faults, and what it
imports."""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
from reference import dcmlda, flat, lda, segment, slda  # noqa: E402


def _digamma(x: float) -> float:
    return float(torch.special.digamma(torch.tensor(x, dtype=torch.float64)))


def hand_step(post, prior, rows, children, k):
    """One VMP step by loops in float64: ``post`` {name: list of rows},
    ``prior`` {name: float}, ``children`` a list of (dirichlet, values,
    row of topic k for token i)."""
    e = {n: [[_digamma(a) - _digamma(sum(r)) for a in r] for r in p]
         for n, p in post.items()}
    stats = {n: [[0.0] * len(r) for r in p] for n, p in post.items()}
    lse_total = 0.0
    for i, d in enumerate(rows):
        logits = []
        for t in range(k):
            x = e["theta"][d][t]
            for name, vals, row in children:
                x += e[name][row(i, t)][vals[i]]
            logits.append(x)
        m = max(logits)
        lse = m + math.log(sum(math.exp(x - m) for x in logits))
        lse_total += lse
        for t in range(k):
            r = math.exp(logits[t] - lse)
            stats["theta"][d][t] += r
            for name, vals, row in children:
                stats[name][row(i, t)][vals[i]] += r
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


@pytest.mark.parametrize("name", ["lda", "dcmlda"])
def test_reference_step_matches_hand(name):
    k, v = 2, 3
    rows = [0, 0, 1, 1, 1]
    words = [0, 2, 1, 1, 2]
    cfg = {"dsl": {"K": k, "V": v, "alpha": 0.3, "beta": 0.2},
           "corpus": {"docs": 2}}
    mod = lda if name == "lda" else dcmlda
    dirs = mod.dirichlets(cfg)
    post = {n: (torch.arange(g * kk, dtype=torch.float32).view(g, kk) * 0.37
                + 0.6 + p) for n, (g, kk, p) in dirs.items()}
    corpus = {"tokens": torch.tensor(words, dtype=torch.int32),
              "doc_ids": torch.tensor(rows, dtype=torch.int32)}
    model = mod.model(cfg, corpus)
    elbo, new = flat.step(model, post, block=2)
    if name == "lda":
        row = (lambda i, t: t)
    else:
        row = (lambda i, t: rows[i] * k + t)
    want_elbo, want = hand_step({n: p.double().tolist() for n, p in
                                 post.items()},
                                {n: p for n, (_, _, p) in dirs.items()},
                                rows, [("phi", words, row)], k)
    assert elbo == pytest.approx(want_elbo, rel=1e-6)
    for n in post:
        assert torch.allclose(new[n].double(), torch.tensor(want[n],
                              dtype=torch.float64), rtol=1e-6, atol=1e-6)


def hand_segment_step(post, prior, sent_doc, seg, words, k):
    """One SLDA step by loops in float64: a topic per sentence, its logits
    the document's theta plus the phi messages of all its words."""
    e = {n: [[_digamma(a) - _digamma(sum(r)) for a in r] for r in p]
         for n, p in post.items()}
    stats = {n: [[0.0] * len(r) for r in p] for n, p in post.items()}
    lse_total = 0.0
    for s, d in enumerate(sent_doc):
        toks = [i for i, x in enumerate(seg) if x == s]
        logits = [e["theta"][d][t] + sum(e["phi"][t][words[i]] for i in toks)
                  for t in range(k)]
        m = max(logits)
        lse = m + math.log(sum(math.exp(x - m) for x in logits))
        lse_total += lse
        for t in range(k):
            r = math.exp(logits[t] - lse)
            stats["theta"][d][t] += r
            for i in toks:
                stats["phi"][t][words[i]] += r
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


@pytest.mark.parametrize("block", [1, 4, 1 << 22])
def test_segment_step_matches_hand(block):
    """SLDA's reference step, in blocks of whole sentences of any size,
    against the loops: 3 documents, 5 sentences, 9 words."""
    k, v = 3, 4
    sent_doc = [0, 0, 1, 2, 2]
    seg = [0, 0, 0, 1, 2, 2, 3, 4, 4]
    words = [0, 3, 3, 1, 2, 0, 1, 1, 3]
    cfg = {"dsl": {"K": k, "V": v, "alpha": 0.3, "beta": 0.2},
           "corpus": {"docs": 3}}
    dirs = slda.dirichlets(cfg)
    post = {n: (torch.arange(g * kk, dtype=torch.float32).view(g, kk) * 0.41
                + 0.7 + p) for n, (g, kk, p) in dirs.items()}
    corpus = {"tokens": torch.tensor(words, dtype=torch.int32),
              "sent_ids": torch.tensor(seg, dtype=torch.int32),
              "sent_doc": torch.tensor(sent_doc, dtype=torch.int32)}
    elbo, new = slda.step(slda.model(cfg, corpus), post, block=block)
    want_elbo, want = hand_segment_step(
        {n: p.double().tolist() for n, p in post.items()},
        {n: p for n, (_, _, p) in dirs.items()}, sent_doc, seg, words, k)
    assert elbo == pytest.approx(want_elbo, rel=1e-6)
    for n in post:
        assert torch.allclose(new[n].double(), torch.tensor(want[n],
                              dtype=torch.float64), rtol=1e-6, atol=1e-6)


def _tiny_slda():
    cfg = {"dsl": {"K": 3, "V": 7, "alpha": 0.1, "beta": 0.05},
           "corpus": {"docs": 4}}
    g = torch.Generator().manual_seed(1)
    seg = torch.sort(torch.randint(0, 20, (60,), generator=g)).values
    _, seg = torch.unique_consecutive(seg, return_inverse=True)
    n_sent = int(seg.max()) + 1
    sent_doc = torch.sort(torch.randint(0, 4, (n_sent,), generator=g)).values
    toks = torch.randint(0, 7, (60,), generator=g, dtype=torch.int32)
    model = slda.model(cfg, {"tokens": toks, "sent_ids": seg.int(),
                             "sent_doc": sent_doc.int()})
    post = {n: torch.rand((a, b), generator=g) + 0.5 + p
            for n, (a, b, p) in slda.dirichlets(cfg).items()}
    return model, post


def test_segment_half_fault_keeps_every_other_sentence_doubled():
    model, post = _tiny_slda()
    _, clean = slda.step(model, post)
    _, half = slda.step(model, post, fault="half")
    n_sent = model.rows.numel()
    # theta's stats: one unit of responsibility a sentence kept, doubled
    kept = 2 * len(range(0, n_sent, 2))
    assert float((half["theta"] - 0.1).double().sum()) == \
        pytest.approx(kept, rel=1e-5)
    assert float((clean["theta"] - 0.1).double().sum()) == \
        pytest.approx(n_sent, rel=1e-5)
    assert not torch.allclose(clean["phi"], half["phi"])


def test_segment_topic_fault_doubles_topic_zero():
    model, post = _tiny_slda()
    _, clean = slda.step(model, post)
    _, topic = slda.step(model, post, fault="topic")
    assert torch.allclose(topic["phi"][0] - 0.05,
                          2 * (clean["phi"][0] - 0.05))
    assert torch.equal(topic["phi"][1:], clean["phi"][1:])
    assert torch.equal(topic["theta"], clean["theta"])
    with pytest.raises(ValueError):
        segment.step(model, post, fault="other")


def test_port_cpu_path_follows_the_segment_reference():
    """The port's SLDA (``models.make("slda")``, ``bind``, ``run_inference``
    with ``ops.zstats`` on its plain path) for 3 steps against the segment
    reference from the same corpus and starting posteriors."""
    import corpus as corpus_mod
    from repro_torch.core import models, runtime, vmp
    k, v = 4, 30
    spec = dict(docs=25, topics=k, vocab=v, alpha=0.1, beta=0.05,
                mean_len=40, min_len=2, sentence_len=7)
    cfg = {"dsl": {"K": k, "V": v, "alpha": 0.1, "beta": 0.05},
           "corpus": spec}
    corp = corpus_mod.make(spec, 2 ** 31 + 77, "cpu")
    host = {n: t.numpy() for n, t in corp.items()}
    m = models.make("slda", alpha=0.1, beta=0.05, K=k, V=v)
    m["x"].observe(host["tokens"], segment_ids=host["sent_ids"])
    m.bind("sents", host["sent_doc"])
    prog = m.compile()
    post0 = corpus_mod.initial_posteriors(slda.dirichlets(cfg), 5, "cpu")
    state, elbos = runtime.run_inference(
        prog, steps=3, state=vmp.VMPState(dict(post0), 0),
        step_fn=runtime.make_step(prog, device="cpu"))
    model = slda.model(cfg, corp)
    post = post0
    for elbo in elbos:
        want, post = slda.step(model, post)
        assert elbo == pytest.approx(want, rel=1e-6)
    for n, p in post.items():
        assert torch.allclose(state.posteriors[n], p, rtol=1e-5, atol=1e-5)


def _tiny():
    cfg = {"dsl": {"K": 3, "V": 7, "alpha": 0.1, "beta": 0.05},
           "corpus": {"docs": 4}}
    g = torch.Generator().manual_seed(0)
    rows = torch.sort(torch.randint(0, 4, (60,), generator=g,
                                    dtype=torch.int32)).values
    toks = torch.randint(0, 7, (60,), generator=g, dtype=torch.int32)
    model = lda.model(cfg, {"tokens": toks, "doc_ids": rows})
    post = {n: torch.rand((a, b), generator=g) + 0.5 + p
            for n, (a, b, p) in lda.dirichlets(cfg).items()}
    return model, post


def test_half_fault_keeps_the_total_count_and_moves_the_stats():
    model, post = _tiny()
    _, clean = flat.step(model, post)
    _, half = flat.step(model, post, fault="half")
    n = model.rows.numel()
    for p in (clean, half):
        total = float((p["theta"] - 0.1).double().sum())
        assert total == pytest.approx(n, rel=1e-5)
    assert not torch.allclose(clean["phi"], half["phi"])


def test_topic_fault_doubles_topic_zero():
    model, post = _tiny()
    _, clean = flat.step(model, post)
    _, topic = flat.step(model, post, fault="topic")
    assert torch.allclose(topic["phi"][0] - 0.05,
                          2 * (clean["phi"][0] - 0.05))
    assert torch.equal(topic["phi"][1:], clean["phi"][1:])
    with pytest.raises(ValueError):
        flat.step(model, post, fault="other")


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "from reference import lda, dcmlda, flat, segment, slda; "
            "import check, corpus; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout
