"""The corpus maker and the starting posteriors: deterministic in the seed,
and the planted-LDA process they claim."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import corpus  # noqa: E402

SPEC = dict(docs=60, topics=5, vocab=40, alpha=0.1, beta=0.05, mean_len=30,
            min_len=2)
SEED = 2 ** 31 + 11


def test_same_seed_same_corpus_other_seed_other():
    a = corpus.make(SPEC, SEED, "cpu")
    b = corpus.make(SPEC, SEED, "cpu")
    c = corpus.make(SPEC, SEED + 1, "cpu")
    assert a.keys() == b.keys() == {"tokens", "doc_ids"}
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["tokens"][:100], c["tokens"][:100])


def test_corpus_shape():
    c = corpus.make(SPEC, SEED, "cpu")
    tok, doc = c["tokens"], c["doc_ids"]
    assert tok.dtype == doc.dtype == torch.int32 and tok.shape == doc.shape
    assert int(tok.min()) >= 0 and int(tok.max()) < SPEC["vocab"]
    assert bool((doc[1:] >= doc[:-1]).all())
    lengths = torch.bincount(doc.long(), minlength=SPEC["docs"])
    assert int(lengths.min()) >= SPEC["min_len"]
    assert abs(float(lengths.float().mean()) - SPEC["mean_len"]) < 3


@pytest.mark.parametrize("a", [0.05, 0.1, 1.0])
def test_log_gamma_has_the_gamma_mean(a):
    gen = corpus.generator(SEED, "cpu")
    x = corpus.log_gamma(a, 200_000, gen, "cpu").exp()
    assert abs(float(x.mean()) - a) < 0.05 * a + 0.01


def test_dirichlet_rows_sum_to_one_and_concentrate():
    gen = corpus.generator(SEED, "cpu")
    p = corpus.dirichlet(0.05, 20, 1000, gen, "cpu")
    assert torch.allclose(p.sum(-1), torch.ones(20, dtype=torch.float64))
    # at 0.05 most of a row's mass sits on few words
    assert float(p.max(-1).values.mean()) > 0.05


def test_initial_posteriors_are_seeded_and_in_range():
    dirs = {"theta": (7, 3, 0.1), "phi": (3, 11, 0.05)}
    a = corpus.initial_posteriors(dirs, SEED, "cpu")
    b = corpus.initial_posteriors(dirs, SEED, "cpu")
    assert list(a) == ["phi", "theta"]
    for n, (g, k, prior) in dirs.items():
        assert a[n].shape == (g, k) and a[n].dtype == torch.float32
        assert torch.equal(a[n], b[n])
        assert float(a[n].min()) >= prior + 0.5
        assert float(a[n].max()) < prior + 1.5
