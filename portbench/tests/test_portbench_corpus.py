"""The corpus maker and the starting posteriors: deterministic in the seed,
and the planted-LDA process they claim."""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import corpus  # noqa: E402

SPEC = dict(docs=60, topics=5, vocab=40, alpha=0.1, beta=0.05, mean_len=30,
            min_len=2)
SEED = 2 ** 31 + 11
SENT = dict(SPEC, sentence_len=7)
#: sha256 of ``make(SPEC, SEED, "cpu")`` (each key's name and bytes, in
#: sorted order) as the corpus maker drew it before it knew sentences
SPEC_DIGEST = "5209dc022baf3d883458903044da4bb1ec0ddffe4759064685ce8662ebfddc17"


def _digest(c: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(c):
        h.update(k.encode())
        h.update(c[k].numpy().tobytes())
    return h.hexdigest()


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


def test_spec_without_sentences_keeps_its_bits():
    assert _digest(corpus.make(SPEC, SEED, "cpu")) == SPEC_DIGEST


def test_sentence_maps():
    c = corpus.make(SENT, SEED, "cpu")
    assert c.keys() == {"tokens", "doc_ids", "sent_ids", "sent_doc"}
    sent, sdoc = c["sent_ids"], c["sent_doc"]
    assert sent.dtype == sdoc.dtype == torch.int32
    assert sent.shape == c["tokens"].shape
    assert int(sent[0]) == 0 and bool((sent[1:] >= sent[:-1]).all())
    assert bool((sent[1:] - sent[:-1] <= 1).all())
    assert bool((sdoc[1:] >= sdoc[:-1]).all())
    # every sentence lies in one document, its own
    assert torch.equal(sdoc[sent.long()], c["doc_ids"])
    # each document cut into consecutive sentences of 7, the last shorter
    sizes = torch.bincount(sent.long(), minlength=len(sdoc))
    assert int(sizes.min()) >= 1 and int(sizes.max()) <= 7
    lengths = torch.bincount(c["doc_ids"].long(), minlength=SPEC["docs"])
    per_doc = torch.bincount(sdoc.long(), minlength=SPEC["docs"])
    assert torch.equal(per_doc, (lengths + 6) // 7)
    full = sizes[torch.cumsum(per_doc, 0) - 1]           # each doc's last
    assert int(sizes.sum() - full.sum()) == 7 * int((per_doc - 1).sum())


def test_sentences_keep_the_lengths_and_the_seed():
    a, b = corpus.make(SENT, SEED, "cpu"), corpus.make(SENT, SEED, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    flat = corpus.make(SPEC, SEED, "cpu")
    assert torch.equal(a["doc_ids"], flat["doc_ids"])


def test_a_sentence_shares_one_topic():
    """Mixed documents (alpha 1) over topics of about one word each (beta
    0.002): two words of one sentence agree far more often than two
    neighbours across a sentence's end; without sentences they do not."""
    spec = dict(SPEC, docs=200, topics=8, vocab=400, alpha=1.0, beta=0.002)

    def agree(c, across):
        tok, doc = c["tokens"], c["doc_ids"]
        sent = c.get("sent_ids", torch.arange(len(tok)) // 7)
        pair = (doc[1:] == doc[:-1]) & ((sent[1:] != sent[:-1]) == across)
        return float((tok[1:] == tok[:-1])[pair].float().mean())
    c = corpus.make(dict(spec, sentence_len=7), SEED, "cpu")
    assert agree(c, False) > agree(c, True) + 0.3
    f = corpus.make(spec, SEED, "cpu")
    assert abs(agree(f, False) - agree(f, True)) < 0.1
