"""The port's query layer (``repro_torch.query``) held to the reference's.

The reference's ``tests/test_query.py`` rebuilt on the port, at its
tolerances; the port's own fold-in contract (bitwise its ``heldout_elbo``
at exact caps); and the two packages side by side on one posterior, built
from the reference's SVI fit: fold-in (LDA, SLDA with bindings, ``pow2`` and
exact buckets) at rtol 1e-5 — f32 sums in another order and digammas that
differ in the last ulps; artifacts saved by each package loaded bitwise by
the other; ``top_k`` and ``similarity`` bitwise (one numpy program);
``credible_interval`` within 1e-4 of the reference (its bisection runs in
f32 without x64) and within 1e-12 of ``scipy.special.betaincinv``.
"""

import contextlib
import json
import os
import threading

import numpy as np
import pytest
import torch

from repro.core import make_engine as j_make_engine
from repro.core import models as jmodels
from repro.data import SyntheticCorpus as JCorpus
from repro.query import FoldIn as JFoldIn
from repro.query import FoldInConfig as JFoldInConfig
from repro.query import Posterior as JPosterior
from repro.query import foldin as jfoldin
from repro_torch.core import compiler as tcomp
from repro_torch.core import make_engine, models
from repro_torch.core import svi as tsvi
from repro_torch.core import vmp as tvmp
from repro_torch.data.pipeline import holdout_split
from repro_torch.kernels import ops as tops
from repro_torch.query import (FoldIn, FoldInConfig, FoldInResult, Posterior,
                               QueryClient, QueryServer)
from repro_torch.query import foldin as tfoldin
from repro_torch.query import server as tserver

CPU = "cpu"
HOLDOUT_ITERS = 10       # the engines' holdout_local_iters default
LDA = dict(alpha=0.1, beta=0.05, K=3, V=30)
SLDA = dict(alpha=0.2, beta=0.2, K=3, V=30)
XTOL = dict(rtol=1e-5, atol=0)   # the port against the reference


@pytest.fixture(scope="module")
def corpus():
    return JCorpus(n_docs=50, vocab=30, n_topics=3, mean_len=60,
                   seed=0).generate()


def _lda(mod, c):
    m = mod.make("lda", **LDA)
    m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
    return m


def _slda(mod, c):
    n = len(c["tokens"])
    sent_of_tok = (np.arange(n) // 7).astype(np.int32)
    m = mod.make("slda", **SLDA)
    m["x"].observe(c["tokens"], segment_ids=sent_of_tok)
    m.bind("sents", c["doc_ids"][::7][:sent_of_tok.max() + 1])
    return m


@pytest.fixture(scope="module")
def fitted(corpus):
    """One port SVI fit with a holdout, shared across the module
    (everything downstream treats the result as read-only)."""
    m = _lda(models, corpus)
    result = make_engine("svi", steps=25, batch_size=16, holdout_frac=0.1,
                         holdout_every=5, seed=0, device=CPU).fit(m)
    return {"corpus": corpus, "model": m, "result": result,
            "posterior": result.freeze(m)}


@pytest.fixture(scope="module")
def ref_posteriors(corpus):
    """The reference's SVI fits of LDA (with a holdout) and SLDA, frozen:
    the one posterior each both packages' fold-in scores against."""
    m = _lda(jmodels, corpus)
    lda = j_make_engine("svi", steps=25, batch_size=16, holdout_frac=0.1,
                        holdout_every=5, seed=0).fit(m).freeze(m)
    s = _slda(jmodels, corpus)
    slda = j_make_engine("svi", steps=10, batch_size=16,
                         seed=0).fit(s).freeze(s)
    return {"lda": lda, "slda": slda}


def _as_port(jpost) -> Posterior:
    return Posterior(posteriors={n: np.asarray(v) for n, v in
                                 jpost.posteriors.items()},
                     model=jpost.model, params=dict(jpost.params),
                     local=tuple(jpost.local),
                     observed=tuple(jpost.observed), meta=dict(jpost.meta))


def _holdout_docs(corpus, n_groups=50, frac=0.1, seed=0):
    """The engine's held-out documents, relabeled 0..H-1 (the fold-in
    caller's view)."""
    _, hold = holdout_split(n_groups, frac, seed)
    hm = np.isin(corpus["doc_ids"], hold)
    return (corpus["tokens"][hm],
            np.searchsorted(hold, corpus["doc_ids"][hm]), hold)


def _docs(corpus, n):
    offs = np.concatenate([[0], np.cumsum(corpus["lengths"])])
    return [corpus["tokens"][offs[i]:offs[i + 1]] for i in range(n)]


# ---------------------------------------------------------------------------
# Posterior artifact (the reference's tests on the port)
# ---------------------------------------------------------------------------

def test_posterior_save_load_round_trip(fitted, tmp_path):
    post = fitted["posterior"]
    path = str(tmp_path / "artifact")
    post.save(path)
    loaded = Posterior.load(path)
    assert loaded.model == post.model == "lda"
    assert loaded.params == {"alpha": 0.1, "beta": 0.05, "K": 3, "V": 30}
    assert loaded.local == ("theta",)
    assert loaded.observed == ("x",)
    for n in post.posteriors:
        np.testing.assert_array_equal(loaded.posteriors[n],
                                      post.posteriors[n])
    assert loaded.meta["backend"] == "svi"


def test_posterior_load_rejects_version_mismatch(fitted, tmp_path):
    path = str(tmp_path / "artifact")
    fitted["posterior"].save(path)
    doc = json.load(open(os.path.join(path, "posterior.json")))
    doc["format_version"] = 999
    json.dump(doc, open(os.path.join(path, "posterior.json"), "w"))
    with pytest.raises(ValueError, match="format version"):
        Posterior.load(path)


def test_posterior_load_missing_artifact(tmp_path):
    with pytest.raises(FileNotFoundError):
        Posterior.load(str(tmp_path / "nope"))


def test_compacted_artifact_raises_by_name(fitted, tmp_path):
    path = str(tmp_path / "artifact")
    fitted["posterior"].save(path)
    doc = json.load(open(os.path.join(path, "posterior.json")))
    doc["compact"] = {"k": 5}
    json.dump(doc, open(os.path.join(path, "posterior.json"), "w"))
    # a compact record hands the load to the compaction layer
    # (gateway.compact.load_compacted), which names the field it misses
    with pytest.raises(KeyError, match="tables"):
        Posterior.load(path)


def test_posterior_statistical_queries(fitted):
    post = fitted["posterior"]
    mean = post.mean("phi")
    np.testing.assert_allclose(mean.sum(-1), 1.0, rtol=1e-12)
    idx, probs = post.top_k("phi", 5)
    assert idx.shape == probs.shape == (3, 5)
    assert (np.diff(probs, axis=-1) <= 0).all()          # sorted descending
    np.testing.assert_allclose(probs[:, 0], mean.max(-1), rtol=1e-12)
    lo, hi = post.credible_interval("phi", 0.9)
    assert ((lo <= mean) & (mean <= hi)).all()
    assert ((hi - lo) > 0).all()
    lo50, hi50 = post.credible_interval("phi", 0.5)
    assert ((hi50 - lo50) <= (hi - lo) + 1e-12).all()    # narrower interval
    sim = post.similarity("phi")
    np.testing.assert_allclose(np.diag(sim), 1.0, atol=1e-9)
    np.testing.assert_allclose(sim, sim.T, atol=1e-12)
    with pytest.raises(KeyError, match="available"):
        post.mean("nope")
    with pytest.raises(ValueError, match="similarity"):
        post.similarity("phi", kind="nope")


def test_freeze_unobserved_model_needs_program(fitted):
    m = models.make("lda", **LDA)
    with pytest.raises(ValueError, match="program="):
        fitted["result"].freeze(m)


def test_top_k_deterministic_under_ties():
    """Tied means break toward the smaller column index, every time."""
    conc = np.array([[2.0, 5.0, 2.0, 5.0, 2.0, 1.0],
                     [3.0, 3.0, 3.0, 3.0, 3.0, 3.0]], np.float32)
    post = Posterior(posteriors={"phi": conc}, model="lda",
                     params={}, local=(), observed=("x",), meta={})
    idx, probs = post.top_k("phi", 4)
    np.testing.assert_array_equal(idx[0], [1, 3, 0, 2])   # ties: low index
    np.testing.assert_array_equal(idx[1], [0, 1, 2, 3])   # all tied
    for _ in range(5):                                    # and stays put
        again, _ = post.top_k("phi", 4)
        np.testing.assert_array_equal(idx, again)
    assert (np.diff(probs, axis=-1) <= 0).all()


# ---------------------------------------------------------------------------
# the artifact across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_artifacts_load_bitwise_across_packages(fitted, ref_posteriors,
                                                tmp_path, writer):
    """One on-disk format: each package loads what the other saved, every
    table bitwise and the provenance equal."""
    path = str(tmp_path / "artifact")
    if writer == "port":
        src = fitted["posterior"]
        src.save(path)
        got = JPosterior.load(path)
    else:
        src = ref_posteriors["lda"]
        src.save(path)
        got = Posterior.load(path)
    assert (got.model, got.params, tuple(got.local), tuple(got.observed)) \
        == (src.model, src.params, tuple(src.local), tuple(src.observed))
    assert sorted(got.posteriors) == sorted(src.posteriors)
    for n in src.posteriors:
        a, b = np.asarray(got.posteriors[n]), np.asarray(src.posteriors[n])
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert got.meta["backend"] == "svi"


@pytest.mark.parametrize("kind", ["hellinger", "cosine"])
def test_top_k_and_similarity_bitwise_the_reference(ref_posteriors, kind):
    jpost = ref_posteriors["lda"]
    post = _as_port(jpost)
    for name in ("phi", "theta"):
        for k in (1, 5, 40):
            for a, b in zip(post.top_k(name, k), jpost.top_k(name, k)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(post.mean(name), jpost.mean(name))
        np.testing.assert_array_equal(post.similarity(name, kind),
                                      jpost.similarity(name, kind))


def test_credible_interval_matches_reference_and_betaincinv(ref_posteriors):
    from scipy.special import betaincinv
    jpost = ref_posteriors["lda"]
    post = _as_port(jpost)
    for name, prob, rows in (("phi", 0.9, None), ("theta", 0.5, [0, 7]),
                             ("phi", 0.95, 1)):
        got = post.credible_interval(name, prob, rows=rows)
        want = jpost.credible_interval(name, prob, rows=rows)
        a = post._conc(name)
        if rows is not None:
            a = np.atleast_2d(a[rows])
        b = a.sum(-1, keepdims=True) - a
        for g, w, q in zip(got, want, ((1 - prob) / 2, (1 + prob) / 2)):
            assert g.dtype == np.float64 and g.shape == a.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
            np.testing.assert_allclose(g, betaincinv(a, b, q), rtol=0,
                                       atol=1e-12)
    with pytest.raises(ValueError, match="prob"):
        post.credible_interval("phi", 1.0)


# ---------------------------------------------------------------------------
# fold-in (the reference's tests on the port)
# ---------------------------------------------------------------------------

def test_foldin_bitwise_parity_with_heldout_elbo(fitted):
    """The acceptance bar: FoldIn.score on the engine's held-out documents
    reproduces InferenceResult.heldout_elbo BITWISE at matching bucket
    (exact) and iteration settings."""
    vals, segs, _ = _holdout_docs(fitted["corpus"])
    fold = FoldIn(fitted["posterior"],
                  FoldInConfig(local_iters=HOLDOUT_ITERS, bucket=None),
                  device=CPU)
    res = fold.score(vals, segment_ids=segs)
    assert res.per_token_ll == fitted["result"].heldout_elbo
    assert res.n_tokens == len(vals)


@pytest.mark.parametrize("iters", [0, 3, HOLDOUT_ITERS])
def test_foldin_bitwise_the_port_heldout_elbo(fitted, iters):
    """``svi.heldout_elbo`` at the fit's own program and final posteriors
    and fold-in of the same documents from the frozen artifact go through
    one scorer build: bitwise at every iteration count."""
    corpus, m = fitted["corpus"], fitted["model"]
    res = fitted["result"]
    state = tvmp.state_from_numpy(res.posteriors, device=CPU)
    vals, segs, hold = _holdout_docs(corpus)
    want = tsvi.heldout_elbo(m.compile(), state, hold, iters)
    fold = FoldIn(fitted["posterior"],
                  FoldInConfig(local_iters=iters, bucket=None), device=CPU)
    assert fold.score(vals, segment_ids=segs).per_token_ll == want


def test_foldin_round_trip_artifact_stays_bitwise(fitted, tmp_path):
    """Same parity through a save/load cycle (f32 arrays survive the npz
    round trip exactly)."""
    path = str(tmp_path / "artifact")
    fitted["posterior"].save(path)
    vals, segs, _ = _holdout_docs(fitted["corpus"])
    fold = FoldIn(Posterior.load(path),
                  FoldInConfig(local_iters=HOLDOUT_ITERS, bucket=None),
                  device=CPU)
    assert fold.score(vals, segment_ids=segs).per_token_ll \
        == fitted["result"].heldout_elbo


def test_foldin_outputs_are_coherent(fitted):
    vals, segs, hold = _holdout_docs(fitted["corpus"])
    fold = FoldIn(fitted["posterior"], FoldInConfig(local_iters=5),
                  device=CPU)
    res = fold.score(vals, segment_ids=segs)
    assert isinstance(res, FoldInResult)
    assert res.n_docs == len(hold)
    assert res.doc_ll.shape == (len(hold),)
    # the per-doc decomposition sums back to the total (float reassociation)
    np.testing.assert_allclose(res.doc_ll.sum(), res.elbo, rtol=1e-5)
    mix = res.mixtures["theta"]
    assert mix.shape == (len(hold), 3)
    np.testing.assert_allclose(mix.sum(-1), 1.0, rtol=1e-5)
    assert res.perplexity == pytest.approx(np.exp(-res.per_token_ll))


def test_score_elbo_is_its_documents_ll_at_a_large_phi():
    """The score holds no global Dirichlet's ELBO term: it is never added
    and then subtracted, so a short request's ELBO is the sum of its
    documents' LL up to the order of f32 sums (bound 1e-6 of it: a few
    hundred terms of ~1e3 nats).  Adding phi's term (here -4.6e6 nats:
    100 x 20,000 cells far from the prior) and subtracting it again leaves
    ~ulp(4.6e6) = 0.5 nats of f32 cancellation, 1e-5 of a 3-document
    score."""
    from repro_torch.core import dists
    from repro_torch.core.engine import InferenceResult
    k, v = 100, 20000
    c = JCorpus(n_docs=20, vocab=v, n_topics=4, mean_len=50,
                seed=0).generate()
    m = models.make("lda", alpha=0.1, beta=0.05, K=k, V=v)
    m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
    rng = np.random.default_rng(0)
    phi = (0.05 + rng.gamma(0.5, 20.0, (k, v))).astype(np.float32)
    theta = (0.1 + rng.gamma(1.0, 5.0, (20, k))).astype(np.float32)
    term = float(dists.dirichlet_elbo_term(torch.full((1,), 0.05),
                                           torch.from_numpy(phi)))
    assert abs(term) > 1e6              # the cancellation would show
    post = InferenceResult("vmp", {"theta": theta, "phi": phi}, [0.0], [],
                           {}).freeze(m)
    fold = FoldIn(post, FoldInConfig(local_iters=10, bucket=None),
                  device=CPU)
    n = int(c["lengths"][:3].sum())
    res = fold.score(c["tokens"][:n], lengths=c["lengths"][:3])
    assert abs(res.elbo - float(res.doc_ll.sum())) <= 1e-6 * abs(res.elbo)


def test_foldin_determinism_across_batch_compositions(fitted):
    """A document's score must not depend on which other documents share
    its dispatch batch: same bucket -> bitwise; the repeated call is
    bitwise by construction."""
    corpus = fitted["corpus"]
    docs = _docs(corpus, 6)
    fold = FoldIn(fitted["posterior"], FoldInConfig(local_iters=5),
                  device=CPU)
    solo = fold.score(docs[0])
    batch = fold.score(np.concatenate(docs), lengths=corpus["lengths"][:6])
    again = fold.score(np.concatenate(docs), lengths=corpus["lengths"][:6])
    np.testing.assert_array_equal(batch.doc_ll, again.doc_ll)
    # doc 0 alone vs doc 0 + 5 co-riders (different padded caps)
    np.testing.assert_allclose(solo.doc_ll[0], batch.doc_ll[0], rtol=1e-6)
    np.testing.assert_allclose(solo.mixtures["theta"][0],
                               batch.mixtures["theta"][0], rtol=1e-6)


def test_foldin_bucketing_caches_compiles(fitted):
    corpus = fitted["corpus"]
    fold = FoldIn(fitted["posterior"],
                  FoldInConfig(local_iters=2, min_cap=64), device=CPU)
    for d in _docs(corpus, 8):    # similar-length docs share one bucket
        fold.score(d)
    assert fold.compiled_buckets <= 2
    with pytest.raises(ValueError, match="bucket"):
        FoldInConfig(bucket="nope")


def test_foldin_plan_reports_the_bucket_and_warmth(fitted):
    """``plan`` reads extents only, equals what ``score`` runs at, and says
    whether that bucket's scorer exists, without touching the LRU order."""
    corpus = fitted["corpus"]
    fold = FoldIn(fitted["posterior"], FoldInConfig(local_iters=1),
                  device=CPU)
    lengths = corpus["lengths"][:3]
    p = fold.plan(lengths)
    assert not p["warm"] and p["n_docs"] == 3
    assert p["n_tokens"] == int(lengths.sum()) and p["n_seg"] == 64
    res = fold.score(np.concatenate(_docs(corpus, 3)), lengths=lengths)
    assert res.caps == p["caps"]
    assert fold.plan(lengths)["warm"]
    jp = JFoldIn(JPosterior(**vars(fitted["posterior"])),
                 JFoldInConfig(local_iters=1)).plan(lengths)
    assert (jp["signature"], jp["caps"]) == (p["signature"], p["caps"])


def test_foldin_rejects_mismatched_vocab(fitted, tmp_path):
    path = str(tmp_path / "artifact")
    fitted["posterior"].save(path)
    doc = json.load(open(os.path.join(path, "posterior.json")))
    doc["params"]["V"] = 64          # artifact tables are still V=30
    json.dump(doc, open(os.path.join(path, "posterior.json"), "w"))
    with pytest.raises(ValueError, match="mismatch"):
        FoldIn(Posterior.load(path), device=CPU).score(
            np.array([1, 2, 3], np.int32))


def test_foldin_slda_with_bindings(corpus):
    """The nested-plate (zmap) family folds in too: SLDA with a
    sentence->document binding."""
    n = len(corpus["tokens"])
    sent_of_tok = (np.arange(n) // 7).astype(np.int32)
    doc_of_sent = corpus["doc_ids"][::7][:sent_of_tok.max() + 1]
    m = _slda(models, corpus)
    result = make_engine("svi", steps=10, batch_size=16, seed=0,
                         device=CPU).fit(m)
    fold = FoldIn(result.freeze(m), FoldInConfig(local_iters=3), device=CPU)
    res = fold.score(corpus["tokens"][:70], segment_ids=sent_of_tok[:70],
                     bindings={"sents": doc_of_sent[:10]})
    assert np.isfinite(res.per_token_ll)
    assert np.isfinite(res.doc_ll).all()


def test_foldin_compile_cache_is_bounded_lru(fitted):
    """max_compiled bounds the bucket cache; evictions are counted and
    surface through QueryServer.stats()."""
    corpus = fitted["corpus"]
    fold = FoldIn(fitted["posterior"],
                  FoldInConfig(local_iters=1, bucket="exact",
                               max_compiled=2), device=CPU)
    offs = np.concatenate([[0], np.cumsum(corpus["lengths"])])
    for i in range(4):           # exact bucketing: one scorer per length
        fold.score(corpus["tokens"][offs[i]:offs[i] + 5 + i])
    assert fold.compiled_buckets <= 2
    assert fold.bucket_evictions >= 2
    with QueryServer(fold) as srv:
        stats = srv.stats()
    assert stats["bucket_evictions"] == fold.bucket_evictions
    # LRU: re-scoring the most recent length builds nothing new
    before = fold.bucket_evictions
    fold.score(corpus["tokens"][offs[3]:offs[3] + 8])
    assert fold.bucket_evictions == before
    with pytest.raises(ValueError, match="max_compiled"):
        FoldInConfig(max_compiled=0)


def test_with_posterior_shares_the_bucket_cache(fitted):
    """A later artifact of the same shapes reuses the warm scorers (a swap
    builds nothing) and scores with its own tables."""
    corpus = fitted["corpus"]
    post = fitted["posterior"]
    fold = FoldIn(post, FoldInConfig(local_iters=2), device=CPU)
    doc = _docs(corpus, 1)[0]
    before = fold.score(doc)
    doubled = Posterior({n: v * 2 for n, v in post.posteriors.items()},
                        post.model, post.params, post.local, post.observed,
                        post.meta)
    new = fold.with_posterior(doubled)
    assert new._fns is fold._fns and new.device == fold.device
    after = new.score(doc)
    assert fold.compiled_buckets == 1
    assert after.per_token_ll != before.per_token_ll
    other = Posterior({"phi": np.ones((3, 31), np.float32),
                       "theta": post.posteriors["theta"]}, "lda",
                      dict(LDA, V=31), post.local, post.observed, {})
    assert fold.with_posterior(other)._fns is not fold._fns


def test_foldin_default_device_without_a_card_raises(fitted):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None means it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FoldIn(fitted["posterior"])


# ---------------------------------------------------------------------------
# the port against the reference on one posterior
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bucket", ["pow2", None])
@pytest.mark.parametrize("name", ["lda", "slda"])
def test_foldin_matches_reference(corpus, ref_posteriors, name, bucket):
    """The reference's SVI posterior scored by both packages' fold-in on the
    same held-out payload: per-token LL, per-document LL and mixtures at
    rtol 1e-5, the caps equal."""
    jpost = ref_posteriors[name]
    cfg = dict(local_iters=HOLDOUT_ITERS, bucket=bucket)
    jfold = JFoldIn(jpost, JFoldInConfig(**cfg))
    tfold = FoldIn(_as_port(jpost), FoldInConfig(**cfg), device=CPU)
    docs = _docs(corpus, 9)[4:9]
    vals = np.concatenate(docs)
    lengths = np.array([len(d) for d in docs])
    kw = dict(lengths=lengths)
    if name == "slda":
        # sentences of 7 tokens within each document, numbered across the
        # payload, and the document of each sentence
        doc_of_tok = np.repeat(np.arange(len(docs)), lengths)
        first = np.concatenate([[0], np.cumsum((lengths + 6) // 7)[:-1]])
        sent_of_tok = np.concatenate([np.arange(n) // 7 for n in lengths]) \
            + np.repeat(first, lengths)
        starts = np.searchsorted(sent_of_tok, np.arange(sent_of_tok[-1] + 1))
        kw = dict(segment_ids=sent_of_tok.astype(np.int32),
                  bindings={"sents": doc_of_tok[starts].astype(np.int32)})
    want, got = jfold.score(vals, **kw), tfold.score(vals, **kw)
    assert got.caps == want.caps
    assert (got.n_tokens, got.n_docs) == (want.n_tokens, want.n_docs)
    np.testing.assert_allclose(got.per_token_ll, want.per_token_ll, **XTOL)
    np.testing.assert_allclose(got.elbo, want.elbo, **XTOL)
    np.testing.assert_allclose(got.doc_ll, want.doc_ll, **XTOL)
    assert got.mixtures.keys() == want.mixtures.keys()
    for n in want.mixtures:
        np.testing.assert_allclose(got.mixtures[n], want.mixtures[n],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got.mixture_groups[n],
                                      want.mixture_groups[n])


@pytest.mark.parametrize("bucket", ["pow2", None])
@pytest.mark.parametrize("name", ["lda", "slda"])
def test_segment_arrays_equal_the_reference(corpus, name, bucket):
    """The per-axis group ids of the decomposition, sentinel padding
    included, are the reference's to the bit."""
    make = _lda if name == "lda" else _slda
    tprog = make(models, corpus).compile()
    jprog = make(jmodels, corpus).compile()
    groups = np.arange(tprog.meta["pstar_size"])   # a request: every doc
    caps_fn = (lambda n_, n: max(64, 1 << int(np.ceil(np.log2(max(n, 1)))))
               ) if bucket else None
    from repro.core.compiler import slice_arrays as j_slice
    _, tdirs, tcaps, _ = tcomp.slice_arrays(tprog, groups, caps_fn)
    _, jdirs, jcaps, _ = j_slice(jprog, groups, caps_fn)
    assert tcaps == jcaps
    n_seg = 64 if bucket else tprog.meta["pstar_size"]
    got = tfoldin._segment_arrays(tprog, tcaps, tdirs, n_seg)
    want = jfoldin._segment_arrays(jprog, jcaps, jdirs, n_seg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_segment_sum_drops_the_sentinel_and_repeats_bitwise():
    """``segment_sum`` over a ``segment_index`` plan: each group's values
    summed (to f32 rounding of the f64 sums), ids outside ``[0, n_seg)``
    dropped, empty groups 0, 2-d values by row; a second call bitwise."""
    rng = np.random.default_rng(3)
    seg = rng.integers(0, 9, 200)          # 7, 8 are out of range
    vals = rng.normal(size=(200, 2)).astype(np.float32)
    order, lengths = tsvi.segment_index(seg, 7)
    assert (np.diff(seg[order]) >= 0).all() and lengths.sum() == len(order)
    plan = (torch.from_numpy(order), torch.from_numpy(lengths))
    got = tsvi.segment_sum(torch.from_numpy(vals), plan)
    assert got.shape == (7, 2)
    assert torch.equal(got, tsvi.segment_sum(torch.from_numpy(vals), plan))
    for g in range(7):
        want = vals[seg == g].astype(np.float64).sum(0)
        np.testing.assert_allclose(got[g].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    empty = tsvi.segment_index(np.array([5, 5]), 3)
    assert len(empty[0]) == 0 and (empty[1] == 0).all()


# ---------------------------------------------------------------------------
# the scorer: extras and plans
# ---------------------------------------------------------------------------

def _request_program(name, corpus, n_docs):
    """The port's program of a request: the first ``n_docs`` documents
    of ``corpus`` under model ``name`` (SLDA: sentences of 7 tokens)."""
    params = {"lda": LDA, "slda": SLDA,
              "dcmlda": dict(alpha=0.4, beta=0.4, K=3, V=30),
              "naive_bayes": dict(alpha=1.0, beta=0.3, C=3, V=30)}[name]
    n = int(corpus["lengths"][:n_docs].sum())
    toks, docs = corpus["tokens"][:n], corpus["doc_ids"][:n]
    m = models.make(name, **params)
    if name == "slda":
        sent_of_tok = (np.arange(n) // 7).astype(np.int32)
        m["x"].observe(toks, segment_ids=sent_of_tok)
        m.bind("sents", docs[::7][:sent_of_tok.max() + 1])
    else:
        m["x"].observe(toks, segment_ids=docs)
    return m.compile()


def _request_inputs(prog, caps_fn, n_seg):
    """A request's batch on the CPU (every document, padded by
    ``caps_fn``), its caps and its segment plans."""
    hb, caps, _ = tsvi.host_batch(prog, np.arange(prog.meta["pstar_size"]),
                                  caps_fn, device=CPU)
    seg = {k: tuple(torch.from_numpy(a) for a in tsvi.segment_index(v, n_seg))
           for k, v in tfoldin._segment_arrays(prog, caps, hb["dirs"],
                                               n_seg).items()}
    return tsvi.device_put_batch(hb, CPU), caps, seg


@pytest.mark.parametrize("name", ["lda", "dcmlda", "naive_bayes", "slda"])
def test_local_scorer_extras_keeps_the_plain_elbo(corpus, name):
    """``extras=True`` returns (elbo, locals, group_elbo): its elbo is the
    ``extras=False`` build's bitwise, each local table has its caps' rows,
    and the groups sum back to the elbo."""
    prog = _request_program(name, corpus, 7)
    state = tvmp.init_state(prog, 0, device=CPU)
    n_seg = 16
    batch, caps, seg = _request_inputs(prog, lambda n_, n: n + 3, n_seg)
    plain = tsvi.build_local_scorer(prog, caps, 3)
    extras = tsvi.build_local_scorer(prog, caps, 3, extras=True, n_seg=n_seg)
    e0 = plain(state.posteriors, batch["arrays"], batch["plans"])
    e1, locs, grp = extras(state.posteriors, batch["arrays"],
                           batch["plans"], seg)
    assert torch.equal(e0, e1)
    local = tcomp.local_dirichlets(prog)
    assert locs.keys() == local
    for n in local:
        assert locs[n].shape == (caps[n], prog.dirichlets[n].k)
    assert grp.shape == (n_seg,) and (grp[7:] == 0).all()
    np.testing.assert_allclose(grp.sum().item(), e1.item(), rtol=1e-5)


def test_scorer_reads_only_the_plans_handed_to_it(corpus, monkeypatch):
    """A bucket's scorer serves every request of its caps, so its per-group
    pass must hand ``zmap_logits`` the plan of the request at hand: a
    sentinel plan passed in reaches it, and no program's meta gains a plan
    cache."""
    prog = _request_program("slda", corpus, 4)
    seen = []
    orig = tops.zmap_logits
    monkeypatch.setattr(tops, "zmap_logits", lambda *a, plan=None, **kw: (
        seen.append(plan), orig(*a, **kw))[1])
    batch, caps, seg = _request_inputs(prog, None, 4)
    fn = tsvi.build_local_scorer(prog, caps, 1, extras=True, n_seg=4)
    state = tvmp.init_state(prog, 0, device=CPU)
    for sentinel in (object(), object()):
        fn(state.posteriors, batch["arrays"], {"z": sentinel}, seg)
        assert seen[-1] is sentinel
    assert "_zstats_plan" not in prog.meta
    # the full-batch path still takes the program's own plan
    tvmp.latent_responsibilities(prog, state, "z")
    assert seen[-1] is None and prog.meta["_zstats_plan"] == {"cpu": {}}


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------

def test_gibbs_heldout_elbo_populated(fitted):
    """The sampling backend scores its held-out docs via the fold-in path,
    so heldout_elbo is populated and on the same metric as the variational
    engines (same split at equal seeds)."""
    m = _lda(models, fitted["corpus"])
    res = make_engine("gibbs", steps=20, holdout_frac=0.1, seed=0,
                      device=CPU).fit(m)
    assert res.heldout_trace
    assert np.isfinite(res.heldout_elbo)
    assert res.meta["n_holdout_groups"] == 5
    # trained on the training slice only: theta has train-many rows
    assert res.posteriors["theta"].shape == (45, 3)
    # same metric, same split -> comparable scale to the SVI number
    assert abs(res.heldout_elbo - fitted["result"].heldout_elbo) < 1.0


def test_topics_keyerror_lists_available(fitted):
    with pytest.raises(KeyError, match=r"available.*phi.*theta"):
        fitted["result"].topics("psi")


# ---------------------------------------------------------------------------
# the query server
# ---------------------------------------------------------------------------

def test_server_batches_and_matches_direct_scoring(fitted):
    docs = _docs(fitted["corpus"], 12)
    fold = FoldIn(fitted["posterior"], FoldInConfig(local_iters=3),
                  device=CPU)
    direct = [fold.score(d) for d in docs]
    with QueryServer(fold, max_batch_docs=8, max_delay_s=0.02) as srv:
        client = QueryClient(srv)
        results = [None] * len(docs)

        def run(i):
            results[i] = client.score(docs[i])

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(docs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats = srv.stats()
    for r, d in zip(results, direct):
        np.testing.assert_allclose(r.doc_ll[0], d.doc_ll[0], rtol=1e-6)
        np.testing.assert_allclose(r.mixtures["theta"],
                                   d.mixtures["theta"], rtol=1e-6)
    assert stats["requests"] == len(docs)
    assert stats["docs"] == len(docs)
    assert stats["batches"] <= len(docs)       # micro-batching happened
    assert stats["compiled_buckets"] >= 1
    assert np.isfinite(stats["latency_p50_ms"])


def test_server_multi_doc_requests_split_correctly(fitted):
    corpus = fitted["corpus"]
    offs = np.concatenate([[0], np.cumsum(corpus["lengths"])])
    fold = FoldIn(fitted["posterior"], FoldInConfig(local_iters=3),
                  device=CPU)
    with QueryServer(fold, max_batch_docs=16, max_delay_s=0.01) as srv:
        client = QueryClient(srv)
        r = client.score(corpus["tokens"][:offs[3]],
                         lengths=corpus["lengths"][:3])
    assert r.n_docs == 3
    assert r.doc_ll.shape == (3,)
    assert r.mixtures["theta"].shape == (3, 3)
    direct = fold.score(corpus["tokens"][:offs[3]],
                        lengths=corpus["lengths"][:3])
    np.testing.assert_array_equal(r.doc_ll, direct.doc_ll)


def test_server_stop_fails_queued_requests(fitted):
    fold = FoldIn(fitted["posterior"], FoldInConfig(local_iters=1),
                  device=CPU)
    srv = QueryServer(fold)          # never started
    fut = srv.submit(np.array([1, 2, 3], np.int32))
    srv.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=5)


def test_server_dispatches_under_the_foldin_device_guard(fitted,
                                                         monkeypatch):
    """The dispatcher thread scores inside ``torch.cuda.device(fold.device)``
    for a fold on the card (the current device is per thread), and a
    failed batch fails its futures."""
    entered = []

    @contextlib.contextmanager
    def fake_device(device):
        entered.append((device, threading.current_thread().name))
        yield

    monkeypatch.setattr(tserver.torch.cuda, "device", fake_device)
    real = FoldIn(fitted["posterior"], FoldInConfig(local_iters=1),
                  device=CPU)

    class OnCard:
        device = torch.device("cuda", 0)
        compiled_buckets = 0
        posterior = real.posterior

        def score(self, values, lengths=None):
            if len(values) == 4:
                raise RuntimeError("launch failed")
            return real.score(values, lengths=lengths)

    with QueryServer(OnCard(), max_delay_s=0.0) as srv:
        client = QueryClient(srv, timeout_s=30)
        r = client.score(np.array([1, 2, 3], np.int32))
        with pytest.raises(RuntimeError, match="launch failed"):
            client.score(np.array([1, 2, 3, 4], np.int32))
    assert r.n_docs == 1 and np.isfinite(r.doc_ll).all()
    assert entered and all(d == torch.device("cuda", 0) for d, _ in entered)
    assert all(name != threading.current_thread().name
               for _, name in entered)
    with tserver._on_device(real):      # a CPU fold needs no guard
        pass
    assert len(entered) == 2
