"""The port's serving gateway (``repro_torch.gateway``) held to the
reference's ``repro.gateway``.

Both packages run on the same numpy inputs at the reference tests' sizes
(K = 3, V = 30; the sparse posterior at V = 1,200), the port on the CPU:
the parsed plans, their ``to_text`` and the parser's errors equal;
admission under a fake clock equal; TOPICS and SIMILARITY bitwise;
CREDIBLE within 1e-4 (the reference bisects in f32 without x64); PREDICT
within rtol 1e-5, micro-batched and with nested-plate bindings; EXPLAIN's
text equal but for its kernel-route lines; compaction bitwise (the top-k
indices, the bf16 bits, the row sums, the dense tables, the measured
error) and compacted artifacts saved by either package loaded bitwise by
the other.  Then the reference's own gateway tests on the port: quotas,
the route contract, the registry's lifecycle, hot swap under load.
"""

import dataclasses
import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from repro import gateway as jgw
from repro.gateway import compact as jcompact
from repro.query import Posterior as JPosterior
from repro_torch import gateway as tgw
from repro_torch.gateway import compact as tcompact
from repro_torch.gateway import plan as tplan
from repro_torch.query import Posterior

K, V = 3, 30
CPU = "cpu"
XTOL = dict(rtol=1e-5, atol=0)        # PREDICT, the port against the reference
CI_ATOL = 1e-4                        # credible intervals (f32 reference)


def _posterior(cls, seed=0, scale=1.0, vocab=V, model="lda"):
    """A synthetic frozen posterior (the reference tests' draws)."""
    rng = np.random.default_rng(seed)
    return cls(
        posteriors={
            "phi": (scale * rng.gamma(2.0, 1.0, (K, vocab)) + 0.05
                    ).astype(np.float32),
            "theta": (rng.gamma(2.0, 1.0, (8, K)) + 0.1).astype(np.float32),
        },
        model=model,
        params={"alpha": 0.1, "beta": 0.05, "K": K, "V": vocab},
        local=("theta",), observed=("x",),
        meta={"backend": "synthetic", "seed": seed})


def _sparse(cls, seed=0, vocab=1200, hot=32):
    """Sparse topics (a few heavy words over a tiny floor): the shape
    compaction is for."""
    rng = np.random.default_rng(seed)
    phi = np.full((K, vocab), 0.01, np.float32)
    for g in range(K):
        idx = rng.choice(vocab, hot, replace=False)
        phi[g, idx] += rng.gamma(3.0, 50.0, hot).astype(np.float32)
    post = _posterior(cls, seed=seed, vocab=vocab)
    post.posteriors["phi"] = phi
    return post


def _docs(seed=0, n_docs=3, mean_len=20, vocab=V):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(mean_len // 2, mean_len * 2, n_docs)
    return {"values": rng.integers(0, vocab, int(lengths.sum()),
                                   dtype=np.int32),
            "lengths": lengths}


def _slda_docs(seed=0, n_docs=2, sents=3, sent_len=7):
    rng = np.random.default_rng(seed)
    n_sent = n_docs * sents
    return {"values": rng.integers(0, V, n_sent * sent_len, dtype=np.int32),
            "segment_ids": np.repeat(np.arange(n_sent, dtype=np.int32),
                                     sent_len),
            "bindings": {"sents": np.repeat(np.arange(n_docs,
                                                      dtype=np.int32),
                                            sents)}}


@pytest.fixture(scope="module")
def pair():
    """The same two artifacts served by a port gateway (on the CPU) and by
    the reference's."""
    t = tgw.Gateway(max_delay_s=0.001, device=CPU)
    j = jgw.Gateway(max_delay_s=0.001)
    for g, cls in ((t, Posterior), (j, JPosterior)):
        g.register("lda-a", _posterior(cls, seed=0), version="a0")
        g.register("lda-b", _posterior(cls, seed=1), version="b0")
        g.register("slda", _posterior(cls, seed=2, model="slda"),
                   version="s0")
    yield t, j
    t.stop()
    j.stop()


# ---------------------------------------------------------------------------
# the query language
# ---------------------------------------------------------------------------

STATEMENTS = [
    "TOPICS OF phi TOP 5", "topics of phi",
    "SIMILARITY BETWEEN phi[0] AND phi[2] USING hellinger",
    "SIMILARITY OF phi USING cosine", "SIMILARITY OF phi",
    "SIMILARITY OF phi USING ARTIFACT 'x'",
    "CREDIBLE INTERVAL 0.9 FOR theta[3]", "CREDIBLE INTERVAL .5 FOR phi",
    "PREDICT LL FOR DOCS $batch USING ARTIFACT 'lda-v7'",
    "EXPLAIN PREDICT LL FOR DOCS $b", "EXPLAIN TOPICS OF phi TOP 10",
    "SHOW ARTIFACTS", "SHOW STATS;",
]


def _plan_dict(q):
    d = {f.name: getattr(q, f.name) for f in dataclasses.fields(q)}
    if "inner" in d:
        d["inner"] = _plan_dict(d["inner"])
    return type(q).__name__, q.kind, d


@pytest.mark.parametrize("text", STATEMENTS)
def test_parsed_plans_match_reference(text):
    got, want = tgw.parse(text), jgw.parse(text)
    assert _plan_dict(got) == _plan_dict(want)
    assert got.to_text() == want.to_text()
    assert _plan_dict(tgw.parse(got.to_text())) == _plan_dict(got)


def test_script_matches_reference():
    script = """
        -- the morning dashboard
        TOPICS OF phi TOP 3;
        SHOW STATS;          -- trailing comment
        CREDIBLE INTERVAL 0.5 FOR phi
    """
    got, want = tgw.parse_script(script), jgw.parse_script(script)
    assert [_plan_dict(q) for q in got] == [_plan_dict(q) for q in want]
    assert [q.kind for q in got] == ["topics", "show", "credible"]


@pytest.mark.parametrize("bad", [
    "TOPICS phi", "TOPICS OF phi TOP 0",
    "SIMILARITY BETWEEN phi[0] AND theta[1]",
    "CREDIBLE INTERVAL 1.5 FOR phi", "PREDICT LL FOR DOCS batch",
    "EXPLAIN SHOW STATS", "TOPICS OF phi; TOPICS", "FROBNICATE phi",
    "TOPICS OF phi USING ARTIFACT lda", "TOPICS OF phi TOP 2.5",
    "TOPICS OF phi\nTOPICS OF # phi", "SIMILARITY BETWEEN phi[0 AND phi[1]",
    "SHOW TABLES",
])
def test_syntax_errors_match_reference(bad):
    with pytest.raises(tgw.QLSyntaxError) as te:
        tgw.parse_script(bad)
    with pytest.raises(jgw.QLSyntaxError) as je:
        jgw.parse_script(bad)
    assert str(te.value) == str(je.value) and "^" in str(te.value)
    assert (te.value.pos, te.value.message) == (je.value.pos, je.value.message)


# ---------------------------------------------------------------------------
# admission, under a fake clock
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _admission_trace(pkg):
    clk = FakeClock()
    out = []
    b = pkg.TokenBucket(rate=10.0, burst=5.0, clock=clk)
    for cost, dt in [(1, 0), (1, 0), (2, 0), (1, 0), (1, 0), (1, 0.05),
                     (1, 0.05), (100, 0), (0.5, 1.0), (4.5, 0)]:
        clk.t += dt
        out.append(b.try_acquire(cost))
    ac = pkg.AdmissionController(default_quota=pkg.TenantQuota(1.0, 2.0),
                                 stats_window=4, clock=clk)
    ac.set_quota("gold", pkg.TenantQuota(rate=5.0, burst=3.0))
    for tenant, cost, dt in [("alice", 1, 0), ("alice", 1, 0.1),
                             ("alice", 1, 0), ("gold", 3, 0),
                             ("gold", 1, 0.1), ("gold", 1, 0.2),
                             ("bob", 5, 0)]:
        clk.t += dt
        try:
            ac.admit(tenant, cost)
            ac.record(tenant, "art", latency_s=0.01 * cost, ok=cost < 3,
                      batch_docs=cost)
            out.append(("ok", tenant))
        except pkg.QuotaExceededError as e:
            out.append(("rejected", tenant, e.retry_after, e.cost, str(e)))
    closed = pkg.AdmissionController(default_quota=None, clock=clk)
    with pytest.raises(pkg.QuotaExceededError):
        closed.admit("stranger")
    out.append(ac.stats())
    out.append(closed.stats())
    return out


def test_admission_matches_reference():
    assert _admission_trace(tgw) == _admission_trace(jgw)
    with pytest.raises(ValueError, match="rate and burst"):
        tgw.TokenBucket(rate=0, burst=1)


# ---------------------------------------------------------------------------
# the queries, against the reference's gateway
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("text", [
    "TOPICS OF phi TOP 5 USING ARTIFACT 'lda-a'", "TOPICS OF theta TOP 2",
    "TOPICS OF phi TOP 50 USING ARTIFACT 'lda-b'",
    "SIMILARITY BETWEEN phi[0] AND phi[2] USING hellinger",
    "SIMILARITY BETWEEN phi[1] AND phi[2] USING cosine",
    "SIMILARITY OF phi USING cosine USING ARTIFACT 'lda-b'",
    "SIMILARITY OF theta",
])
def test_topics_and_similarity_bitwise(pair, text):
    t, j = pair
    got, want = t.query(text), j.query(text)
    assert (got.kind, got.artifact, got.version, got.route,
            got.error_bound) == (want.kind, want.artifact, want.version,
                                 want.route, want.error_bound)
    assert sorted(got.value) == sorted(want.value)
    for key, v in got.value.items():
        w = want.value[key]
        if isinstance(v, np.ndarray):
            assert v.dtype == w.dtype
            np.testing.assert_array_equal(v, w)
        else:
            assert v == w, key


@pytest.mark.parametrize("text", [
    "CREDIBLE INTERVAL 0.9 FOR phi[1]", "CREDIBLE INTERVAL 0.5 FOR theta",
    "CREDIBLE INTERVAL 0.8 FOR theta[0] USING ARTIFACT 'lda-b'",
])
def test_credible_within_tolerance(pair, text):
    t, j = pair
    got, want = t.query(text), j.query(text)
    assert got.route == want.route and got.value["prob"] == want.value["prob"]
    for key in ("lo", "hi"):
        assert got.value[key].shape == np.asarray(want.value[key]).shape
        np.testing.assert_allclose(got.value[key], want.value[key],
                                   rtol=0, atol=CI_ATOL)
    assert (got.value["lo"] <= got.value["hi"]).all()


def _assert_predict_close(got, want):
    for key in ("per_token_ll", "perplexity"):
        np.testing.assert_allclose(got.value[key], want.value[key], **XTOL)
    np.testing.assert_allclose(got.value["doc_ll"], want.value["doc_ll"],
                               **XTOL)
    for key in ("n_docs", "n_tokens"):
        assert got.value[key] == want.value[key]
    for name, mix in got.value["mixtures"].items():
        np.testing.assert_allclose(mix, want.value["mixtures"][name],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("art,seed", [("lda-a", 3), ("lda-b", 4)])
def test_predict_within_tolerance(pair, art, seed):
    t, j = pair
    text = f"PREDICT LL FOR DOCS $d USING ARTIFACT '{art}'"
    docs = _docs(seed=seed)
    got = t.query(text, params={"d": docs}, timeout_s=60)
    want = j.query(text, params={"d": docs}, timeout_s=60)
    assert (got.route, got.version) == (want.route, want.version)
    _assert_predict_close(got, want)


def test_predict_with_bindings_within_tolerance(pair):
    """A nested-plate payload (SLDA's sentence->document map) scores
    direct on the caller's thread, on the fold-in's device."""
    t, j = pair
    text = "PREDICT LL FOR DOCS $d USING ARTIFACT 'slda'"
    docs = _slda_docs(seed=5)
    got = t.query(text, params={"d": docs}, timeout_s=60)
    want = j.query(text, params={"d": docs}, timeout_s=60)
    assert got.route == want.route and "[direct" in got.route
    assert got.version == want.version == "s0"
    _assert_predict_close(got, want)
    fold, _ = t.registry.get("slda").capture()
    alone = fold.score(docs["values"], segment_ids=docs["segment_ids"],
                       bindings=docs["bindings"])
    assert got.value["per_token_ll"] == alone.per_token_ll


def _without_kernel_lines(text):
    lines = text.splitlines()
    cut = next((i for i, line in enumerate(lines)
                if line.startswith("  kernel routes")), len(lines))
    return lines[:cut], lines[cut:]


@pytest.mark.parametrize("text,params", [
    ("TOPICS OF phi TOP 5 USING ARTIFACT 'lda-b'", lambda: None),
    ("SIMILARITY BETWEEN phi[0] AND phi[1] USING hellinger", lambda: None),
    ("CREDIBLE INTERVAL 0.8 FOR theta[0]", lambda: None),
    ("CREDIBLE INTERVAL 0.8 FOR theta", lambda: None),
    ("TOPICS OF ghost", lambda: None),
    ("PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-a'", lambda: None),
    ("PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-a'",
     lambda: {"d": _docs(seed=11)}),
    ("PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-b'",
     lambda: {"d": {"values": np.arange(45, dtype=np.int32) % V,
                    "segment_ids": np.repeat(np.arange(3), [10, 20, 15])}}),
    ("PREDICT LL FOR DOCS $d USING ARTIFACT 'slda'",
     lambda: {"d": _slda_docs(seed=6)}),
], ids=["topics", "similarity", "credible-row", "credible", "unknown-rv",
        "predict-unbound", "predict", "predict-segments", "predict-bindings"])
def test_explain_text_matches_reference(pair, text, params):
    t, j = pair
    params = params()
    got, got_k = _without_kernel_lines(t.explain(text, params=params))
    want, want_k = _without_kernel_lines(j.explain(text, params=params))
    assert got == want
    assert len(got_k) == len(want_k)
    for gl, wl in zip(got_k[1:], want_k[1:]):
        # the latent and its prior name the same row of the plan
        assert gl.split(": route=")[0] == wl.split(": route=")[0]


def _on_card(fold):
    """A copy of ``fold`` that names the card as its device: its analysis
    plans the card's routes; nothing here launches."""
    out = type(fold).__new__(type(fold))
    out.__dict__.update(fold.__dict__, device=torch.device("cuda", 0))
    return out


def test_explain_kernel_routes_name_the_bucket_route(pair):
    """EXPLAIN routes the padded bucket the scorer runs, on the fold-in's
    device: plain on the CPU; flat with the pieces pass for LDA and zmap
    with the group logits for SLDA on the card."""
    t, _ = pair
    docs = _docs(seed=7)
    text = t.explain("PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-a'",
                     params={"d": docs})
    assert "kernel routes (static, repro_torch.analysis.explain)" in text
    fold, _ = t.registry.get("lda-a").capture()
    caps = fold.plan(docs["lengths"])["caps"]
    assert (f"latent z (prior theta): route=plain tokens={caps['x']} K=3"
            in text)
    lines = tplan._kernel_route_lines(_on_card(fold), docs["values"], None,
                                      docs["lengths"], None)
    assert lines == [
        "  kernel routes (static, repro_torch.analysis.explain):",
        f"    latent z (prior theta): route=flat passes=pieces "
        f"tokens={caps['x']} K=3"]
    sdocs = _slda_docs(seed=8)
    sfold, _ = t.registry.get("slda").capture()
    lines = tplan._kernel_route_lines(_on_card(sfold), sdocs["values"],
                                      sdocs["segment_ids"], None,
                                      sdocs["bindings"])
    assert "(prior theta): route=zmap passes=pieces logits=group " \
        in lines[1]


# ---------------------------------------------------------------------------
# compaction: bitwise against the reference, across packages
# ---------------------------------------------------------------------------

def _bits(vals):
    if isinstance(vals, torch.Tensor):
        return vals.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(vals).view(np.uint16)


def _assert_compacted_equal(got, want):
    assert sorted(got.compact_tables) == sorted(want.compact_tables)
    for name, v in got.compact_tables.items():
        w = want.compact_tables[name]
        if name.endswith("__vals"):
            assert v.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(v), _bits(w))
        else:
            assert v.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(v, np.asarray(w))
    assert sorted(got.posteriors) == sorted(want.posteriors)
    for name, p in got.posteriors.items():
        assert p.dtype == np.float32
        np.testing.assert_array_equal(p, np.asarray(want.posteriors[name]))
    assert got.compaction == want.compaction
    assert got.error_bound == want.error_bound


@pytest.mark.parametrize("post,top_k", [("sparse", 64), ("sparse", 256),
                                        ("sparse", 1), ("dense", 64),
                                        ("dense", 4)])
def test_compaction_bitwise_reference(post, top_k):
    make = _sparse if post == "sparse" else _posterior
    got = tgw.compact_posterior(make(Posterior, seed=7), top_k=top_k)
    want = jgw.compact_posterior(make(JPosterior, seed=7), top_k=top_k)
    _assert_compacted_equal(got, want)
    assert got.compression_ratio() == want.compression_ratio()
    assert (got.nbytes_full(), got.nbytes_compact()) == \
        (want.nbytes_full(), want.nbytes_compact())
    assert got.meta == want.meta


def test_bf16_cast_matches_reference_at_ties():
    """f64 values on and just off a bf16 rounding tie (a float32 halfway
    between two bf16 neighbours) round to the reference's bits."""
    rng = np.random.default_rng(0)
    u = (rng.integers(0x3000, 0x3f80, 4096).astype(np.uint32) << 16) | 0x8000
    ties = u.view(np.float32).astype(np.float64)
    p = np.concatenate([ties, np.nextafter(ties, 2), np.nextafter(ties, -1),
                        ties * (1 + 1e-12), rng.dirichlet(np.ones(50), 40)
                        .ravel()])
    np.testing.assert_array_equal(_bits(tcompact._bf16(p)),
                                  p.astype(jcompact._bf16()).view(np.uint16))


@pytest.mark.parametrize("saver", ["port", "ref"])
def test_compacted_artifacts_load_across_packages(saver, tmp_path):
    got = tgw.compact_posterior(_sparse(Posterior, seed=3), top_k=64)
    want = jgw.compact_posterior(_sparse(JPosterior, seed=3), top_k=64)
    path = str(tmp_path / "lite")
    (got if saver == "port" else want).save(path)
    t_loaded, j_loaded = Posterior.load(path), JPosterior.load(path)
    assert isinstance(t_loaded, tgw.CompactedPosterior)
    assert isinstance(j_loaded, jgw.CompactedPosterior)
    _assert_compacted_equal(t_loaded, want)
    _assert_compacted_equal(got, j_loaded)
    for name in got.posteriors:                    # bitwise pre/post save
        np.testing.assert_array_equal(t_loaded.posteriors[name],
                                      got.posteriors[name])


def test_compaction_guards_and_dense_mode():
    post = _posterior(Posterior, seed=8)           # V=30 <= top_k
    comp = tgw.compact_posterior(post, top_k=64)
    assert all(r["k"] == r["shape"][1] for r in comp.compaction.values())
    assert not any(n.endswith("__idx") for n in comp.compact_tables)
    assert comp.error_bound < 0.01                 # bf16 rounding only
    with pytest.raises(ValueError, match="already compacted"):
        tgw.compact_posterior(comp)
    with pytest.raises(ValueError, match="top_k"):
        tgw.compact_posterior(post, top_k=0)


def test_gateway_serves_compacted_beside_the_reference():
    sparse = _sparse(Posterior, seed=11)
    rng = np.random.default_rng(12)
    docs = {"values": rng.choice(1200, 60, p=sparse.mean("phi")[0]
                                 ).astype(np.int32), "lengths": [25, 35]}
    results = {}
    for pkg, cls, kw in ((tgw, Posterior, dict(device=CPU)),
                         (jgw, JPosterior, {})):
        post = _sparse(cls, seed=11)
        with pkg.Gateway(**kw) as g:
            g.register("full", post, version="f0")
            g.register("lite", pkg.compact_posterior(post, top_k=256),
                       version="l0")
            results[pkg] = [g.query(f"{q} USING ARTIFACT '{a}'",
                                    params={"d": docs}, timeout_s=60)
                            for a in ("full", "lite")
                            for q in ("TOPICS OF phi TOP 5",
                                      "PREDICT LL FOR DOCS $d")]
            ex = g.query("EXPLAIN TOPICS OF phi USING ARTIFACT 'lite'")
            assert "compacted: yes" in ex.value["text"]
            lite = [a for a in g.query("SHOW ARTIFACTS").value["artifacts"]
                    if a["artifact"] == "lite"][0]
            assert lite["compacted"] and lite["error_bound"] > 0
    tr, jr = results[tgw], results[jgw]
    for got, want in zip(tr, jr):
        assert (got.route, got.error_bound) == (want.route, want.error_bound)
    np.testing.assert_array_equal(tr[2].value["indices"],
                                  jr[2].value["indices"])
    _assert_predict_close(tr[3], jr[3])
    assert tr[1].error_bound is None and tr[3].error_bound > 0
    assert tr[3].value["per_token_ll"] == pytest.approx(
        tr[1].value["per_token_ll"], rel=0.02)


# ---------------------------------------------------------------------------
# the reference's gateway tests, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gw():
    g = tgw.Gateway(max_delay_s=0.001, device=CPU)
    g.register("lda-a", _posterior(Posterior, seed=0), version="a0")
    g.register("lda-b", _posterior(Posterior, seed=1), version="b0")
    yield g
    g.stop()


def test_gateway_enforces_tenant_quota(gw):
    gw.set_quota("scraper", tgw.TenantQuota(rate=1.0, burst=2.0))
    gw.query("TOPICS OF phi", tenant="scraper")
    gw.query("TOPICS OF phi", tenant="scraper")
    with pytest.raises(tgw.QuotaExceededError) as ei:
        gw.query("TOPICS OF phi", tenant="scraper")
    assert ei.value.retry_after > 0.0
    stats = gw.stats()["tenants"]["scraper"]
    assert stats["rejected"] >= 1 and stats["served"] >= 2


def test_predict_charges_per_document(gw):
    gw.set_quota("bulk", tgw.TenantQuota(rate=0.001, burst=4.0))
    docs = _docs(n_docs=3)
    gw.query("PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-a'",
             params={"d": docs}, tenant="bulk")
    with pytest.raises(tgw.QuotaExceededError):
        gw.query("PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-a'",
                 params={"d": docs}, tenant="bulk")
    gw.query("TOPICS OF phi", tenant="bulk")


def test_explain_route_matches_executed_route(gw):
    docs = _docs(seed=3)
    for text in ["TOPICS OF phi TOP 5 USING ARTIFACT 'lda-b'",
                 "SIMILARITY BETWEEN phi[0] AND phi[1] USING hellinger",
                 "CREDIBLE INTERVAL 0.8 FOR theta[0]",
                 "PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-a'"]:
        ex = gw.query(f"EXPLAIN {text}", params={"d": docs})
        ran = gw.query(text, params={"d": docs}, timeout_s=30)
        assert ex.route == ran.route, text
        assert f"route: {ran.route}" in ex.value["text"]


def test_explain_predict_reports_bucket_and_warm_scorer(gw):
    text = gw.explain("PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-a'",
                      params={"d": _docs(seed=4)})
    assert "bucket caps:" in text and "kernel routes" in text
    gw.query("PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-a'",
             params={"d": _docs(seed=4)}, timeout_s=30)
    text = gw.explain("PREDICT LL FOR DOCS $d USING ARTIFACT 'lda-a'",
                      params={"d": _docs(seed=4)})
    assert "scorer warm" in text
    with pytest.raises(ValueError, match="no plan"):
        gw.explain("SHOW STATS")


def test_show_artifacts_and_stats_shape(gw):
    gw.query("TOPICS OF phi USING ARTIFACT 'lda-a'", tenant="alice")
    r = gw.query("SHOW ARTIFACTS")
    ids = [a["artifact"] for a in r.value["artifacts"]]
    assert "lda-a" in ids and "lda-b" in ids
    s = gw.query("SHOW STATS").value["stats"]
    ten = s["tenants"]["alice"]
    for key in ("served", "rejected", "errors", "throughput_qps",
                "latency_p50_ms", "latency_p95_ms", "latency_p99_ms"):
        assert key in ten
    art = s["artifacts"]["lda-a"]
    assert art["server"]["compiled_buckets"] >= 0
    assert "bucket_evictions" in art["server"]
    assert art["server"]["version"] == "a0"


def test_unknown_artifact_and_rv_fail_cleanly(gw):
    with pytest.raises(tgw.UnknownArtifactError, match="nope"):
        gw.query("TOPICS OF phi USING ARTIFACT 'nope'")
    with pytest.raises(KeyError, match="ghost"):
        gw.query("TOPICS OF ghost USING ARTIFACT 'lda-a'")
    with pytest.raises(IndexError, match="out of range"):
        gw.query("CREDIBLE INTERVAL 0.9 FOR theta[99]")
    with pytest.raises(KeyError, match="payload"):
        gw.query("PREDICT LL FOR DOCS $missing")
    assert gw.stats()["tenants"]["default"]["errors"] >= 2
    assert gw.query("TOPICS OF phi").artifact == "lda-a"   # the default


def test_script_runs_in_order(gw):
    out = gw.run_script("TOPICS OF phi TOP 2; SHOW ARTIFACTS; "
                        "SIMILARITY OF phi", tenant="carol")
    assert [r.kind for r in out] == ["topics", "show", "similarity"]
    assert all(r.tenant == "carol" for r in out)


def test_register_duplicate_and_retire():
    with tgw.ArtifactRegistry(device=CPU) as reg:
        reg.register("m", _posterior(Posterior), version="v0")
        with pytest.raises(ValueError, match="already registered"):
            reg.register("m", _posterior(Posterior))
        reg.register("n", _posterior(Posterior, seed=5), version="n0")
        reg.retire("m")
        with pytest.raises(tgw.UnknownArtifactError):
            reg.get("m")
        assert reg.get().artifact_id == "n"
        with pytest.raises(tgw.UnknownArtifactError):
            reg.retire("m")


def test_swap_keeps_cache_warm_and_frees_the_old_tables():
    """A same-family swap shares the warm bucket cache, relabels the
    responses, and drops every reference to the old artifact's tables on
    the device once no request holds them."""
    with tgw.ArtifactRegistry(server_defaults={"max_delay_s": 0.001},
                              device=CPU) as reg:
        entry = reg.register("m", _posterior(Posterior, seed=0),
                             version="v0")
        d = _docs()
        fut = entry.server.submit(d["values"], lengths=d["lengths"])
        assert fut.result(timeout=60).artifact_version == "v0"
        warm = entry.foldin.compiled_buckets
        old = weakref.ref(entry.foldin._globals["phi"])
        assert warm >= 1
        v = reg.swap("m", _posterior(Posterior, seed=9), "v1")
        assert v == "v1" and entry.version == "v1"
        assert entry.foldin.compiled_buckets == warm
        r = entry.server.submit(d["values"], lengths=d["lengths"]) \
            .result(timeout=60)
        assert r.artifact_version == "v1"
        assert entry.foldin.compiled_buckets == warm
        time.sleep(0.1)                        # the dispatcher's next wait
        gc.collect()
        assert old() is None, "the swapped-out phi is still referenced"


def test_concurrent_swap_and_submit_across_artifacts():
    """Concurrent submits while both artifacts are swapped: every future
    resolves, no response carries the other artifact's version, and
    stop() strands nothing."""
    reg = tgw.ArtifactRegistry(server_defaults={"max_delay_s": 0.001},
                               device=CPU)
    reg.register("A", _posterior(Posterior, seed=0), version="A-v0")
    reg.register("B", _posterior(Posterior, seed=1), version="B-v0")
    futures = {"A": [], "B": []}
    errors = []
    stop_swapping = threading.Event()

    def submitter(aid, seed):
        rng = np.random.default_rng(seed)
        for i in range(15):
            d = _docs(seed=int(rng.integers(1 << 30)), n_docs=2)
            try:
                futures[aid].append(
                    reg.get(aid).server.submit(d["values"],
                                               lengths=d["lengths"]))
            except RuntimeError:
                errors.append(("submit", aid, i))

    def swapper(aid):
        n = 0
        while not stop_swapping.is_set():
            n += 1
            reg.swap(aid, _posterior(Posterior, seed=100 + n),
                     version=f"{aid}-v{n}")
            time.sleep(0.002)

    threads = [threading.Thread(target=submitter, args=(aid, s))
               for s, aid in enumerate(["A", "B", "A", "B"])]
    swappers = [threading.Thread(target=swapper, args=(aid,))
                for aid in ("A", "B")]
    for t in threads + swappers:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stop_swapping.set()
    for t in swappers:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads + swappers)
    assert not errors
    for aid, futs in futures.items():
        assert len(futs) == 30
        for f in futs:
            r = f.result(timeout=60)
            assert r.artifact_version.startswith(f"{aid}-v"), \
                f"{aid} answered by {r.artifact_version}"
    reg.stop()
    with pytest.raises(tgw.UnknownArtifactError):
        reg.get("A")
    with pytest.raises(RuntimeError):
        reg.register("C", _posterior(Posterior))


def test_package_exports_the_reference_names():
    assert tgw.__all__ == jgw.__all__
    for name in tgw.__all__:
        assert hasattr(tgw, name), name
