"""The port's Gibbs backend and EM baseline held to the reference's.

The reference's ``tests/test_gibbs.py`` (quick variants) rebuilt on the
port, and both packages side by side on one corpus.  The port draws from
torch's generator and the reference from threefry, so chains agree
statistically only: the mean complete-data log-likelihood after burn-in
within 2% relative, each phi's ``aligned_tv`` to the planted topics under
the reference's quick bar (0.5); ``GibbsEngine`` with a holdout trains on
the same documents, bitwise, and its held-out ELBO lies within 1.0 nat of
the reference's; ``em_lda``'s final log-likelihood, averaged over four
seeds, within 5% of the reference's.  Within the port one seed gives one
chain, bitwise.
"""

import numpy as np
import pytest

from repro.core import make_engine as j_make_engine
from repro.core import models as jmodels
from repro.core.baselines import em_lda as j_em_lda
from repro.core.gibbs import gibbs_lda as j_gibbs_lda
from repro_torch.core import make_engine, models
from repro_torch.core.baselines import em_lda
from repro_torch.core.gibbs import gibbs_lda
from repro_torch.core.metrics import aligned_tv
from repro_torch.data import SyntheticCorpus

CPU = "cpu"


def _corpus(seed=0, K=3, V=40, docs=60):
    return SyntheticCorpus(n_docs=docs, vocab=V, n_topics=K, mean_len=80,
                           seed=seed).generate()


def _lda(mod, c, K=3, V=40):
    m = mod.make("lda", alpha=0.1, beta=0.05, K=K, V=V)
    m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
    return m


# ---------------------------------------------------------------------------
# the reference's tests on the port (quick variants)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters,burnin,tol", [
    pytest.param(80, 40, 0.5, id="quick")])
def test_gibbs_recovers_planted_topics(iters, burnin, tol):
    K, V = 3, 40
    c = _corpus(K=K, V=V)
    _, phi, lls = gibbs_lda(c["tokens"], c["doc_ids"], K, V,
                            iters=iters, burnin=burnin, seed=0, device=CPU)
    # burn-in improves complete-data log-likelihood
    assert lls[burnin:].mean() > lls[:burnin // 4].mean()
    assert aligned_tv(phi, c["true_phi"]) < tol


def test_gibbs_deterministic_counter_rng():
    """Same seed => bitwise identical chains."""
    c = _corpus(seed=1)
    t1, p1, l1 = gibbs_lda(c["tokens"], c["doc_ids"], 3, 40, iters=12,
                           burnin=4, seed=7, device=CPU)
    t2, p2, l2 = gibbs_lda(c["tokens"], c["doc_ids"], 3, 40, iters=12,
                           burnin=4, seed=7, device=CPU)
    np.testing.assert_array_equal(l1, l2)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(t1, t2)
    _, p3, _ = gibbs_lda(c["tokens"], c["doc_ids"], 3, 40, iters=12,
                         burnin=4, seed=8, device=CPU)
    assert not np.array_equal(p1, p3)


@pytest.mark.parametrize("iters_g,steps_v", [
    pytest.param(80, 20, id="quick")])
def test_gibbs_agrees_with_vmp_predictive(iters_g, steps_v):
    """Two inference engines, one model: the posterior-predictive word
    distributions should agree (coarsely) on the same corpus."""
    K, V = 4, 30
    c = _corpus(seed=2, K=K, V=V)
    _, phi_g, _ = gibbs_lda(c["tokens"], c["doc_ids"], K, V,
                            iters=iters_g, burnin=iters_g // 2, seed=0,
                            device=CPU)
    m = _lda(models, c, K, V)
    m.infer(steps=steps_v, device=CPU)
    phi_post = m["phi"].get_result()
    phi_v = phi_post / phi_post.sum(-1, keepdims=True)
    emp = np.bincount(c["tokens"], minlength=V) / len(c["tokens"])
    assert 0.5 * np.abs(phi_g.mean(0) - emp).sum() < 0.15
    assert 0.5 * np.abs(phi_v.mean(0) - emp).sum() < 0.15


# ---------------------------------------------------------------------------
# the port's sampler on its own
# ---------------------------------------------------------------------------

def test_gibbs_counts_cover_every_token_each_sweep():
    """Every sweep's integer counts sum to the tokens, per document and per
    topic-word, and the concentrations are prior + mean counts."""
    c = _corpus(seed=3)
    n = len(c["tokens"])
    seen = []

    def on_sweep(it, cnt_d, cnt_k):
        seen.append(it)
        assert int(cnt_d.sum()) == n and int(cnt_k.sum()) == n
        np.testing.assert_array_equal(cnt_d.sum(-1).numpy(), c["lengths"])
        np.testing.assert_array_equal(cnt_k.sum(0).numpy(), np.bincount(
            c["tokens"], minlength=40))

    theta, phi, lls, (tc, pc) = gibbs_lda(
        c["tokens"], c["doc_ids"], 3, 40, iters=6, burnin=2, seed=0,
        thin=2, return_conc=True, device=CPU, on_sweep=on_sweep)
    assert seen == list(range(6)) and lls.shape == (6,)
    assert lls.dtype == theta.dtype == phi.dtype == np.float32
    np.testing.assert_allclose(tc.sum(), 0.1 * tc.size + n, rtol=1e-5)
    np.testing.assert_allclose(pc.sum(), 0.05 * pc.size + n, rtol=1e-5)
    np.testing.assert_allclose(theta.sum(-1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(phi.sum(-1), 1.0, rtol=1e-5)


def test_gibbs_underflowing_gamma_gives_no_nan():
    """At beta = 0.05 over a wide vocabulary about 1% of the Gamma(0.05)
    draws fall below the smallest normal f32, where the reference's draws
    underflow to 0 (log phi -inf).  Torch's sampler clamps them at that
    smallest normal, so the port's phi stays positive; either way no NaN
    appears."""
    c = SyntheticCorpus(n_docs=30, vocab=3000, n_topics=5, mean_len=40,
                        seed=4).generate()
    theta, phi, lls = gibbs_lda(c["tokens"], c["doc_ids"], 5, 3000,
                                iters=4, burnin=3, seed=0, device=CPU)
    tiny = np.finfo(np.float32).tiny           # the one kept sweep's draw
    assert (phi > 0).all() and (phi < tiny).mean() > 0.005
    assert np.isfinite(np.log(phi)).all()
    assert np.isfinite(lls).all() and not np.isnan(theta).any()


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def test_gibbs_chain_matches_reference_statistically():
    c = _corpus()
    kw = dict(iters=80, burnin=40, seed=0)
    _, phi, lls = gibbs_lda(c["tokens"], c["doc_ids"], 3, 40, device=CPU,
                            **kw)
    _, jphi, jlls = j_gibbs_lda(c["tokens"], c["doc_ids"], 3, 40, **kw)
    got, want = lls[40:].mean(), np.asarray(jlls)[40:].mean()
    assert abs(got - want) <= 0.02 * abs(want)
    assert aligned_tv(phi, c["true_phi"]) < 0.5
    assert aligned_tv(np.asarray(jphi), c["true_phi"]) < 0.5


def test_gibbs_engine_holdout_matches_reference():
    """``make_engine("gibbs", holdout_frac=...)``: the same training
    documents as the reference, bitwise, the held-out ELBO within 1.0 nat
    of the reference's, and the result's topics the normalized means as
    they are."""
    c = _corpus(seed=5)
    kw = dict(steps=40, holdout_frac=0.1, seed=0)
    res = make_engine("gibbs", device=CPU, **kw).fit(_lda(models, c))
    jres = j_make_engine("gibbs", **kw).fit(_lda(jmodels, c))
    np.testing.assert_array_equal(res.meta["train_groups"],
                                  jres.meta["train_groups"])
    assert (res.meta["n_holdout_groups"], res.meta["burnin"]) == \
        (jres.meta["n_holdout_groups"], jres.meta["burnin"]) == (6, 20)
    assert np.isfinite(res.heldout_elbo)
    assert abs(res.heldout_elbo - jres.heldout_elbo) < 1.0
    assert res.heldout_trace[0][0] == jres.heldout_trace[0][0] == 39
    assert res.meta["normalized"]
    np.testing.assert_array_equal(res.topics("phi"),
                                  res.posteriors["phi"].astype(np.float64))
    assert res.posteriors["theta"].shape == (54, 3)
    post = res.freeze(_lda(models, c))
    np.testing.assert_array_equal(post.posteriors["phi"],
                                  res.meta["concentrations"]["phi"])


def test_gibbs_rejects_a_model_that_is_not_lda_shaped():
    c = _corpus()
    m = models.make("naive_bayes", alpha=1.0, beta=0.3, C=3, V=40)
    m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
    with pytest.raises(ValueError, match="LDA-shaped"):
        make_engine("gibbs", steps=2, device=CPU).fit(m)


def test_em_lda_climbs_and_matches_reference():
    """EM climbs to a local optimum that depends on its initial draws, and
    the two packages draw differently: the final log-likelihood, averaged
    over four seeds, within 5% of the reference's average."""
    c = _corpus(seed=6)
    finals, jfinals = [], []
    for seed in range(4):
        theta, phi, trace = em_lda(c["tokens"], c["doc_ids"], 3, 40,
                                   iters=20, seed=seed, device=CPU)
        assert len(trace) == 20 and trace[-1] > trace[0]
        finals.append(trace[-1])
        jfinals.append(j_em_lda(c["tokens"], c["doc_ids"], 3, 40, iters=20,
                                seed=seed)[2][-1])
    got, want = np.mean(finals), np.mean(jfinals)
    assert abs(got - want) <= 0.05 * abs(want)
    assert theta.shape == (60, 3) and phi.shape == (3, 40)
    np.testing.assert_allclose(phi.sum(-1), 1.0, rtol=1e-5)
    again = em_lda(c["tokens"], c["doc_ids"], 3, 40, iters=20, seed=3,
                   device=CPU)
    assert again[2] == trace
    np.testing.assert_array_equal(again[1], phi)
