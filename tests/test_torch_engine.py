"""``make_engine("svi")``, the holdout route of ``make_engine("vmp")`` and the
quickstart's flows on the port, held to a live run of the JAX reference.

Both packages fit the same model over the same numpy corpus from the same
initial state: the port's ``init_state`` draws from torch's generator, not
threefry, so these tests hand the port the reference's initial posteriors
(through ``state_from_numpy``) in its place.  Tolerances are the VMP parity
ones (``tests/test_torch_vmp.py``): ELBO rtol 1e-4, posteriors rtol = atol =
2e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import make_engine as j_make_engine
from repro.core import models as jmodels
from repro.core.engine import _svi_config as j_svi_config
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.metrics import aligned_tv as j_aligned_tv
from repro.core.vmp import init_state as j_init
from repro.data import SyntheticCorpus as JCorpus
from repro_torch.core import engine as tengine
from repro_torch.core import make_engine, models as tmodels
from repro_torch.core import runtime as trun
from repro_torch.core import svi as tsvi
from repro_torch.core import vmp as tvmp
from repro_torch.core.metrics import aligned_tv
from repro_torch.core.partition import ShardingPlan
from repro_torch.data import HostAssignment, SyntheticCorpus

MODELS = {
    "lda": dict(alpha=0.1, beta=0.05, K=3, V=30),
    "dcmlda": dict(alpha=0.4, beta=0.4, K=3, V=30),
    "naive_bayes": dict(alpha=1.0, beta=0.3, C=3, V=30),
    "slda": dict(alpha=0.2, beta=0.2, K=3, V=30),
}


@pytest.fixture(scope="module")
def corpus():
    return JCorpus(n_docs=50, vocab=30, n_topics=3, mean_len=60,
                   seed=0).generate()


def _observe(m, name, c):
    if name == "slda":
        n = len(c["tokens"])
        sent_of_tok = (np.arange(n) // 7).astype(np.int32)
        m["x"].observe(c["tokens"], segment_ids=sent_of_tok)
        m.bind("sents", c["doc_ids"][::7][:sent_of_tok.max() + 1])
    else:
        m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
    return m


def _same_start(monkeypatch, module, jmodel):
    """The port's ``init_state`` in ``module`` returns the reference's
    initial state of ``jmodel``'s program at the requested seed."""
    jprog = jmodel.compile()

    def init_state(program, seed=0, device=None):
        posts = {n: np.asarray(p)
                 for n, p in j_init(jprog, seed=seed).posteriors.items()}
        return tvmp.state_from_numpy(posts, 0, device)
    monkeypatch.setattr(module, "init_state", init_state)


def _assert_results_close(got, want):
    assert got.backend == want.backend
    np.testing.assert_allclose(got.elbo_trace, want.elbo_trace, rtol=1e-4)
    assert [s for s, _ in got.heldout_trace] == \
        [s for s, _ in want.heldout_trace]
    np.testing.assert_allclose([v for _, v in got.heldout_trace],
                               [v for _, v in want.heldout_trace], rtol=1e-4)
    assert set(got.posteriors) == set(want.posteriors)
    for n, p in want.posteriors.items():
        assert isinstance(got.posteriors[n], np.ndarray)
        np.testing.assert_allclose(got.posteriors[n], np.asarray(p),
                                   rtol=2e-4, atol=2e-4, err_msg=n)
    for k in ("batch_size", "n_train_groups", "n_holdout_groups"):
        assert got.meta[k] == want.meta[k], k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_svi_engine_matches_reference(corpus, name, monkeypatch):
    kw = dict(steps=10, batch_size=8, pad_multiple=32, holdout_frac=0.1,
              holdout_every=5, holdout_local_iters=5, seed=0)
    jm = _observe(jmodels.make(name, **MODELS[name]), name, corpus)
    want = j_make_engine("svi", **kw).fit(jm)
    _same_start(monkeypatch, tsvi, jm)
    tm = _observe(tmodels.make(name, **MODELS[name]), name, corpus)
    got = make_engine("svi", device="cpu", **kw).fit(tm)
    _assert_results_close(got, want)
    assert got.meta["device"] == "cpu" and len(got.heldout_trace) == 2


@pytest.mark.parametrize("name", ["lda", "naive_bayes", "slda"])
def test_vmp_engine_with_holdout_matches_reference(corpus, name,
                                                   monkeypatch):
    """``holdout_frac > 0`` routes full-batch VMP through the SVI machinery
    at rho = 1 and |B| = every training group."""
    kw = dict(steps=6, holdout_frac=0.1, holdout_every=3, seed=1)
    jm = _observe(jmodels.make(name, **MODELS[name]), name, corpus)
    want = j_make_engine("vmp", **kw).fit(jm)
    _same_start(monkeypatch, tsvi, jm)
    tm = _observe(tmodels.make(name, **MODELS[name]), name, corpus)
    got = make_engine("vmp", device="cpu", **kw).fit(tm)
    _assert_results_close(got, want)
    assert got.meta["n_holdout_groups"] == 5
    assert np.isfinite(got.heldout_elbo)
    scale = abs(got.elbo_trace[0])
    assert (np.diff(got.elbo_trace) >= -1e-5 * scale).all()


def test_engine_svi_knobs_round_trip():
    """Every SVI knob on EngineConfig reaches the SVIConfig the engine
    builds, as in the reference (``tests/test_engine.py``)."""
    knobs = dict(batch_size=17, kappa=0.9, tau=3.0, rho=0.25, local_iters=4,
                 pad_multiple=64, holdout_frac=0.125, holdout_every=7,
                 holdout_local_iters=21, prefetch=False,
                 elog_dtype="bfloat16", seed=11)
    cfg = tengine.EngineConfig(backend="svi", **knobs)
    jcfg = JEngineConfig(backend="svi", **knobs)
    for full_batch in (False, True):
        got = tengine._svi_config(cfg, full_batch=full_batch, n_groups=100)
        want = j_svi_config(jcfg, full_batch=full_batch, n_groups=100)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    s = tengine._svi_config(cfg, full_batch=False, n_groups=100)
    assert (s.batch_size, s.kappa, s.tau, s.rho) == (17, 0.9, 3.0, 0.25)
    assert (s.local_iters, s.pad_multiple) == (4, 64)
    assert (s.holdout_frac, s.holdout_every) == (0.125, 7)
    assert (s.holdout_local_iters, s.prefetch) == (21, False)
    assert (s.elog_dtype, s.seed, s.shuffle) == ("bfloat16", 11, True)
    eng = make_engine("svi", rho=0.25, holdout_local_iters=21, prefetch=False)
    assert (eng.cfg.rho, eng.cfg.holdout_local_iters,
            eng.cfg.prefetch) == (0.25, 21, False)
    fb = tengine._svi_config(cfg, full_batch=True, n_groups=100)
    assert (fb.rho, fb.batch_size, fb.pad_multiple, fb.shuffle) == \
        (1.0, 100, 0, False)
    assert (fb.holdout_local_iters, fb.prefetch) == (21, False)


def test_make_engine_selection():
    assert make_engine("vmp").name == "vmp"
    assert make_engine("svi").name == "svi"
    assert make_engine({"backend": "svi", "steps": 7}).cfg.steps == 7
    assert make_engine("gibbs").name == "gibbs"
    assert isinstance(make_engine("gibbs", burnin=3), tengine.GibbsEngine)
    with pytest.raises(ValueError, match="unknown backend"):
        make_engine("annealed_ais")


@pytest.mark.parametrize("backend", ["vmp", "svi", "gibbs"])
@pytest.mark.parametrize("knob", [
    pytest.param(lambda: dict(hosts=HostAssignment(2, 0)), id="hosts"),
    pytest.param(lambda: dict(sharding=ShardingPlan(2, "inferspark")),
                 id="sharding")])
def test_distributed_knobs_act_as_in_the_reference(corpus, backend, knob):
    """The distributed knobs act as in the reference: a two-shard
    ``sharding`` plan shards vmp and svi (within 1e-4 of one device) and
    gibbs ignores it bit for bit; ``hosts`` needs a corpus and a plan under
    svi (the reference's ``ValueError``), and vmp and gibbs ignore it bit
    for bit."""
    knob = knob()
    m = _observe(tmodels.make("lda", **MODELS["lda"]), "lda", corpus)
    kw = dict(device="cpu", steps=3, seed=0)
    if backend == "svi":
        kw.update(batch_size=8, holdout_frac=0.1, holdout_every=2)
        if "hosts" in knob:
            with pytest.raises(ValueError, match="corpus"):
                make_engine(backend, **kw, **knob).fit(m)
            return
    want = make_engine(backend, **kw).fit(m)
    got = make_engine(backend, **kw, **knob).fit(m)
    if backend == "gibbs" or "hosts" in knob:
        assert got.elbo_trace == want.elbo_trace
        for n in want.posteriors:
            np.testing.assert_array_equal(got.posteriors[n],
                                          want.posteriors[n])
        return
    np.testing.assert_allclose(got.elbo_trace, want.elbo_trace, rtol=1e-4)
    np.testing.assert_allclose([v for _, v in got.heldout_trace],
                               [v for _, v in want.heldout_trace], rtol=1e-4)
    for n in want.posteriors:
        np.testing.assert_allclose(got.posteriors[n], want.posteriors[n],
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("backend", ["vmp", "svi"])
@pytest.mark.parametrize("knob", [dict(burnin=3), dict(thin=2)])
def test_gibbs_knobs_leave_a_variational_fit_alone(corpus, backend, knob):
    """``burnin`` and ``thin`` belong to the sampler: as in the reference,
    a vmp or svi fit ignores them, bit for bit."""
    m = _observe(tmodels.make("lda", **MODELS["lda"]), "lda", corpus)
    kw = dict(device="cpu", steps=3, seed=0)
    if backend == "svi":
        kw.update(batch_size=8, holdout_frac=0.1, holdout_every=2)
    want = make_engine(backend, **kw).fit(m)
    got = make_engine(backend, **kw, **knob).fit(m)
    assert got.elbo_trace == want.elbo_trace
    assert got.heldout_trace == want.heldout_trace
    for n in want.posteriors:
        np.testing.assert_array_equal(got.posteriors[n], want.posteriors[n])


@pytest.mark.parametrize("backend", ["vmp", "svi"])
@pytest.mark.parametrize("knob", [
    dict(prefetch=False), dict(growing=True), dict(capacity_docs=10),
    dict(population_size=10), dict(checkpoint_dir="ckpt"),
    dict(checkpoint_every=5), dict(resume=True)])
def test_ported_knobs_act_as_in_the_reference(corpus, tmp_path, backend,
                                             knob):
    """The out-of-core and checkpoint knobs of a resident fit: where the
    reference raises ``ValueError`` the port raises it too, and where the
    reference fits (full-batch VMP ignores them; SVI checkpoints into
    ``checkpoint_dir``) the port fits the same number of steps."""
    if "checkpoint_dir" in knob:
        knob = dict(checkpoint_dir=str(tmp_path / backend / "ref"))
    jm = _observe(jmodels.make("lda", **MODELS["lda"]), "lda", corpus)
    try:
        want = j_make_engine(backend, steps=2, batch_size=16, **knob).fit(jm)
    except ValueError as e:
        m = _observe(tmodels.make("lda", **MODELS["lda"]), "lda", corpus)
        with pytest.raises(ValueError, match=str(e).split()[0]):
            make_engine(backend, device="cpu", steps=2, batch_size=16,
                        **knob).fit(m)
        return
    if "checkpoint_dir" in knob:
        knob = dict(checkpoint_dir=str(tmp_path / backend / "port"))
    m = _observe(tmodels.make("lda", **MODELS["lda"]), "lda", corpus)
    got = make_engine(backend, device="cpu", steps=2, batch_size=16,
                      **knob).fit(m)
    assert len(got.elbo_trace) == len(want.elbo_trace) == 2
    if "checkpoint_dir" in knob:
        saved = os.path.exists(knob["checkpoint_dir"])
        assert saved == (backend == "svi") == os.path.exists(
            str(tmp_path / backend / "ref"))


def test_corpus_knob(corpus, tmp_path):
    """A full-batch fit needs a resident corpus (``ValueError``, as in the
    reference); an out-of-core SVI fit over the corpus written to shards is
    bitwise the resident fit."""
    from repro_torch.data import write_sharded_corpus
    sharded = write_sharded_corpus(corpus, str(tmp_path / "c"),
                                   shard_tokens=500)
    m = _observe(tmodels.make("lda", **MODELS["lda"]), "lda", corpus)
    with pytest.raises(ValueError, match="resident corpus"):
        make_engine("vmp", device="cpu", corpus=sharded).fit(m)
    kw = dict(device="cpu", steps=3, batch_size=16, holdout_frac=0.1)
    ooc = make_engine("svi", corpus=sharded, **kw).fit(
        tmodels.make("lda", **MODELS["lda"]))
    res = make_engine("svi", **kw).fit(m)
    assert ooc.elbo_trace == res.elbo_trace
    assert ooc.heldout_trace == res.heldout_trace
    for n in res.posteriors:
        np.testing.assert_array_equal(ooc.posteriors[n], res.posteriors[n])


def test_svi_engine_without_a_card_raises(corpus, monkeypatch):
    """``device=None`` means the card: without one the fit raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _observe(tmodels.make("lda", **MODELS["lda"]), "lda", corpus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("svi", steps=2).fit(m)


# ---------------------------------------------------------------------------
# examples/quickstart.py's two flows, on the port
# ---------------------------------------------------------------------------

def _tosses():
    rng = np.random.default_rng(0)
    pick = rng.random(2000) < 0.6
    return np.where(pick, rng.random(2000) < 0.85,
                    rng.random(2000) < 0.2).astype(np.int32)


def test_quickstart_two_coins(monkeypatch):
    x = _tosses()
    jm = jmodels.make("two_coins", alpha=1.0, beta=1.0)
    jm["x"].observe(x)
    jm.infer(steps=30)
    _same_start(monkeypatch, trun, jm)
    m = tmodels.make("two_coins", alpha=1.0, beta=1.0)
    m["x"].observe(x)
    m.infer(steps=30, device="cpu")
    np.testing.assert_allclose(m.lower_bound, jm.lower_bound, rtol=1e-4)
    np.testing.assert_allclose(m["phi"].get_result(),
                               np.asarray(jm["phi"].get_result()),
                               rtol=2e-4, atol=2e-4)


def _quickstart_lda(models, corpus_cls, **infer):
    corpus = corpus_cls(n_docs=100, vocab=500, n_topics=8, mean_len=100,
                        seed=1).generate()
    m = models.make("lda", alpha=0.1, beta=0.05, K=8, V=500)
    m["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    trace = []

    def progress(i, elbo):
        trace.append(elbo)
        return len(trace) < 2 or trace[-1] - trace[-2] > 1e-4 * abs(trace[-2])

    m.infer(steps=60, callback=progress, **infer)
    phi = np.asarray(m["phi"].get_result(), np.float64)
    return m, trace, phi / phi.sum(-1, keepdims=True), corpus["true_phi"]


def test_quickstart_lda_recovers_topics_as_reference(monkeypatch):
    jm, jtrace, jphi, true_phi = _quickstart_lda(jmodels, JCorpus)
    j_tv = j_aligned_tv(jphi, true_phi)
    # the port's own start (torch's generator): as a user runs it
    _, own_trace, own_phi, own_true = _quickstart_lda(
        tmodels, SyntheticCorpus, device="cpu")
    np.testing.assert_array_equal(own_true, true_phi)
    own_tv = aligned_tv(own_phi, true_phi)
    # the reference's start: the same fit at tolerance
    _same_start(monkeypatch, trun, jm)
    _, trace, phi, _ = _quickstart_lda(tmodels, SyntheticCorpus,
                                       device="cpu")
    tv = aligned_tv(phi, true_phi)
    assert len(trace) == len(jtrace)
    np.testing.assert_allclose(trace, jtrace, rtol=1e-4)
    assert abs(tv - j_tv) < 1e-3, (tv, j_tv)
    assert own_tv < j_tv + 0.05, (own_tv, j_tv)
    assert len(own_trace) < 60                # the callback stopped it
