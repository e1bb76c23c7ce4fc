"""The port's single-host SVI held to a live run of the JAX reference.

Both packages compile the same model over the same numpy corpus; the port
starts from the reference's own ``init_state`` (carried across as numpy by
``state_from_numpy``).  Tolerances are the full-batch VMP parity ones
(``tests/test_torch_vmp.py``): ELBO rtol 1e-4, posteriors rtol = atol =
2e-4 — f32 sums run in another order across frameworks, and the two
digammas differ in the last ulps.  Within the port the reference's own SVI
contracts hold: bitwise VMP at |B| = G and rho = 1, padding within 2e-5
(the reference's bound: masked padding changes the order of f32 sums),
untouched rows bitwise.  The samplers and the slicer are numpy copies, so
they are held to the reference exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compiler as jcomp
from repro.core import models as jmodels
from repro.core import svi as jsvi
from repro.core.vmp import init_state as j_init
from repro.data import pipeline as jpipe
from repro.data import SyntheticCorpus as JCorpus
from repro_torch.core import compiler as tcomp
from repro_torch.core import models as tmodels
from repro_torch.core import runtime as trun
from repro_torch.core import svi as tsvi
from repro_torch.core import vmp as tvmp
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import fused_zmap as tfzm
from repro_torch.kernels import fused_zstats as tfz
from repro_torch.kernels import ops as tops

CPU = torch.device("cpu")
MODELS = {
    "lda": dict(alpha=0.1, beta=0.05, K=3, V=30),
    "dcmlda": dict(alpha=0.4, beta=0.4, K=3, V=30),        # local phi + base
    "naive_bayes": dict(alpha=1.0, beta=0.3, C=3, V=30),   # doc-level latent
    "slda": dict(alpha=0.2, beta=0.2, K=3, V=30),          # zmap under slicing
}


def _pad64(name, n):
    return -(-max(n, 1) // 64) * 64


CAPS = {"exact": None, "padded": _pad64}


@pytest.fixture(scope="module")
def corpus():
    return JCorpus(n_docs=50, vocab=30, n_topics=3, mean_len=60,
                   seed=0).generate()


def _observe(m, name, c):
    if name == "slda":
        n = len(c["tokens"])
        sent_of_tok = (np.arange(n) // 7).astype(np.int32)
        doc_of_sent = c["doc_ids"][::7][:sent_of_tok.max() + 1]
        m["x"].observe(c["tokens"], segment_ids=sent_of_tok)
        m.bind("sents", doc_of_sent)
    else:
        m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
    return m


def _pair(name, c):
    """(reference program, port program, the reference's initial
    posteriors as numpy)."""
    jprog = _observe(jmodels.make(name, **MODELS[name]), name, c).compile()
    tprog = _observe(tmodels.make(name, **MODELS[name]), name, c).compile()
    posts0 = {n: np.asarray(p)
              for n, p in j_init(jprog, seed=0).posteriors.items()}
    return jprog, tprog, posts0


def _state(posts, step=0):
    return tvmp.state_from_numpy(posts, step, CPU)


def _assert_posts_close(got, want, **tol):
    tol = tol or dict(rtol=2e-4, atol=2e-4)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), np.asarray(w), err_msg=n,
                                   **tol)


def _assert_bitwise(a, b):
    assert set(a.posteriors) == set(b.posteriors)
    for n in a.posteriors:
        assert torch.equal(a.posteriors[n], b.posteriors[n]), n


def _port_step(tprog, state, groups, rho=1.0, scale=1.0, caps_fn=None):
    batch, caps, _ = tsvi.device_batch(tprog, groups, caps_fn, device=CPU)
    return tsvi.make_svi_step(tprog, caps)(state, batch, rho, scale)


# ---------------------------------------------------------------------------
# the samplers, the split and the slicer: numpy copies, equal to the bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n,b,shuffle", [(50, 8, True), (37, 37, True),
                                         (64, 5, False), (10, 3, True)])
def test_minibatch_sampler_equals_reference(seed, n, b, shuffle):
    groups = np.arange(100, 100 + n)
    j = jpipe.MinibatchSampler(groups=groups, batch_size=b, seed=seed,
                               shuffle=shuffle)
    t = tpipe.MinibatchSampler(groups=groups, batch_size=b, seed=seed,
                               shuffle=shuffle)
    assert t.batches_per_epoch == j.batches_per_epoch
    for step in range(3 * j.batches_per_epoch + 1):       # several epochs
        np.testing.assert_array_equal(t.batch_at(step), j.batch_at(step))


@pytest.mark.parametrize("kw", [dict(batch_size=0), dict(batch_size=11),
                                dict(groups=np.zeros(0, np.int64))])
def test_minibatch_sampler_rejects_what_reference_rejects(kw):
    args = {"groups": np.arange(10), "batch_size": 4, **kw}
    with pytest.raises(ValueError):
        jpipe.MinibatchSampler(**args)
    with pytest.raises(ValueError):
        tpipe.MinibatchSampler(**args)


@pytest.mark.parametrize("seed", [0, 3])
def test_growing_sampler_equals_reference(seed):
    """Each package's population grows by 7 groups at every snapshot."""
    def grower():
        sizes = iter(range(20, 400, 7))
        return lambda: np.arange(next(sizes))
    j = jpipe.GrowingMinibatchSampler(population=grower(), batch_size=6,
                                      seed=seed)
    t = tpipe.GrowingMinibatchSampler(population=grower(), batch_size=6,
                                      seed=seed)
    for step in range(40):
        np.testing.assert_array_equal(t.batch_at(step), j.batch_at(step))
        assert t.population_at(step) == j.population_at(step)
    np.testing.assert_array_equal(t.batch_at(3), j.batch_at(3))  # seek back
    assert t.epoch_log() == j.epoch_log()
    assert t.batches_per_epoch == j.batches_per_epoch
    r = tpipe.GrowingMinibatchSampler(population=grower(), batch_size=6,
                                      seed=seed)
    r.restore_epochs(t.epoch_snapshots())
    for step in range(40):
        np.testing.assert_array_equal(r.batch_at(step), j.batch_at(step))


@pytest.mark.parametrize("n,frac,seed", [(50, 0.1, 0), (50, 0.25, 3),
                                         (7, 0.5, 1), (1000, 0.05, 11)])
def test_holdout_split_equals_reference(n, frac, seed):
    jt, jh = jpipe.holdout_split(n, frac, seed)
    tt, th = tpipe.holdout_split(n, frac, seed)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(th, jh)


@pytest.mark.parametrize("n,frac", [(0, 0.1), (10, 0.0), (10, 1.0),
                                    (10, 0.01), (2, 0.9)])
def test_holdout_split_rejects_what_reference_rejects(n, frac):
    with pytest.raises(ValueError):
        jpipe.holdout_split(n, frac)
    with pytest.raises(ValueError):
        tpipe.holdout_split(n, frac)


def _assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
    elif want is None:
        assert got is None, where
    else:
        np.testing.assert_array_equal(got, want, err_msg=where)
        assert np.asarray(got).dtype == np.asarray(want).dtype, where


@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_slice_arrays_and_shadow_equal_reference(corpus, name, caps):
    jprog, tprog, _ = _pair(name, corpus)
    groups = np.array([1, 4, 5, 9, 20, 33, 49])
    jout = jcomp.slice_arrays(jprog, groups, CAPS[caps])
    tout = tcomp.slice_arrays(tprog, groups, CAPS[caps])
    for g, w, part in zip(tout, jout, ("arrays", "dirs", "caps", "n")):
        _assert_tree_equal(g, w, part)
    js, ts = jcomp.sliced_shadow(jprog, jout[2]), tcomp.sliced_shadow(
        tprog, tout[2])
    assert ts.meta["slice_of"] == js.meta["slice_of"] == jprog.name
    for n, jd in js.dirichlets.items():
        td = ts.dirichlets[n]
        assert (td.g, td.k, td.group_rows) == (jd.g, jd.k, jd.group_rows)
        np.testing.assert_array_equal(td.prior, jd.prior)
    for tl, jl in zip(ts.latents, js.latents, strict=True):
        assert (tl.name, tl.n, tl.k, tl.prior_dir, tl.group) == \
            (jl.name, jl.n, jl.k, jl.prior_dir, jl.group)
        np.testing.assert_array_equal(tl.prior_rows, jl.prior_rows)
        for tf, jf in zip(tl.children, jl.children, strict=True):
            assert (tf.x_name, tf.dir_name, tf.stride, tf.n_z) == \
                (jf.x_name, jf.dir_name, jf.stride, jf.n_z)
    assert tcomp.local_dirichlets(tprog) == jcomp.local_dirichlets(jprog)


# ---------------------------------------------------------------------------
# the schedule and the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tau,kappa", [(10.0, 0.7), (0.0, 0.7), (0.5, 0.7),
                                       (1.0, 1.0), (64.0, 0.51)])
def test_robbins_monro_equals_reference(tau, kappa):
    for t in range(60):
        assert tsvi.robbins_monro(t, tau, kappa) == \
            jsvi.robbins_monro(t, tau, kappa)
    assert tsvi.robbins_monro(0, tau, kappa) <= 1.0


@pytest.mark.parametrize("kw", [
    dict(kappa=0.4), dict(kappa=1.5), dict(tau=-1.0), dict(rho=2.0),
    dict(rho=0.0), dict(rho=-1.0), dict(capacity_docs=-1),
    dict(capacity_docs=10), dict(population_size=10),
    dict(rho=0.3, kappa=7.0), dict(rho=1.0), dict(tau=0.0),
    dict(growing=True, capacity_docs=10)])
def test_svi_config_validates_like_reference(kw):
    try:
        want = dataclasses.asdict(jsvi.SVIConfig(**kw))
    except ValueError:
        with pytest.raises(ValueError):
            tsvi.SVIConfig(**kw)
        return
    assert dataclasses.asdict(tsvi.SVIConfig(**kw)) == want


# ---------------------------------------------------------------------------
# one step against the reference's make_svi_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("caps", sorted(CAPS))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_step_matches_reference(corpus, name, caps):
    jprog, tprog, posts0 = _pair(name, corpus)
    groups = np.arange(5, 25)
    jb, jc, _ = jsvi.device_batch(jprog, groups, CAPS[caps])
    js, je = jsvi.make_svi_step(jprog, jc, donate=False)(
        j_init(jprog, seed=0), jb, jnp.float32(0.5), jnp.float32(2.0))
    ts, te = _port_step(tprog, _state(posts0), groups, 0.5, 2.0, CAPS[caps])
    np.testing.assert_allclose(float(te), float(je), rtol=1e-4)
    _assert_posts_close(ts.posteriors, js.posteriors)
    assert ts.step == int(js.step) == 1


# ---------------------------------------------------------------------------
# the reference's contracts, within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["lda", "dcmlda", "naive_bayes", "slda"])
def test_full_batch_rho1_is_bitwise_vmp(corpus, name):
    """|B| = all docs at exact caps and rho = 1: one SVI step IS the port's
    full-batch VMP step, bit for bit."""
    _, tprog, posts0 = _pair(name, corpus)
    s_full, e_full = trun.make_step(tprog, device=CPU)(_state(posts0))
    s_svi, e_svi = _port_step(tprog, _state(posts0),
                              np.arange(tprog.meta["pstar_size"]))
    _assert_bitwise(s_full, s_svi)
    assert float(e_full) == float(e_svi)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_padding_does_not_change_the_update(corpus, name):
    _, tprog, posts0 = _pair(name, corpus)
    groups = np.arange(0, 20)
    s_exact, e_exact = _port_step(tprog, _state(posts0), groups, 0.5, 2.0)
    s_pad, e_pad = _port_step(tprog, _state(posts0), groups, 0.5, 2.0,
                              _pad64)
    np.testing.assert_allclose(float(e_pad), float(e_exact), rtol=1e-5)
    _assert_posts_close(s_pad.posteriors, s_exact.posteriors, rtol=2e-5,
                        atol=2e-5)


@pytest.mark.parametrize("caps", sorted(CAPS))
def test_untouched_docs_keep_their_rows(corpus, caps):
    """A minibatch step writes only the batch's local rows (padding rows
    go to the scratch row, never to row 0 or the last row)."""
    _, tprog, posts0 = _pair("lda", corpus)
    groups = np.array([0, 5, 6, 7, 14, 49])
    s1, _ = _port_step(tprog, _state(posts0), groups, 0.3, 5.0, CAPS[caps])
    theta0, theta1 = posts0["theta"], s1.posteriors["theta"].numpy()
    out = np.setdiff1d(np.arange(tprog.meta["pstar_size"]), groups)
    np.testing.assert_array_equal(theta1[out], theta0[out])
    assert not np.allclose(theta0[groups], theta1[groups])
    assert s1.posteriors["theta"].shape == theta0.shape


def test_fit_resumes_schedule_from_state(corpus):
    """fit() continues the Robbins-Monro schedule at state.step: two
    segments equal one long run, bit for bit."""
    _, tprog, posts0 = _pair("lda", corpus)
    cfg = tsvi.SVIConfig(batch_size=10, pad_multiple=32, seed=3)
    s_long, h_long = tsvi.SVI(tprog, cfg, device=CPU).fit(
        12, state=_state(posts0))
    two = tsvi.SVI(tprog, cfg, device=CPU)
    s_a, h_a = two.fit(5, state=_state(posts0))
    s_b, h_b = two.fit(7, state=s_a)
    assert s_b.step == s_long.step == 12
    _assert_bitwise(s_long, s_b)
    assert h_a["elbo"] + h_b["elbo"] == h_long["elbo"]


def test_tau_zero_fit_stays_finite(corpus):
    _, tprog, _ = _pair("lda", corpus)
    state, history = tsvi.SVI(tprog, tsvi.SVIConfig(batch_size=16, tau=0.0),
                              device=CPU).fit(steps=3)
    assert np.isfinite(history["elbo"]).all()
    assert all(torch.isfinite(p).all() for p in state.posteriors.values())


def test_heldout_groups_never_train(corpus):
    _, tprog, _ = _pair("lda", corpus)
    svi = tsvi.SVI(tprog, tsvi.SVIConfig(batch_size=7, holdout_frac=0.2,
                                         seed=1), device=CPU)
    seen = set()
    for t in range(3 * svi.sampler.batches_per_epoch):
        seen.update(svi.sampler.batch_at(t).tolist())
    assert seen == set(svi.train.tolist())
    assert not seen & set(svi.holdout.tolist())


# ---------------------------------------------------------------------------
# SVI.fit against the reference's, from the same state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_traces_match_reference(corpus, name):
    jprog, tprog, posts0 = _pair(name, corpus)
    kw = dict(batch_size=8, pad_multiple=32, holdout_frac=0.1,
              holdout_every=5, holdout_local_iters=5, seed=0)
    j = jsvi.SVI(jprog, jsvi.SVIConfig(**kw))
    js, jh = j.fit(steps=10, state=j_init(jprog, seed=0))
    t = tsvi.SVI(tprog, tsvi.SVIConfig(**kw), device=CPU)
    ts, th = t.fit(steps=10, state=_state(posts0))
    np.testing.assert_array_equal(t.holdout, j.holdout)
    np.testing.assert_array_equal(t.train, j.train)
    np.testing.assert_allclose(th["elbo"], jh["elbo"], rtol=1e-4)
    assert [s for s, _ in th["heldout"]] == [s for s, _ in jh["heldout"]] \
        == [4, 9]
    np.testing.assert_allclose([v for _, v in th["heldout"]],
                               [v for _, v in jh["heldout"]], rtol=1e-4)
    assert np.isfinite([v for _, v in th["heldout"]]).all()
    _assert_posts_close(ts.posteriors, js.posteriors)


def test_local_iters_and_bf16_tables_match_reference(corpus):
    """``local_iters`` > 1 refines only the local rows; bf16 concentration
    tables (``elog_dtype``) round the token plate's inputs in both
    packages alike."""
    jprog, tprog, posts0 = _pair("lda", corpus)
    for kw, rtol in [(dict(local_iters=3), 1e-4),
                     (dict(elog_dtype="bfloat16"), 1e-3)]:
        cfg = dict(batch_size=10, pad_multiple=32, seed=2, **kw)
        _, jh = jsvi.SVI(jprog, jsvi.SVIConfig(**cfg)).fit(
            steps=4, state=j_init(jprog, seed=0))
        _, th = tsvi.SVI(tprog, tsvi.SVIConfig(**cfg), device=CPU).fit(
            4, state=_state(posts0))
        np.testing.assert_allclose(th["elbo"], jh["elbo"], rtol=rtol)


def test_heldout_elbo_matches_reference(corpus):
    jprog, tprog, posts0 = _pair("lda", corpus)
    groups = np.arange(40, 50)
    want = jsvi.heldout_elbo(jprog, j_init(jprog, seed=0), groups, 7)
    cache = {}
    got = tsvi.heldout_elbo(tprog, _state(posts0), groups, 7, cache=cache)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert len(cache) == 1
    again = tsvi.heldout_elbo(tprog, _state(posts0), groups, 7, cache=cache)
    assert again == got and len(cache) == 1
    assert np.isnan(tsvi.heldout_elbo(tprog, _state(posts0),
                                      np.zeros(0, np.int64)))


# ---------------------------------------------------------------------------
# owner plans: one per batch, never shared through program.meta
# ---------------------------------------------------------------------------

def _two_batches(tprog):
    """Two disjoint batches of five documents, padded to equal caps."""
    a = tsvi.host_batch(tprog, np.arange(0, 5), _pad64, device="cuda")
    b = tsvi.host_batch(tprog, np.arange(5, 10), _pad64, device="cuda")
    assert a[1] == b[1]                   # the same caps: one cache key
    return a[0], b[0]


@pytest.mark.parametrize("name", list(MODELS))
def test_equal_caps_batches_get_different_plans(corpus, name):
    """Two batches of equal caps give the same key to a per-program plan
    cache but different plans: each plan holds its own batch's streams."""
    _, tprog, _ = _pair(name, corpus)
    a, b = _two_batches(tprog)
    spec = tprog.latents[0]
    f = spec.children[0]
    caps = tcomp.slice_arrays(tprog, np.arange(5), _pad64)[2]
    shape = (caps.get(spec.prior_dir, tprog.dirichlets[spec.prior_dir].g),
             tprog.dirichlets[spec.prior_dir].k)
    tab = np.zeros((caps.get(f.dir_name, tprog.dirichlets[f.dir_name].g),
                    tprog.dirichlets[f.dir_name].k), np.float32)
    plans = []
    for batch in (a, b):
        arr = batch["arrays"]
        child = tops.ZChild(tab, arr[f.x_name]["values"], f.stride,
                            arr[f.x_name]["zmap"], arr[f.x_name]["base"],
                            arr[f.x_name]["mask"])
        build = tfzm.build_zmap_plan if f.zmap is not None else tfz.build_plan
        plans.append(build(arr[spec.name]["prior_rows"], (child,), shape))
    pa, pb = plans
    if f.zmap is not None:  # by value: the streams phase 2b reads
        assert not np.array_equal(pa.by_value[0].perm, pb.by_value[0].perm)
        pa, pb = pa.streams, pb.streams
        key = ("value0", "zmap")
    else:                   # the prior's pass reads the child's values
        pa, pb = pa.streams, pb.streams
        key = ("prior", "values0")
    assert key in pa and not np.array_equal(pa[key], pb[key])
    # host_batch builds the same plans from the batch's arrays
    for batch, want in zip((a, b), plans):
        got = batch["plans"][spec.name]
        assert got.streams.keys() == want.streams.keys()
        for k in want.streams:
            np.testing.assert_array_equal(got.streams[k], want.streams[k])


def _plan_arrays(plan) -> dict:
    """Every index array of an owner plan: its groupings' and its streams,
    a segment plan's flat plan's among them."""
    if isinstance(plan, tfzm.ZmapPlan):
        named = [(f"latent{i}", g) for i, g in enumerate(plan.by_latent)] + \
            [(f"value{i}", g) for i, g in enumerate(plan.by_value)]
        out = {**tfz.grouping_arrays(named), **plan.streams}
        if plan.flat is not None:
            out.update({("flat",) + k: a
                        for k, a in _plan_arrays(plan.flat).items()})
        return out
    return {**tfz.grouping_arrays(plan.passes()), **plan.streams}


@pytest.mark.parametrize("caps", ["full"] + list(CAPS))
@pytest.mark.parametrize("name", list(MODELS))
def test_owner_plans_match_plans_from_real_tables(corpus, name, caps):
    """``vmp.owner_plans`` builds each plan from zero-byte stand-in tables
    of the program's shapes (a batch's local rows at its caps); the plan is
    the one ``kops.host_plan`` builds from the step's real Elog tables: the
    full program's, or a batch's from its sliced state on the shadow."""
    _, tprog, posts0 = _pair(name, corpus)
    state = _state(posts0)
    if caps == "full":
        prog, arrays = tprog, tvmp._program_arrays(tprog, CPU)
        plans = tvmp.owner_plans(tprog, arrays, "cuda")
    else:
        batch, bcaps, _ = tsvi.host_batch(tprog, np.arange(3, 11),
                                          CAPS[caps], device="cuda")
        plans = batch["plans"]
        batch = tsvi.device_put_batch(batch, CPU)
        prog, arrays = tcomp.sliced_shadow(tprog, bcaps), batch["arrays"]
        state = tsvi.sliced_state(tprog, state, batch)
    tabs = tvmp._elog_tables(prog, state)
    assert plans.keys() == {spec.name for spec in prog.latents}
    for spec in prog.latents:
        want = _plan_arrays(tops.host_plan(
            tabs[spec.prior_dir].shape, arrays[spec.name]["prior_rows"],
            tvmp._latent_children(spec, tabs, arrays)))
        got = _plan_arrays(plans[spec.name])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert tvmp.owner_plans(prog, arrays, CPU) == {}


def test_sliced_shadow_and_steps_leave_the_plan_cache_alone(corpus,
                                                            monkeypatch):
    """The shadow's meta carries no full-batch plan, and a sliced step
    hands every zstats call its own batch's plan and writes none to any
    program's meta."""
    _, tprog, posts0 = _pair("lda", corpus)
    trun.make_step(tprog, device=CPU)(_state(posts0))   # full batch: caches
    assert "_zstats_plan" in tprog.meta
    caps = tcomp.slice_arrays(tprog, np.arange(5), _pad64)[2]
    shadow = tcomp.sliced_shadow(tprog, caps)
    assert "_zstats_plan" not in shadow.meta
    del tprog.meta["_zstats_plan"]

    seen = []
    orig = tops.zstats
    monkeypatch.setattr(tops, "zstats", lambda *a, plan=None, **kw: (
        seen.append(plan), orig(*a, plan=plan, **kw))[1])
    step = tsvi.make_svi_step(tprog, caps, local_iters=2)
    state = _state(posts0)
    for batch in _two_batches(tprog):
        dev = tsvi.device_put_batch(batch, CPU)
        state, _ = step(state, dev, 0.5, 2.0)
        assert seen[-2:] == [dev["plans"]["z"]] * 2
    assert len(seen) == 4 and seen[0] is not seen[2]
    svi = tsvi.SVI(tprog, tsvi.SVIConfig(batch_size=5, holdout_frac=0.1),
                   device=CPU)
    svi.fit(3, state=_state(posts0))
    assert "_zstats_plan" not in tprog.meta
    assert "_zstats_plan" not in shadow.meta


# ---------------------------------------------------------------------------
# what belongs to a later slice raises
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(plan=object()), "distributed"), (dict(hosts=object()),
                                           "distributed"),
    (dict(validate=True), "analysis")])
def test_later_slice_arguments_raise(corpus, kw, match):
    _, tprog, _ = _pair("lda", corpus)
    with pytest.raises(NotImplementedError, match=match):
        tsvi.SVI(tprog, tsvi.SVIConfig(), device=CPU, **kw)


def test_later_slice_modes_raise(corpus):
    _, tprog, _ = _pair("lda", corpus)
    with pytest.raises(NotImplementedError, match="query"):
        tsvi.build_local_scorer(tprog, {}, 3, extras=True)
    with pytest.raises(NotImplementedError, match="distributed"):
        tsvi.host_batch(tprog, np.arange(3), plan=object())



@pytest.mark.parametrize("name", ["lda", "slda"])
def test_plan_on_cuda_names_the_card(corpus, name, monkeypatch):
    """A batch's plan moved to ``"cuda"`` records the card's index, as the
    call's tables report it (``cuda:0``): a plan on ``"cuda"`` would compare
    unequal to them and be copied to the card again at every call."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tfz, "device_arrays", lambda arrays, device: {})
    _, tprog, _ = _pair(name, corpus)
    batch, _, _ = tsvi.host_batch(tprog, np.arange(4), _pad64,
                                  device="cuda")
    plan = batch["plans"][tprog.latents[0].name].to("cuda")
    assert plan.device == torch.device("cuda", 0)
    if name == "slda":
        assert plan.flat.device == torch.device("cuda", 0)
    assert tfz.placed("cpu") == CPU
    assert tfz.placed("cuda:0") == torch.device("cuda", 0)
