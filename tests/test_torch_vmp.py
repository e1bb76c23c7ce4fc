"""The port's full-batch VMP held to a live run of the JAX reference.

Both packages compile the same model and data; the port starts from the
reference's own ``init_state`` (carried across as numpy by
``state_from_numpy``, since threefry and torch's generator differ) and both
run 10 steps on the CPU.  Tolerances: ELBO trace rtol 1e-4, posteriors
rtol = atol = 2e-4 — f32 sums run in another order across frameworks, and
``torch.special.digamma`` and ``jax.scipy.special.digamma`` differ in the
last ulps.
"""

import numpy as np
import pytest
import torch

from repro.core import models as jmodels
from repro.core.runtime import run_inference as j_run
from repro.core.vmp import full_elbo as j_full_elbo
from repro.core.vmp import init_state as j_init
from repro.core.vmp import latent_responsibilities as j_resp
from repro_torch.core import models as tmodels
from repro_torch.core import runtime as trun
from repro_torch.core import vmp as tvmp

STEPS = 10


def _docs_corpus(seed, V, D=14):
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 30, size=D)
    docs = np.repeat(np.arange(D, dtype=np.int32), lens)
    toks = rng.integers(0, V, size=len(docs)).astype(np.int32)
    return toks, docs


def _observe(name, m, seed):
    if name == "two_coins":
        rng = np.random.default_rng(seed)
        pick = rng.random(500) < 0.5
        x = np.where(pick, rng.random(500) < 0.85,
                     rng.random(500) < 0.2).astype(np.int32)
        m["x"].observe(x)
    elif name == "slda":
        rng = np.random.default_rng(seed)
        S = 40
        sent_doc = np.sort(rng.integers(0, 9, size=S)).astype(np.int32)
        tok_sent = np.repeat(np.arange(S, dtype=np.int32),
                             rng.integers(3, 9, size=S))
        xs = rng.integers(0, 20, size=len(tok_sent)).astype(np.int32)
        m["x"].observe(xs, segment_ids=tok_sent)
        m.bind("sents", sent_doc)
    else:
        toks, docs = _docs_corpus(seed, V=25)
        m["x"].observe(toks, segment_ids=docs)
    return m


MODELS = {
    "lda": dict(alpha=0.2, beta=0.1, K=4, V=25),
    "dcmlda": dict(alpha=0.4, beta=0.4, K=3, V=25),
    "two_coins": dict(),
    "slda": dict(alpha=0.2, beta=0.2, K=3, V=20),
    "naive_bayes": dict(alpha=1.0, beta=0.3, C=3, V=25),
}


def _pair(name, seed=0):
    jm = _observe(name, jmodels.make(name, **MODELS[name]), seed)
    tm = _observe(name, tmodels.make(name, **MODELS[name]), seed)
    jprog, tprog = jm.compile(), tm.compile()
    s0 = j_init(jprog, seed=0)
    posts0 = {n: np.asarray(p) for n, p in s0.posteriors.items()}
    return jprog, tprog, posts0


def _expected_counts(prog):
    """Sum of (posterior - prior) each Dirichlet must carry after a step:
    one unit per latent instance (prior) and per observed token (child)."""
    want = {n: 0.0 for n in prog.dirichlets}
    for spec in prog.latents:
        want[spec.prior_dir] += spec.n
        for f in spec.children:
            want[f.dir_name] += len(f.values)
    return want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ten_steps_match_jax_reference(name):
    jprog, tprog, posts0 = _pair(name)
    jstate, jtrace = j_run(jprog, steps=STEPS,
                           state=j_init(jprog, seed=0))
    tstate, ttrace = trun.run_inference(
        tprog, steps=STEPS, state=tvmp.state_from_numpy(posts0, 0, "cpu"),
        device="cpu")
    np.testing.assert_allclose(ttrace, jtrace, rtol=1e-4)
    tposts, step = tvmp.state_to_numpy(tstate)
    assert step == STEPS == int(jstate.step)
    for n, p in tposts.items():
        np.testing.assert_allclose(p, np.asarray(jstate.posteriors[n]),
                                   rtol=2e-4, atol=2e-4, err_msg=n)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_elbo_monotone_and_counts_conserved(name):
    _, tprog, posts0 = _pair(name, seed=1)
    state, trace = trun.run_inference(
        tprog, steps=STEPS, state=tvmp.state_from_numpy(posts0, 0, "cpu"))
    scale = abs(trace[0])
    assert (np.diff(trace) >= -1e-5 * scale).all(), np.diff(trace)
    want = _expected_counts(tprog)
    for n, d in tprog.dirichlets.items():
        got = float((state.posteriors[n].double()
                     - torch.from_numpy(d.prior).double()).sum())
        assert abs(got - want[n]) < 1e-3 * want[n], (n, got, want[n])


@pytest.mark.parametrize("name,latent", [("lda", "z"), ("dcmlda", "z"),
                                         ("two_coins", "z"), ("slda", "z"),
                                         ("naive_bayes", "c")])
def test_latent_responsibilities_match_jax(name, latent):
    jprog, tprog, posts0 = _pair(name)
    want = np.asarray(j_resp(jprog, j_init(jprog, seed=0), latent))
    got = tvmp.latent_responsibilities(
        tprog, tvmp.state_from_numpy(posts0, 0, "cpu"), latent).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", ["lda", "naive_bayes"])
def test_full_elbo_matches_jax(name):
    jprog, tprog, posts0 = _pair(name)
    want = j_full_elbo(jprog, j_init(jprog, seed=0))
    got = tvmp.full_elbo(tprog, tvmp.state_from_numpy(posts0, 0, "cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_state_numpy_round_trip():
    _, tprog, posts0 = _pair("lda")
    s = tvmp.state_from_numpy(posts0, 3, "cpu")
    back, step = tvmp.state_to_numpy(s)
    assert step == 3 and set(back) == set(posts0)
    for n in posts0:
        np.testing.assert_array_equal(back[n], posts0[n])


def test_init_state_seeded_and_in_range():
    _, tprog, _ = _pair("lda")
    a, b = tprog.init_state(seed=5, device="cpu"), tvmp.init_state(tprog, 5, "cpu")
    c = tvmp.init_state(tprog, 6, "cpu")
    for n, d in tprog.dirichlets.items():
        assert torch.equal(a.posteriors[n], b.posteriors[n])
        assert not torch.equal(a.posteriors[n], c.posteriors[n])
        noise = a.posteriors[n] - torch.from_numpy(d.prior)[None, :]
        assert a.posteriors[n].shape == (d.g, d.k)
        assert float(noise.min()) >= 0.5 - 1e-6 and float(noise.max()) <= 1.5


def test_two_runs_bitwise_equal():
    _, tprog, posts0 = _pair("dcmlda")
    runs = [trun.run_inference(tprog, steps=3,
                               state=tvmp.state_from_numpy(posts0, 0, "cpu"))
            for _ in range(2)]
    assert runs[0][1] == runs[1][1]
    for n in posts0:
        assert torch.equal(runs[0][0].posteriors[n], runs[1][0].posteriors[n])


def test_bf16_elog_dtype_close_to_f32():
    _, tprog, posts0 = _pair("lda")
    _, t32 = trun.run_inference(tprog, steps=4, device="cpu",
                                state=tvmp.state_from_numpy(posts0, 0, "cpu"))
    _, t16 = trun.run_inference(tprog, steps=4, device="cpu",
                                state=tvmp.state_from_numpy(posts0, 0, "cpu"),
                                elog_dtype="bfloat16")
    np.testing.assert_allclose(t16, t32, rtol=2e-2)


def test_callback_stops_early():
    _, tprog, posts0 = _pair("lda")
    seen = []
    _, trace = trun.run_inference(
        tprog, steps=50, state=tvmp.state_from_numpy(posts0, 0, "cpu"),
        callback=lambda i, e: seen.append((i, e)) or len(seen) < 4)
    assert len(trace) == 4 and [i for i, _ in seen] == [0, 1, 2, 3]


def test_model_facade_matches_runtime():
    """``Model.infer`` from a carried-across state is ``run_inference``."""
    _, tprog, posts0 = _pair("lda")
    m = _observe("lda", tmodels.make("lda", **MODELS["lda"]), 0)
    m.compile()
    m._state = tvmp.state_from_numpy(posts0, 0, "cpu")
    m.infer(steps=4)
    _, trace = trun.run_inference(
        tprog, steps=4, state=tvmp.state_from_numpy(posts0, 0, "cpu"))
    assert m.elbo_trace == trace
    assert m.lower_bound == trace[-1]
    phi = m["phi"].get_result()
    assert isinstance(phi, np.ndarray) and phi.shape == (4, 25)
    r = m["z"].get_result()
    assert r.shape == (len(tprog.latents[0].prior_rows), 4)
