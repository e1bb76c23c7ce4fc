"""The port's front end held to the JAX package's: the same IR from the same
model and data, the same corpus from the same seed, the same diagnostics,
and the entry points' device rule."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.analysis import diagnostics as jdiag
from repro.core import compiler as jcomp
from repro.core import metrics as jmetrics
from repro.core import models as jmodels
from repro.data import SyntheticCorpus as JCorpus
from repro_torch.analysis import diagnostics as tdiag
from repro_torch.core import compiler as tcomp
from repro_torch.core import metrics as tmetrics
from repro_torch.core import models as tmodels
from repro_torch.core import runtime as trun
from repro_torch.core import vmp as tvmp
from repro_torch.data import SyntheticCorpus as TCorpus


def _observe(name, m):
    rng = np.random.default_rng(7)
    if name == "two_coins":
        m["x"].observe(rng.integers(0, 2, 300).astype(np.int32))
    elif name == "slda":
        S = 30
        sent_doc = np.sort(rng.integers(0, 6, size=S)).astype(np.int32)
        tok_sent = np.repeat(np.arange(S, dtype=np.int32),
                             rng.integers(2, 7, size=S))
        m["x"].observe(rng.integers(0, 20, len(tok_sent)).astype(np.int32),
                       segment_ids=tok_sent)
        m.bind("sents", sent_doc)
    else:
        lens = rng.integers(5, 15, size=9)
        m["x"].observe(rng.integers(0, 25, lens.sum()).astype(np.int32),
                       lengths=lens)
    return m


PARAMS = {"lda": dict(alpha=0.1, beta=0.05, K=4, V=25),
          "dcmlda": dict(alpha=0.1, beta=0.05, K=3, V=25),
          "two_coins": dict(),
          "slda": dict(alpha=0.1, beta=0.05, K=3, V=20),
          "naive_bayes": dict(alpha=1.0, beta=0.3, C=3, V=25)}


def _assert_same(a, b, path):
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            if f.name == "net":
                continue
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _assert_same(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_compile_program_same_ir(name):
    jprog = _observe(name, jmodels.make(name, **PARAMS[name])).compile()
    tprog = _observe(name, tmodels.make(name, **PARAMS[name])).compile()
    assert tprog.meta.keys() >= {"n_observed", "n_vertices", "model_loc"}
    _assert_same(tprog, jprog, name)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_model_loc_matches_reference(name):
    j = jmodels.make(name, **PARAMS[name]).net.loc()
    assert tmodels.make(name, **PARAMS[name]).net.loc() == j


@pytest.mark.parametrize("kw", [
    dict(n_docs=20, vocab=50, n_topics=3, seed=0),
    dict(n_docs=37, vocab=400, n_topics=7, mean_len=33, seed=5),
    dict(n_docs=5, vocab=102660, n_topics=4, alpha=0.1, beta=0.05,
         mean_len=12, seed=11),
])
def test_synthetic_corpus_bitwise(kw):
    want, got = JCorpus(**kw).generate(), TCorpus(**kw).generate()
    assert set(want) == set(got)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_aligned_tv_same_as_reference():
    rng = np.random.default_rng(3)
    est = rng.dirichlet(np.ones(30), size=5)
    true = rng.dirichlet(np.ones(30), size=5)
    assert tmetrics.aligned_tv(est, true) == jmetrics.aligned_tv(est, true)
    assert tmetrics.aligned_tv(true, true) == 0.0


def test_diagnostic_codes_same_as_reference():
    assert tdiag.CODES == jdiag.CODES
    d = tdiag.make("bad-dim", "phi", "msg", hint="h")
    assert str(d) == str(jdiag.make("bad-dim", "phi", "msg", hint="h"))


def _dup(m):
    m.dirichlet("a", 1.0, dim=2)
    m.dirichlet("a", 1.0, dim=2)


def _bad_dim(m):
    m.dirichlet("a", 1.0, dim=1)


def _latent_mixture(m):
    toks = m.plate("?", name="toks")
    pi = m.dirichlet("pi", 1.0, dim=2)
    phi = m.dirichlet("phi", 1.0, dim=2, plate=m.plate(2, name="k"))
    z = m.categorical("z", given=pi, plate=toks)
    m.categorical("y", given=phi, plate=toks, selector=z)


def _chained(m):
    toks = m.plate("?", name="toks")
    pi = m.dirichlet("pi", 1.0, dim=2)
    phi = m.dirichlet("phi", 1.0, dim=2, plate=m.plate(2, name="k"))
    z = m.categorical("z", given=pi, plate=toks)
    y = m.categorical("y", given=phi, plate=toks, selector=z)
    m.categorical("x", given=phi, plate=toks, selector=y)


def _mismatch(m):
    toks = m.plate("?", name="toks")
    pi = m.dirichlet("pi", 1.0, dim=3)
    phi = m.dirichlet("phi", 1.0, dim=4, plate=m.plate(2, name="k"))
    z = m.categorical("z", given=pi, plate=toks)
    m.categorical("x", given=phi, plate=toks, selector=z)


BAD_MODELS = {"duplicate-rv": _dup, "bad-dim": _bad_dim,
              "latent-mixture": _latent_mixture,
              "chained-selector": _chained,
              "selector-dim-mismatch": _mismatch}


@pytest.mark.parametrize("code", sorted(BAD_MODELS))
def test_invalid_models_raise_same_diagnostic(code):
    """Rejected at definition or at compile, by both packages, with the
    same exception class, code and message."""
    from repro.core.dsl import Model as JModel
    from repro_torch.core.dsl import Model as TModel

    def outcome(model_cls, diag_mod):
        try:
            model_cls(BAD_MODELS[code]).compile()
        except (diag_mod.ModelDiagnosticError,
                diag_mod.UnsupportedConstructError) as e:
            return type(e).__name__, e.diagnostic.code, str(e)
        return None

    want = outcome(JModel, jdiag)
    assert want is not None and want[1] == code
    assert outcome(TModel, tdiag) == want


def test_observe_rejects_out_of_range_values():
    m = tmodels.make("lda", **PARAMS["lda"])
    with pytest.raises(tdiag.ModelDiagnosticError) as e:
        m["x"].observe(np.array([0, 25], np.int32), segment_ids=[0, 0])
    assert e.value.diagnostic.code == "value-range"


# ---------------------------------------------------------------------------
# the device rule of the entry points
# ---------------------------------------------------------------------------

@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _lda():
    return _observe("lda", tmodels.make("lda", **PARAMS["lda"]))


@pytest.mark.parametrize("entry", ["Model.infer", "run_inference",
                                   "make_step", "init_state",
                                   "state_from_numpy"])
def test_entry_points_raise_without_a_card(no_gpu, entry):
    m = _lda()
    prog = m.compile()
    call = {"Model.infer": lambda: m.infer(steps=1),
            "run_inference": lambda: trun.run_inference(prog, steps=1),
            "make_step": lambda: trun.make_step(prog),
            "init_state": lambda: tvmp.init_state(prog),
            "state_from_numpy": lambda: tvmp.state_from_numpy(
                {"phi": np.ones((2, 2), np.float32)})}[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_cpu_when_asked(no_gpu):
    m = _lda()
    m.infer(steps=2, device="cpu")
    assert len(m.elbo_trace) == 2
    m.infer(steps=1)                  # continues on the state's device
    assert len(m.elbo_trace) == 3 and m._state.step == 3


@pytest.mark.parametrize("kw", [dict(sharding=object())])
def test_later_slices_raise_not_implemented(kw):
    with pytest.raises(NotImplementedError, match="slice"):
        _lda().infer(steps=1, device="cpu", **kw)


def test_results_api():
    m = _lda()
    with pytest.raises(RuntimeError):
        m["phi"].get_result()
    with pytest.raises(RuntimeError):
        m.lower_bound
    m.infer(steps=3, device="cpu")
    with pytest.raises(TypeError):
        m["x"].get_result()
    theta = m["theta"].get_result()
    assert isinstance(theta, np.ndarray) and theta.shape == (9, 4)
    m.reset()
    assert m.elbo_trace == [] and m._state is None


def test_vmp_program_init_state_on_cpu():
    prog = _lda().compile()
    s = prog.init_state(seed=1, device="cpu")
    assert s.step == 0 and set(s.posteriors) == {"theta", "phi"}
    assert isinstance(prog, tcomp.VMPProgram)
    assert hasattr(tcomp, "slice_arrays") and hasattr(jcomp, "slice_arrays")
