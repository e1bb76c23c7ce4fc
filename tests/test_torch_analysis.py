"""The port's static analysis (``repro_torch.analysis``) held to the
reference's, and its Hopper routes held to the dispatch.

Both packages run on the same inputs: every bad-model case of
``tests/test_analysis.py`` gives equal diagnostics (code, subject,
severity and message: the port copies the front end's words); every audit
hazard and both presets give equal (code, subject, severity) findings (the
port's messages name its own per-shape cost); ``explain_plan`` predicts the
reference's caps and signature on the zoo at the grid of
``tests/test_explain.py``, and for SVI the caps of the port's own batch 0.

The card's routes cannot run here, but their decision can: for every zoo
model at every grid point (the reference's, and one of documents longer
than a piece) ``routing(backend="cuda")`` equals the route read
from the owner plan the step builds (``vmp.owner_plans``), and that route
equals one worked out from first principles (a specialized child takes the
"pieces" pass; a strided child without a zmap the "runs" pass where its
rows base + stride * k are one to one over the bases its tokens use;
phase 1 takes "warp" when the instances' pieces outnumber the instances).
The grid covers flat (pieces and runs) and zmap (group and warp); a
strided child whose rows meet across bases takes "strided";
``backend="cpu"`` gives "plain".
"""

import json
import types

import numpy as np
import pytest

from repro.analysis import audit as jaudit
from repro.analysis import diagnostics as jdiag
from repro.analysis import explain as jexplain
from repro.analysis import validate as jvalidate
from repro.core import dsl as jdsl
from repro.core import models as jmodels
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.svi import SVIConfig as JSVIConfig
from repro.query.foldin import FoldInConfig as JFoldInConfig
from repro_torch import analysis as tanalysis
from repro_torch.analysis import audit as taudit
from repro_torch.analysis import explain as texplain
from repro_torch.analysis import validate as tvalidate
from repro_torch.analysis.diagnostics import (ModelDiagnosticError,
                                              UnsupportedConstructError)
from repro_torch.core import dsl as tdsl
from repro_torch.core import make_engine
from repro_torch.core import models as tmodels
from repro_torch.core import svi as tsvi
from repro_torch.core import vmp as tvmp
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.core.svi import SVIConfig as TSVIConfig
from repro_torch.kernels import fused_zstats as tfz
from repro_torch.kernels import ops as tops
from repro_torch.query.foldin import FoldInConfig as TFoldInConfig

CPU = "cpu"
PKGS = {"ref": (jdsl, jmodels), "port": (tdsl, tmodels)}


def _keys(diags, message=True):
    return [(d.code, d.subject, d.severity) + ((d.message,) if message
                                               else ())
            for d in diags]


# ---------------------------------------------------------------------------
# validate_model / preflight: the bad models of tests/test_analysis.py
# ---------------------------------------------------------------------------

def _lda(models, corpus=True):
    m = models.make("lda", alpha=0.1, beta=0.05, K=3, V=30)
    if corpus:
        rng = np.random.default_rng(0)
        m["x"].observe(rng.integers(0, 30, 200).astype(np.int32),
                       segment_ids=np.repeat(np.arange(10, dtype=np.int32),
                                             20))
    return m


def _unsupported_edge(m):
    toks = m.plate("?", name="toks")
    phi = m.dirichlet("phi", 1.0, dim=5, plate=m.plate(3, name="topics"))
    m.categorical("x", given=phi, plate=toks)


def _selector_dim_mismatch(m):
    toks = m.plate("?", name="toks")
    theta = m.dirichlet("theta", 1.0, dim=4)
    phi = m.dirichlet("phi", 1.0, dim=5, plate=m.plate(5, name="topics"))
    z = m.categorical("z", given=theta, plate=toks)
    m.categorical("x", given=phi, plate=toks, selector=z)


def _selector_plate(m):
    toks = m.plate("?", name="toks")
    other = m.plate("?", name="other")
    theta = m.dirichlet("theta", 1.0, dim=3)
    phi = m.dirichlet("phi", 1.0, dim=5, plate=m.plate(3, name="topics"))
    z = m.categorical("z", given=theta, plate=other)
    m.categorical("x", given=phi, plate=toks, selector=z)


def _chained_selector(m):
    toks = m.plate("?", name="toks")
    theta = m.dirichlet("theta", 1.0, dim=3)
    psi = m.dirichlet("psi", 1.0, dim=4, plate=m.plate(3, name="mid"))
    phi = m.dirichlet("phi", 1.0, dim=5, plate=m.plate(4, name="top"))
    z1 = m.categorical("z1", given=theta, plate=toks)
    z2 = m.categorical("z2", given=psi, plate=toks, selector=z1)
    m.categorical("x", given=phi, plate=toks, selector=z2)


def _two_bad(m):
    toks = m.plate("?", name="toks")
    phi1 = m.dirichlet("phi1", 1.0, dim=5, plate=m.plate(3, name="t1"))
    phi2 = m.dirichlet("phi2", 1.0, dim=5, plate=m.plate(4, name="t2"))
    m.categorical("x1", given=phi1, plate=toks)
    m.categorical("x2", given=phi2, plate=toks)


def _two_obs(m):
    toks = m.plate("?", name="toks")
    d1 = m.dirichlet("d1", 1.0, dim=3)
    d2 = m.dirichlet("d2", 1.0, dim=3)
    m.categorical("x", given=d1, plate=toks)
    m.categorical("y", given=d2, plate=toks)


def _plate_unresolved(m):
    docs = m.plate("?", name="docs")
    other = m.plate("?", name="other")
    m.dirichlet("theta", 1.0, dim=3, plate=other)
    d = m.dirichlet("d", 1.0, dim=3)
    m.categorical("x", given=d, plate=docs)


def _prior_shape(m):
    docs = m.plate("?", name="docs")
    d = m.dirichlet("d", [1.0, 2.0, 3.0], dim=2)
    m.categorical("x", given=d, plate=docs)


def _prior_positive(m):
    docs = m.plate("?", name="docs")
    d = m.dirichlet("d", 0.0, dim=3)
    m.categorical("x", given=d, plate=docs)


def _unknown_plate_position(m):
    topics = m.plate(3, name="topics")
    inner = m.plate("?", name="inner", within=topics)
    d = m.dirichlet("d", 1.0, dim=4, plate=inner)
    m.categorical("x", given=d, plate=inner)


def _fixed(m):
    grid = m.plate(4, name="grid")
    d = m.dirichlet("d", 1.0, dim=3, plate=grid)
    m.categorical("x", given=d, plate=grid)


def _built(fn):
    """A case whose network the builder holds without ``net.validate()``
    (``Model`` would raise at construction)."""
    def make(dsl, models):
        b = dsl.ModelBuilder("bad")
        fn(b)
        return b.net
    return make


def _observed(fn, **obs):
    def make(dsl, models):
        m = dsl.Model(fn)
        for name, (values, seg) in obs.items():
            m[name].observe(values, segment_ids=seg)
        return m
    return make


def _lda_observing_z(dsl, models):
    m = models.make("lda", alpha=0.1, beta=0.05, K=3, V=10)
    seg = np.zeros(4, np.int32)
    m["x"].observe(np.array([0, 1, 2, 3]), segment_ids=seg)
    m["z"].observe(np.array([0, 1, 2, 0]), segment_ids=seg)
    return m


def _lda_latent_mixture(dsl, models):
    m = models.make("lda", alpha=0.1, beta=0.05, K=3, V=10)
    m.bind("tokens", np.array([0, 0, 1, 1], np.int32))
    return m


_Z5 = (np.zeros(5, np.int32), None)
VALIDATE_CASES = {
    "unsupported-edge": _built(_unsupported_edge),
    "selector-dim-mismatch": _built(_selector_dim_mismatch),
    "selector-plate": _built(_selector_plate),
    "chained-selector": _built(_chained_selector),
    "two-unsupported-edges": _built(_two_bad),
    "selector-observed": _lda_observing_z,
    "latent-mixture": _lda_latent_mixture,
    "plate-size-conflict": _observed(_two_obs, x=_Z5,
                                     y=(np.zeros(7, np.int32), None)),
    "plate-unresolved": _observed(_plate_unresolved, x=_Z5),
    "prior-shape": _observed(_prior_shape, x=_Z5),
    "prior-positive": _observed(_prior_positive, x=_Z5),
    "unknown-plate-position": _observed(
        _unknown_plate_position,
        x=(np.array([0, 1, 2, 3]), np.array([0, 0, 1, 2], np.int32))),
    "no-partition-plate": _observed(
        _fixed, x=(np.array([0, 1, 2, 0]),
                   np.arange(4, dtype=np.int32) // 2)),
    "no-observed": lambda dsl, models: _lda(models, corpus=False),
    "rv-shape": lambda dsl, models: _lda(models),
}


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_and_preflight_match_reference(case):
    got = VALIDATE_CASES[case](*PKGS["port"])
    want = VALIDATE_CASES[case](*PKGS["ref"])
    tdiags = tvalidate.validate_model(got)
    assert _keys(tdiags) == _keys(jvalidate.validate_model(want))
    assert tdiags, case
    if any(d.severity == "error" for d in tdiags):
        with pytest.raises(tvalidate.PreflightError) as te:
            tvalidate.preflight(got)
        with pytest.raises(jvalidate.PreflightError) as je:
            jvalidate.preflight(want)
        assert _keys(te.value.diagnostics) == _keys(je.value.diagnostics)
        assert str(te.value) == str(je.value)
    else:
        assert _keys(tvalidate.preflight(got)) == _keys(tdiags)


RAISE_CASES = {
    "bad-plate-size": lambda dsl, models: dsl.Model(
        lambda m: m.plate(0, name="docs")),
    "bad-dim": lambda dsl, models: dsl.Model(
        lambda m: m.dirichlet("d", 1.0, dim=1)),
    "duplicate-rv": lambda dsl, models: dsl.Model(
        lambda m: (m.dirichlet("d", 1.0, dim=3),
                   m.dirichlet("d", 2.0, dim=3))),
    "value-range": lambda dsl, models: models.make(
        "lda", alpha=0.1, beta=0.05, K=3, V=10)["x"].observe(
            np.array([0, 4, 10]), segment_ids=np.zeros(3, np.int32)),
}


@pytest.mark.parametrize("case", sorted(RAISE_CASES))
def test_definition_time_errors_match_reference(case):
    """The bad models that raise while they are defined carry the
    reference's diagnostic."""
    errs = (ModelDiagnosticError, UnsupportedConstructError)
    with pytest.raises(errs) as te:
        RAISE_CASES[case](*PKGS["port"])
    with pytest.raises((jdiag.ModelDiagnosticError,
                        jdiag.UnsupportedConstructError)) as je:
        RAISE_CASES[case](*PKGS["ref"])
    assert te.value.diagnostic.code == case
    assert _keys([te.value.diagnostic]) == _keys([je.value.diagnostic])


# ---------------------------------------------------------------------------
# audit_config: every hazard case and both presets
# ---------------------------------------------------------------------------

AUDIT_CASES = {
    "growth-over": (dict(growing=True, capacity_docs=100), None,
                    dict(n_docs=150)),
    "growth-near": (dict(growing=True, capacity_docs=100), None,
                    dict(n_docs=90)),
    "growth-far": (dict(growing=True, capacity_docs=100), None,
                   dict(n_docs=10)),
    "bucket-churn": (dict(pad_multiple=0), dict(bucket=None), {}),
    "bucket-exact": (None, dict(bucket="exact"), {}),
    "clean": (dict(pad_multiple=256), {}, {}),
    "host-caps": (dict(growing=True, capacity_docs=100, pad_multiple=0),
                  None, dict(n_hosts=4)),
    "host-caps-padded": (dict(pad_multiple=256), None, dict(n_hosts=2)),
}


@pytest.mark.parametrize("case", sorted(AUDIT_CASES))
def test_audit_matches_reference(case):
    cfg, fold, kw = AUDIT_CASES[case]
    got = taudit.audit_config(
        TSVIConfig(**cfg) if cfg is not None else None,
        foldin=TFoldInConfig(**fold) if fold is not None else None, **kw)
    want = jaudit.audit_config(
        JSVIConfig(**cfg) if cfg is not None else None,
        foldin=JFoldInConfig(**fold) if fold is not None else None, **kw)
    assert _keys(got, message=False) == _keys(want, message=False)
    assert case in ("clean", "growth-far", "host-caps-padded") or got


def test_audit_of_engine_config_matches_reference():
    """``hosts`` as an int on an EngineConfig is the planned host count."""
    kw = dict(backend="svi", growing=True, capacity_docs=64, pad_multiple=0,
              hosts=3)
    got = taudit.audit_config(TEngineConfig(**kw), n_docs=60)
    want = jaudit.audit_config(JEngineConfig(**kw), n_docs=60)
    assert _keys(got, message=False) == _keys(want, message=False)
    assert {d.code for d in got} == {"retrace-growth",
                                    "retrace-bucket-churn",
                                    "retrace-host-caps"}


@pytest.mark.parametrize("preset", ["lda_topics", "streaming_lda"])
def test_audit_presets_match_reference(preset, capsys):
    tcfg, tfold, tn = taudit._preset(preset)
    jcfg, jfold, jn = jaudit._preset(preset)
    assert tn == jn
    assert _keys(taudit.audit_config(tcfg, foldin=tfold, n_docs=tn),
                 message=False) == \
        _keys(jaudit.audit_config(jcfg, foldin=jfold, n_docs=jn),
              message=False)
    assert taudit._main(["--preset", preset]) == \
        jaudit._main(["--preset", preset]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == out[1] == f"audit {preset}: 0 finding(s)"


# ---------------------------------------------------------------------------
# explain_plan: caps and signature against the reference's
# ---------------------------------------------------------------------------

GRID = [
    ("tiny", dict(docs=200, vocab=500, topics=8, mean_len=50)),
    ("bench-small", dict(docs=2_000, vocab=10_000, topics=64, mean_len=100)),
    ("bench-large", dict(docs=5_000, vocab=20_000, topics=128, mean_len=120)),
    ("bench-largev", dict(docs=2_000, vocab=60_000, topics=32, mean_len=200)),
    # documents longer than a piece (PIECE tokens), as 20 Newsgroups' are:
    # naive Bayes' phase 1 takes the warp route
    ("long-docs", dict(docs=300, vocab=2_000, topics=20, mean_len=400)),
]
ZOO = ["lda", "slda", "dcmlda", "naive_bayes", "two_coins"]


def _rows_meet(base, stride, k):
    """True where two (base, k) pairs of the distinct bases of ``base``
    (None: all 0) name one row base + stride * k, counted row by row."""
    b = np.unique(np.asarray(base)) if base is not None else np.zeros(1, int)
    rows = b.astype(np.int64)[:, None] + stride * np.arange(k)[None, :]
    return len(np.unique(rows)) < rows.size


def _first_principles(spec, arrays):
    """The routes worked out without the kernel modules: a specialized
    child (no base, stride 1) takes the "pieces" pass; a strided child
    without a zmap takes "runs" unless two of its (base, k) name one row,
    and then, like a strided zmap child, "strided"; a zmap child's phase 1
    takes "warp" when its tokens, cut into pieces of at most PIECE per
    instance, make more pieces than there are instances."""
    def kind(f):
        if f.base is None and f.stride == 1:
            return "pieces"
        if f.zmap is None and not _rows_meet(arrays[f.x_name].get("base"),
                                             f.stride, spec.k):
            return "runs"
        return "strided"
    passes = tuple(kind(f) for f in spec.children)
    n_inst = len(np.asarray(arrays[spec.name]["prior_rows"]))
    logits = []
    for f in spec.children:
        if f.zmap is None:
            continue
        counts = np.bincount(np.asarray(arrays[f.x_name]["zmap"]),
                             minlength=n_inst)
        pieces = int((-(-counts // tfz.PIECE)).sum())
        logits.append("warp" if pieces > n_inst else "group")
    path = "zmap" if logits else "flat"
    return path, passes, tuple(logits)


@pytest.fixture(scope="module")
def grid_routes():
    """Per (model, grid point): the port's full-batch plan, the reference's,
    and the routes read from the step's own owner plans."""
    out = {}
    for gname, knobs in GRID:
        for name in ZOO:
            tm = texplain.synthesize_model(name, **knobs)
            jm = jexplain.synthesize_model(name, **knobs)
            plan = texplain.explain_plan(tm, None, backend="cuda")
            jplan = jexplain.explain_plan(jm, None, backend="ref")
            prog = tm.compile()
            arrays = tvmp._program_arrays(prog, CPU)
            plans = tvmp.owner_plans(prog, arrays, "cuda")
            by_plan, principled = {}, {}
            for spec in prog.latents:
                tabs = {n: np.broadcast_to(np.float32(0), (d.g, d.k))
                        for n, d in prog.dirichlets.items()}
                r = tops.routing(tabs[spec.prior_dir], None,
                                 tvmp._latent_children(spec, tabs, arrays),
                                 plan=plans[spec.name])
                by_plan[spec.name] = (r.path, r.passes, r.logits)
                principled[spec.name] = _first_principles(spec, arrays)
            out[name, gname] = (plan, jplan, by_plan, principled)
    return out


@pytest.mark.parametrize("model_name", ZOO)
@pytest.mark.parametrize("grid_name", [g[0] for g in GRID])
def test_plan_matches_reference_and_dispatch(grid_routes, model_name,
                                             grid_name):
    plan, jplan, by_plan, principled = grid_routes[model_name, grid_name]
    assert not any(d.severity == "error" for d in plan.diagnostics)
    assert plan.caps == jplan.caps
    assert plan.signature == jplan.signature == \
        tuple(sorted(plan.caps.items()))
    assert _keys(plan.diagnostics) == _keys(jplan.diagnostics)
    assert [r.latent for r in plan.routes] == [r.latent for r in
                                              jplan.routes]
    for r, jr in zip(plan.routes, jplan.routes):
        assert (r.n_latent, r.n_tokens, r.k, r.table_shapes) == \
            (jr.n_latent, jr.n_tokens, jr.k, jr.table_shapes)
        got = (r.path, r.passes, r.logits)
        assert got == by_plan[r.latent] == principled[r.latent], \
            (model_name, grid_name, r)
        assert r.backend == "cuda" and r.plan_bytes > 0
        assert r.table_bytes == 4 * sum(g * k for g, k in
                                        r.table_shapes.values())
        assert 0 < r.hbm_fused < r.hbm_unfused


def test_grid_covers_every_route(grid_routes):
    """The zoo x grid matrix exercises the Hopper routes of its models: flat
    with the pieces and the runs pass (DCM-LDA's phi), zmap with the group
    and the warp logits."""
    seen = set()
    for plan, *_ in grid_routes.values():
        for r in plan.routes:
            seen.add(r.path)
            seen.update(f"{r.path}/{p}" for p in r.passes + r.logits)
    assert {"flat/pieces", "flat/runs", "zmap/group",
            "zmap/warp"} <= seen, seen


@pytest.mark.parametrize("bases,stride,k,want", [
    ([0, 5, 10], 1, 5, "runs"),          # DCM-LDA's base = doc * K
    ([0, 4, 10], 1, 5, "strided"),       # rows 4 .. 4 of two bases meet
    ([0, 1, 2], 3, 3, "runs"),           # interleaved, never meeting
    ([0, 3, 9], 3, 3, "strided"),        # 0 + 3 * 1 = 3 + 3 * 0
    ([2, 2, 2], 0, 1, "runs"),
])
def test_strided_child_routes_by_its_rows(bases, stride, k, want):
    """A strided child's pass, from any host: "runs" where no two (base, k)
    name one row, "strided" where two do; the same as first principles, and
    on a segment latent's child without a zmap too."""
    n = 12
    rows = np.arange(n) % 3
    base = np.asarray(bases, np.int32)[np.arange(n) % len(bases)]
    gf = int(base.max()) + stride * (k - 1) + 1
    child = tops.ZChild(elog=np.broadcast_to(np.float32(0), (gf, 7)),
                        values=np.arange(n) % 7, stride=stride, base=base)
    tab = np.broadcast_to(np.float32(0), (3, k))
    assert (want == "runs") == (not _rows_meet(base, stride, k))
    r = tops.routing(tab, rows, (child,))
    assert r.label == f"flat passes={want}"
    zkid = tops.ZChild(elog=np.broadcast_to(np.float32(0), (k, 5)),
                       values=np.arange(2 * n) % 5,
                       zmap=np.repeat(np.arange(n), 2))
    r = tops.routing(tab, rows, (zkid, child))
    assert r.passes == ("pieces", want)


@pytest.mark.parametrize("spacing,want", [(1, "runs"), (2, "strided")],
                         ids=["doc-times-k", "half-spaced"])
def test_owner_plans_route_a_strided_child_as_dispatch(spacing, want):
    """The DCM-LDA program's owner plans, as a step builds them
    (``vmp.owner_plans``), route phi as the dispatch without a plan and
    first principles do: with the program's bases (doc * K: "runs") and
    with bases respaced to doc * K / 2, where the rows of neighbouring
    documents meet ("strided").  A program of the DSL never gives a strided
    child whose rows meet (its rows are mixed-radix indices), so the zoo x
    grid matrix cannot reach the "strided" pass and this test does."""
    prog = texplain.synthesize_model("dcmlda", **dict(GRID)["tiny"]).compile()
    arrays = tvmp._program_arrays(prog, CPU)
    spec, = prog.latents
    f, = spec.children
    arrays[f.x_name]["base"] = arrays[f.x_name]["base"] // spacing
    plans = tvmp.owner_plans(prog, arrays, "cuda")
    tabs = {n: np.broadcast_to(np.float32(0), (d.g, d.k))
            for n, d in prog.dirichlets.items()}
    kids = tvmp._latent_children(spec, tabs, arrays)
    by_plan = tops.routing(tabs[spec.prior_dir], None, kids,
                           plan=plans[spec.name])
    dispatch = tops.routing(tabs[spec.prior_dir],
                            arrays[spec.name]["prior_rows"], kids)
    assert plans[spec.name].kinds == (want,)
    assert (by_plan.path, by_plan.passes, by_plan.logits) == \
        (dispatch.path, dispatch.passes, dispatch.logits) == \
        _first_principles(spec, arrays) == ("flat", (want,), ())


@pytest.mark.parametrize("model_name", ZOO)
def test_cpu_backend_plans_plain(model_name):
    m = texplain.synthesize_model(model_name, docs=50, vocab=40, topics=3,
                                  mean_len=20)
    plan = texplain.explain_plan(m, None, backend="cpu")
    assert plan.routes and all(
        (r.path, r.passes, r.logits, r.plan_bytes) == ("plain", (), (), 0)
        for r in plan.routes)
    assert "plain PyTorch version" in plan.routes[0].reason
    with pytest.raises(ValueError, match="backend"):
        texplain.explain_plan(m, None, backend="tpu")


def test_routing_reads_streams_or_a_plan():
    tab = np.broadcast_to(np.float32(0), (4, 3))
    child = tops.ZChild(elog=np.broadcast_to(np.float32(0), (3, 9)),
                        values=np.arange(8) % 9)
    with pytest.raises(ValueError, match="index streams or plan="):
        tops.routing(tab, None, (child,))
    r = tops.routing(tab, np.arange(8) % 4, (child,))
    assert (r.path, r.passes, r.logits, r.label) == \
        ("flat", ("pieces",), (), "flat passes=pieces")
    assert r.l2_bytes == tops.L2_BYTES == 50 * 2 ** 20


# ---------------------------------------------------------------------------
# explain_plan under SVI: the caps of the port's own batch 0
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cfg", [
    ("lda", dict(batch_size=8, pad_multiple=4, holdout_frac=0.1, seed=3)),
    ("lda", dict(batch_size=16, pad_multiple=0, seed=1)),
    ("slda", dict(batch_size=4, pad_multiple=32, holdout_frac=0.2)),
    ("naive_bayes", dict(batch_size=8, pad_multiple=64, shuffle=False)),
])
def test_svi_caps_are_batch_zeros(name, cfg):
    knobs = dict(docs=40, vocab=60, topics=3, mean_len=24)
    tm = texplain.synthesize_model(name, **knobs)
    jm = jexplain.synthesize_model(name, **knobs)
    plan = texplain.explain_plan(tm, TSVIConfig(**cfg))
    jplan = jexplain.explain_plan(jm, JSVIConfig(**cfg), backend="ref")
    assert plan.engine == "svi"
    assert plan.caps == jplan.caps and plan.signature == jplan.signature
    prog = tm.compile()
    fit = tsvi.SVI(prog, TSVIConfig(**cfg), device=CPU)
    try:
        _, caps, _ = tsvi.host_batch(prog, fit.sampler.batch_at(0),
                                     fit._caps_fn, device=CPU)
        assert plan.caps == caps
        fit.step(0, tvmp.init_state(prog, seed=0, device=CPU))
        assert set(fit._steps) == {plan.signature}
    finally:
        fit.close()
    assert plan.working_set == jplan.working_set


def test_engineconfig_and_fallbacks_match_reference():
    knobs = dict(docs=30, vocab=40, topics=3, mean_len=10)
    for cfg_kw in (dict(backend="svi", batch_size=8, pad_multiple=4, seed=3),
                   dict(backend="gibbs"), dict(backend="vmp")):
        plan = texplain.explain_plan(texplain.synthesize_model(
            "lda", **knobs), TEngineConfig(**cfg_kw))
        jplan = jexplain.explain_plan(jexplain.synthesize_model(
            "lda", **knobs), JEngineConfig(**cfg_kw), backend="ref")
        assert (plan.engine, plan.caps, plan.notes) == \
            (jplan.engine, jplan.caps, jplan.notes)
    for pkg, ex, cfg in (("port", texplain, TSVIConfig),
                         ("ref", jexplain, JSVIConfig)):
        m = PKGS[pkg][0].Model(_fixed)
        m["x"].observe(np.array([0, 1, 2, 0]),
                       segment_ids=np.arange(4, dtype=np.int32) // 2)
        kw = {} if pkg == "port" else dict(backend="ref")
        p = ex.explain_plan(m, cfg(batch_size=2), **kw)
        assert any("planning full batch" in n for n in p.notes)
        assert p.caps == {"x": 4}
    bad = VALIDATE_CASES["prior-positive"](*PKGS["port"])
    plan = texplain.explain_plan(bad)
    assert plan.routes == [] and "plan aborted" in plan.render()


def test_host_partition_is_the_reference(tmp_path):
    """``explain_plan(n_hosts=)`` with a sharded corpus: each host's
    shards, documents and bytes, the reference's summary exactly, and its
    render line."""
    from repro.data import store as jstore
    from repro_torch.data import store as tstore
    m = texplain.synthesize_model("lda", docs=20, vocab=30, topics=3,
                                  mean_len=10)
    jm = jexplain.synthesize_model("lda", docs=20, vocab=30, topics=3,
                                   mean_len=10)
    c = {"tokens": m.observations["x"]["values"],
         "doc_ids": m.observations["x"]["segment_ids"]}
    tstore.write_sharded_corpus(c, str(tmp_path / "c"), shard_tokens=40)
    got = texplain.explain_plan(m, None, n_hosts=2,
                                corpus=tstore.ShardedCorpus.open(
                                    str(tmp_path / "c")))
    want = jexplain.explain_plan(jm, None, n_hosts=2,
                                 corpus=jstore.ShardedCorpus.open(
                                     str(tmp_path / "c")))
    assert got.hosts == want.hosts and len(got.hosts) == 2
    assert sum(h["docs"] for h in got.hosts) == 20
    assert "host partition:" in got.render()


def test_zstats_bytes_counts_gathered_cells():
    """The kernel's least bytes: streams once, the prior's used rows and
    each child's distinct (row, value) cells gathered, every stats table
    written whole, the lse sum; masked tokens gather nothing."""
    tab = np.broadcast_to(np.float32(0), (4, 3))
    rows = np.array([0, 0, 1, 1, 3], np.int32)
    child = tops.ZChild(elog=np.broadcast_to(np.float32(0), (3, 50)),
                        values=np.array([5, 5, 7, 9, 9], np.int32))
    streams = 5 * 4 + 5 * 4
    want = streams + 3 * 3 * 4 + 12 * 4 + 3 * 3 * 4 + 150 * 4 + 4
    assert texplain.zstats_bytes(tab, rows, (child,)) == want
    zmask = np.array([1, 1, 1, 1, 0], np.float32)
    # the zmask is read; rows 0 and 1 and words 5, 7 and 9 stay gathered
    masked = streams + 5 * 4 + 2 * 3 * 4 + 12 * 4 + 3 * 3 * 4 + 150 * 4 + 4
    assert texplain.zstats_bytes(tab, rows, (child,), zmask) == masked
    import torch
    tt = [torch.from_numpy(a) for a in (rows, child.values, zmask)]
    tchild = child._replace(values=tt[1])
    assert texplain.zstats_bytes(tab, tt[0], (tchild,), tt[2]) == masked


# ---------------------------------------------------------------------------
# nothing launches; the CLI; the package surface
# ---------------------------------------------------------------------------

def test_analysis_never_launches(monkeypatch):
    """Validation, the EXPLAIN plan on the card's routes and the audit run
    with every kernel wrapper and the kernel library replaced by a trap."""
    from repro_torch.kernels import fused_zmap, vmp_zstep
    from repro_torch.kernels import dirichlet_expectation as de

    def trap(*a, **k):
        raise AssertionError("static analysis reached a kernel")
    for mod, name in ((tfz, "library"), (tfz, "zstats"),
                      (fused_zmap, "zstats_zmap"),
                      (fused_zmap, "zmap_logits"), (de, "dirichlet_expectation"),
                      (vmp_zstep, "zstep")):
        monkeypatch.setattr(mod, name, trap)
    tops.reset_launch_counts()
    for name in ("lda", "slda"):
        m = texplain.synthesize_model(name, docs=30, vocab=40, topics=3,
                                      mean_len=16)
        assert tvalidate.validate_model(m)
        plan = texplain.explain_plan(m, TSVIConfig(batch_size=8,
                                                   pad_multiple=4))
        assert plan.routes and plan.signature
        assert plan.render() and json.loads(plan.to_json())
    assert taudit.audit_config(TSVIConfig(pad_multiple=0))
    assert set(tops.launch_counts().values()) == {0}


def test_explain_cli_json_and_render(capsys):
    rc = texplain._main(["--model", "lda", "--docs", "100", "--vocab", "200",
                         "--topics", "4", "--mean-len", "20", "--engine",
                         "svi", "--batch-docs", "16", "--json"])
    assert rc == 0
    plan = json.loads(capsys.readouterr().out)
    assert plan["engine"] == "svi" and plan["backend"] == "cuda"
    assert plan["routes"][0]["path"] == "flat"
    assert plan["routes"][0]["passes"] == ["pieces"]
    assert plan["working_set"]["table_bytes"] > 0
    rc = texplain._main(["--model", "slda", "--docs", "60", "--vocab", "100",
                         "--topics", "4", "--engine", "vmp", "--backend",
                         "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "EXPLAIN slda" in out and "route=plain" in out
    assert "HBM/step" in out


def test_package_exposes_the_reference_names():
    assert set(tanalysis.__all__) == {
        "diagnostics", "validate", "explain", "audit", "Diagnostic",
        "validate_model", "preflight", "explain_plan", "Plan",
        "audit_config"}
    assert tanalysis.validate_model is tvalidate.validate_model
    assert tanalysis.preflight is tvalidate.preflight
    assert tanalysis.explain_plan is texplain.explain_plan
    assert tanalysis.Plan is texplain.Plan
    assert tanalysis.audit_config is taudit.audit_config
    with pytest.raises(AttributeError, match="no attribute"):
        tanalysis.nope


# ---------------------------------------------------------------------------
# engine / SVI pre-flight wiring
# ---------------------------------------------------------------------------

def _bad_prior_model():
    return VALIDATE_CASES["prior-positive"](*PKGS["port"])


@pytest.mark.parametrize("backend", ["vmp", "svi", "gibbs"])
def test_engine_validate_runs_the_preflight(backend):
    with pytest.raises(tvalidate.PreflightError, match="prior-positive"):
        make_engine(backend, validate=True, steps=1,
                    device=CPU).fit(_bad_prior_model())


def test_engine_validate_passes_a_good_model():
    m = _lda(tmodels)
    res = make_engine("vmp", validate=True, steps=2, device=CPU).fit(m)
    assert res.backend == "vmp" and len(res.elbo_trace) == 2


def test_engine_validate_audits_config():
    eng = make_engine("svi", validate=True, growing=True, capacity_docs=10,
                      corpus=types.SimpleNamespace(n_docs=50), device=CPU)
    with pytest.raises(tvalidate.PreflightError, match="retrace-growth"):
        eng.fit(_lda(tmodels))


def test_svi_validate_kwarg():
    with pytest.raises(tvalidate.PreflightError, match="prior-positive"):
        tsvi.SVI(_bad_prior_model(), TSVIConfig(), validate=True, device=CPU)
    prog = _lda(tmodels).compile()
    fit = tsvi.SVI(prog, TSVIConfig(batch_size=4), validate=True, device=CPU)
    fit.close()
    with pytest.raises(tvalidate.PreflightError, match="retrace-growth"):
        tsvi.SVI(prog, TSVIConfig(growing=True, capacity_docs=4),
                 corpus=types.SimpleNamespace(n_docs=9), validate=True,
                 device=CPU)
