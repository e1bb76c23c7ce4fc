"""DCM-SLDA in the port, on the CPU: SLDA's sentence topics (the paper's
Figure 21) over DCM-LDA's per-document topic-word tables (Figure 22), the
port's ``models.make("dcmslda")`` held to a live run of the JAX reference
(this file's DSL lines) on the same numpy inputs; and the owner plan that
sends its strided zmap child to phase 2b's ``runs`` pass.

Tolerances, each with its reason:

- 10 VMP steps against the reference from its own ``init_state``: ELBO
  trace rtol 1e-4, posteriors rtol = atol = 2e-4, ``get_result("z")`` 2e-4
  (as ``test_torch_vmp.py``: f32 sums in another order across frameworks,
  digamma in the last ulps);
- each Dirichlet's statistics after a step sum to the sentences (theta) and
  the tokens (phi) within 1e-5 relative, the f32 rounding of their sums;
- the runs pass emulated in f32 against the per-column walk emulated in
  f32: bitwise (the same terms, in the same order, rounded the same way);
  against ``ref.zstats``' child stats: rtol = atol = 1e-5, f32 sums of a
  few terms in another order;
- the port's plain ``zstats`` against the reference's ``ref.zstats``:
  rtol = atol = 2e-4, lse rtol 2e-5 (the reference's own).

The CUDA kernel runs only on the card, where ``chip_smoke.py`` holds it to
the plain version and to the per-column pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import models as jmodels
from repro.core.runtime import run_inference as j_run
from repro.core.vmp import init_state as j_init
from repro.core.vmp import latent_responsibilities as j_resp
from repro.kernels import ref as jref
from repro_torch.analysis.explain import explain_plan
from repro_torch.core import models as tmodels
from repro_torch.core import runtime as trun
from repro_torch.core import vmp as tvmp
from repro_torch.kernels import fused_zmap as tfzm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import work
from repro_torch.launch import step_cost

STEPS = 10
K, V = 3, 25
PARAMS = dict(alpha=0.4, beta=0.4, K=K, V=V)
ROUTE = "zmap passes=runs logits=group"


def dcmslda(m, alpha, beta, K, V):
    """The JAX package's side of the model (its ``make`` has no DCM-SLDA);
    the port's is ``models.make("dcmslda")``."""
    docs = m.plate("?", name="docs")
    sents = m.plate("?", name="sents", within=docs)
    tokens = m.plate("?", name="tokens", within=sents)
    theta = m.dirichlet("theta", alpha, dim=K, plate=docs)
    phi = m.dirichlet("phi", beta, dim=V,
                      plate=m.plate(K, name="topics", within=docs))
    z = m.categorical("z", given=theta, plate=sents)
    m.categorical("x", given=phi, plate=tokens, selector=z)


def _corpus(seed, docs=14):
    """(words, sentence of each token, document of each sentence): each
    document of 2 to 5 sentences of 3 to 8 tokens; word 0 in a fifth of
    the tokens, so words repeat within documents and sentences."""
    rng = np.random.default_rng(seed)
    sent_doc = np.repeat(np.arange(docs), rng.integers(2, 6, docs))
    tok_sent = np.repeat(np.arange(len(sent_doc)),
                         rng.integers(3, 9, len(sent_doc)))
    words = rng.integers(0, V, len(tok_sent))
    words[rng.random(len(words)) < 0.2] = 0
    i32 = lambda a: np.asarray(a, np.int32)  # noqa: E731
    return i32(words), i32(tok_sent), i32(sent_doc)


def _model(pkg, seed=0, own=False):
    """The model observed over :func:`_corpus`: the port's from its
    ``make``, the reference's (or, with ``own``, the port's too) from this
    file's DSL lines."""
    words, tok_sent, sent_doc = _corpus(seed)
    m = pkg.make("dcmslda", **PARAMS) if pkg is tmodels and not own else \
        pkg.Model(dcmslda, **PARAMS)
    m["x"].observe(words, segment_ids=tok_sent)
    m.bind("sents", sent_doc)
    return m


def _pair(seed=0):
    jm, tm = _model(jmodels, seed), _model(tmodels, seed)
    jprog = jm.compile()
    s0 = j_init(jprog, seed=0)
    posts0 = {n: np.asarray(p) for n, p in s0.posteriors.items()}
    return jm, tm, jprog, s0, posts0


def test_program_has_a_strided_zmap_child():
    """phi lives on docs x topics: the child of the sentence latent maps
    each token to its sentence and reads rows doc * K + k, stride 1."""
    _, tm, jprog, _, _ = _pair()
    words, tok_sent, sent_doc = _corpus(0)
    for prog in (jprog, tm.compile()):
        (spec,) = prog.latents
        (f,) = spec.children
        assert spec.n == len(sent_doc)
        assert (prog.dirichlets["phi"].g, prog.dirichlets["theta"].g) == \
            (14 * K, 14)
        assert f.stride == 1
        np.testing.assert_array_equal(f.zmap, tok_sent)
        np.testing.assert_array_equal(f.base, sent_doc[tok_sent] * K)


def test_ten_steps_match_jax_reference():
    """``Model.infer`` of the port from the reference's initial state, 10
    steps, against the reference's own 10 steps; then ``get_result("z")``
    against the reference's responsibilities at its final state."""
    _, tm, jprog, s0, posts0 = _pair()
    jstate, jtrace = j_run(jprog, steps=STEPS, state=s0)
    tm.compile()
    tm._state = tvmp.state_from_numpy(posts0, 0, "cpu")
    tm.infer(steps=STEPS, device="cpu")
    np.testing.assert_allclose(tm.elbo_trace, jtrace, rtol=1e-4)
    for n in ("theta", "phi"):
        np.testing.assert_allclose(tm[n].get_result(),
                                   np.asarray(jstate.posteriors[n]),
                                   rtol=2e-4, atol=2e-4, err_msg=n)
    want = np.asarray(j_resp(jprog, jstate, "z"))
    got = tm["z"].get_result()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)


def test_elbo_monotone_and_stats_sum_to_sentences_and_tokens():
    _, tm, _, _, posts0 = _pair(seed=1)
    prog = tm.compile()
    words, _, sent_doc = _corpus(1)
    state, trace = trun.run_inference(
        prog, steps=STEPS, state=tvmp.state_from_numpy(posts0, 0, "cpu"),
        device="cpu")
    assert (np.diff(trace) >= -1e-6 * abs(trace[-1])).all(), np.diff(trace)
    for name, n in (("theta", len(sent_doc)), ("phi", len(words))):
        got = float((state.posteriors[name].double() - torch.from_numpy(
            prog.dirichlets[name].prior).double()).sum())
        assert abs(got - n) <= 1e-5 * n, (name, got, n)


def test_make_is_bitwise_these_dsl_lines():
    """``models.make("dcmslda")`` and this file's DSL lines, through the
    port, give the same posteriors and ELBOs, bit for bit, over 3 steps
    from one seeded state."""
    out = []
    for own in (False, True):
        prog = _model(tmodels, seed=2, own=own).compile()
        state, trace = trun.run_inference(
            prog, steps=3, state=tvmp.init_state(prog, 11, device="cpu"),
            device="cpu")
        out.append((state.posteriors, trace))
    (made, t_made), (own, t_own) = out
    assert t_made == t_own and made.keys() == own.keys() == {"theta", "phi"}
    for n in made:
        assert torch.equal(made[n], own[n]), n


# ---------------------------------------------------------------------------
# the owner plan: runs exactly where rows are one to one
# ---------------------------------------------------------------------------

def _program_call(seed=0):
    """The ``zstats`` arguments of the DCM-SLDA program's step, as numpy:
    ``(prior table, prior rows, [child dicts], zmask)``, Elog tables drawn
    from ``seed``."""
    prog = _model(tmodels, seed).compile()
    (spec,) = prog.latents
    (f,) = spec.children
    rng = np.random.default_rng(seed + 50)
    child = dict(table=rng.normal(size=(prog.dirichlets["phi"].g, V))
                 .astype(np.float32), values=np.asarray(f.values, np.int32),
                 stride=f.stride, zmap=np.asarray(f.zmap, np.int32),
                 base=np.asarray(f.base, np.int32), mask=None)
    et = rng.normal(size=(prog.dirichlets["theta"].g, K)).astype(np.float32)
    return et, np.asarray(spec.prior_rows, np.int32), [child], None


def _strided_child(rng, n, gf, kf, stride, base_hi, zmap=None):
    return dict(table=rng.normal(size=(gf, kf)).astype(np.float32),
                values=rng.integers(0, kf, n).astype(np.int32), stride=stride,
                zmap=zmap, base=rng.integers(0, base_hi, n).astype(np.int32),
                mask=(rng.random(n) > 0.25).astype(np.float32))


def _colliding():
    """The reference's ZMAP_KERNEL_CASES "strided": bases 0..23 at stride 3
    under K = 3, so rows of two bases meet."""
    rng = np.random.default_rng(7)
    nz, n = 35, 200
    et = rng.normal(size=(9, K)).astype(np.float32)
    rows = rng.integers(0, 9, nz).astype(np.int32)
    zmap = np.sort(rng.integers(0, nz, n)).astype(np.int32)
    return et, rows, [_strided_child(rng, n, 30, 11, 3, 24, zmap)], None


def _beside_flat(zmap_one_to_one):
    """A zmap child beside a flat strided child, one of them with rows one
    to one over (base, k) (bases multiples of K at stride 1), the other
    with colliding rows (bases 0..12 at stride 2)."""
    rng = np.random.default_rng(8)
    et, rows, (c,), _ = _program_call(3)
    nz = len(rows)
    flat = _strided_child(rng, nz, 30, 9, 2, 13)
    if not zmap_one_to_one:
        c = _strided_child(rng, len(c["values"]), 30, 11, 3, 24, c["zmap"])
        flat = dict(flat, stride=1, base=(rng.integers(0, 10, nz) * K)
                    .astype(np.int32))
    return et, rows, [c, flat], (rng.random(nz) > 0.15).astype(np.float32)


def _torch_children(children):
    opt = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return tuple(tref.ZChild(torch.from_numpy(c["table"]),
                             torch.from_numpy(c["values"]), c["stride"],
                             opt(c["zmap"]), opt(c["base"]), opt(c["mask"]))
                 for c in children)


def _one_to_one_by_count(base, stride, k):
    b = np.unique(base)
    rows = b.astype(np.int64)[:, None] + stride * np.arange(k)[None, :]
    return len(np.unique(rows)) == rows.size


@pytest.mark.parametrize("name,make,kinds", [
    ("dcmslda", _program_call, ("runs",)),
    ("zmap-strided", _colliding, ("strided",)),
    ("runs-zmap-beside-flat", lambda: _beside_flat(True),
     ("runs", "strided")),
    ("strided-zmap-beside-flat", lambda: _beside_flat(False),
     ("strided", "runs")),
])
def test_plan_takes_runs_exactly_where_rows_are_one_to_one(name, make, kinds):
    """Each strided child's pass is "runs" exactly where (base, k) -> base +
    stride * k is one to one over the bases its tokens use (counted here
    row by row), a zmap child's in phase 2b as a flat child's in phase 2a;
    ``routing`` names the passes, and a device copy keeps them."""
    et, rows, children, _ = make()
    tkids = _torch_children(children)
    plan = tfzm.build_zmap_plan(rows, tkids, et.shape)
    for c, kind in zip(children, kinds):
        assert (kind == "runs") == _one_to_one_by_count(c["base"],
                                                        c["stride"], K)
    assert tfzm.pass_kinds(tkids, plan) == kinds
    assert plan.kinds == tuple(k for c, k in zip(children, kinds)
                               if c["zmap"] is not None)
    assert tops.routing(et, rows, tkids).passes == kinds
    assert plan.to("cpu").kinds == plan.kinds
    col = tfzm.build_zmap_plan(rows, tkids, et.shape, per_column=True)
    assert col.kinds == ("strided",) * len(plan.kinds)


def test_runs_hold_one_base_and_value_in_token_order():
    """The runs pass's grouping: every token in one run, each run one
    (base, value) pair with its tokens in their original order, runs in
    (base, value) order; its streams (values, base, zmap) are the call's
    arrays gathered in run order."""
    et, rows, (c,), _ = _program_call()
    plan = tfzm.build_zmap_plan(rows, _torch_children([c]), et.shape)
    g = plan.by_value[0]
    assert plan.kinds == ("runs",)
    np.testing.assert_array_equal(np.sort(g.perm), np.arange(len(c["values"])))
    np.testing.assert_array_equal(g.piece_start, g.key_start)
    keys = []
    for s in range(g.n_keys):
        toks = g.perm[g.key_start[s]:g.key_start[s + 1]]
        assert len(toks) and (np.diff(toks) > 0).all()
        assert len(set(c["values"][toks])) == len(set(c["base"][toks])) == 1
        keys.append((c["base"][toks[0]], c["values"][toks[0]]))
    assert keys == sorted(set(keys))
    assert max(np.diff(g.key_start)) > 1          # a word repeats in a doc
    for f in ("values", "base", "zmap"):
        np.testing.assert_array_equal(plan.streams["value0", f],
                                      c[f][g.perm])
    assert ("value0", "mask") not in plan.streams


# ---------------------------------------------------------------------------
# phase 2b: the runs pass and the per-column walk, emulated in f32
# ---------------------------------------------------------------------------

def _variant(name):
    """The DCM-SLDA program's call with its child's mask: none, 0/1, with
    fractions; or with sentence 0 left empty and every token of sentence 2
    masked; each but the first with a zmask."""
    et, rows, (c,), _ = _program_call()
    rng = np.random.default_rng(31)
    n, nz = len(c["values"]), len(rows)
    zm = (rng.random(nz) > 0.15).astype(np.float32)
    if name == "plain":
        return et, rows, [c], None
    mask = (rng.random(n) > 0.25).astype(np.float32)
    if name in ("fractional", "empty-and-masked"):
        u = rng.random(n)
        mask = np.where(u < 0.2, 0.0, np.where(
            u < 0.6, rng.uniform(0.05, 1.0, n), 1.0)).astype(np.float32)
    if name == "empty-and-masked":
        c = dict(c, zmap=np.where(c["zmap"] == 0, 1, c["zmap"])
                 .astype(np.int32))
        mask = np.where(c["zmap"] == 2, 0.0, mask).astype(np.float32)
    return et, rows, [dict(c, mask=mask)], zm


def _responsibilities(case):
    """r as phase 2a writes it: the softmax of the prior row plus phase 1's
    logits, times zmask, f32 (the plain versions)."""
    et, rows, children, zm = case
    logits = torch.from_numpy(et)[torch.from_numpy(rows).long()] + \
        tops.zmap_logits(_torch_children(children), len(rows), K)
    r = torch.softmax(logits, dim=1)
    if zm is not None:
        r = r * torch.from_numpy(zm)[:, None]
    return r.numpy().astype(np.float32)


def _runs_pass(plan, c, r):
    """The runs pass driven by the plan: each run, its tokens in stream
    order, adds f32(r[zmap] * mask) to an f32 zero, rounded each time, and
    stores its K cells once."""
    g = plan.by_value[0]
    s = {f: plan.streams.get(("value0", f), c[f]) for f in
         ("values", "base", "zmap", "mask")}
    out = np.zeros(c["table"].shape, np.float32)
    for run in range(g.n_keys):
        t0, t1 = g.key_start[run], g.key_start[run + 1]
        acc = np.zeros(K, np.float32)
        for t in range(t0, t1):
            w = np.float32(s["mask"][t] if s["mask"] is not None else 1.0)
            acc = acc + r[s["zmap"][t]] * w
        out[s["base"][t0] + c["stride"] * np.arange(K), s["values"][t0]] = acc
    return out


def _column_walk(plan, c, r):
    """The per-column pass driven by its plan: each value column's tokens in
    stream order, each adding f32(r[zmap] * mask) into its rows of the
    zeroed f32 table."""
    g = plan.by_value[0]
    s = {f: plan.streams.get(("value0", f), c[f]) for f in
         ("base", "zmap", "mask")}
    out = np.zeros(c["table"].shape, np.float32)
    for v in range(g.n_keys):
        for t in range(g.key_start[v], g.key_start[v + 1]):
            w = np.float32(s["mask"][t] if s["mask"] is not None else 1.0)
            rows = s["base"][t] + c["stride"] * np.arange(K)
            out[rows, v] = out[rows, v] + r[s["zmap"][t]] * w
    return out


@pytest.mark.parametrize("name", ["plain", "masked", "fractional",
                                  "empty-and-masked"])
def test_runs_pass_is_bitwise_the_column_walk(name):
    """Phase 2b emulated over the runs plan equals the per-column walk over
    a ``per_column`` plan bit for bit (each cell: the same products, added
    in the same order to the same zero), and both equal the plain
    ``zstats``' child stats within the f32 rounding of their sums."""
    case = _variant(name)
    et, rows, (c,), _ = case
    tkids = _torch_children([c])
    runs = tfzm.build_zmap_plan(rows, tkids, et.shape)
    col = tfzm.build_zmap_plan(rows, tkids, et.shape, per_column=True)
    assert (runs.kinds, col.kinds) == (("runs",), ("strided",))
    r = _responsibilities(case)
    got = _runs_pass(runs, c, r)
    np.testing.assert_array_equal(got, _column_walk(col, c, r))
    want = tref.zstats(torch.from_numpy(et), torch.from_numpy(rows), tkids,
                       None if case[3] is None else torch.from_numpy(case[3]))
    np.testing.assert_allclose(got, want[2][0].numpy(), rtol=1e-5, atol=1e-5)
    if name == "empty-and-masked":
        assert 0 not in c["zmap"] and (c["mask"][c["zmap"] == 2] == 0).all()


@pytest.mark.parametrize("name", ["plain", "fractional", "empty-and-masked"])
def test_dcmslda_zstats_matches_jax_ref(name):
    """The port's plain ``zstats`` on the DCM-SLDA call's streams against
    the reference's ``ref.zstats``."""
    et, rows, children, zm = _variant(name)
    opt = lambda f, a: None if a is None else f(a)  # noqa: E731
    jkids = tuple(jref.ZChild(jnp.asarray(c["table"]),
                              jnp.asarray(c["values"]), c["stride"],
                              jnp.asarray(c["zmap"]), jnp.asarray(c["base"]),
                              opt(jnp.asarray, c["mask"])) for c in children)
    want = jref.zstats(jnp.asarray(et), jnp.asarray(rows), jkids,
                       opt(jnp.asarray, zm))
    got = tops.zstats(torch.from_numpy(et), torch.from_numpy(rows),
                      _torch_children(children), opt(torch.from_numpy, zm))
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=2e-5,
                               atol=2e-4)
    for g, w in zip((got[1], *got[2]), (want[1], *want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


# ---------------------------------------------------------------------------
# the route on the CPU, the dry run and the counted work
# ---------------------------------------------------------------------------

def test_routing_label_from_the_plan_on_the_cpu():
    """``explain_plan(backend="cuda")`` and ``ops.routing`` plan the card's
    route here: phase 1 on the lane-group route (a sentence is one piece),
    phase 2b on the runs pass; the plain route for ``backend="cpu"``."""
    m = _model(tmodels)
    (r,) = explain_plan(m, backend="cuda").routes
    assert r.label == ROUTE
    (r,) = explain_plan(m, backend="cpu").routes
    assert r.label == "plain"
    et, rows, children, _ = _program_call()
    assert tops.routing(et, rows, _torch_children(children)).label == ROUTE


def test_dry_step_counts_the_runs_route():
    """A VMP step of DCM-SLDA on ``meta`` counts one ``zstats_zmap`` launch
    on the runs pass and the lane-group logits route, as on the card."""
    prog = _model(tmodels).compile()
    step = trun.make_step(prog, device="meta")
    state = tvmp.state_from_numpy(
        {n: np.ones((d.g, d.k), np.float32) for n, d in
         prog.dirichlets.items()}, 0, "meta")
    costs = step_cost.count(step, state)
    z = costs.launches["zstats_zmap"]
    assert z["count"] == 1
    assert z["routes"] == {"runs": 1, "group": 1}


def test_work_counts_streams_cells_and_the_zero_fill():
    """``work.zstats_zmap``'s bytes hold each stream once, the (doc, word)
    cells of phi that the tokens reach and phi's stats written dense (the
    zero fill); ``work.zmap_stats`` counts phase 2b alone, with the rows of
    r that the kept tokens gather."""
    et, rows, children, zm = _variant("masked")
    tkids = _torch_children(children)
    (c,) = children
    ops_, nbytes = work.zstats_zmap(torch.from_numpy(et),
                                    torch.from_numpy(rows), tkids,
                                    torch.from_numpy(zm))
    streams = sum(c[f].nbytes for f in ("values", "zmap", "base", "mask"))
    kept = c["mask"] > 0
    cells = len(set(zip(c["base"][kept], c["values"][kept]))) * K
    theta_rows = len(np.unique(rows[zm > 0])) * K
    want = (rows.nbytes + zm.nbytes + theta_rows * 4 + et.nbytes + streams
            + cells * 4 + c["table"].nbytes + 4)
    assert nbytes == want
    assert ops_ == 8 * int((zm > 0).sum()) * K + 4 * int(kept.sum()) * K
    p_ops, p_bytes = work.zmap_stats(tkids, len(rows), K)
    r_rows = len(np.unique(c["zmap"][kept])) * K
    assert p_bytes == streams + r_rows * 4 + c["table"].nbytes
    assert p_ops == 2 * int(kept.sum()) * K
