"""The port's co-partitioned VMP and sharded SVI (``repro_torch.core.
partition``, ``svi`` with ``plan=``) held to a live run of the reference.

``scripts/dist_checks.py``'s checks on the port (``vmp_parity`` for the
three strategies, ``svi_parity``, ``svi_outofcore_parity``,
``vmp_collectives``), and the two packages side by side:

- the numpy pieces (``lpt_pack``, ``_pack_indices``, ``build_layout``,
  ``strategy_costs``) equal the reference's element for element;
- the reference's distributed VMP (2 devices, in a child started with
  ``--xla_force_host_platform_device_count=2``, as ``tests/
  test_distributed.py`` runs it) and its sharded SVI, from the reference's
  own initial state: the port's traces within ELBO rtol 1e-4 (the
  reference's own bound between its strategies, ``scripts/
  dist_checks.py``) and its posteriors within rtol = atol = 2e-4 (the VMP
  parity tolerance of ``tests/test_torch_vmp.py``: f32 sums in another
  order, digammas that differ in the last ulps).

Within the port: every strategy within 1e-4 of the one-device step, two
runs bitwise, out of core bitwise resident, the bytes each shard hands
the shard group (phi's stats, none of theta's), and
``collective_bytes_per_iteration`` equal to the reference's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import models as jmodels
from repro.core import partition as jpart
from repro.data import SyntheticCorpus as JCorpus
from repro_torch.core import compiler as tcomp
from repro_torch.core import make_engine
from repro_torch.core import models as tmodels
from repro_torch.core import partition as tpart
from repro_torch.core import vmp as tvmp
from repro_torch.core.engine import EngineConfig
from repro_torch.core.svi import SVI, SVIConfig
from repro_torch.data import write_sharded_corpus
from repro_torch.launch.dist import ShardGroup
from repro_torch.launch.steps import build_infer_step

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
XTOL = dict(rtol=2e-4, atol=2e-4)      # posteriors, port against reference
ELBO_RTOL = 1e-4
MODELS = {
    "lda": dict(alpha=0.1, beta=0.1, K=4, V=40),
    "dcmlda": dict(alpha=0.4, beta=0.4, K=3, V=40),       # local phi + base
    "naive_bayes": dict(alpha=1.0, beta=0.3, C=3, V=40),  # doc-level latent
    "slda": dict(alpha=0.2, beta=0.2, K=3, V=40),         # zmap children
}


@pytest.fixture(scope="module")
def docs():
    """dist_checks.py's corpus: 30 documents of 10-80 tokens, V = 40."""
    rng = np.random.default_rng(1)
    doc_len = rng.integers(10, 80, size=30)
    return {"tokens": rng.integers(0, 40, size=doc_len.sum()).astype(np.int32),
            "doc_ids": np.repeat(np.arange(30), doc_len).astype(np.int32)}


def _observe(m, name, c):
    if name == "slda":
        n = len(c["tokens"])
        sent_of_tok = (np.arange(n) // 7).astype(np.int32)
        m["x"].observe(c["tokens"], segment_ids=sent_of_tok)
        m.bind("sents", c["doc_ids"][::7][:sent_of_tok.max() + 1])
    else:
        m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
    return m


def _model(pkg, name, c):
    return _observe(pkg.make(name, **MODELS[name]), name, c)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


# ---------------------------------------------------------------------------
# the numpy pieces: the reference's, element for element
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 3, 8])
def test_lpt_pack_is_the_reference(m):
    rng = np.random.default_rng(m)
    w = rng.integers(1, 500, size=97)
    w[::7] = w[0]                                   # ties
    np.testing.assert_array_equal(tpart.lpt_pack(w, m), jpart.lpt_pack(w, m))
    load = np.bincount(tpart.lpt_pack(w, m), weights=w, minlength=m)
    assert load.max() - load.min() <= w.max()       # LPT's balance


@pytest.mark.parametrize("m", [1, 2, 5])
def test_pack_indices_is_the_reference(m):
    shard = np.random.default_rng(m).integers(0, m, size=200)
    for got, want in zip(tpart._pack_indices(shard, m),
                         jpart._pack_indices(shard, m)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("m", [2, 3])
def test_build_layout_is_the_reference(docs, name, m):
    """Every array and map of the layout equals the reference's; a flat
    child's ``zmap``, which the port leaves out, is the identity on every
    shard in the reference's."""
    got = tpart.build_layout(_model(tmodels, name, docs).compile(), m)
    want = jpart.build_layout(_model(jmodels, name, docs).compile(), m)
    np.testing.assert_array_equal(got.group_shard, want.group_shard)
    assert got.local_dirs == want.local_dirs
    for part in ("dir_row", "lat"):
        a, b = getattr(got, part), getattr(want, part)
        assert a.keys() == b.keys()
        for n in a:
            for k in b[n]:
                np.testing.assert_array_equal(a[n][k], b[n][k], err_msg=n)
    assert got.arrays.keys() == want.arrays.keys()
    for n, sub in want.arrays.items():
        for k, v in sub.items():
            if got.arrays[n][k] is None and k == "zmap":
                cap = v.shape[1]
                on = sub["mask"] > 0
                np.testing.assert_array_equal(
                    v[on], np.broadcast_to(np.arange(cap), v.shape)[on])
                continue
            if v is None:
                assert got.arrays[n][k] is None
            else:
                np.testing.assert_array_equal(got.arrays[n][k], v,
                                              err_msg=f"{n}.{k}")
    for d in want.shadow.dirichlets:
        assert got.shadow.dirichlets[d].g == want.shadow.dirichlets[d].g
    assert [s.n for s in got.shadow.latents] == \
        [s.n for s in want.shadow.latents]


def test_strategy_costs_is_the_reference():
    assert tpart.strategy_costs(10_000, 300, 20, 8) == \
        jpart.strategy_costs(10_000, 300, 20, 8)


def test_layout_drops_the_program_plan_cache(docs):
    """The program's cached full-batch owner plans hold its own streams:
    the shadow every shard shares must not carry them."""
    prog = _model(tmodels, "lda", docs).compile()
    prog.meta["_zstats_plan"] = {"cuda:0": {"z": "the program's plan"}}
    layout = tpart.build_layout(prog, 2)
    assert "_zstats_plan" not in layout.shadow.meta
    assert "_zstats_plan" in prog.meta


@pytest.mark.parametrize("name", ["lda", "slda"])
def test_each_shard_gets_its_own_owner_plan(docs, name):
    """Shards share every shape, so one plan cache key would serve them
    all; each shard's owner plan is built from its own streams (on the
    host, for the card) and differs from the other shard's."""
    layout = tpart.build_layout(_model(tmodels, name, docs).compile(), 2)
    spec = layout.shadow.latents[0]

    def plan_arrays(s):
        return tvmp.owner_plans(layout.shadow,
                                tpart._shard_arrays(layout.arrays, s, CPU),
                                "cuda")[spec.name].host_arrays()
    a, b = plan_arrays(0), plan_arrays(1)
    assert a.keys() != b.keys() or any(
        a[k].shape != b[k].shape or not np.array_equal(a[k], b[k])
        for k in a)
    again = plan_arrays(1)
    assert again.keys() == b.keys()
    for k in b:
        np.testing.assert_array_equal(again[k], b[k])


# ---------------------------------------------------------------------------
# the port's strategies against its one-device step (dist_checks.py)
# ---------------------------------------------------------------------------

def _infer(name, c, plan, steps=8, seed=3):
    m = _model(tmodels, name, c)
    m.infer(steps=steps, sharding=plan, seed=seed, device=CPU)
    return m


@pytest.mark.parametrize("strategy", ["replicated", "inferspark", "gspmd"])
def test_vmp_parity(docs, strategy):
    """``vmp_parity``: every strategy's ELBO trace within 1e-4 of the
    one-device step's, and the gathered posteriors close."""
    ref = _infer("lda", docs, None)
    m = _infer("lda", docs, tpart.ShardingPlan(8, strategy))
    assert _rel(m.elbo_trace, ref.elbo_trace) < 1e-4
    for n in ("theta", "phi"):
        np.testing.assert_allclose(m[n].get_result(), ref[n].get_result(),
                                   **XTOL)
    assert m["theta"].get_result().shape == (30, 4)


@pytest.mark.parametrize("name", ["slda", "dcmlda", "naive_bayes"])
def test_segment_and_local_models_under_a_plan(docs, name):
    """Segment latents (zmap children), a local child Dirichlet with row
    bases (DCM-LDA) and a document-level latent, co-partitioned over 3
    shards: within 1e-4 of one device."""
    ref = _infer(name, docs, None, steps=5)
    m = _infer(name, docs, tpart.ShardingPlan(3, "inferspark"), steps=5)
    assert _rel(m.elbo_trace, ref.elbo_trace) < 1e-4
    prog = m.compile()
    for n in prog.dirichlets:
        np.testing.assert_allclose(m[n].get_result(), ref[n].get_result(),
                                   **XTOL)


def test_gspmd_refuses_segment_latents(docs):
    with pytest.raises(ValueError, match="inferspark"):
        _infer("slda", docs, tpart.ShardingPlan(2, "gspmd"), steps=1)


def test_two_runs_bitwise(docs):
    plan = tpart.ShardingPlan(4, "inferspark")
    a, b = _infer("lda", docs, plan), _infer("lda", docs, plan)
    assert a.elbo_trace == b.elbo_trace
    for n in ("theta", "phi"):
        np.testing.assert_array_equal(a[n].get_result(), b[n].get_result())


def test_vmp_collectives(docs):
    """``vmp_collectives``: per step each shard hands the group its phi
    stats and ELBO and nothing of theta (every Dirichlet under ``gspmd``);
    in one process nothing goes over the wire.
    ``collective_bytes_per_iteration`` is the reference's, key for key."""
    prog = _model(tmodels, "lda", docs).compile()
    jprog = _model(jmodels, "lda", docs).compile()
    for strategy, theta_bytes in (("inferspark", 0),
                                  ("gspmd", 8 * 30 * 4 * 4)):
        plan = tpart.ShardingPlan(8, strategy)
        want = tpart.collective_bytes_per_iteration(prog, plan)
        assert want == jpart.collective_bytes_per_iteration(jprog, None)
        assert want == {"theta": 0, "phi": 2 * 4 * 40 * 4}
        step, state = tpart.make_distributed_step(prog, plan, seed=0,
                                                  device=CPU)
        for _ in range(2):
            before = dict(plan.group.payload)
            state, elbo = step(state)
            assert np.isfinite(float(elbo))
            handed = {k: v - before.get(k, 0)
                      for k, v in plan.group.payload.items()}
            assert handed.pop("elbo") == 8 * 4
            assert handed.pop("phi") == 8 * 4 * 40 * 4
            assert handed.get("theta", 0) == theta_bytes and not (
                set(handed) - {"theta"})
        assert plan.group.wire == {} and plan.group.wire_bytes == 0


def test_results_and_engines_under_a_plan(docs):
    """``get_result`` gathers a local Dirichlet; a latent's result raises
    as in the reference; ``make_engine("vmp", sharding=)`` and
    ``build_infer_step`` run the same step."""
    plan = tpart.ShardingPlan(2, "inferspark")
    m = _infer("lda", docs, plan, steps=3)
    with pytest.raises(NotImplementedError, match="distributed"):
        m["z"].get_result()
    res = make_engine("vmp", steps=3, seed=3, sharding=plan,
                      device=CPU).fit(_model(tmodels, "lda", docs))
    assert res.elbo_trace == m.elbo_trace
    for n in ("theta", "phi"):
        np.testing.assert_array_equal(res.posteriors[n], m[n].get_result())
    step, s0 = build_infer_step(m.compile(), EngineConfig(
        sharding=plan, seed=3, device=CPU))
    assert s0.posteriors["theta"].shape[0] == 2
    elbos = []
    for _ in range(3):
        s0, e = step(s0)
        elbos.append(float(e))
    assert elbos == m.elbo_trace


def test_distributed_checkpoint_resume_bitwise(docs, tmp_path):
    """A distributed run's checkpoints save the laid-out state (theta
    stacked per shard), and a resumed run ends bitwise at a straight one."""
    plan = tpart.ShardingPlan(2, "inferspark")
    straight = _infer("lda", docs, plan, steps=6)
    ck = str(tmp_path / "ck")
    first = _model(tmodels, "lda", docs)
    first.infer(steps=4, sharding=plan, seed=3, device=CPU,
                checkpoint_every=2, checkpoint_dir=ck)
    again = _model(tmodels, "lda", docs)
    again.infer(steps=2, sharding=plan, seed=3, device=CPU,
                checkpoint_every=2, checkpoint_dir=ck)
    assert first.elbo_trace + again.elbo_trace == straight.elbo_trace
    assert again._state.posteriors["theta"].dim() == 3
    for n in ("theta", "phi"):
        np.testing.assert_array_equal(again[n].get_result(),
                                      straight[n].get_result())


def test_shard_group_sums_in_shard_order():
    g = ShardGroup(3)
    assert g.world_size == 1 and g.local_shards == [0, 1, 2]
    parts = {s: [torch.full((2,), 10.0 ** (8 * s)), torch.tensor(s)]
             for s in range(3)}
    total, idx = g.sum(parts, ["a", "b"])
    want = (parts[0][0] + parts[1][0]) + parts[2][0]
    assert torch.equal(total, want) and int(idx) == 3
    assert g.payload == {"a": 3 * 2 * 4, "b": 3 * 8} and g.calls == 1
    assert g.wire == {} and g.wire_bytes == 0
    with pytest.raises(ValueError, match="shards"):
        g.gather({0: parts[0]}, ["a", "b"])
    with pytest.raises(ValueError, match="keys"):
        g.gather(parts, ["a"])
    with pytest.raises(ValueError, match="strategy"):
        tpart.ShardingPlan(2, "ring")


# ---------------------------------------------------------------------------
# sharded SVI (dist_checks.py's svi_parity, svi_outofcore_parity)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def svi_corpus():
    return JCorpus(n_docs=48, vocab=50, n_topics=4, mean_len=60,
                   seed=5).generate()


def _svi_lda(c):
    m = tmodels.make("lda", alpha=0.1, beta=0.1, K=4, V=50)
    m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
    return m


def test_svi_parity(svi_corpus):
    """Per-shard minibatches, stats summed over 8 shards and local rows
    merged as deltas: within 1e-4 of one device on the same schedule."""
    cfg = SVIConfig(batch_size=16, holdout_frac=0.1, pad_multiple=64, seed=0)
    got = {}
    for key, plan in (("one", None),
                      ("sharded", tpart.ShardingPlan(8, "inferspark"))):
        svi = SVI(_svi_lda(svi_corpus).compile(), cfg, plan=plan, device=CPU)
        got[key] = svi.fit(steps=15)
    (s1, h1), (s8, h8) = got["one"], got["sharded"]
    for n in s1.posteriors:
        a, b = s1.posteriors[n].numpy(), s8.posteriors[n].numpy()
        assert np.max(np.abs(a - b)) / np.max(np.abs(a)) < 1e-4, n
    assert abs(h1["heldout"][-1][1] - h8["heldout"][-1][1]) < 1e-3


def test_svi_outofcore_parity(tmp_path):
    """Out-of-core SVI under a plan (batches sliced from disk shards and
    LPT-packed over the shards) is bitwise the resident run under it."""
    c = JCorpus(n_docs=40, vocab=50, n_topics=4, mean_len=40,
                seed=7).generate()
    store = write_sharded_corpus(c, str(tmp_path / "c"), shard_tokens=400)
    plan = tpart.ShardingPlan(8, "inferspark")
    cfg = SVIConfig(batch_size=8, holdout_frac=0.1, pad_multiple=32, seed=0)
    s_res, h_res = SVI(_svi_lda(c).compile(), cfg, plan=plan,
                       device=CPU).fit(steps=6)
    svi = SVI(tmodels.make("lda", alpha=0.1, beta=0.1, K=4, V=50), cfg,
              plan=plan, corpus=store, device=CPU)
    s_st, h_st = svi.fit(steps=6)
    svi.close()
    assert h_res == h_st
    for n in s_res.posteriors:
        assert torch.equal(s_res.posteriors[n], s_st.posteriors[n]), n


# ---------------------------------------------------------------------------
# against the live reference, in a 2-device child
# ---------------------------------------------------------------------------

_REF_CHILD = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {src!r})
import numpy as np
from repro.compat import make_mesh
from repro.core import models
from repro.core.partition import (ShardingPlan, gather_posterior,
                                  make_distributed_step)
from repro.core.svi import SVI, SVIConfig
from repro.core.vmp import init_state
d = np.load({data!r})
mesh = make_mesh((2,), ("data",))
out = {{}}
m = models.make("lda", alpha=0.1, beta=0.1, K=4, V=40)
m["x"].observe(d["tokens"], segment_ids=d["doc_ids"])
prog = m.compile()
for n, p in init_state(prog, 3).posteriors.items():
    out["init_" + n] = np.asarray(p)
for strat in ("inferspark", "gspmd"):
    step, st = make_distributed_step(prog, ShardingPlan(mesh, ("data",),
                                                        strat), seed=3)
    trace = []
    for _ in range(8):
        st, e = step(st)
        trace.append(float(e))
    out[strat + "_trace"] = np.asarray(trace)
    for n in ("theta", "phi"):
        out[strat + "_" + n] = gather_posterior(step, prog, st, n)
m = models.make("lda", alpha=0.1, beta=0.1, K=4, V=50)
m["x"].observe(d["svi_tokens"], segment_ids=d["svi_doc_ids"])
prog = m.compile()
s0 = init_state(prog, 0)
for n, p in s0.posteriors.items():
    out["svi_init_" + n] = np.array(p)
svi = SVI(prog, SVIConfig(batch_size=16, holdout_frac=0.1, pad_multiple=64,
                          holdout_every=5, seed=0),
          plan=ShardingPlan(mesh, ("data",), "inferspark"))
st, h = svi.fit(steps=10, state=s0)
out["svi_elbo"] = np.asarray(h["elbo"])
out["svi_heldout"] = np.asarray([v for _, v in h["heldout"]])
for n, p in st.posteriors.items():
    out["svi_" + n] = np.asarray(p)
np.savez({out!r}, **out)
print("DONE")
"""


@pytest.fixture(scope="module")
def reference(docs, svi_corpus, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_dist")
    data, out = str(tmp / "data.npz"), str(tmp / "out.npz")
    np.savez(data, tokens=docs["tokens"], doc_ids=docs["doc_ids"],
             svi_tokens=svi_corpus["tokens"],
             svi_doc_ids=svi_corpus["doc_ids"])
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c",
                        _REF_CHILD.format(src=SRC, data=data, out=out)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("strategy", ["inferspark", "gspmd"])
def test_vmp_matches_the_reference(docs, reference, strategy):
    """The reference's 2-device distributed step and the port's 2-shard
    one, from the reference's initial state: ELBO traces within rtol 1e-4,
    gathered posteriors within 2e-4."""
    prog = _model(tmodels, "lda", docs).compile()
    s0 = tvmp.state_from_numpy({n: reference["init_" + n]
                                for n in ("theta", "phi")}, device=CPU)
    step, st = tpart.make_distributed_step(
        prog, tpart.ShardingPlan(2, strategy), device=CPU, state=s0)
    trace = []
    for _ in range(8):
        st, e = step(st)
        trace.append(float(e))
    np.testing.assert_allclose(trace, reference[strategy + "_trace"],
                               rtol=ELBO_RTOL)
    for n in ("theta", "phi"):
        np.testing.assert_allclose(
            tpart.gather_posterior(step, prog, st, n),
            reference[f"{strategy}_{n}"], **XTOL)


def test_sharded_svi_matches_the_reference(svi_corpus, reference):
    """The reference's sharded SVI over a 2-device mesh and the port's over
    a 2-shard plan, from the reference's initial state: batch and held-out
    ELBO within rtol 1e-4, posteriors within 2e-4."""
    s0 = tvmp.state_from_numpy({n: reference["svi_init_" + n]
                                for n in ("theta", "phi")}, device=CPU)
    svi = SVI(_svi_lda(svi_corpus).compile(),
              SVIConfig(batch_size=16, holdout_frac=0.1, pad_multiple=64,
                        holdout_every=5, seed=0),
              plan=tpart.ShardingPlan(2, "inferspark"), device=CPU)
    st, h = svi.fit(steps=10, state=s0)
    np.testing.assert_allclose(h["elbo"], reference["svi_elbo"],
                               rtol=ELBO_RTOL)
    np.testing.assert_allclose([v for _, v in h["heldout"]],
                               reference["svi_heldout"], rtol=ELBO_RTOL)
    for n in ("theta", "phi"):
        np.testing.assert_allclose(st.posteriors[n].numpy(),
                                   reference["svi_" + n], **XTOL)


def test_slice_arrays_is_untouched_by_plans(docs):
    """The sharded batch reuses the resident slicer per shard; only its
    padding moves: masked instances spread over theta's padding rows and
    masked tokens over phi's values, so no owner walks them all."""
    prog = _model(tmodels, "lda", docs).compile()
    groups = np.arange(10)
    plan = tpart.ShardingPlan(2, "inferspark")
    from repro_torch.core import svi as tsvi
    batch, caps, n_tok = tsvi.host_batch(prog, groups, lambda n, v: v + 40,
                                         plan=plan, device=CPU)
    assert sorted(batch["shards"]) == [0, 1]
    assert n_tok == sum(int(np.sum(docs["doc_ids"] == g)) for g in groups)
    for s, b in batch["shards"].items():
        theta = b["dirs"]["theta"]
        part = theta["rows"][theta["mask"] > 0]
        want = tcomp.slice_arrays(prog, part, lambda n, v: caps[n])[0]
        z, x = b["arrays"]["z"], b["arrays"]["x"]
        real = z["mask"] > 0
        np.testing.assert_array_equal(z["mask"], want["z"]["mask"])
        np.testing.assert_array_equal(z["prior_rows"][real],
                                      want["z"]["prior_rows"][real])
        np.testing.assert_array_equal(x["values"][real],
                                      want["x"]["values"][real])
        n_pad, free = int((~real).sum()), np.flatnonzero(theta["mask"] == 0)
        assert n_pad >= 40 and len(free) >= 40
        assert np.isin(z["prior_rows"][~real], free).all()
        per_row = np.bincount(z["prior_rows"][~real])
        per_value = np.bincount(x["values"][~real])
        assert per_row.max() == -(-n_pad // len(free))
        assert per_value.max() == -(-n_pad // prog.dirichlets["phi"].k)


# ---------------------------------------------------------------------------
# full-batch VMP in two processes (gloo) against one
# ---------------------------------------------------------------------------

_VMP_CHILD = """
import sys; sys.path.insert(0, {src!r})
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.core import models
from repro_torch.core.partition import ShardingPlan, make_distributed_step
from repro_torch.launch.dist import init_distributed
if {world} > 1:
    init_distributed("127.0.0.1:{port}", {world}, {rank})
rng = np.random.default_rng(1)
doc_len = rng.integers(10, 80, size=30)
m = models.make("lda", alpha=0.1, beta=0.1, K=4, V=40)
m["x"].observe(rng.integers(0, 40, size=doc_len.sum()).astype(np.int32),
               segment_ids=np.repeat(np.arange(30), doc_len).astype(np.int32))
plan = ShardingPlan(4, {strategy!r})
step, state = make_distributed_step(m.compile(), plan, seed=0, device="cpu")
elbos = []
for _ in range(3):
    state, elbo = step(state)
    elbos.append(float(elbo))
np.savez({out!r}, elbo=np.asarray(elbos, np.float64),
         local=np.asarray(plan.group.local_shards),
         **{{n: p.numpy() for n, p in state.posteriors.items()}})
print("DONE", flush=True)
"""


@pytest.mark.parametrize("strategy", ["inferspark", "gspmd"])
def test_vmp_in_two_processes_is_bitwise_one(strategy, tmp_path):
    """Two gloo ranks, each running its 2 of the plan's 4 shards and
    holding only their rows of theta, give the bits of one process running
    all 4: the shards meet only in the group's ordered sums."""
    import socket
    from repro_torch.testing import faults
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    outs = {r: str(tmp_path / f"r{r}.npz") for r in (0, 1)}
    procs = [faults.spawn_child(_VMP_CHILD.format(
        src=SRC, world=2, port=port, rank=r, strategy=strategy,
        out=outs[r])) for r in (0, 1)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, f"gloo child failed:\n{err[-4000:]}"
    one_out = str(tmp_path / "one.npz")
    one = faults.run_child(_VMP_CHILD.format(
        src=SRC, world=1, port=0, rank=0, strategy=strategy, out=one_out),
        timeout=300)
    assert one.returncode == 0, one.stderr[-4000:]
    whole = np.load(one_out)
    local = strategy == "inferspark"
    for r in (0, 1):
        part = np.load(outs[r])
        np.testing.assert_array_equal(part["local"], [2 * r, 2 * r + 1])
        np.testing.assert_array_equal(part["elbo"], whole["elbo"])
        np.testing.assert_array_equal(part["phi"], whole["phi"])
        want = whole["theta"][2 * r:2 * r + 2] if local else whole["theta"]
        np.testing.assert_array_equal(part["theta"], want)
