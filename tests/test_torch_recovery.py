"""The port's crash safety: the single-host half of the reference's
``tests/test_recovery.py`` rebuilt on ``repro_torch`` — the fault harness,
writer crash recovery at every commit point (a child process SIGKILLed), and
train -> crash -> resume bitwise within the port for resident and growing
corpora, in one process and across a SIGKILLed child — plus sessions across
packages: each package loads the other's, and a reference session resumed
by the port ends within the port's SVI tolerance (``tests/test_torch_svi.py``:
ELBO rtol 1e-4, posteriors rtol = atol = 2e-4) of the reference's
uninterrupted run."""

import dataclasses
import json
import os
import signal
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import models as jmodels
from repro.core.svi import SVI as JSVI, SVIConfig as JSVIConfig
from repro.core.vmp import init_state as j_init
from repro_torch.checkpoint import latest_session_step, load_session
from repro_torch.checkpoint import session as tsession
from repro_torch.core import models
from repro_torch.core import vmp as tvmp
from repro_torch.core.svi import SVI, SVIConfig
from repro_torch.data import ShardedCorpus, ShardedCorpusWriter
from repro_torch.testing import faults

SRC = str(Path(__file__).resolve().parents[1] / "src")
CHILD_TIMEOUT = 240           # seconds: one child interpreter, torch import
#                               and a few CPU steps
LDA = dict(alpha=0.1, beta=0.05, K=3, V=30)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.reset()


@pytest.fixture(scope="module")
def program(small_corpus):
    m = models.make("lda", **LDA)
    m["x"].observe(small_corpus["tokens"], segment_ids=small_corpus["doc_ids"])
    return m.compile()


def _lda():
    return models.make("lda", **LDA)


def _child(code: str) -> str:
    """``code`` for a child interpreter that imports the port from this
    checkout (and nothing of the JAX package)."""
    return f"import sys\nsys.path.insert(0, {SRC!r})\n" + code


# ---------------------------------------------------------------------------
# the fault harness itself
# ---------------------------------------------------------------------------

def test_fault_fires_on_nth_hit_then_stays_fired():
    with faults.inject("t.point", nth=3):
        faults.trip("t.point")
        faults.trip("t.point")
        with pytest.raises(faults.InjectedCrash, match="t.point"):
            faults.trip("t.point")
        faults.trip("t.point")
    faults.trip("t.point")


def test_env_spec_parsing():
    fs = faults._parse_env("a=kill@2, b, c=sleep:0.25")
    assert (fs[0].point, fs[0].action, fs[0].nth) == ("a", "kill", 2)
    assert (fs[1].point, fs[1].action, fs[1].nth) == ("b", "raise", 1)
    assert fs[2].action == "sleep" and fs[2].sleep_s == 0.25
    with pytest.raises(ValueError, match="unknown fault action"):
        faults.Fault("p", "bogus")
    with pytest.raises(ValueError, match="nth"):
        faults.Fault("p", nth=0)
    with pytest.raises(ValueError, match="fn"):
        faults.Fault("p", "call")


def test_same_variable_and_exit_code_as_the_reference():
    from repro.testing import faults as jfaults
    assert (faults.ENV_VAR, faults.EXIT_CODE, faults._ACTIONS) == \
        (jfaults.ENV_VAR, jfaults.EXIT_CODE, jfaults._ACTIONS)


def test_env_armed_child_dies_at_point():
    code = _child("from repro_torch.testing import faults\n"
                  "faults.trip('x.y')\n"
                  "print('SURVIVED')\n")
    r = faults.run_child(code, faults="x.y=exit", timeout=CHILD_TIMEOUT)
    assert r.returncode == faults.EXIT_CODE and "SURVIVED" not in r.stdout
    r = faults.run_child(code, faults="x.y=kill", timeout=CHILD_TIMEOUT)
    assert r.returncode == -signal.SIGKILL
    r = faults.run_child(code, timeout=CHILD_TIMEOUT)
    assert r.returncode == 0 and "SURVIVED" in r.stdout


def test_corruption_helpers(tmp_path):
    p = str(tmp_path / "f.bin")
    with open(p, "wb") as fh:
        fh.write(bytes(range(100)))
    faults.truncate_file(p, 0.5)
    assert os.path.getsize(p) == 50
    faults.truncate_file(p, 10)
    assert os.path.getsize(p) == 10
    faults.flip_byte(p, 3)
    assert open(p, "rb").read()[3] == 3 ^ 0xFF
    faults.flip_byte(p, -1)
    assert open(p, "rb").read()[9] == 9 ^ 0xFF


# ---------------------------------------------------------------------------
# writer crash recovery: a child SIGKILLed at every commit point
# ---------------------------------------------------------------------------

def _writer_data():
    rng = np.random.default_rng(7)
    lengths = rng.integers(3, 9, 40)
    tokens = rng.integers(0, 30, int(lengths.sum())).astype(np.int32)
    return tokens, np.asarray(lengths, np.int64)


_WRITER_CHILD = """
import numpy as np
from repro_torch.data.store import ShardedCorpusWriter
rng = np.random.default_rng(7)
lengths = rng.integers(3, 9, 40)
tokens = rng.integers(0, 30, int(lengths.sum())).astype(np.int32)
offs = np.concatenate([[0], np.cumsum(lengths)])
w = ShardedCorpusWriter({path!r}, shard_tokens=64, vocab=30)
w.add_docs(tokens[:offs[20]], lengths[:20])
w.commit()
print('COMMIT1', flush=True)
w.add_docs(tokens[offs[20]:], lengths[20:])
w.commit()
print('COMMIT2', flush=True)
"""


@pytest.mark.parametrize("point,docs_after_crash", [
    ("store.commit.pre_lengths", 20),
    ("store.commit.pre_manifest", 20),
    ("store.commit.post_manifest", 40),
])
def test_commit_crash_point_leaves_consistent_prefix(tmp_path, point,
                                                     docs_after_crash):
    path = str(tmp_path / "c")
    r = faults.run_child(_child(_WRITER_CHILD.format(path=path)),
                         faults=f"{point}=kill@2", timeout=CHILD_TIMEOUT)
    assert r.returncode == -signal.SIGKILL, r.stderr
    assert "COMMIT1" in r.stdout and "COMMIT2" not in r.stdout

    tokens, lengths = _writer_data()
    offs = np.concatenate([[0], np.cumsum(lengths)])
    sc = ShardedCorpus.open(path)
    assert sc.n_docs == docs_after_crash
    np.testing.assert_array_equal(sc.resident()["tokens"],
                                  tokens[:offs[docs_after_crash]])
    w = ShardedCorpusWriter.reopen(path)
    if docs_after_crash < 40:
        w.add_docs(tokens[offs[docs_after_crash]:],
                   lengths[docs_after_crash:])
    full = w.close()
    assert full.n_docs == 40
    np.testing.assert_array_equal(full.resident()["tokens"], tokens)
    np.testing.assert_array_equal(full.lengths, lengths)
    assert sc.refresh() is (docs_after_crash < 40)
    assert sc.n_docs == 40


def test_reopen_cleans_torn_uncommitted_shard(tmp_path):
    path = str(tmp_path / "c")
    tokens, lengths = _writer_data()
    offs = np.concatenate([[0], np.cumsum(lengths)])
    w = ShardedCorpusWriter(path, shard_tokens=64, vocab=30)
    w.add_docs(tokens[:offs[20]], lengths[:20])
    w.commit()
    with open(os.path.join(path, "manifest.json")) as fh:
        committed = {s["path"] for s in json.load(fh)["shards"]}

    def tear():
        orphans = sorted(n for n in os.listdir(path)
                         if n.startswith("shard-") and n.endswith(".npy")
                         and n not in committed)
        faults.truncate_file(os.path.join(path, orphans[-1]), 0.5)
        raise faults.InjectedCrash("torn mid-flush")

    with faults.inject("store.flush.post_shard", action="call", fn=tear):
        with pytest.raises(faults.InjectedCrash):
            w.add_docs(tokens[offs[20]:], lengths[20:])
            w.commit()
    assert ShardedCorpus.open(path).n_docs == 20
    w2 = ShardedCorpusWriter.reopen(path)
    assert not [n for n in os.listdir(path)
                if n.startswith("shard-") and n not in committed]
    w2.add_docs(tokens[offs[20]:], lengths[20:])
    full = w2.close()
    np.testing.assert_array_equal(full.resident()["tokens"], tokens)
    np.testing.assert_array_equal(full.lengths, lengths)


def test_reopen_continues_shard_numbering_and_counters(tmp_path):
    path = str(tmp_path / "c")
    tokens, lengths = _writer_data()
    offs = np.concatenate([[0], np.cumsum(lengths)])
    w = ShardedCorpusWriter(path, shard_tokens=64, vocab=30)
    w.add_docs(tokens[:offs[20]], lengths[:20])
    n_before = len(w.commit().manifest["shards"])
    w2 = ShardedCorpusWriter.reopen(path)
    w2.add_docs(tokens[offs[20]:], lengths[20:])
    full = w2.close()
    assert full.manifest["commit"] == 2
    names = [s["path"] for s in full.manifest["shards"]]
    assert names == sorted(set(names)) and len(names) > n_before
    ref_path = str(tmp_path / "ref")
    ShardedCorpusWriter(ref_path, shard_tokens=64, vocab=30) \
        .add_docs(tokens, lengths).close()
    np.testing.assert_array_equal(
        full.resident()["tokens"],
        ShardedCorpus.open(ref_path).resident()["tokens"])


def test_reopen_without_manifest_clears_strays(tmp_path):
    path = str(tmp_path / "c")
    os.makedirs(path)
    np.save(os.path.join(path, "shard-00000.npy"),
            np.arange(5, dtype=np.int32))
    with open(os.path.join(path, "lengths.npy.tmp"), "wb") as fh:
        fh.write(b"torn")
    w = ShardedCorpusWriter.reopen(path, shard_tokens=64, vocab=30)
    assert os.listdir(path) == []
    tokens, lengths = _writer_data()
    assert w.add_docs(tokens, lengths).close().n_docs == 40


# ---------------------------------------------------------------------------
# SVI sessions: train -> crash -> resume is bitwise (resident corpus)
# ---------------------------------------------------------------------------

def _resident_cfg(**kw):
    return SVIConfig(batch_size=12, holdout_frac=0.1, holdout_every=3,
                     seed=0, **kw)


def _svi(program, cfg=None):
    return SVI(program, cfg or _resident_cfg(), device="cpu")


def _assert_states_equal(state, ref_state):
    assert int(state.step) == int(ref_state.step)
    for n, v in ref_state.posteriors.items():
        assert torch.equal(state.posteriors[n], v), n


def test_svi_crash_resume_is_bitwise(program, tmp_path):
    d = str(tmp_path / "ck")
    ref_state, ref_hist = _svi(program).fit(steps=10)
    with faults.inject("svi.step", nth=7):
        with pytest.raises(faults.InjectedCrash):
            _svi(program).fit(steps=10, checkpoint_dir=d, checkpoint_every=2)
    assert latest_session_step(d) == 6
    state, hist = _svi(program).fit(steps=4, checkpoint_dir=d,
                                    resume_from=True)
    _assert_states_equal(state, ref_state)
    assert hist["elbo"] == ref_hist["elbo"]
    assert hist["heldout"] == ref_hist["heldout"]


def test_resume_falls_back_past_corrupt_newest_session(program, tmp_path):
    d = str(tmp_path / "ck")
    ref_state, _ = _svi(program).fit(steps=10)
    with faults.inject("svi.step", nth=7):
        with pytest.raises(faults.InjectedCrash):
            _svi(program).fit(steps=10, checkpoint_dir=d, checkpoint_every=2)
    newest = os.path.join(d, "step_%010d.npz" % 6)
    faults.flip_byte(newest, os.path.getsize(newest) // 2)
    with pytest.warns(RuntimeWarning, match="falling back"):
        state, _ = _svi(program).fit(steps=6, checkpoint_dir=d,
                                     resume_from=True)
    _assert_states_equal(state, ref_state)


def test_resume_refuses_mismatched_fingerprint(program, tmp_path):
    d = str(tmp_path / "ck")
    _svi(program).fit(steps=4, checkpoint_dir=d, checkpoint_every=2)
    other = _svi(program, dataclasses.replace(_resident_cfg(), seed=1,
                                              kappa=0.9))
    with pytest.raises(ValueError, match="seed.*|kappa.*"):
        other.fit(steps=4, checkpoint_dir=d, resume_from=True)


def test_resume_argument_contract(program, tmp_path):
    svi = _svi(program)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        svi.fit(steps=1, resume_from=True)
    with pytest.raises(FileNotFoundError):
        svi.fit(steps=1, resume_from=str(tmp_path / "nowhere"))
    d = str(tmp_path / "ck")
    state, _ = svi.fit(steps=2, checkpoint_dir=d, resume_from=True)
    assert int(state.step) == 2
    with pytest.raises(ValueError, match="not both"):
        svi.fit(steps=1, state=state, checkpoint_dir=d, resume_from=True)


@pytest.mark.parametrize("elog_dtype,name", [
    (None, ""), ("float32", "float32"), ("bfloat16", "bfloat16"),
    (torch.bfloat16, "bfloat16")])
def test_fingerprint_matches_the_reference(program, small_corpus, elog_dtype,
                                           name):
    """The same model and config give the reference's fingerprint, key for
    key (the dtype named without ``ml_dtypes``)."""
    import ml_dtypes
    from repro.checkpoint.session import session_fingerprint as j_fp
    jm = jmodels.make("lda", **LDA)
    jm["x"].observe(small_corpus["tokens"],
                    segment_ids=small_corpus["doc_ids"])
    j_dtype = (np.dtype(ml_dtypes.bfloat16) if name == "bfloat16"
               else elog_dtype)
    want = j_fp(jm.compile(), JSVIConfig(elog_dtype=j_dtype, seed=3), 12)
    got = tsession.session_fingerprint(
        program, SVIConfig(elog_dtype=elog_dtype, seed=3), 12)
    assert got == want and got["elog_dtype"] == name


_SVI_CHILD = """
from repro_torch.data import SyntheticCorpus
from repro_torch.core import models
from repro_torch.core.svi import SVI, SVIConfig
c = SyntheticCorpus(n_docs=50, vocab=30, n_topics=3, mean_len=60,
                    seed=0).generate()
m = models.make("lda", alpha=0.1, beta=0.05, K=3, V=30)
m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
svi = SVI(m.compile(), SVIConfig(batch_size=12, holdout_frac=0.1,
                                 holdout_every=3, seed=0), device="cpu")
svi.fit(steps=10, checkpoint_dir={d!r}, checkpoint_every=2,
        callback=lambda t, e: print(f"STEP {{t}}", flush=True))
print("DONE", flush=True)
"""


def test_subprocess_sigkill_resume_matches_uninterrupted(program, tmp_path):
    """A child SIGKILLed by its own armed fault entering step 7 (no
    unwinding, no flushes); a fresh SVI here resumes from its newest valid
    session and ends bitwise at the uninterrupted run."""
    d = str(tmp_path / "ck")
    r = faults.run_child(_child(_SVI_CHILD.format(d=d)),
                         faults="svi.step=kill@8", timeout=CHILD_TIMEOUT)
    assert r.returncode == -signal.SIGKILL, r.stderr
    assert "STEP 6" in r.stdout and "STEP 7" not in r.stdout
    step = latest_session_step(d)
    assert step is not None and 2 <= step <= 6

    ref_state, ref_hist = _svi(program).fit(steps=10)
    state, hist = _svi(program).fit(steps=10 - step, checkpoint_dir=d,
                                    resume_from=True)
    _assert_states_equal(state, ref_state)
    assert hist["elbo"] == ref_hist["elbo"]


# ---------------------------------------------------------------------------
# SVI sessions: growing corpus (epoch snapshots + holdout carry over)
# ---------------------------------------------------------------------------

def _grow_cfg():
    # prefetch off: epoch snapshots land at step granularity, so the crash
    # run and the uninterrupted reference see appends at identical epochs
    return SVIConfig(batch_size=10, holdout_frac=0.1, holdout_every=4,
                     pad_multiple=64, seed=0, growing=True,
                     capacity_docs=64, prefetch=False)


def _offsets(corpus):
    return np.concatenate([[0], np.cumsum(corpus["lengths"])])


def _write_prefix(corpus, path, n_docs):
    offs = _offsets(corpus)
    w = ShardedCorpusWriter(str(path), shard_tokens=500, vocab=30)
    w.add_docs(corpus["tokens"][:offs[n_docs]], corpus["lengths"][:n_docs])
    return w, w.commit()


def _append_rest(w, corpus, n_done):
    offs = _offsets(corpus)
    w.add_docs(corpus["tokens"][offs[n_done]:], corpus["lengths"][n_done:])
    w.close()


def test_growing_crash_resume_is_bitwise(small_corpus, tmp_path):
    """fit -> append -> fit with a crash inside the second fit: a new SVI
    over the reopened, grown corpus replays the saved epoch snapshots and
    held-out split and ends bitwise at the uninterrupted run."""
    w, sc = _write_prefix(small_corpus, tmp_path / "ref", 30)
    svi = SVI(_lda(), _grow_cfg(), corpus=sc, device="cpu")
    state, _ = svi.fit(steps=6)
    _append_rest(w, small_corpus, 30)
    ref_state, h2 = svi.fit(steps=9, state=state)
    svi.close()

    w2, sc2 = _write_prefix(small_corpus, tmp_path / "crash", 30)
    d = str(tmp_path / "ck")
    svi1 = SVI(_lda(), _grow_cfg(), corpus=sc2, device="cpu")
    state1, _ = svi1.fit(steps=6, checkpoint_dir=d, checkpoint_every=2)
    _append_rest(w2, small_corpus, 30)
    with faults.inject("svi.step", nth=4):
        with pytest.raises(faults.InjectedCrash):
            svi1.fit(steps=9, state=state1, checkpoint_dir=d,
                     checkpoint_every=2)
    svi1.close()
    assert latest_session_step(d) == 8
    sizes = [len(g) for _, g in load_session(d).epochs]
    assert sizes[-1] > sizes[0]                  # the growth rides along

    svi2 = SVI(_lda(), _grow_cfg(),
               corpus=ShardedCorpus.open(str(tmp_path / "crash")),
               device="cpu")
    state2, hist = svi2.fit(steps=7, checkpoint_dir=d, resume_from=True)
    svi2.close()
    _assert_states_equal(state2, ref_state)
    assert hist["elbo"] == h2["elbo"]
    assert hist["heldout"] == h2["heldout"]


def test_growing_resume_refuses_shrunk_corpus(small_corpus, tmp_path):
    w, sc = _write_prefix(small_corpus, tmp_path / "a", 30)
    d = str(tmp_path / "ck")
    svi = SVI(_lda(), _grow_cfg(), corpus=sc, device="cpu")
    svi.fit(steps=3, checkpoint_dir=d, checkpoint_every=1)
    svi.close()
    w.close()
    _, small = _write_prefix(small_corpus, tmp_path / "b", 20)
    svi2 = SVI(_lda(), _grow_cfg(), corpus=small, device="cpu")
    with pytest.raises(ValueError, match="append-only|shrink|20"):
        svi2.fit(steps=3, checkpoint_dir=d, resume_from=True)
    svi2.close()


# ---------------------------------------------------------------------------
# the engine's resume budget
# ---------------------------------------------------------------------------

def test_engine_resume_budget_semantics(small_corpus, tmp_path):
    """EngineConfig(resume=True): ``steps`` is the total budget, and a
    relaunch lands on the uninterrupted run's result bitwise."""
    from repro_torch.core import make_engine
    m = _lda()
    m["x"].observe(small_corpus["tokens"],
                   segment_ids=small_corpus["doc_ids"])
    kw = dict(batch_size=16, seed=0, device="cpu")
    ref = make_engine("svi", steps=10, **kw).fit(m)
    d = str(tmp_path / "ck")
    r1 = make_engine("svi", steps=4, checkpoint_dir=d, checkpoint_every=2,
                     **kw).fit(m)
    assert r1.meta["resumed_from_step"] is None
    r2 = make_engine("svi", steps=10, checkpoint_dir=d, checkpoint_every=2,
                     resume=True, **kw).fit(m)
    assert r2.meta["resumed_from_step"] == 4
    assert r2.elbo_trace == ref.elbo_trace
    for n in ref.posteriors:
        np.testing.assert_array_equal(r2.posteriors[n], ref.posteriors[n])
    r3 = make_engine("svi", steps=10, checkpoint_dir=d, checkpoint_every=2,
                     resume=True, **kw).fit(m)
    assert r3.meta["resumed_from_step"] == 10
    assert r3.elbo_trace == ref.elbo_trace
    with pytest.raises(ValueError, match="checkpoint_dir"):
        make_engine("svi", steps=2, resume=True, **kw).fit(m)


# ---------------------------------------------------------------------------
# sessions across packages
# ---------------------------------------------------------------------------

def _j_program(corpus):
    jm = jmodels.make("lda", **LDA)
    jm["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    return jm.compile()


def _j_cfg():
    return JSVIConfig(batch_size=12, holdout_frac=0.1, holdout_every=3,
                      seed=0)


def test_reference_session_resumes_in_the_port(program, small_corpus,
                                               tmp_path):
    """The reference checkpoints 6 steps of a 10-step fit; the port loads
    its session (same fingerprint, holdout and history) and finishes the
    fit within tolerance of the reference's uninterrupted run."""
    jprog = _j_program(small_corpus)
    d = str(tmp_path / "ck")
    j_ref_state, j_ref_hist = JSVI(jprog, _j_cfg()).fit(steps=10)
    JSVI(jprog, _j_cfg()).fit(steps=6, checkpoint_dir=d, checkpoint_every=3)
    sess = load_session(d)
    assert sess.t == 6 and sess.corpus is None
    svi = _svi(program)
    assert sess.fingerprint == svi._fingerprint()
    np.testing.assert_array_equal(sess.holdout, svi.holdout)
    state, hist = svi.fit(steps=4, checkpoint_dir=d, resume_from=True)
    assert int(state.step) == 10
    assert hist["elbo"][:6] == j_ref_hist["elbo"][:6]    # carried over
    np.testing.assert_allclose(hist["elbo"], j_ref_hist["elbo"], rtol=1e-4)
    np.testing.assert_allclose([v for _, v in hist["heldout"]],
                               [v for _, v in j_ref_hist["heldout"]],
                               rtol=1e-4)
    for n, p in j_ref_state.posteriors.items():
        np.testing.assert_allclose(state.posteriors[n].numpy(),
                                   np.asarray(p), rtol=2e-4, atol=2e-4,
                                   err_msg=n)


def test_port_session_loads_in_the_reference(program, small_corpus,
                                             tmp_path):
    """The reference's ``load_session`` reads the port's session exactly,
    and its raw checkpoint restores into a dict ``tree_like``."""
    d = str(tmp_path / "ck")
    s0 = j_init(_j_program(small_corpus), 0)
    posts0 = {n: np.asarray(p) for n, p in s0.posteriors.items()}
    state, hist = _svi(program).fit(
        steps=4, state=tvmp.state_from_numpy(posts0, 0, "cpu"),
        checkpoint_dir=d, checkpoint_every=2)
    from repro.checkpoint.session import load_session as j_load
    js = j_load(d)
    assert js.t == 4 and js.history == hist
    assert js.fingerprint == _svi(program)._fingerprint()
    for n, p in state.posteriors.items():
        np.testing.assert_array_equal(js.posteriors[n], p.numpy())
    tree = jckpt.restore(d, {"posteriors": {"phi": 0, "theta": 0},
                             "elbo": 0, "heldout_t": 0, "heldout_v": 0,
                             "epoch_starts": 0, "epoch_sizes": 0,
                             "epoch_groups": 0, "holdout": 0})
    np.testing.assert_array_equal(tree["elbo"], np.asarray(hist["elbo"]))
    # and the reference resumes it, within tolerance of the port's own run
    j_state, j_hist = JSVI(_j_program(small_corpus), _j_cfg()).fit(
        steps=6, checkpoint_dir=d, resume_from=True)
    t_state, t_hist = _svi(program).fit(
        steps=10, state=tvmp.state_from_numpy(posts0, 0, "cpu"))
    np.testing.assert_allclose(j_hist["elbo"], t_hist["elbo"], rtol=1e-4)
    for n, p in t_state.posteriors.items():
        np.testing.assert_allclose(np.asarray(j_state.posteriors[n]),
                                   p.numpy(), rtol=2e-4, atol=2e-4,
                                   err_msg=n)
