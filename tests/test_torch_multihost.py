"""Multi-host SVI over a partitioned corpus on the port, held to the
reference (``tests/test_multihost.py`` on ``repro_torch``).

Three rings, inside out:

- **In-process**: the shard-ownership map (rendezvous hashing, equal to
  the reference's element for element) and the host-view I/O fence a
  ``ShardedCorpus`` enforces.
- **Virtual hosts** (one process): ``hosts=`` with an unrestricted corpus
  partitions minibatches by document ownership over the plan's shards —
  ``n_hosts=1`` is bitwise the plain plan path, ``n_hosts=2`` within 5e-4
  of it (the reference's bound), and within rtol 1e-4 / 2e-4 (the VMP
  parity tolerances) of the reference's own 2-virtual-host run from the
  same initial state, which runs in a child with 2 fake devices.
- **Real multi-process** (``torch.distributed`` children over gloo,
  spawned through ``repro_torch.testing.faults``): a 2-process run must be
  *bitwise* the single-process 2-virtual-host run — the shard group sums
  every shard's stats in shard order in both.  Crash-resume is bitwise;
  a resume on a new topology carries the history over bitwise.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from repro.data import store as jstore
from repro_torch.core import models
from repro_torch.core import vmp as tvmp
from repro_torch.core.partition import (ShardingPlan,
                                        collective_bytes_per_iteration)
from repro_torch.core.svi import SVI, SVIConfig
from repro_torch.data import (HostAssignment, ShardedCorpus, SyntheticCorpus,
                              doc_ownership, shard_ownership,
                              sharded_template, write_sharded_corpus)
from repro_torch.launch import dist
from repro_torch.testing import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
CHILD_TIMEOUT = 300
LDA = dict(alpha=0.1, beta=0.05, K=3, V=30)
SESSION = dict(backend="svi", batch_size=12, holdout_frac=0.1,
               holdout_every=4, seed=0, device="cpu")


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """A planted-topic corpus written as ~8 on-disk shards, shared with
    child interpreters by path."""
    path = tmp_path_factory.mktemp("mh_shards")
    corpus = SyntheticCorpus(n_docs=60, vocab=30, n_topics=3, mean_len=50,
                             seed=0).generate()
    store = write_sharded_corpus(corpus, str(path), shard_tokens=400)
    assert store.n_shards >= 4
    return str(path)


# ---------------------------------------------------------------------------
# ownership map (in-process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards,n_hosts,seed", [
    (40, 4, 3), (64, 3, 0), (64, 4, 0), (9, 2, 7), (5, 1, 0), (0, 2, 0)])
def test_ownership_is_the_reference(n_shards, n_hosts, seed):
    np.testing.assert_array_equal(
        shard_ownership(n_shards, n_hosts, seed),
        jstore.shard_ownership(n_shards, n_hosts, seed))


def test_ownership_exactly_one_owner_and_deterministic():
    own = shard_ownership(40, 4, seed=3)
    assert own.shape == (40,) and own.dtype == np.int32
    assert own.min() >= 0 and own.max() < 4
    np.testing.assert_array_equal(own, shard_ownership(40, 4, seed=3))
    assert set(np.unique(own)) == {0, 1, 2, 3}
    assert not np.array_equal(own, shard_ownership(40, 4, seed=4))


def test_ownership_minimal_movement_on_join_and_leave():
    before = shard_ownership(64, 3, seed=0)
    after = shard_ownership(64, 4, seed=0)
    moved = np.flatnonzero(before != after)
    # a join steals shards only FOR the new host
    assert len(moved) and np.all(after[moved] == 3)
    np.testing.assert_array_equal(shard_ownership(64, 3, seed=0), before)


def test_doc_ownership_expands_shard_ranges(corpus_dir):
    sc = ShardedCorpus.open(corpus_dir)
    own = shard_ownership(sc.n_shards, 2, seed=0)
    docs = doc_ownership(sc.manifest, 2, seed=0)
    np.testing.assert_array_equal(
        docs, jstore.doc_ownership(sc.manifest, 2, seed=0))
    for sid, s in enumerate(sc.manifest["shards"]):
        np.testing.assert_array_equal(
            docs[s["doc_start"]:s["doc_end"]], own[sid])


# ---------------------------------------------------------------------------
# host view: the I/O fence (in-process)
# ---------------------------------------------------------------------------

def test_host_view_partitions_io(corpus_dir):
    views = [ShardedCorpus.open(corpus_dir, hosts=HostAssignment(2, h))
             for h in (0, 1)]
    want = [jstore.ShardedCorpus.open(corpus_dir,
                                      hosts=jstore.HostAssignment(2, h))
            for h in (0, 1)]
    for v, w in zip(views, want):
        np.testing.assert_array_equal(v.owned_doc_ids(), w.owned_doc_ids())
        np.testing.assert_array_equal(v.owned_shards(), w.owned_shards())
        assert v.owned_disk_bytes == w.owned_disk_bytes
    all_docs = np.sort(np.concatenate([v.owned_doc_ids() for v in views]))
    np.testing.assert_array_equal(all_docs, np.arange(views[0].n_docs))
    assert sum(v.owned_disk_bytes for v in views) == views[0].disk_bytes
    v0 = views[0]
    mine = v0.owned_doc_ids()[:4]
    ref = ShardedCorpus.open(corpus_dir)
    np.testing.assert_array_equal(v0.gather_tokens(mine),
                                  ref.gather_tokens(mine))
    alien = views[1].owned_doc_ids()[:3]
    with pytest.raises(PermissionError, match="host 0"):
        v0.gather_tokens(alien)
    with pytest.raises(PermissionError, match="owned by host 1"):
        v0._mmap(int(views[1].owned_shards()[0]))
    assert v0.n_docs == ref.n_docs and v0.n_tokens == ref.n_tokens
    np.testing.assert_array_equal(v0.lengths, ref.lengths)


def test_sharded_template_reads_through_host_view(corpus_dir):
    view = ShardedCorpus.open(corpus_dir, hosts=HostAssignment(3, 2))
    prog = sharded_template(models.make("lda", **LDA), view)
    assert prog.meta.get("pstar_size") == view.n_docs


def test_svi_host_config_validation(corpus_dir):
    lda = models.make("lda", **LDA)
    with pytest.raises(ValueError, match="corpus"):
        SVI(lda, SVIConfig(batch_size=8), hosts=HostAssignment(1, 0),
            device="cpu")
    plan = ShardingPlan(1, "inferspark")
    view = ShardedCorpus.open(corpus_dir, hosts=HostAssignment(2, 0))
    with pytest.raises(ValueError, match="virtual"):
        SVI(lda, SVIConfig(batch_size=8), plan=plan, corpus=view,
            hosts=HostAssignment(2, 0), device="cpu")
    with pytest.raises(ValueError, match="split evenly"):
        SVI(lda, SVIConfig(batch_size=8), plan=ShardingPlan(3),
            corpus=ShardedCorpus.open(corpus_dir),
            hosts=HostAssignment(2, 0), device="cpu")
    with pytest.raises(NotImplementedError, match="single-host"):
        SVI(lda, SVIConfig(batch_size=8, growing=True, capacity_docs=80),
            plan=plan, corpus=ShardedCorpus.open(corpus_dir),
            hosts=HostAssignment(1, 0), device="cpu")


def test_the_group_refuses_nccl():
    with pytest.raises(ValueError, match="gloo"):
        dist.init_distributed("127.0.0.1:1", 2, 0, backend="nccl")
    assert dist.process_count() == 1 and dist.process_index() == 0


# ---------------------------------------------------------------------------
# virtual hosts (one process)
# ---------------------------------------------------------------------------

_CFG = SVIConfig(batch_size=12, holdout_frac=0.1, holdout_every=4,
                 pad_multiple=64, seed=0)


def _run(corpus_dir, hosts, steps=8, state=None):
    svi = SVI(models.make("lda", **LDA), _CFG, plan=ShardingPlan(2),
              corpus=ShardedCorpus.open(corpus_dir), hosts=hosts,
              device="cpu")
    s, h = svi.fit(steps=steps, state=state)
    svi.close()
    return {n: v.numpy() for n, v in s.posteriors.items()}, h


def test_virtual_hosts_vs_plain_plan(corpus_dir):
    """n_hosts=1 over a 2-shard plan is bitwise the plain plan path (same
    LPT packing, same sums); n_hosts=2 repartitions by document ownership,
    so it agrees to float-reassociation tolerance only (5e-4, the
    reference's bound).  The held-out score of a hosts run is summed per
    shard, so it is held to tolerance too, as in the reference."""
    p_plain, h_plain = _run(corpus_dir, None)
    p_v1, h_v1 = _run(corpus_dir, HostAssignment(1, 0))
    for n in p_plain:
        np.testing.assert_array_equal(p_plain[n], p_v1[n])
    assert h_plain["elbo"] == h_v1["elbo"]
    np.testing.assert_allclose([v for _, v in h_v1["heldout"]],
                               [v for _, v in h_plain["heldout"]], rtol=1e-5)
    p_v2, h_v2 = _run(corpus_dir, HostAssignment(2, 0))
    for n in p_plain:
        np.testing.assert_allclose(p_plain[n], p_v2[n], rtol=5e-4, atol=5e-4)
    assert len(h_v2["elbo"]) == 8
    assert all(np.isfinite(v) for _, v in h_v2["heldout"])


_REF_VIRTUAL = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, {src!r})
import numpy as np
from repro.compat import make_mesh
from repro.core import models
from repro.core.partition import ShardingPlan
from repro.core.svi import SVI, SVIConfig
from repro.core.vmp import init_state
from repro.data import HostAssignment, ShardedCorpus
svi = SVI(models.make("lda", alpha=0.1, beta=0.05, K=3, V=30),
          SVIConfig(batch_size=12, holdout_frac=0.1, holdout_every=4,
                    pad_multiple=64, seed=0),
          plan=ShardingPlan(make_mesh((2,), ("data",)), ("data",),
                            "inferspark"),
          corpus=ShardedCorpus.open({corpus!r}), hosts=HostAssignment(2, 0))
s0 = init_state(svi.program, 0)
init = {{"init_" + n: np.array(p) for n, p in s0.posteriors.items()}}
s, h = svi.fit(steps=8, state=s0)      # donates s0's buffers
svi.close()
np.savez({out!r}, elbo=np.asarray(h["elbo"]),
         heldout=np.asarray([v for _, v in h["heldout"]]), **init,
         **{{n: np.asarray(p) for n, p in s.posteriors.items()}})
print("DONE")
"""


def test_two_virtual_hosts_match_the_reference(corpus_dir, tmp_path):
    """The reference's 2-virtual-host run (2 fake devices, in a child) and
    the port's over a 2-shard plan, from the reference's initial state:
    batch and held-out ELBO within rtol 1e-4, posteriors within 2e-4."""
    out = str(tmp_path / "ref.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _REF_VIRTUAL.format(
        src=SRC, corpus=corpus_dir, out=out)], capture_output=True,
        text=True, timeout=600, env=env)
    assert r.returncode == 0 and "DONE" in r.stdout, r.stderr[-4000:]
    ref = np.load(out)
    s0 = tvmp.state_from_numpy({n: ref["init_" + n] for n in ("theta", "phi")},
                               device="cpu")
    posts, h = _run(corpus_dir, HostAssignment(2, 0), state=s0)
    np.testing.assert_allclose(h["elbo"], ref["elbo"], rtol=1e-4)
    np.testing.assert_allclose([v for _, v in h["heldout"]], ref["heldout"],
                               rtol=1e-4)
    for n in posts:
        np.testing.assert_allclose(posts[n], ref[n], rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# real multi-process runs (torch.distributed over gloo)
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reap(proc) -> str:
    """Drain a spawned child's remaining output and wait; returns stderr."""
    try:
        _, err = proc.communicate(timeout=CHILD_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        _, err = proc.communicate()
    return err or ""


_SESSION = """
import sys; sys.path.insert(0, {src!r})
import numpy as np
from repro_torch.core import models
from repro_torch.launch.elastic import multihost_svi_session
res = multihost_svi_session(
    models.make("lda", alpha=0.1, beta=0.05, K=3, V=30),
    dict({engine!r}, steps={steps}), {corpus!r}, {ckpt!r},
    n_hosts={n_hosts}, **{join!r})
print("RESUMED", res.meta["resumed_from_step"])
print("WIRE", res.meta["group"]["wire"].get("phi", 0))
if {save!r}:
    np.savez({out!r}, elbo=np.asarray(res.elbo_trace, np.float64),
             heldout=np.asarray([v for _, v in res.heldout_trace],
                                np.float64), **res.posteriors)
print("DONE")
"""


def _session(corpus_dir, out, steps=8, ckpt=None, n_hosts=2, join=None,
             save=True, engine=None):
    return _SESSION.format(src=SRC, corpus=corpus_dir, out=out, steps=steps,
                           ckpt=ckpt, n_hosts=n_hosts, join=join or {},
                           save=save, engine=engine or SESSION)


def _virtual(corpus_dir, out, **kw):
    r = faults.run_child(_session(corpus_dir, out, **kw),
                         timeout=CHILD_TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    return r


def _assert_npz_bitwise(a, b):
    a, b = np.load(a), np.load(b)
    assert set(a.files) == set(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_process_bitwise_equals_virtual(corpus_dir, tmp_path):
    """The headline: a real 2-process run (one shard a host, each opening
    the corpus through its own host view, stats all-gathered over gloo and
    summed in shard order) equals one process with 2 virtual hosts bit for
    bit: ELBO trace, held-out trace and final posteriors.  Each step moves
    phi's stats over the wire as ``collective_bytes_per_iteration`` counts
    them (sent and received at 2 ranks: twice the (K, V) stats); the
    virtual hosts move none."""
    from repro_torch.checkpoint import load_session
    port = _free_port()
    out2 = str(tmp_path / "two_proc.npz")
    ck = str(tmp_path / "ck")             # rank 0 is the one writer
    procs = [faults.spawn_child(_session(
        corpus_dir, out2, ckpt=ck, engine=dict(SESSION, checkpoint_every=4),
        join=dict(host_id=pid, coordinator=f"127.0.0.1:{port}"),
        save=pid == 0)) for pid in (0, 1)]
    wire = []
    for p in procs:
        done = faults.wait_for_marker(p, "RESUMED", timeout=CHILD_TIMEOUT)
        line = p.stdout.readline() if done else ""
        done = done and faults.wait_for_marker(p, "DONE",
                                               timeout=CHILD_TIMEOUT)
        err = _reap(p)
        assert done and p.returncode == 0, \
            f"2-process SVI child failed:\n{err[-4000:]}"
        wire.append(int(line.split()[1]))
    out1 = str(tmp_path / "virtual.npz")
    r = _virtual(corpus_dir, out1)
    _assert_npz_bitwise(out2, out1)
    phi = collective_bytes_per_iteration(sharded_template(
        models.make("lda", **LDA), ShardedCorpus.open(corpus_dir)),
        ShardingPlan(2))["phi"]
    assert phi == 2 * 3 * 30 * 4
    assert wire == [8 * phi] * 2 and "WIRE 0" in r.stdout
    sess, got = load_session(ck), np.load(out2)
    assert sess.t == 8 and list(sess.history["elbo"]) == list(got["elbo"])
    for n, v in sess.posteriors.items():
        np.testing.assert_array_equal(v, got[n])


_GROUP = """
import sys; sys.path.insert(0, {src!r})
import torch
from repro_torch.launch.dist import ShardGroup, init_distributed
init_distributed("127.0.0.1:{port}", 2, {pid})
g = ShardGroup(4)
assert g.world_size == 2 and g.local_shards == [2 * {pid}, 2 * {pid} + 1]
parts = {{s: [torch.full((3,), 10.0 ** (7 * s)), torch.tensor([s, -s])]
         for s in g.local_shards}}
got = g.gather(parts, ["a", "b"])
assert [int(x[1][0]) for x in got] == [0, 1, 2, 3]
total, idx = g.sum(parts, ["a", "b"])
want = torch.full((3,), 1.0)
for s in range(1, 4):
    want = want + torch.full((3,), 10.0 ** (7 * s))
assert torch.equal(total, want) and idx.tolist() == [6, -6], (total, idx)
# two exchanges of every shard's payload; over the wire each rank sends
# its 2 shards' block and receives the other rank's, each piece 8-byte
# aligned (12 -> 16)
assert g.payload == {{"a": 2 * 4 * 3 * 4, "b": 2 * 4 * 2 * 8}}, g.payload
assert g.wire == {{"a": 2 * 2 * 2 * 16, "b": 2 * 2 * 2 * 16}}, g.wire
print("GROUP OK")
"""


def test_shard_group_gathers_across_processes():
    """Two gloo ranks of 2 shards each: ``gather`` returns all 4 shards'
    tensors in shard order on each rank, ``sum`` adds them in shard order
    (bitwise the one-process order); ``payload`` counts every shard's
    tensors and ``wire`` the bytes each rank sent and received."""
    port = _free_port()
    procs = [faults.spawn_child(_GROUP.format(src=SRC, port=port, pid=pid))
             for pid in (0, 1)]
    for p in procs:
        ok = faults.wait_for_marker(p, "GROUP OK", timeout=CHILD_TIMEOUT)
        err = _reap(p)
        assert ok and p.returncode == 0, err[-4000:]


# ---------------------------------------------------------------------------
# elastic: crash resume and topology change (virtual hosts + sessions)
# ---------------------------------------------------------------------------

def test_crash_resume_bitwise_same_topology(corpus_dir, tmp_path):
    """Kill a 2-virtual-host session entering step 5 (``svi.step=kill@6``);
    relaunching with the same topology resumes from the newest valid
    session and finishes bitwise-identical to a run that never crashed."""
    engine = dict(SESSION, checkpoint_every=2)
    straight = str(tmp_path / "straight.npz")
    _virtual(corpus_dir, straight, ckpt=str(tmp_path / "ck_straight"),
             engine=engine)
    ck = str(tmp_path / "ck_crash")
    crash = faults.run_child(_session(corpus_dir, str(tmp_path / "x.npz"),
                                      ckpt=ck, engine=engine),
                             faults="svi.step=kill@6", timeout=CHILD_TIMEOUT)
    assert crash.returncode == -9, crash.stderr[-2000:]
    resumed = str(tmp_path / "resumed.npz")
    r = _virtual(corpus_dir, resumed, ckpt=ck, engine=engine)
    # the async committer may or may not have landed the t=4 session
    # before the kill — either valid session resumes bitwise
    got = int(r.stdout.split("RESUMED", 1)[1].split()[0])
    assert got in (2, 4), r.stdout
    _assert_npz_bitwise(straight, resumed)


def test_topology_change_resume(corpus_dir, tmp_path):
    """Remesh: finish 4 steps as 2 virtual hosts, resume as 1 host (one
    shard).  The session fingerprint excludes the topology, so the
    resume is accepted; the carried-over history prefix is bitwise, the
    continuation deterministic going forward."""
    engine = dict(SESSION, checkpoint_every=2)
    ck = str(tmp_path / "ck_topo")
    first = str(tmp_path / "first.npz")
    r = _virtual(corpus_dir, first, steps=4, ckpt=ck, engine=engine)
    assert "RESUMED None" in r.stdout
    cont = str(tmp_path / "cont.npz")
    r2 = _virtual(corpus_dir, cont, steps=8, ckpt=ck, n_hosts=1,
                  engine=engine)
    assert "RESUMED 4" in r2.stdout
    a, b = np.load(first), np.load(cont)
    assert len(b["elbo"]) == 8
    np.testing.assert_array_equal(a["elbo"], b["elbo"][:4])
    assert np.isfinite(b["heldout"]).all()


def test_remesh_and_resume_svi_continues_on_a_new_shard_count(tmp_path):
    """``remesh_and_resume_svi``: a fit of 4 steps on 2 shards with
    sessions, resumed to 8 steps on 1 shard; the history prefix carries
    over bitwise and the continuation runs the remaining steps."""
    from repro_torch.core import make_engine
    from repro_torch.launch.elastic import remesh_and_resume_svi
    c = SyntheticCorpus(n_docs=40, vocab=30, n_topics=3, mean_len=40,
                        seed=1).generate()

    def lda():
        m = models.make("lda", **LDA)
        m["x"].observe(c["tokens"], segment_ids=c["doc_ids"])
        return m
    ck = str(tmp_path / "ck")
    cfg = dict(SESSION, steps=4, checkpoint_every=2)
    first = make_engine(cfg, sharding=ShardingPlan(2), checkpoint_dir=ck
                        ).fit(lda())
    assert first.meta["group"]["calls"] > 0
    cont = remesh_and_resume_svi(lda(), dict(cfg, steps=8), ck, n_devices=1)
    assert cont.meta["resumed_from_step"] == 4
    assert cont.elbo_trace[:4] == first.elbo_trace
    assert len(cont.elbo_trace) == 8 and np.isfinite(cont.elbo_trace).all()


@pytest.mark.parametrize("n_devices, want_model",
                         [(1, 0), (2, 0), (4, 2), (6, 4), (8, 2)])
def test_remesh_svi_plan_shards_the_references_data_axis(n_devices,
                                                         want_model):
    """The plan ``remesh_and_resume_svi`` resumes on has as many shards as
    the reference's ``factor_counts`` gives its data axis: 4 devices with
    ``want_model=2`` run 2 shards in both packages."""
    from repro.launch.elastic import factor_counts as ref_factor_counts
    from repro_torch.launch.elastic import svi_plan
    plan = svi_plan(n_devices, want_model)
    assert plan.strategy == "inferspark"
    assert plan.n_shards == ref_factor_counts(n_devices, want_model)[0]


@pytest.mark.parametrize("name", ["launch.train:train", "launch.serve:serve",
                                  "launch.elastic:remesh_and_resume_svi"])
def test_entry_points_take_the_references_positional_parameters(name):
    """The port's ``train``, ``serve`` and ``remesh_and_resume_svi`` list the
    reference's parameters in its order with its defaults, so that a
    positional ``mesh`` binds to ``mesh``; only the port's keyword-only
    ``device`` and ``params`` are its own."""
    import importlib
    import inspect
    mod, fn = name.split(":")
    sig = {pkg: inspect.signature(getattr(
        importlib.import_module(f"{pkg}.{mod}"), fn))
        for pkg in ("repro", "repro_torch")}
    ref = [(p.name, p.kind, p.default)
           for p in sig["repro"].parameters.values()]
    port = [(p.name, p.kind, p.default)
            for p in sig["repro_torch"].parameters.values()
            if p.kind != p.KEYWORD_ONLY]
    assert port == ref
    own = {p.name for p in sig["repro_torch"].parameters.values()
           if p.kind == p.KEYWORD_ONLY}
    assert own <= {"device", "params"}
