"""The port's sharded corpus store and out-of-core SVI, held to the JAX
reference.

The store is numpy, copied from the reference, so its files, manifests,
samplers and slices are held to the reference exactly, in both directions
(each package reads what the other wrote).  Within the port, out-of-core
SVI is bitwise resident SVI (the reference's own contract,
``tests/test_store.py``); against the reference's out-of-core SVI, from the
reference's own ``init_state``, it is held at the port's SVI tolerance
(``tests/test_torch_svi.py``: ELBO rtol 1e-4, posteriors rtol = atol =
2e-4).  Growing corpora follow ``tests/test_streaming.py``'s store half.
"""

import functools
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import models as jmodels
from repro.core.svi import SVI as JSVI, SVIConfig as JSVIConfig
from repro.core.vmp import init_state as j_init
from repro.data import store as jstore
from repro_torch.core import compiler as tcomp
from repro_torch.core import models
from repro_torch.core import svi as tsvi
from repro_torch.core import vmp as tvmp
from repro_torch.core.svi import SVI, SVIConfig
from repro_torch.data import (GrowingMinibatchSampler, MinibatchSampler,
                              ShardedCorpus, ShardedCorpusWriter,
                              ShardedMinibatchSampler, sharded_caps,
                              sharded_template, slice_sharded,
                              write_sharded_corpus)
from repro_torch.data import store as tstore

CPU = torch.device("cpu")
LDA = dict(alpha=0.1, beta=0.05, K=3, V=30)


@pytest.fixture(scope="module")
def store(small_corpus, tmp_path_factory):
    """The shared small corpus written by the port as ~6 on-disk shards."""
    path = tmp_path_factory.mktemp("shards")
    return write_sharded_corpus(small_corpus, str(path), shard_tokens=500)


@pytest.fixture(scope="module")
def program(small_corpus):
    m = models.make("lda", **LDA)
    m["x"].observe(small_corpus["tokens"], segment_ids=small_corpus["doc_ids"])
    return m.compile()


def _lda():
    return models.make("lda", **LDA)


def _offsets(corpus):
    return np.concatenate([[0], np.cumsum(corpus["lengths"])])


def _write_prefix(corpus, path, n_docs, shard_tokens=500):
    """A port writer with the first ``n_docs`` documents committed."""
    offs = _offsets(corpus)
    w = ShardedCorpusWriter(str(path), shard_tokens=shard_tokens, vocab=30)
    w.add_docs(corpus["tokens"][:offs[n_docs]], corpus["lengths"][:n_docs])
    return w, w.commit()


def _bitwise(a, b):
    assert int(a.step) == int(b.step)
    for n in a.posteriors:
        assert torch.equal(a.posteriors[n], b.posteriors[n]), n


# ---------------------------------------------------------------------------
# format: write / open / gather, and the reference's files
# ---------------------------------------------------------------------------

def test_roundtrip(small_corpus, store):
    assert store.n_docs == 50 and store.n_shards > 1
    r = store.resident()
    np.testing.assert_array_equal(r["tokens"], small_corpus["tokens"])
    np.testing.assert_array_equal(r["doc_ids"], small_corpus["doc_ids"])
    np.testing.assert_array_equal(r["lengths"], small_corpus["lengths"])
    shards = store.manifest["shards"]
    assert shards[0]["doc_start"] == 0 and shards[-1]["doc_end"] == 50
    assert all(a["doc_end"] == b["doc_start"]
               for a, b in zip(shards, shards[1:]))


def test_reopen_and_gather(small_corpus, store):
    sc = ShardedCorpus.open(store.path)
    docs = np.array([3, 11, 12, 13, 40])
    exp = np.concatenate([small_corpus["tokens"]
                          [small_corpus["doc_ids"] == d] for d in docs])
    np.testing.assert_array_equal(sc.gather_tokens(docs), exp)


def test_gather_touches_only_needed_shards(store):
    sc = ShardedCorpus.open(store.path)
    first = store.manifest["shards"][0]
    sc.gather_tokens(np.arange(first["doc_end"] - 1))
    assert set(sc._mmaps) == {0}
    assert sc.bytes_read == int(store.offsets[first["doc_end"] - 1]) * 4


def test_streaming_writer_matches_one_shot(small_corpus, tmp_path):
    w = ShardedCorpusWriter(str(tmp_path / "chunked"), shard_tokens=500)
    lo = 0
    for chunk in np.array_split(np.arange(50), 7):
        n = int(small_corpus["lengths"][chunk].sum())
        w.add_docs(small_corpus["tokens"][lo:lo + n],
                   small_corpus["lengths"][chunk])
        lo += n
    r = w.close().resident()
    np.testing.assert_array_equal(r["tokens"], small_corpus["tokens"])
    np.testing.assert_array_equal(r["lengths"], small_corpus["lengths"])


def test_writer_validates(tmp_path):
    w = ShardedCorpusWriter(str(tmp_path / "w"))
    with pytest.raises(ValueError):
        w.add_docs(np.arange(5, dtype=np.int32), [2, 2])
    with pytest.raises(ValueError):
        ShardedCorpusWriter(str(tmp_path / "w2")).close()
    with pytest.raises(ValueError):
        write_sharded_corpus({"tokens": np.ones(4, np.int32),
                              "doc_ids": np.array([1, 0, 1, 0])},
                             str(tmp_path / "w3"))
    with pytest.raises(FileNotFoundError):
        ShardedCorpus.open(str(tmp_path / "nowhere"))


def test_hosts_view_belongs_to_the_distributed_slice(store):
    with pytest.raises(NotImplementedError, match="distributed"):
        ShardedCorpus.open(store.path, hosts=object())


@pytest.mark.parametrize("writer,reader", [("reference", "port"),
                                           ("port", "reference")])
def test_each_package_reads_the_others_shards(small_corpus, tmp_path,
                                              writer, reader):
    """One format on disk: the same files, manifest and lengths, whichever
    package wrote them, and the other reads them back equal."""
    write = {"reference": jstore.write_sharded_corpus,
             "port": tstore.write_sharded_corpus}
    opener = {"reference": jstore.ShardedCorpus, "port": ShardedCorpus}
    path = str(tmp_path / "c")
    write[writer](small_corpus, path, shard_tokens=500)
    mine = opener[reader].open(path)
    theirs = opener[writer].open(path)
    other = str(tmp_path / "other")
    write[reader](small_corpus, other, shard_tokens=500)
    assert sorted(os.listdir(path)) == sorted(os.listdir(other))
    assert mine.manifest == ShardedCorpus.open(other).manifest \
        == theirs.manifest
    np.testing.assert_array_equal(mine.lengths, small_corpus["lengths"])
    np.testing.assert_array_equal(mine.lengths, theirs.lengths)
    docs = np.array([0, 5, 6, 7, 31, 49])
    np.testing.assert_array_equal(mine.gather_tokens(docs),
                                  theirs.gather_tokens(docs))
    np.testing.assert_array_equal(mine.resident()["tokens"],
                                  small_corpus["tokens"])


# ---------------------------------------------------------------------------
# sharded slicing == resident slicing
# ---------------------------------------------------------------------------

def _pad64(name, n):
    return -(-max(n, 1) // 64) * 64


GROUPS = [np.arange(50), np.array([3, 17, 4, 44, 9]), np.array([0])]


def _assert_slices_equal(s1, s2):
    (a1, d1, c1, n1), (a2, d2, c2, n2) = s1, s2
    assert c1 == c2 and n1 == n2
    for k in a1:
        for kk, x in a1[k].items():
            if x is None:
                assert a2[k][kk] is None
            else:
                assert x.dtype == a2[k][kk].dtype
                np.testing.assert_array_equal(x, a2[k][kk])
    for k in d1:
        for kk, x in d1[k].items():
            np.testing.assert_array_equal(x, d2[k][kk])


@pytest.mark.parametrize("caps_fn", [None, _pad64], ids=["exact", "padded"])
@pytest.mark.parametrize("gi", range(len(GROUPS)))
def test_slice_sharded_bitwise(store, program, gi, caps_fn):
    """The port's out-of-core slice is bitwise its resident slice and
    equal to the reference's out-of-core slice."""
    groups = GROUPS[gi]
    tmpl = sharded_template(_lda(), store)
    got = slice_sharded(tmpl, store, groups, caps_fn)
    _assert_slices_equal(tcomp.slice_arrays(program, groups, caps_fn), got)
    jcorpus = jstore.ShardedCorpus.open(store.path)
    jtmpl = jstore.sharded_template(jmodels.make("lda", **LDA), jcorpus)
    _assert_slices_equal(
        jstore.slice_sharded(jtmpl, jcorpus, groups, caps_fn), got)


def test_sharded_caps_probe_matches_slicer(store):
    tmpl = sharded_template(_lda(), store)
    for groups in GROUPS:
        assert sharded_caps(tmpl, store, groups) == \
            slice_sharded(tmpl, store, groups, None)[2]


def test_template_matches_resident_program(store, program):
    tmpl = sharded_template(_lda(), store)
    assert tmpl.meta["sharded"] and tmpl.meta["pstar_size"] == 50
    for name, d in program.dirichlets.items():
        t = tmpl.dirichlets[name]
        assert (t.g, t.k) == (d.g, d.k)
        np.testing.assert_array_equal(t.prior, d.prior)
    assert tmpl.vertex_layout == program.vertex_layout
    assert tmpl.plate_sizes == program.plate_sizes


@pytest.mark.parametrize("name,kw", [
    ("naive_bayes", dict(alpha=1.0, beta=0.3, C=3, V=30)),
    ("dcmlda", dict(alpha=0.4, beta=0.4, K=3, V=30)),
])
def test_template_rejects_non_token_plate_models(store, name, kw):
    with pytest.raises(ValueError, match="sharded|token plate"):
        sharded_template(models.make(name, **kw), store)


def test_template_rejects_undersized_vocab(store):
    with pytest.raises(ValueError, match="vocab"):
        sharded_template(models.make("lda", alpha=0.1, beta=0.05,
                                     K=3, V=5), store)


def test_resident_paths_refuse_a_template(store):
    """A template has no token arrays: the resident slicer and full-batch
    VMP fail loudly instead of reading its ``None`` arrays."""
    from repro_torch.core.runtime import run_inference
    tmpl = sharded_template(_lda(), store)
    with pytest.raises(ValueError, match="sharded template"):
        tcomp.slice_arrays(tmpl, np.arange(3))
    with pytest.raises(ValueError, match="sharded template"):
        run_inference(tmpl, steps=1, device="cpu")
    with pytest.raises(ValueError, match="sharded template"):
        SVI(tmpl, SVIConfig(batch_size=8), device="cpu")


@pytest.mark.parametrize("gi", range(len(GROUPS)))
def test_owner_plans_out_of_core_equal_resident(store, program, gi):
    """The loader ends in the same ``owner_plans`` call as the resident
    batch: for a CUDA device (nothing is placed, so no card is needed) the
    plans of an out-of-core batch are bitwise the resident batch's, and
    count in the prefetched batch's bytes."""
    groups = GROUPS[gi]
    tmpl = sharded_template(_lda(), store)
    slicer = functools.partial(slice_sharded, tmpl, store)
    hb_r, caps_r, _ = tsvi.host_batch(program, groups, _pad64,
                                      device="cuda")
    hb_s, caps_s, _ = tsvi.host_batch(tmpl, groups, _pad64, device="cuda",
                                      slicer=slicer)
    assert caps_r == caps_s and set(hb_r["plans"]) == {"z"}
    pr, ps = hb_r["plans"]["z"], hb_s["plans"]["z"]
    want, got = pr.host_arrays(), ps.host_arrays()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(want[k], got[k], err_msg=str(k))
    assert ps.nbytes == sum(a.nbytes for a in got.values()) > 0
    arrays = sum(a.nbytes for part in ("arrays", "dirs")
                 for v in hb_s[part].values() for a in v.values()
                 if a is not None)
    assert tstore._tree_nbytes(hb_s) == arrays + ps.nbytes


# ---------------------------------------------------------------------------
# sampler determinism + prefetch
# ---------------------------------------------------------------------------

def test_sharded_sampler_matches_resident_order(store):
    groups = np.arange(store.n_docs)
    res = MinibatchSampler(groups=groups, batch_size=8, seed=4)
    sh = ShardedMinibatchSampler(corpus=store, groups=groups, batch_size=8,
                                 seed=4)
    assert sh.batches_per_epoch == res.batches_per_epoch
    for t in range(3 * res.batches_per_epoch):
        np.testing.assert_array_equal(res.batch_at(t), sh.batch_at(t))


def test_sharded_sampler_resume_mid_schedule(store):
    def mk():
        return ShardedMinibatchSampler(
            corpus=store, groups=np.arange(store.n_docs), batch_size=7,
            seed=2, loader=store.gather_tokens)
    full, resumed = mk(), mk()
    want = [full.host_batch_at(t) for t in range(9)]
    got = [resumed.host_batch_at(t) for t in range(4, 9)]
    for w, g in zip(want[4:], got):
        np.testing.assert_array_equal(w, g)
    full.close(), resumed.close()


def test_prefetch_is_transparent(store):
    """Prefetch on/off yields identical host batches, and prefetch-thread
    exceptions surface at the matching get."""
    def mk(prefetch, loader=store.gather_tokens):
        return ShardedMinibatchSampler(
            corpus=store, groups=np.arange(store.n_docs), batch_size=10,
            seed=0, loader=loader, prefetch=prefetch)
    on, off = mk(True), mk(False)
    for t in range(12):
        np.testing.assert_array_equal(on.host_batch_at(t),
                                      off.host_batch_at(t))
    on.close()

    calls = {"n": 0}

    def boom(groups):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("loader failed")
        return groups
    bad = mk(True, loader=boom)
    bad.host_batch_at(0)
    with pytest.raises(RuntimeError, match="loader failed"):
        bad.host_batch_at(1)
    bad.close()


def test_prefetch_close_abandons_blocked_loader(store):
    """close() abandons a worker blocked in its loader after the timeout
    (returns False), the late worker writes into no newer state, and a
    drained close leaks no prefetch thread."""
    release = threading.Event()
    entered = threading.Event()

    def stuck(groups):
        entered.set()
        release.wait(timeout=30)
        return groups

    s = ShardedMinibatchSampler(corpus=store, groups=np.arange(store.n_docs),
                                batch_size=8, seed=0, loader=stuck)
    s._prefetcher._schedule(0)
    assert entered.wait(timeout=10)
    t0 = time.monotonic()
    assert s.close(timeout=0.2) is False
    assert time.monotonic() - t0 < 5
    release.set()
    time.sleep(0.05)
    assert s._prefetcher._thread is None and s._prefetcher._box is None
    s2 = ShardedMinibatchSampler(corpus=store,
                                 groups=np.arange(store.n_docs),
                                 batch_size=8, seed=0,
                                 loader=store.gather_tokens)
    s2.host_batch_at(0)
    assert s2.close() is True
    assert not [th for th in threading.enumerate()
                if th.name == "sharded-corpus-prefetch" and th.is_alive()]


# ---------------------------------------------------------------------------
# SVI out of core: bitwise resident within the port, the reference's within
# tolerance
# ---------------------------------------------------------------------------

CFG = dict(batch_size=12, holdout_frac=0.1, holdout_every=5, pad_multiple=64,
           seed=0)


@pytest.mark.parametrize("prefetch", [True, False])
def test_out_of_core_svi_bitwise_equals_resident(store, program, prefetch):
    cfg = SVIConfig(prefetch=prefetch, **CFG)
    res = SVI(program, cfg, device=CPU)
    s_res, h_res = res.fit(steps=9)
    sh = SVI(_lda(), cfg, corpus=ShardedCorpus.open(store.path), device=CPU)
    sh.host_ms = []
    s_sh, h_sh = sh.fit(steps=9)
    sh.close()
    np.testing.assert_array_equal(res.train, sh.train)
    np.testing.assert_array_equal(res.holdout, sh.holdout)
    _bitwise(s_res, s_sh)
    assert h_res["elbo"] == h_sh["elbo"]
    assert h_res["heldout"] == h_sh["heldout"]
    assert sh.sampler.peak_buffer_bytes > 0
    assert sh.corpus.bytes_read > 0
    # the host split keeps its keys and adds the wait on the loader
    assert len(sh.host_ms) == 9
    assert all(set(r) == {"slice", "plan", "h2d", "wait"}
               for r in sh.host_ms)


def test_out_of_core_svi_matches_reference(store):
    """The port's out-of-core SVI against the reference's, both from the
    reference's ``init_state``, at the port's SVI tolerance."""
    jcorpus = jstore.ShardedCorpus.open(store.path)
    jsvi = JSVI(jmodels.make("lda", **LDA), JSVIConfig(**CFG),
                corpus=jcorpus)
    s0 = j_init(jsvi.program, 0)
    posts0 = {n: np.asarray(p) for n, p in s0.posteriors.items()}
    j_state, j_hist = jsvi.fit(steps=9, state=s0)
    jsvi.close()
    tsv = SVI(_lda(), SVIConfig(**CFG), corpus=ShardedCorpus.open(store.path),
              device=CPU)
    t_state, t_hist = tsv.fit(steps=9,
                              state=tvmp.state_from_numpy(posts0, 0, CPU))
    tsv.close()
    np.testing.assert_allclose(t_hist["elbo"], j_hist["elbo"], rtol=1e-4)
    assert [t for t, _ in t_hist["heldout"]] == \
        [t for t, _ in j_hist["heldout"]]
    np.testing.assert_allclose([v for _, v in t_hist["heldout"]],
                               [v for _, v in j_hist["heldout"]], rtol=1e-4)
    for n, p in j_state.posteriors.items():
        np.testing.assert_allclose(t_state.posteriors[n].numpy(),
                                   np.asarray(p), rtol=2e-4, atol=2e-4,
                                   err_msg=n)


def test_engine_api_out_of_core(store):
    from repro_torch.core import make_engine
    m = _lda()
    result = make_engine("svi", steps=6, batch_size=16, holdout_frac=0.1,
                         corpus=ShardedCorpus.open(store.path),
                         device="cpu").fit(m)
    assert not m.observations and not m.net.rvs["x"].observed
    assert result.backend == "svi"
    assert len(result.elbo_trace) == 6
    assert np.isfinite(result.heldout_elbo)
    assert result.topics("phi").shape == (3, 30)
    with pytest.raises(ValueError, match="resident"):
        make_engine("vmp", corpus=ShardedCorpus.open(store.path),
                    device="cpu").fit(_lda())


def test_build_infer_step_out_of_core(store, program):
    from repro_torch.core.engine import EngineConfig
    from repro_torch.launch.steps import build_infer_step
    step_fn, state = build_infer_step(
        _lda(), EngineConfig(backend="svi", batch_size=16, seed=0,
                             device="cpu"),
        corpus=ShardedCorpus.open(store.path))
    for _ in range(2):
        state, elbo = step_fn(state)
    assert np.isfinite(float(elbo)) and int(state.step) == 2
    step_fn.svi.close()
    # the same steps over the resident program, bitwise
    r_fn, r_state = build_infer_step(
        program, EngineConfig(backend="svi", batch_size=16, seed=0,
                              device="cpu"))
    for _ in range(2):
        r_state, _ = r_fn(r_state)
    _bitwise(state, r_state)
    vmp_fn, v0 = build_infer_step(program, EngineConfig(device="cpu"))
    assert np.isfinite(float(vmp_fn(v0)[1]))
    with pytest.raises(ValueError, match="resident"):
        build_infer_step(_lda(), EngineConfig(device="cpu"),
                         corpus=ShardedCorpus.open(store.path))
    with pytest.raises(NotImplementedError, match="distributed"):
        build_infer_step(program, EngineConfig(device="cpu",
                                               sharding=object()))


# ---------------------------------------------------------------------------
# growing corpora: writer commit / reader refresh, the growing sampler
# ---------------------------------------------------------------------------

def test_commit_publishes_openable_prefix(small_corpus, tmp_path):
    w, sc = _write_prefix(small_corpus, tmp_path / "c", 30)
    assert sc.n_docs == 30
    offs = _offsets(small_corpus)
    np.testing.assert_array_equal(sc.gather_tokens(np.arange(30)),
                                  small_corpus["tokens"][:offs[30]])
    w.add_docs(small_corpus["tokens"][offs[30]:],
               small_corpus["lengths"][30:])
    full = w.close()
    assert full.n_docs == 50
    np.testing.assert_array_equal(full.resident()["tokens"],
                                  small_corpus["tokens"])
    with pytest.raises(RuntimeError, match="closed"):
        w.commit()


def test_refresh_picks_up_growth_without_invalidating_reads(small_corpus,
                                                            tmp_path):
    w, _ = _write_prefix(small_corpus, tmp_path / "c", 20)
    rd = ShardedCorpus.open(str(tmp_path / "c"))
    offs = _offsets(small_corpus)
    before = rd.gather_tokens(np.arange(20))
    assert rd.refresh() is False
    w.add_docs(small_corpus["tokens"][offs[20]:],
               small_corpus["lengths"][20:])
    w.commit()
    assert rd.refresh() is True
    assert rd.n_docs == 50
    np.testing.assert_array_equal(rd.gather_tokens(np.arange(20)), before)
    np.testing.assert_array_equal(rd.resident()["tokens"],
                                  small_corpus["tokens"])
    w.close()


def test_refresh_rejects_shrinkage(small_corpus, tmp_path):
    import shutil
    w, rd = _write_prefix(small_corpus, tmp_path / "c", 30)
    w.close()
    shutil.rmtree(tmp_path / "c")
    _write_prefix(small_corpus, tmp_path / "c", 10)[0].close()
    with pytest.raises(ValueError, match="append-only"):
        rd.refresh()


def test_manifest_written_after_lengths(small_corpus, tmp_path):
    w, sc = _write_prefix(small_corpus, tmp_path / "c", 30)
    lengths = np.load(os.path.join(sc.path, "lengths.npy"))
    assert len(lengths) == sc.manifest["n_docs"] == 30
    assert sc.manifest["commit"] == 1
    w.add_docs(small_corpus["tokens"][_offsets(small_corpus)[30]:],
               small_corpus["lengths"][30:])
    sc2 = w.close()
    assert sc2.manifest["commit"] == 2
    assert len(np.load(os.path.join(sc.path, "lengths.npy"))) == 50


def test_growing_sampler_bitwise_matches_fixed_when_constant():
    pop = np.arange(37, dtype=np.int64)
    grow = GrowingMinibatchSampler(population=lambda: pop, batch_size=8,
                                   seed=3)
    fixed = MinibatchSampler(groups=pop, batch_size=8, seed=3)
    for t in range(3 * fixed.batches_per_epoch):
        np.testing.assert_array_equal(grow.batch_at(t), fixed.batch_at(t))


def test_sharded_grow_mode_excludes_holdout_and_caps_growth(small_corpus,
                                                            tmp_path):
    w, sc = _write_prefix(small_corpus, tmp_path / "c", 30)
    hold = np.array([1, 7])
    s = ShardedMinibatchSampler(corpus=sc, groups=np.arange(30),
                                batch_size=7, seed=0, grow=True,
                                exclude=hold, max_group=40)
    epoch0 = np.concatenate([s.batch_at(t)
                             for t in range(s.batches_per_epoch)])
    assert not np.isin(hold, epoch0).any()
    assert len(epoch0) == 28
    offs = _offsets(small_corpus)
    w.add_docs(small_corpus["tokens"][offs[30]:], small_corpus["lengths"][30:])
    w.close()
    with pytest.raises(RuntimeError, match="capacity_docs"):
        s.batch_at(1000)


# ---------------------------------------------------------------------------
# SVI over a growing corpus
# ---------------------------------------------------------------------------

def _grow_cfg(**kw):
    return SVIConfig(**{**dict(batch_size=10, holdout_frac=0.1,
                               holdout_every=4, pad_multiple=64, seed=0,
                               growing=True, capacity_docs=64), **kw})


def test_growing_svi_trains_through_appends(small_corpus, tmp_path):
    w, sc = _write_prefix(small_corpus, tmp_path / "c", 30)
    svi = SVI(_lda(), _grow_cfg(), corpus=sc, device=CPU)
    assert svi.program.meta["capacity_docs"] == 64
    assert svi.program.meta["pstar_size"] == 30
    state, _ = svi.fit(steps=6)
    offs = _offsets(small_corpus)
    w.add_docs(small_corpus["tokens"][offs[30]:], small_corpus["lengths"][30:])
    w.close()
    state, h2 = svi.fit(steps=9, state=state)
    svi.close()
    assert np.isfinite(h2["heldout"][-1][1])
    log = svi.sampler._inner.epoch_log()
    assert log[-1][1] > log[0][1]
    theta = state.posteriors["theta"]
    assert theta.shape[0] == 64 and torch.isfinite(theta).all()
    # the held-out documents are never trained on: their rows keep the
    # initial state bitwise
    theta0 = tvmp.init_state(svi.program, 0, device=CPU).posteriors["theta"]
    hold = torch.from_numpy(svi.holdout)
    assert torch.equal(theta[hold], theta0[hold])


def test_growing_svi_matches_reference(small_corpus, tmp_path):
    """A growing fit with an append between two fits, in both packages from
    the reference's initial state, within the port's SVI tolerance."""
    def run(pkg):
        w, _ = _write_prefix(small_corpus, tmp_path / pkg, 30)
        w_close_offs = _offsets(small_corpus)
        if pkg == "reference":
            svi = JSVI(jmodels.make("lda", **LDA),
                       JSVIConfig(**{**CFG, "batch_size": 10,
                                     "holdout_every": 4, "growing": True,
                                     "capacity_docs": 64,
                                     "prefetch": False}),
                       corpus=jstore.ShardedCorpus.open(str(tmp_path / pkg)))
            st = j_init(svi.program, 0)
            run.posts0 = {n: np.asarray(p) for n, p in st.posteriors.items()}
        else:
            svi = SVI(_lda(), _grow_cfg(prefetch=False),
                      corpus=ShardedCorpus.open(str(tmp_path / pkg)),
                      device=CPU)
            st = tvmp.state_from_numpy(run.posts0, 0, CPU)
        st, _ = svi.fit(steps=4, state=st)
        w.add_docs(small_corpus["tokens"][w_close_offs[30]:],
                   small_corpus["lengths"][30:])
        w.close()
        st, hist = svi.fit(steps=6, state=st)
        svi.close()
        return ({n: np.asarray(p) for n, p in st.posteriors.items()}, hist,
                svi.sampler._inner.epoch_log())
    j_posts, j_hist, j_log = run("reference")
    t_posts, t_hist, t_log = run("port")
    assert t_log == j_log and t_log[-1][1] > t_log[0][1]
    np.testing.assert_allclose(t_hist["elbo"], j_hist["elbo"], rtol=1e-4)
    for n in j_posts:
        np.testing.assert_allclose(t_posts[n], j_posts[n], rtol=2e-4,
                                   atol=2e-4, err_msg=n)


def test_growing_config_validation(small_corpus, tmp_path):
    _, sc = _write_prefix(small_corpus, tmp_path / "c", 30)
    with pytest.raises(ValueError, match="growing"):
        SVIConfig(capacity_docs=10)
    with pytest.raises(ValueError, match="corpus"):
        SVI(_lda(), SVIConfig(growing=True, capacity_docs=10), device=CPU)
    with pytest.raises(ValueError, match="capacity_docs"):
        SVI(_lda(), SVIConfig(growing=True), corpus=sc, device=CPU)
    with pytest.raises(ValueError, match="headroom"):
        SVI(sharded_template(_lda(), sc), SVIConfig(growing=True),
            corpus=sc, device=CPU)
    with pytest.raises(ValueError, match="below"):
        sharded_template(_lda(), sc, capacity_docs=10)
    with pytest.raises(ValueError, match="sharded template"):
        SVI(_observed(small_corpus), SVIConfig(), corpus=sc, device=CPU)


def _observed(corpus):
    m = _lda()
    m["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    return m.compile()


def test_population_vi_scale_is_pinned(small_corpus, tmp_path):
    _, sc = _write_prefix(small_corpus, tmp_path / "c", 30)

    def run(pop):
        cfg = _grow_cfg(holdout_frac=0.0, capacity_docs=40,
                        population_size=pop)
        svi = SVI(_lda(), cfg, corpus=ShardedCorpus.open(sc.path),
                  device=CPU)
        state, _ = svi.fit(steps=2)
        svi.close()
        return state.posteriors["phi"]
    a, b, c = run(1000), run(1000), run(0)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
