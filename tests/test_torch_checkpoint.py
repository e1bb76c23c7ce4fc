"""The port's checkpoint store: the reference's ``tests/test_checkpoint.py``
rebuilt on ``repro_torch.checkpoint``, plus the two packages' files read
across (one format: each package loads what the other saved, leaf order and
paths included) and VMP resume through ``Model.infer``, bitwise within the
port."""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.core import models as jmodels
from repro.core.vmp import VMPState as JState
from repro.core.vmp import init_state as j_init
from repro_torch.checkpoint import (CheckpointCorruptError, CheckpointStore,
                                    complete_steps, latest_step,
                                    latest_valid_step, load, restore, save,
                                    validate)
from repro_torch.checkpoint import store as tstore
from repro_torch.core import models
from repro_torch.core import vmp as tvmp
from repro_torch.testing import faults


def _tree(x=1.0):
    return {"a": np.full((3, 2), x, np.float32),
            "b": {"c": np.arange(5, dtype=np.int32)}}


def _ck_path(d, step):
    return os.path.join(d, f"step_{step:010d}.npz")


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    save(d, 7, _tree(2.5))
    out = restore(d, _tree(0.0))
    np.testing.assert_array_equal(out["a"], _tree(2.5)["a"])
    np.testing.assert_array_equal(out["b"]["c"], np.arange(5))
    assert latest_step(d) == 7


def test_tensor_leaves_save_as_arrays(tmp_path):
    """Tensors (CPU here) are saved by value and come back as numpy."""
    d = str(tmp_path)
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    save(d, 1, {"t": t, "s": (torch.tensor(3), [np.float64(2.5)])})
    out, manifest = load(d, {"t": 0, "s": (0, [0])})
    np.testing.assert_array_equal(out["t"], t.numpy())
    assert out["s"][0] == 3 and out["s"][1][0] == 2.5
    assert isinstance(out["s"], tuple) and isinstance(out["s"][1], list)
    assert [r["path"] for r in manifest["leaves"]] == ["s/0", "s/1/0", "t"]
    assert manifest["dict_tree"] is False


def test_latest_picks_newest_complete(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    save(d, 5, _tree(5.0))
    os.makedirs(os.path.join(d, "step_0000000009"))
    assert latest_step(d) == 5
    assert restore(d, _tree(0.0))["a"][0, 0] == 5.0


def test_keep_k_gc(tmp_path):
    store = CheckpointStore(str(tmp_path), every=1, keep=2, blocking=True)
    for i in range(1, 6):
        assert store.maybe_save(i, _tree(float(i)))
    assert complete_steps(str(tmp_path)) == [4, 5]


def test_every_k(tmp_path):
    store = CheckpointStore(str(tmp_path), every=3, keep=5, blocking=True)
    saved = [i for i in range(1, 10) if store.maybe_save(i, _tree())]
    assert saved == [3, 6, 9]


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path), _tree())


def test_async_save_takes_its_copy_on_the_callers_thread(tmp_path):
    """The store copies each leaf before its commit thread starts: a CPU
    tensor changed in place right after ``maybe_save`` (its ``numpy()``
    would alias it) is saved as it was."""
    store = CheckpointStore(str(tmp_path), every=1)
    live = torch.zeros(4, 3)
    with faults.inject("checkpoint.save.pre_replace", action="sleep:0.2"):
        store.maybe_save(1, {"live": live})
        live.add_(7.0)
        store.wait()
    np.testing.assert_array_equal(restore(str(tmp_path))["live"],
                                  np.zeros((4, 3), np.float32))


def test_flipped_byte_falls_back_with_warning(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    save(d, 2, _tree(2.0))
    path = _ck_path(d, 2)
    faults.flip_byte(path, os.path.getsize(path) // 2)
    with pytest.warns(RuntimeWarning, match="falling back"):
        out = restore(d, _tree(0.0))
    assert out["a"][0, 0] == 1.0
    assert latest_step(d) == 2
    assert latest_valid_step(d) == 1


def test_truncated_newest_falls_back(tmp_path):
    d = str(tmp_path)
    save(d, 3, _tree(3.0))
    save(d, 7, _tree(7.0))
    faults.truncate_file(_ck_path(d, 7), 0.5)
    with pytest.warns(RuntimeWarning):
        out, manifest = load(d, _tree(0.0))
    assert manifest["step"] == 3 and out["a"][0, 0] == 3.0


def test_explicit_step_never_falls_back(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    save(d, 2, _tree(2.0))
    faults.truncate_file(_ck_path(d, 2), 0.5)
    with pytest.raises(CheckpointCorruptError):
        restore(d, _tree(0.0), step=2)
    assert restore(d, _tree(0.0), step=1)["a"][0, 0] == 1.0


def test_all_corrupt_raises_itemized(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    save(d, 2, _tree(2.0))
    faults.truncate_file(_ck_path(d, 1), 10)
    faults.flip_byte(_ck_path(d, 2), os.path.getsize(_ck_path(d, 2)) // 2)
    with pytest.warns(RuntimeWarning):
        with pytest.raises(CheckpointCorruptError, match="every checkpoint"):
            restore(d, _tree(0.0))


def _tamper_leaf(path, leaf_name, mutate):
    """Re-write a checkpoint with one leaf mutated but the manifest kept
    (the zip container's CRCs are recomputed, so only the manifest's
    per-leaf checksums can catch it)."""
    import io
    import zipfile
    with np.load(path) as data:
        entries = {n: data[n] for n in data.files}
    entries[leaf_name] = mutate(entries[leaf_name])
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as zf:
        for n, arr in entries.items():
            b = io.BytesIO()
            np.save(b, arr)
            zf.writestr(f"{n}.npy", b.getvalue())
    with open(path, "wb") as fh:
        fh.write(buf.getvalue())


def test_per_leaf_checksum_names_damaged_leaf(tmp_path):
    path = save(str(tmp_path), 5, _tree(1.0))

    def corrupt(arr):
        arr = arr.copy()
        arr.flat[0] += 1
        return arr

    _tamper_leaf(path, "leaf_00000", corrupt)
    with pytest.raises(CheckpointCorruptError,
                       match=r"leaf 'a': checksum mismatch"):
        validate(path)


def test_shape_and_dtype_drift_detected(tmp_path):
    d = str(tmp_path)
    p_shape = save(d, 1, _tree(1.0))
    _tamper_leaf(p_shape, "leaf_00000", lambda a: a[:2])
    with pytest.raises(CheckpointCorruptError, match="shape"):
        validate(p_shape)
    p_dtype = save(d, 2, _tree(1.0))
    _tamper_leaf(p_dtype, "leaf_00000", lambda a: a.astype(np.float64))
    with pytest.raises(CheckpointCorruptError, match="dtype"):
        validate(p_dtype)


def test_leaf_count_mismatch_names_checkpoint_paths(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    stale = {"a": np.zeros((3, 2), np.float32)}
    with pytest.raises(ValueError, match=r"2 leaves.*has 1.*a, b/c"):
        restore(d, stale)


def test_dict_restore_without_tree_like_and_meta_roundtrip(tmp_path):
    d = str(tmp_path)
    save(d, 4, _tree(4.0), meta={"note": "hi", "k": 3})
    tree, manifest = load(d)
    np.testing.assert_array_equal(tree["b"]["c"], np.arange(5))
    assert tree["a"].dtype == np.float32
    assert manifest["meta"] == {"note": "hi", "k": 3}
    assert manifest["step"] == 4


def test_resave_never_deletes_the_complete_copy(tmp_path):
    d = str(tmp_path)
    save(d, 1, _tree(1.0))
    with faults.inject("checkpoint.save.pre_replace"):
        with pytest.raises(faults.InjectedCrash):
            save(d, 1, _tree(99.0))
    assert restore(d, _tree(0.0))["a"][0, 0] == 1.0
    assert any(".npz.tmp-" in n for n in os.listdir(d))
    CheckpointStore(d)
    assert not any(".npz.tmp-" in n for n in os.listdir(d))


def test_async_commit_failure_surfaces_in_wait(tmp_path):
    store = CheckpointStore(str(tmp_path), every=1, blocking=False)
    with faults.inject("checkpoint.save.pre_replace"):
        assert store.maybe_save(1, _tree(1.0))
        with pytest.raises(RuntimeError, match="async checkpoint"):
            store.wait()
    store.maybe_save(2, _tree(2.0))
    store.wait()
    assert latest_step(str(tmp_path)) == 2


def _bf16_case():
    rng = np.random.default_rng(0)
    vals = rng.gamma(1.0, 1.0, (4, 9)).astype(np.float32)
    return torch.from_numpy(vals).to(torch.bfloat16), \
        np.arange(36, dtype=np.int32).reshape(4, 9)


def test_bfloat16_leaves_round_trip_bitwise(tmp_path):
    """bf16 tensors are stored as a uint16 bitcast (``stored_as``) and come
    back as bf16 tensors with the same bits; the checksums cover them."""
    vals, idx = _bf16_case()
    d = str(tmp_path)
    save(d, 3, {"vals": vals, "idx": idx})
    manifest = validate(_ck_path(d, 3))
    rec = {r["path"]: r for r in manifest["leaves"]}["vals"]
    assert rec["dtype"] == "bfloat16" and rec["stored_as"] == "uint16"
    out = restore(d, {"vals": 0, "idx": 0}, step=3)
    assert out["vals"].dtype == torch.bfloat16
    assert torch.equal(out["vals"].view(torch.int16), vals.view(torch.int16))
    np.testing.assert_array_equal(out["idx"], idx)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bfloat16_leaves_cross_packages(tmp_path, writer):
    """A bf16 leaf written by either package loads in the other with its
    bits (the reference's as an ``ml_dtypes`` array, the port's as a
    tensor)."""
    vals, idx = _bf16_case()
    bits = vals.view(torch.int16).numpy().view(np.uint16)
    d = str(tmp_path)
    if writer == "reference":
        jckpt.save(d, 1, {"vals": bits.view(ml_dtypes.bfloat16), "idx": idx})
        out = restore(d)
        assert torch.equal(out["vals"].view(torch.int16),
                           vals.view(torch.int16))
    else:
        save(d, 1, {"vals": vals, "idx": idx})
        out = jckpt.restore(d)
        assert out["vals"].dtype == np.dtype(ml_dtypes.bfloat16)
        np.testing.assert_array_equal(out["vals"].view(np.uint16), bits)
    np.testing.assert_array_equal(out["idx"], idx)


# ---------------------------------------------------------------------------
# VMP states: the reference's leaf order and paths, loads across packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    """A small LDA corpus and the reference's initial state for it."""
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 20, 200).astype(np.int32)
    docs = np.sort(rng.integers(0, 10, 200)).astype(np.int32)
    jm = jmodels.make("lda", alpha=.1, beta=.1, K=3, V=20)
    jm["x"].observe(toks, segment_ids=docs)
    j0 = j_init(jm.compile(), 0)
    return toks, docs, j0


def _fresh(toks, docs):
    m = models.make("lda", alpha=.1, beta=.1, K=3, V=20)
    m["x"].observe(toks, segment_ids=docs)
    return m


def test_vmp_state_flattens_as_the_reference(tmp_path, toy):
    """The port's ``VMPState`` saves as the reference's: sorted posteriors
    then the step (a 0-d int32), paths "0", "1", ..., not a dict tree."""
    _, _, j0 = toy
    posts = {n: np.asarray(p) for n, p in j0.posteriors.items()}
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jckpt.save(jd, 4, JState({n: jnp.asarray(p) for n, p in posts.items()},
                             jnp.asarray(4, jnp.int32)))
    save(td, 4, tvmp.state_from_numpy(posts, 4, "cpu"))
    jm, tm = jckpt.validate(_ck_path(jd, 4)), validate(_ck_path(td, 4))
    assert tm["leaves"] == jm["leaves"]       # names, paths, dtypes, crcs
    assert tm["dict_tree"] is jm["dict_tree"] is False
    assert [r["path"] for r in tm["leaves"]] == ["0", "1", "2"]
    assert tm["leaves"][-1]["dtype"] == "int32"


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_vmp_state_loads_across_packages(tmp_path, toy, writer):
    """A ``VMPState`` checkpoint written by one package restores in the
    other through ``restore(tree_like=)``, bit for bit."""
    _, _, j0 = toy
    posts = {n: np.asarray(p) for n, p in j0.posteriors.items()}
    d = str(tmp_path)
    if writer == "reference":
        jckpt.save(d, 6, JState(dict(j0.posteriors),
                                jnp.asarray(6, jnp.int32)))
        got = restore(d, tvmp.state_from_numpy(posts, 0, "cpu"))
        assert isinstance(got, tvmp.VMPState) and got.step == 6
        for n, p in posts.items():
            np.testing.assert_array_equal(got.posteriors[n].numpy(), p)
    else:
        save(d, 6, tvmp.state_from_numpy(posts, 6, "cpu"))
        got = jckpt.restore(d, j0)
        assert int(got.step) == 6
        for n, p in posts.items():
            np.testing.assert_array_equal(np.asarray(got.posteriors[n]), p)


def test_vmp_inference_resume_is_bitwise(tmp_path, toy):
    """Paper section 4.2 checkpointing: a fresh model resumes from disk and
    its trace and posteriors are the uninterrupted run's, bit for bit (the
    reference holds its own at rtol 1e-5)."""
    toks, docs, _ = toy
    m_full = _fresh(toks, docs)
    m_full.infer(steps=10, device="cpu")
    d = str(tmp_path / "ck")
    m1 = _fresh(toks, docs)
    m1.infer(steps=5, checkpoint_every=1, checkpoint_dir=d, device="cpu")
    assert latest_step(d) == 5
    m2 = _fresh(toks, docs)
    m2.infer(steps=5, checkpoint_every=1, checkpoint_dir=d, device="cpu")
    assert m1.elbo_trace + m2.elbo_trace == m_full.elbo_trace
    for n in ("theta", "phi"):
        np.testing.assert_array_equal(m2[n].get_result(),
                                      m_full[n].get_result())
    assert complete_steps(d)[-1] == 10


def test_vmp_resume_from_a_reference_checkpoint(tmp_path, toy):
    """The reference's ``Model.infer`` checkpoints 5 steps; the port resumes
    from them for 5 more and ends within the VMP parity tolerance of the
    reference's uninterrupted 10 (``tests/test_torch_vmp.py``)."""
    toks, docs, j0 = toy
    d = str(tmp_path / "ck")
    jm = jmodels.make("lda", alpha=.1, beta=.1, K=3, V=20)
    jm["x"].observe(toks, segment_ids=docs)
    jm.infer(steps=5, checkpoint_every=5, checkpoint_dir=d)
    jm.infer(steps=5)
    m = _fresh(toks, docs)
    m.infer(steps=5, checkpoint_every=5, checkpoint_dir=d, device="cpu")
    np.testing.assert_allclose(m.elbo_trace, jm.elbo_trace[5:], rtol=1e-4)
    for n in ("theta", "phi"):
        np.testing.assert_allclose(m[n].get_result(),
                                   np.asarray(jm[n].get_result()),
                                   rtol=2e-4, atol=2e-4, err_msg=n)


def test_treedef_string_is_the_ports_own(tmp_path):
    """Neither package compares the manifest's treedef: the port writes a
    description of its own tree."""
    save(str(tmp_path), 1, _tree())
    manifest = tstore.read_manifest(_ck_path(str(tmp_path), 1))
    assert manifest["treedef"] == "{'a': *, 'b': {'c': *}}"
    np.testing.assert_array_equal(jckpt.restore(str(tmp_path))["b"]["c"],
                                  np.arange(5))


@pytest.mark.parametrize("knob", ["checkpoint_every", "checkpoint_dir"])
def test_infer_checkpoints_need_both_knobs(tmp_path, toy, knob):
    """As in the reference's ``run_inference``, one of the two knobs alone
    runs the steps and saves nothing."""
    toks, docs, _ = toy
    d = str(tmp_path / "ck")
    kw = {"checkpoint_every": 2} if knob == "checkpoint_every" else \
        {"checkpoint_dir": d}
    m = _fresh(toks, docs)
    m.infer(steps=3, device="cpu", **kw)
    assert len(m.elbo_trace) == 3 and not os.path.exists(d)
