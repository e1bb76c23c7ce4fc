"""The port's sharding rules, meshes and gradient compression, held to the
reference (``repro.launch.shardings``, ``repro.launch.elastic``,
``repro.optim.adamw``).

- **Rules parity**: ``Rules`` gives the reference's ``PartitionSpec`` on
  every parameter, AdamW moment, batch and decode-cache leaf of every
  architecture of the registry, at reduced and full widths (the
  reference's trees through ``jax.eval_shape``), on meshes (1, 1), (8, 1),
  (4, 2), (2, 4) and (1, 8), with and without FSDP.  A duck-typed mesh (its
  ``axis_names`` and ``shape``) stands in for the reference's, which would
  need 8 devices in this process.
- **Slices**: each shard's slice of a spec, the owners of replicated
  slices, and the mesh's ordered axis sums.
- **Compression**: ``compress_decompress`` bitwise the reference's on
  seeded inputs, and the reference's error-feedback test.
- **Elastic**: ``factor_counts`` as the reference's (and its table in
  ``tests/test_streaming.py``), ``remesh_and_resume``'s divisibility check.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.optim import adamw as joptim
from repro.configs import ARCHS as J_ARCHS
from repro.configs import RunConfig as JRun
from repro.launch import elastic as jelastic
from repro.launch.shardings import Rules as JRules
from repro.models import make_model as j_make_model
from repro_torch.configs import RunConfig
from repro_torch.configs import get_arch
from repro_torch.launch import elastic, shardings
from repro_torch.launch.mesh import (Mesh, axis_size, data_axes,
                                     make_host_mesh, model_axis)
from repro_torch.models import sharding_ctx
from repro_torch.optim import compress_decompress, compress_init

MESHES = [(1, 1), (8, 1), (4, 2), (2, 4), (1, 8)]


def _duck(shape, axes=("data", "model")):
    return types.SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))


def _norm(entry):
    """A spec entry as ``PartitionSpec`` normalises it: a 1-tuple of names
    is the name, an empty tuple None."""
    if isinstance(entry, tuple):
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def _flat_ref(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(_norm(e) for e in spec)
            for path, spec in flat}


def _flat_port(tree, prefix=""):
    out = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tuple(_norm(e) for e in tree)}
    for k, v in items:
        out.update(_flat_port(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _port_specs(rules, tree, kind):
    """The port's spec of every leaf of the reference's shape tree, by
    path, through ``param_spec`` or ``cache_leaf``."""
    fn = rules.param_spec if kind == "params" else rules.cache_leaf
    return {p: tuple(_norm(e) for e in fn(p, leaf.shape))
            for p, leaf in _leaves(tree)}


def _leaves(tree, prefix=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _leaves(v, f"{prefix}/{k}" if prefix else str(k))
    return out


@pytest.fixture(scope="module")
def shapes():
    """Per (arch, width): the reference's parameter and cache shape trees
    (``jax.eval_shape``), built once."""
    cache = {}

    def get(name, width):
        if (name, width) not in cache:
            cfg = J_ARCHS[name] if width == "full" else J_ARCHS[name].reduced()
            model = j_make_model(cfg)
            run = JRun(seq_len=64, global_batch=8)
            params = jax.eval_shape(
                lambda: model["init"](run, jax.random.PRNGKey(0)))
            caches = {b: jax.eval_shape(
                lambda b=b: model["init_cache"](run, b, 64)) for b in (1, 8)}
            cache[(name, width)] = (cfg, params, caches)
        return cache[(name, width)]
    return get


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_rules_give_the_reference_specs(name, width, shapes):
    jcfg, params, caches = shapes(name, width)
    cfg = get_arch(name) if width == "full" else get_arch(name).reduced()
    d = cfg.d_model
    batches = [{"tokens": (b, 64), "labels": (b, 64), "frames": (b, 48, d),
                "patches": (b, 8, d), "pos": (b,)} for b in (8, 1, 3)]
    for shape in MESHES:
        for fsdp in (False, True):
            mesh = _duck(shape)
            ref = JRules(jcfg, JRun(fsdp=fsdp), mesh)
            port = shardings.Rules(cfg, RunConfig(fsdp=fsdp), mesh)
            want = _flat_ref(ref.params(params))
            got = _port_specs(port, params, "params")
            assert got == want, (shape, fsdp)
            # AdamW's moments follow the parameters; the count is replicated
            o_ref = ref.opt_state(None, ref.params(params))
            o_port = port.opt_state(None, port.params(params))
            assert _flat_port(o_port["mu"]) == _flat_ref(o_ref["mu"])
            assert _flat_port(o_port["nu"]) == _flat_ref(o_ref["nu"])
            assert o_port["count"] == tuple(o_ref["count"]) == ()
            for b in batches:
                sds = {k: jax.ShapeDtypeStruct(v, np.int32)
                       for k, v in b.items()}
                want = {k: tuple(_norm(e) for e in v)
                        for k, v in ref.batch(sds).items()}
                got = {k: tuple(_norm(e) for e in v)
                       for k, v in port.batch(sds).items()}
                assert got == want, (shape, fsdp, b)
            for b, tree in caches.items():
                want = _flat_ref(ref.cache(tree))
                assert _port_specs(port, tree, "cache") == want, (shape, b)
                assert _flat_port(port.cache(tree)) == want


def test_rules_tree_keeps_the_reference_paths(shapes):
    jcfg, params, _ = shapes("whisper-large-v3", "reduced")
    port = shardings.Rules(get_arch("whisper-large-v3").reduced(),
                           RunConfig(fsdp=True), _duck((4, 2)))
    ref = JRules(jcfg, JRun(fsdp=True), _duck((4, 2)))
    assert _flat_port(port.params(params)) == _flat_ref(ref.params(params))
    assert "encoder/scan/0/attn/wq" in _flat_port(port.params(params))


def test_mesh_helpers_match_the_reference():
    from repro.launch import mesh as jmesh
    for shape, axes in (((4, 2), ("data", "model")),
                        ((2, 2, 2), ("pod", "data", "model")),
                        ((8,), ("data",))):
        mesh, duck = Mesh(shape, axes), _duck(shape, axes)
        assert data_axes(mesh) == jmesh.data_axes(duck)
        assert model_axis(mesh) == jmesh.model_axis(duck)
        for a in (None, "data", axes, axes[-1]):
            assert axis_size(mesh, a) == jmesh.axis_size(duck, a)
        assert mesh.size == int(np.prod(shape))
    mesh = make_host_mesh()
    assert mesh.shape == {"data": 1} and mesh.local_shards == [0]
    with pytest.raises(ValueError, match="model axis comes last"):
        Mesh((2, 2), ("model", "data"))


def test_mesh_rows_columns_and_ordered_sums():
    mesh = Mesh((2, 3), ("data", "model"))
    assert mesh.coords(5) == {"data": 1, "model": 2}
    assert mesh.axis_group(4, ("model",)) == [3, 4, 5]
    assert mesh.axis_group(4, ("data",)) == [1, 4]
    big = [[torch.tensor([10.0 ** (8 * s)])] for s in range(6)]
    rows = mesh.sum_model(big, "x")
    for s in range(6):
        row = mesh.axis_group(s, ("model",))
        want = big[row[0]][0]
        for t in row[1:]:
            want = want + big[t][0]
        assert torch.equal(rows[s][0], want)
    cols = mesh.sum_data(big, "x")
    assert torch.equal(cols[4][0], big[1][0] + big[4][0])
    assert mesh.group.payload == {"x": 2 * 6 * 4}
    got = mesh.gather_model(big, "y")
    assert [g[0] for g in got[3]] == [big[t][0] for t in (3, 4, 5)]


def test_shard_slices_owners_and_place():
    mesh = Mesh((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    spec = (("pod", "data"), "model")
    parts = shardings.place(x, spec, mesh, range(8))
    for s in range(8):
        c = mesh.coords(s)
        i = 2 * c["pod"] + c["data"]
        assert torch.equal(parts[s], x[2 * i:2 * i + 2,
                                       3 * c["model"]:3 * c["model"] + 3])
        assert parts[s].is_contiguous()
    # FSDP's "data" alone: the pods hold replicas, pod 0 owns them
    spec = ("data", None)
    assert shardings.shard_slices(spec, (8, 6), mesh, 6) == (
        slice(4, 8), slice(None))
    assert [s for s in range(8) if shardings.owns(spec, mesh, s)] == [0, 2]
    assert [s for s in range(8) if shardings.owns((None, None), mesh, s)] \
        == [0]
    with pytest.raises(ValueError, match="does not split"):
        shardings.shard_slices(("model",), (3,), mesh, 0)


def test_constrain_outside_a_mesh_changes_nothing():
    x = torch.ones(2, 4, 3)
    assert sharding_ctx.constrain(x, ("dp", "tp", None)) is x
    mesh = Mesh((1, 2), ("data", "model"))
    xs = [torch.arange(24.0).reshape(2, 4, 3)] * 2
    with sharding_ctx.mesh_ctx(mesh, ("data",), "model"):
        kept = sharding_ctx.constrain(xs, ("dp", "tp", None))
        assert torch.equal(kept[1], xs[1][:, 2:])
        odd = [torch.ones(2, 3, 3)] * 2
        assert sharding_ctx.constrain(odd, ("dp", "tp", None))[0].shape == \
            (2, 3, 3)
    assert sharding_ctx._CTX["mesh"] is None


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_decompress_is_bitwise_the_reference(seed):
    rng = np.random.default_rng(seed)
    grads = [rng.normal(size=(64,)).astype(np.float32) * 10 ** seed,
             rng.normal(size=(7, 5)).astype(np.float32),
             np.zeros((3,), np.float32)]
    res = [rng.normal(size=g.shape).astype(np.float32) * 0.01 for g in grads]
    jd, jr = joptim.compress_decompress([jnp.asarray(g) for g in grads],
                                        [jnp.asarray(r) for r in res])
    td, tr = compress_decompress([torch.from_numpy(g) for g in grads],
                                 [torch.from_numpy(r) for r in res])
    for a, b in zip(list(td) + list(tr), list(jd) + list(jr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    init = compress_init([torch.ones(3, dtype=torch.bfloat16)])
    assert init[0].dtype == torch.float32 and not init[0].any()


def test_compression_error_feedback():
    """The reference's test: quantization error is carried, not lost."""
    rng = np.random.default_rng(0)
    g_true = [rng.normal(size=(64,)).astype(np.float32) for _ in range(30)]
    res = compress_init([torch.zeros(64)])
    acc_deq, acc_true = np.zeros(64), np.zeros(64)
    for g in g_true:
        deq, res = compress_decompress([torch.from_numpy(g)], res)
        acc_deq += deq[0].numpy()
        acc_true += g
    assert np.abs(acc_deq - acc_true).max() < 0.1


# ---------------------------------------------------------------------------
# elastic
# ---------------------------------------------------------------------------

def test_factor_counts_match_the_reference():
    for n in range(1, 33):
        for want in (0, 1, 2, 3, 4, 8, 16, 64):
            assert elastic.factor_counts(n, want) == \
                jelastic.factor_counts(n, want), (n, want)
    # tests/test_streaming.py's table
    assert elastic.factor_counts(8, 4) == (2, 4)
    assert elastic.factor_counts(6, 4) == (3, 2)
    assert elastic.factor_counts(5, 4) == (5, 1)
    assert elastic.factor_counts(7, 0) == (7, 1)
    mesh = elastic.factor_mesh(6, want_model=4)
    assert mesh.shape == {"data": 3, "model": 2}


def test_remesh_rejects_an_indivisible_batch(tmp_path):
    run = RunConfig(seq_len=8, global_batch=4)
    with pytest.raises(ValueError, match="data=3"):
        elastic.remesh_and_resume(get_arch("olmo-1b").reduced(), run,
                                  str(tmp_path), n_devices=6, want_model=4,
                                  device="cpu")
