"""The port's LM trainer on a mesh of shards, held to its one-device run.

The reference cannot run a mesh in this process (its 8 fake devices need
``XLA_FLAGS`` before jax starts), and its sharding changes no value; so
the port's mesh run is held to the port's one-device run, which
``tests/test_torch_lm.py`` holds to the reference.

- **One step on (2, 2)**, every architecture of the registry, reduced: the
  loss to rel 1e-5, each gradient leaf's max abs gap at most 1e-4 times its
  max abs value; a batch the data rows split by the sequence, and one they
  cannot split at all.
- **Bitwise**: (1, 1) is the mesh-less step, FSDP the step without it,
  ``act_shard="seq"`` and ``moe_ep_local`` the default, remat the plain
  run, all on one mesh.
- **The reference's 2-D check** (``scripts/dist_checks.py:135``), its
  elastic re-mesh (``:164``), checkpoints gathered whole and resumed on any
  mesh, microbatches.
- **Serving**: prefill and greedy decode against one device for every
  placement of the cache ``Rules.cache`` gives (heads, a few KV heads'
  sequence, batch 1's sequence over data and model, the head dim, the
  recurrent states), whisper's cross K/V and internvl2's patch prefix
  included, ``serve(mesh=)`` giving one device's tokens; zeroed frames or
  patches move the logits past the tolerance; internvl2's mesh prefill
  against the reference's ``prefill`` (whisper's is held to one device
  only: the reference's prefill skips the encoder).
- **Two processes**: gloo children on (1, 2) and (2, 2), bitwise the one
  process run of the same mesh.
"""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import RunConfig as JRun
from repro.models import make_model as j_make_model
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHS, RunConfig, get_arch
from repro_torch.launch import elastic
from repro_torch.launch import steps as S
from repro_torch.launch.dist import ShardGroup
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import restore_state, train
from repro_torch.models import make_model
from repro_torch.models.parallel import ShardedParams, gather_leaves
from repro_torch.models.transformer import modality_inputs, params_from_numpy
from repro_torch.testing import faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
CHILD_TIMEOUT = 300
LOSS_RTOL = 1e-5
GRAD_GAP = 1e-4            # of each leaf's max abs gradient
BASE = dict(seq_len=16, global_batch=4, dtype="float32")


def _cfg(name, layers=2):
    cfg = get_arch(name).reduced()
    return dataclasses.replace(cfg, n_layers=max(layers, len(cfg.pattern)))


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    out["labels"][0, :3] = -1                   # padding labels are masked
    for k in modality_inputs(cfg):
        n = 12 if k == "frames" else cfg.n_patches
        out[k] = rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)
    return out


def _one_device(cfg, run, batch, module):
    built = S.build_train_step(cfg, run, device="cpu")
    return built["loss_and_grads"](module, S.batch_to(batch, "cpu"))


def _on_mesh(cfg, run, batch, module, shape, axes=("data", "model")):
    """(loss, every leaf's gradient gathered whole, the global norm)."""
    mesh = Mesh(shape, axes)
    built = S.build_train_step(cfg, run, device="cpu", mesh=mesh)
    layout = built["layout"]
    params = ShardedParams.from_module(layout, module)
    loss, grads = built["loss_and_grads"](
        params, S.place_batch(batch, mesh, built["rules"], "cpu"))
    stored, gnorm = layout.reduce(grads)
    return loss, gather_leaves(layout, stored), gnorm


def _assert_close(loss, grads, want_loss, want_grads):
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        gap = float((g - w).abs().max())
        assert gap <= GRAD_GAP * float(w.abs().max()), (i, gap)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_one_step_on_2x2_matches_one_device(name):
    cfg = _cfg(name)
    run = RunConfig(**BASE)
    batch = _batch(cfg, 4, 16)
    module = make_model(cfg)["init"](run, device="cpu")
    want_loss, want = _one_device(cfg, run, batch, module)
    loss, grads, gnorm = _on_mesh(cfg, run, batch, module, (2, 2))
    _assert_close(loss, grads, want_loss, want)
    want_norm = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(want)))
    np.testing.assert_allclose(float(gnorm), float(want_norm), rtol=1e-5)


@pytest.mark.parametrize("name,b,s,shape", [
    ("olmo-1b", 1, 16, (2, 2)),             # the rows split the sequence
    ("qwen3-moe-30b-a3b", 1, 16, (2, 1)),
    ("gemma3-4b", 3, 15, (2, 2)),           # neither divides: row 0 counts
    ("olmo-1b", 4, 16, (2, 2, 2))])         # a pod axis folds into data
def test_batches_the_rows_cannot_split_by_rows(name, b, s, shape):
    cfg = _cfg(name)
    run = RunConfig(**dict(BASE, seq_len=s, global_batch=b))
    batch = _batch(cfg, b, s, seed=1)
    module = make_model(cfg)["init"](run, device="cpu")
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    _assert_close(*_on_mesh(cfg, run, batch, module, shape, axes)[:2],
                  *_one_device(cfg, run, batch, module))


# ---------------------------------------------------------------------------
# bitwise equalities through the trainer
# ---------------------------------------------------------------------------

def _trained(cfg, run, shape, steps=2, **kw):
    """``(losses, every leaf after the steps)`` of ``train`` from the seed's
    initialisation, on ``shape`` (None: one device)."""
    module = make_model(cfg)["init"](run, device="cpu")
    mesh = None if shape is None else Mesh(shape, ("data", "model"))
    params, _, losses, _ = train(cfg, run, steps, device="cpu",
                                 params=module, mesh=mesh, log_every=0, **kw)
    if mesh is None:
        return losses, [p.detach() for p in params.parameters()]
    return losses, gather_leaves(params.layout, params.shards)


def _bitwise(a, b):
    assert a[0] == b[0], (a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


TRAIN = dict(seq_len=16, global_batch=8, dtype="float32", warmup=0,
             learning_rate=3e-3)
BITWISE_ARCHS = ("olmo-1b", "gemma3-4b", "qwen3-moe-30b-a3b",
                 "recurrentgemma-2b", "mamba2-370m")


@pytest.mark.parametrize("name", BITWISE_ARCHS)
def test_one_shard_mesh_is_bitwise_the_meshless_step(name):
    cfg, run = _cfg(name), RunConfig(**TRAIN)
    _bitwise(_trained(cfg, run, (1, 1)), _trained(cfg, run, None))


@pytest.mark.parametrize("knob", [dict(fsdp=True), dict(act_shard="seq"),
                                  dict(moe_ep_local=True),
                                  dict(remat="full", fsdp=True)])
@pytest.mark.parametrize("name", BITWISE_ARCHS)
def test_knobs_are_bitwise_the_default_on_one_mesh(name, knob):
    cfg = _cfg(name)
    shape = (2, 4) if knob.get("act_shard") else (2, 2)
    _bitwise(_trained(cfg, RunConfig(**TRAIN, **knob), shape),
             _trained(cfg, RunConfig(**TRAIN), shape))


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "olmo-1b"])
def test_microbatches_on_a_mesh_match_one_device(name):
    cfg = _cfg(name)
    run = RunConfig(**dict(TRAIN, microbatch=2))
    got, want = _trained(cfg, run, (2, 2)), _trained(cfg, run, None)
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="does not split over 4 data rows"):
        _trained(cfg, RunConfig(**dict(TRAIN, microbatch=4)), (4, 1))


def test_the_reference_2d_mesh_check():
    """``check_lm_train_2d_mesh``: qwen3-moe reduced, 4 experts top 2, on
    (4, 2) with FSDP; 3 steps within 1e-4 of one device, the loss falling."""
    cfg = dataclasses.replace(ARCHS["qwen3-moe-30b-a3b"].reduced(),
                              n_layers=2, n_experts=4, experts_per_tok=2)
    run = RunConfig(seq_len=32, global_batch=8, dtype="float32", fsdp=True)
    got, want = _trained(cfg, run, (4, 2), steps=3), \
        _trained(cfg, run, None, steps=3)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert all(np.isfinite(got[0])) and got[0][-1] < got[0][0]


# ---------------------------------------------------------------------------
# checkpoints and elastic re-mesh
# ---------------------------------------------------------------------------

def test_checkpoint_is_the_gathered_tree_and_resumes_anywhere(tmp_path):
    cfg, run = _cfg("olmo-1b"), RunConfig(**dict(TRAIN, fsdp=True))
    ck = str(tmp_path / "ck")
    module = make_model(cfg)["init"](run, device="cpu")
    params, opt, _, _ = train(cfg, run, 2, device="cpu", params=module,
                              mesh=Mesh((2, 2), ("data", "model")),
                              checkpoint_dir=ck, checkpoint_every=2,
                              log_every=0)
    module, opt_back, step = restore_state(cfg, CheckpointStore(ck), "cpu")
    got = [p.detach() for p in module.parameters()]
    for a, b in zip(got, gather_leaves(params.layout, params.shards)):
        assert torch.equal(a, b)
    for a, b in zip(opt_back["nu"], gather_leaves(params.layout, opt["nu"])):
        assert torch.equal(a, b)
    assert step == 2 and opt_back["count"] == 2
    # the next step: on (2, 2) as the uninterrupted run, on (1, 2) and on one
    # device within the one-device tolerance
    straight = _trained(cfg, run, (2, 2), steps=3)[0]
    again = train(cfg, run, 1, device="cpu", checkpoint_dir=ck,
                  mesh=Mesh((2, 2), ("data", "model")), log_every=0)[2]
    assert again == straight[2:]
    for mesh in (Mesh((1, 2), ("data", "model")), None):
        got = train(cfg, run, 1, device="cpu", checkpoint_dir=ck, mesh=mesh,
                    log_every=0)[2]
        np.testing.assert_allclose(got, straight[2:], rtol=LOSS_RTOL)


def test_the_reference_elastic_remesh(tmp_path):
    """``check_elastic_remesh``: 6 steps on (4, 2) checkpointed every 3,
    half the shards lost, 4 more on (2, 2) from the checkpoint: finite and
    below the first run's worst loss; ``remesh_and_resume`` picks up the
    newest checkpoint as ``train`` does."""
    cfg = dataclasses.replace(ARCHS["olmo-1b"].reduced(), n_layers=2)
    run = RunConfig(seq_len=32, global_batch=8, dtype="float32",
                    learning_rate=3e-3, warmup=0)
    ck = str(tmp_path / "ck")
    _, _, losses1, _ = train(cfg, run, 6, device="cpu",
                             mesh=elastic.factor_mesh(8, want_model=2),
                             checkpoint_dir=ck, checkpoint_every=3,
                             log_every=0)
    _, _, losses2, _ = train(cfg, run, 4, device="cpu",
                             mesh=elastic.factor_mesh(4, want_model=2),
                             checkpoint_dir=ck, checkpoint_every=2,
                             log_every=0)
    assert np.isfinite(losses2).all()
    assert min(losses2) < max(losses1), (losses1, losses2)
    params, _, losses3, _ = elastic.remesh_and_resume(
        cfg, run, ck, n_devices=2, want_model=2, steps=2, device="cpu")
    assert params.layout.mesh.shape == {"data": 1, "model": 2}
    assert np.isfinite(losses3).all() and len(losses3) == 2
    assert CheckpointStore(ck).latest() == 12


# ---------------------------------------------------------------------------
# what the mesh refuses
# ---------------------------------------------------------------------------

def test_mesh_and_group_sizes_must_agree():
    with pytest.raises(ValueError, match="a group of 2 shards"):
        Mesh((2, 2), ("data", "model"), group=ShardGroup(2))
    with pytest.raises(ValueError, match="does not fit"):
        Mesh((2,), ("data", "model"))


def test_nccl_is_refused():
    from repro_torch.launch.dist import init_distributed
    with pytest.raises(ValueError, match="NCCL needs a card per rank"):
        init_distributed("127.0.0.1:1", 2, 0, backend="nccl")


# ---------------------------------------------------------------------------
# prefill, decode and serve on a mesh
# ---------------------------------------------------------------------------

def _decode(cfg, run, prompts, new, module, mesh=None, inputs=None):
    """Every logits of a greedy prefill + decode (prefill's last, then each
    step's) and the tokens, on one device or ``mesh``; ``inputs`` the
    model's frames or patches (numpy), a patch prefix counted in the
    positions."""
    b, s0 = prompts.shape
    inputs = inputs or {}
    s0 += inputs["patches"].shape[1] if "patches" in inputs else 0
    pre = S.build_prefill_step(cfg, run, "cpu", mesh=mesh)
    if mesh is None:
        dec, params = S.build_decode_step(cfg, run, "cpu"), module
    else:
        dec = S.build_decode_step(cfg, run, "cpu", mesh=mesh)
        params = ShardedParams.from_module(pre["server"].layout, module)
    with torch.inference_mode():
        logits, cache = pre["fn"](params, S.batch_to(
            dict(inputs, tokens=prompts), "cpu"), s0 + new)
        out, toks = [logits.clone()], []
        for i in range(new):
            toks.append(logits.argmax(-1))
            logits, cache = dec["fn"](params, cache, toks[-1][:, None],
                                      s0 + i)
            out.append(logits.clone())
    return out, torch.stack(toks, 1), cache


def _inputs(cfg, b, seed, frames=12, scale=1.0):
    """The model's frames (``frames`` of them) or patches from ``seed``,
    times ``scale`` (0: zeroed); ``{}`` for a decoder alone."""
    rng = np.random.default_rng(seed)
    return {k: (scale * rng.normal(size=(
        b, frames if k == "frames" else cfg.n_patches,
        cfg.d_model))).astype(np.float32) for k in modality_inputs(cfg)}


def _local_shape_fits(cache_t, spec, full, mesh):
    from repro_torch.launch.shardings import shard_slices
    sl = shard_slices(spec, full, mesh, mesh.local_shards[-1])
    assert tuple(cache_t.shape) == tuple(
        len(range(*x.indices(n))) for x, n in zip(sl, full))


# (arch, batch, prompt, new tokens, mesh, the K/V spec it must take, in the
# port's (B, KV, S, Dh) layout, of the layer kind named)
DECODE_CASES = [
    ("olmo-1b", 4, 8, 6, (2, 2), "global", ("data", "model", None, None)),
    ("olmo-1b", 1, 8, 6, (2, 1), "global", (None, "model", "data", None)),
    ("gemma3-4b", 2, 8, 14, (1, 4), "local", ("data", None, "model", None)),
    ("gemma3-4b", 2, 8, 14, (1, 4), "global", ("data", None, None, "model")),
    ("recurrentgemma-2b", 1, 8, 8, (2, 2), "local",
     (None, None, ("data", "model"), None)),
    ("h2o-danube-1.8b", 2, 40, 6, (1, 2), "local",
     ("data", "model", None, None)),
    ("qwen3-moe-30b-a3b", 4, 8, 6, (2, 2), "global",
     ("data", "model", None, None)),
    ("mamba2-370m", 1, 8, 6, (8, 1), None, None),
    # whisper (2 KV heads) against CROSS's frames, internvl2 (2 KV heads)
    # after its 8 patches, which the cache's length counts
    ("whisper-large-v3", 4, 8, 6, (2, 2), "global",
     ("data", "model", None, None)),
    ("whisper-large-v3", 1, 8, 6, (2, 1), "global",
     (None, "model", "data", None)),
    ("whisper-large-v3", 2, 8, 8, (1, 4), "global",
     ("data", None, "model", None)),
    ("whisper-large-v3", 2, 8, 6, (1, 4), "global",
     ("data", None, None, "model")),
    ("whisper-large-v3", 1, 8, 8, (2, 4), "global",
     (None, None, ("data", "model"), None)),
    ("internvl2-1b", 2, 8, 8, (1, 4), "global",
     ("data", None, "model", None)),
    ("internvl2-1b", 4, 8, 6, (2, 2), "global",
     ("data", "model", None, None)),
    ("internvl2-1b", 2, 8, 6, (1, 4), "global",
     ("data", None, None, "model")),
    ("internvl2-1b", 1, 8, 6, (2, 1), "global",
     (None, "model", "data", None))]

# whisper's cases: (its frames, the spec its cross K/V must take): heads
# over model, batch 1's sequence over data (and model), the head dim where
# 14 frames do not split over 4 model shards, the sequence over model
CROSS = {(4, (2, 2), 8, 6): (12, ("data", "model", None, None)),
         (1, (2, 1), 8, 6): (12, (None, "model", "data", None)),
         (2, (1, 4), 8, 8): (14, ("data", None, None, "model")),
         (2, (1, 4), 8, 6): (12, ("data", None, "model", None)),
         (1, (2, 4), 8, 8): (16, (None, None, ("data", "model"), None))}


@pytest.mark.parametrize("name,b,s0,new,shape,kind,spec", DECODE_CASES)
def test_decode_on_a_mesh_matches_one_device(name, b, s0, new, shape, kind,
                                             spec):
    """Prefill and greedy decode against one device: the same tokens, the
    logits within 1e-5 (f32; a split sequence or head dim sums in another
    order), the cache placed as ``Rules.cache`` places it: heads over model,
    a few KV heads' sequence over model, batch 1's over data (and model),
    the head dim where nothing else divides; mamba2 at batch 1 on (8, 1) is
    the reference's ``check_long_context_sp_decode``.  whisper's cross K/V
    takes its own placement (``CROSS``) at the frames' length."""
    cfg = _cfg(name)
    run = RunConfig(**dict(BASE, seq_len=s0, global_batch=b))
    module = make_model(cfg)["init"](run, device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (b, s0))
    frames, cross = CROSS.get((b, shape, s0, new), (12, None)) \
        if cfg.family == "encdec" else (0, None)
    inputs = _inputs(cfg, b, 2, frames)
    want, wt, _ = _decode(cfg, run, prompts, new, module, inputs=inputs)
    mesh = Mesh(shape, ("data", "model"))
    got, gt, cache = _decode(cfg, run, prompts, new, module, mesh, inputs)
    assert torch.equal(gt, wt)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    if kind is not None:
        j = cfg.layer_kinds().index(kind)
        assert cache.specs[j]["k"] == spec
        local = cache.shards[mesh.local_shards[-1]][j]
        _local_shape_fits(local["k"], spec, (b, cfg.n_kv_heads,
                                             cache.lengths[j],
                                             cfg.head_dim_), mesh)
        if kind == "global":
            assert cache.lengths[j] == s0 + new + (
                cfg.n_patches if "patches" in inputs else 0)
        assert ("cross" in local) == (cross is not None)
        if cross is not None:
            assert cache.specs[j]["cross"]["k"] == cross
            assert cache.cross_lengths[j] == frames
            _local_shape_fits(local["cross"]["v"], cross, (
                b, cfg.n_kv_heads, frames, cfg.head_dim_), mesh)


def test_one_shard_decode_is_bitwise_one_device():
    cfg = _cfg("gemma3-4b")
    run = RunConfig(**dict(BASE, seq_len=8, global_batch=2))
    module = make_model(cfg)["init"](run, device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8))
    want, wt, _ = _decode(cfg, run, prompts, 12, module)
    got, gt, _ = _decode(cfg, run, prompts, 12, module,
                         Mesh((1, 1), ("data", "model")))
    assert torch.equal(gt, wt)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("name", ["whisper-large-v3", "internvl2-1b"])
def test_one_shard_modality_decode_is_bitwise_one_device(name):
    """The encoder, the cross K/V and the patch prefix on (1, 1) run every
    op of the one-device prefill and decode."""
    cfg = _cfg(name)
    run = RunConfig(**dict(BASE, seq_len=8, global_batch=2))
    module = make_model(cfg)["init"](run, device="cpu")
    prompts = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8))
    inputs = _inputs(cfg, 2, 3)
    want, wt, _ = _decode(cfg, run, prompts, 8, module, inputs=inputs)
    got, gt, _ = _decode(cfg, run, prompts, 8, module,
                         Mesh((1, 1), ("data", "model")), inputs)
    assert torch.equal(gt, wt)
    assert all(torch.equal(a, w) for a, w in zip(got, want))


@pytest.mark.parametrize("name,b,shape", [("whisper-large-v3", 4, (2, 2)),
                                          ("internvl2-1b", 2, (1, 4))])
def test_zeroed_modality_inputs_leave_the_tolerance_on_a_mesh(name, b, shape):
    """The mesh reads the frames and the patches: zeroing them moves the
    prefill's logits and the decode's past the 1e-5 that holds the mesh to
    one device, and past 100 times the mesh's own gap."""
    cfg = _cfg(name)
    run = RunConfig(**dict(BASE, seq_len=8, global_batch=b))
    module = make_model(cfg)["init"](run, device="cpu")
    prompts = np.random.default_rng(6).integers(0, cfg.vocab, (b, 8))
    mesh = Mesh(shape, ("data", "model"))
    want, _, _ = _decode(cfg, run, prompts, 4, module,
                         inputs=_inputs(cfg, b, 6))
    got, _, _ = _decode(cfg, run, prompts, 4, module, mesh,
                        _inputs(cfg, b, 6))
    zeroed, _, _ = _decode(cfg, run, prompts, 4, module, mesh,
                           _inputs(cfg, b, 6, scale=0.0))
    gap = max(float((a - w).abs().max()) for a, w in zip(got, want))
    for z, w in zip(zeroed, want):
        moved = float((z - w).abs().max())
        assert moved > max(1e-5, 100 * gap), (moved, gap)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_vlm_mesh_prefill_matches_the_reference(shape):
    """internvl2's prefill on a mesh, the sequence (1, 4) or the heads (2,
    2) of its cache over the model shards, against the reference's
    ``prefill`` from the same parameters: the last logits within
    ``tests/test_torch_encoder.py``'s 1e-5."""
    name = "internvl2-1b"
    cfg, jcfg = get_arch(name).reduced(), J_ARCHS[name].reduced()
    kw = dict(seq_len=16, global_batch=2, dtype="float32")
    run, jrun = RunConfig(**kw), JRun(**kw)
    tree = jax.tree_util.tree_map(np.asarray, j_make_model(jcfg)["init"](
        jrun, jax.random.PRNGKey(0)))
    module = params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
             "patches": rng.normal(size=(2, cfg.n_patches, cfg.d_model))
             .astype(np.float32)}
    cache_len = cfg.n_patches + 16 + 8
    want, _ = jax.jit(lambda p, b: j_make_model(jcfg)["prefill"](
        p, b, jrun, cache_len))(jax.tree_util.tree_map(jnp.asarray, tree),
                                {k: jnp.asarray(v) for k, v in batch.items()})
    mesh = Mesh(shape, ("data", "model"))
    built = S.build_prefill_step(cfg, run, "cpu", mesh=mesh)
    got, cache = built["fn"](ShardedParams.from_module(
        built["server"].layout, module), S.batch_to(batch, "cpu"), cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert cache.lengths == [cache_len] * cfg.n_layers


@pytest.mark.parametrize("name,b,shape", [("olmo-1b", 8, (1, 2)),
                                          ("olmo-1b", 1, (2, 1))])
def test_serve_on_a_mesh_gives_the_one_device_tokens(name, b, shape):
    cfg = _cfg(name)
    run = RunConfig(**dict(BASE, seq_len=8, global_batch=b))
    module = make_model(cfg)["init"](run, device="cpu")
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (b, 8))
    from repro_torch.launch.serve import serve
    want, _ = serve(cfg, run, prompts, 6, device="cpu", params=module)
    got, stats = serve(cfg, run, prompts, 6, device="cpu", params=module,
                       mesh=Mesh(shape, ("data", "model")))
    np.testing.assert_array_equal(got, want)
    assert stats["batch"] == b and stats["tokens_per_s"] > 0


# ---------------------------------------------------------------------------
# two processes (gloo) against one
# ---------------------------------------------------------------------------

_CHILD = """
import sys; sys.path.insert(0, {src!r})
import dataclasses
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.configs import RunConfig, get_arch
from repro_torch.launch.dist import init_distributed
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.train import train
from repro_torch.models import make_model
from repro_torch.models.parallel import gather_leaves
if {world} > 1:
    init_distributed("127.0.0.1:{port}", {world}, {rank})
cfg = get_arch({name!r}).reduced()
cfg = dataclasses.replace(cfg, n_layers=max(2, len(cfg.pattern)))
run = RunConfig(seq_len=16, global_batch=4, dtype="float32", warmup=0,
                learning_rate=3e-3, **{kw!r})
mesh = Mesh({shape!r}, ("data", "model"))
module = make_model(cfg)["init"](run, device="cpu")
params, opt, losses, _ = train(cfg, run, 2, device="cpu", params=module,
                               mesh=mesh, log_every=0)
leaves = gather_leaves(params.layout, params.shards)
nu = gather_leaves(params.layout, opt["nu"])
g = mesh.group
print("WIRE", sum(g.wire.values()), g.calls, flush=True)
if {rank} == 0:
    np.savez({out!r}, losses=np.asarray(losses, np.float64),
             **{{f"p{{i}}": t.numpy() for i, t in enumerate(leaves)}},
             **{{f"nu{{i}}": t.numpy() for i, t in enumerate(nu)}})
print("DONE", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _reap(p):
    try:
        _, err = p.communicate(timeout=CHILD_TIMEOUT)
    except Exception:
        faults.sigkill(p)
        raise
    return err


@pytest.mark.parametrize("name,shape,kw", [
    ("olmo-1b", (1, 2), {}),
    ("qwen3-moe-30b-a3b", (2, 2), dict(fsdp=True, act_shard="seq"))])
def test_two_processes_are_bitwise_one(name, shape, kw, tmp_path):
    """Two gloo ranks, each running its block of the mesh's shards, give
    the bits of one process running every shard: every exchange is taken
    in shard order from the same bits."""
    port = _free_port()
    outs = {w: str(tmp_path / f"w{w}.npz") for w in (1, 2)}
    procs = [faults.spawn_child(_CHILD.format(
        src=SRC, world=2, port=port, rank=r, name=name, kw=kw, shape=shape,
        out=outs[2])) for r in (0, 1)]
    for p in procs:
        ok = faults.wait_for_marker(p, "DONE", timeout=CHILD_TIMEOUT)
        err = _reap(p)
        assert ok and p.returncode == 0, f"gloo child failed:\n{err[-4000:]}"
    one = faults.run_child(_CHILD.format(
        src=SRC, world=1, port=0, rank=0, name=name, kw=kw, shape=shape,
        out=outs[1]), timeout=CHILD_TIMEOUT)
    assert one.returncode == 0, one.stderr[-4000:]
    assert "WIRE 0 " in one.stdout
    a, b = np.load(outs[2]), np.load(outs[1])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
