"""The encoder and the modality frontends of the port on the CPU: reduced
whisper-large-v3 (2 encoder and 2 decoder layers, the stub's frames as
embeddings) and reduced internvl2-1b (2 layers, a prefix of 8 patch
embeddings), held to the JAX reference on the same numpy inputs and
weights (``params_from_numpy``), all in f32.  Whisper's encoder reads 24
frames against 16 decoder tokens, so that a cross cache laid out on the
wrong axis cannot pass.

Tolerances, each with its reason (those of ``tests/test_torch_lm.py`` and
``tests/test_torch_serve.py``):

- losses: rtol 1e-5 (``LOSS_TOL``), f32 sums over the vocabulary and the
  width in another order across frameworks;
- gradients: rtol 2e-4, atol 2e-6 (``GRAD_TOL``), a backward pass
  compounding those orders;
- layers, logits and caches against the reference's: rtol = atol = 1e-5
  (``LAYER_TOL``), f32 rounding;
- the port's decode against its own training forward: the reference's
  ``test_decode_matches_full_forward`` tolerance, rtol = atol = 2e-3
  (``DECODE_TOL``);
- round trips, a resumed run against an uninterrupted one, and
  ``batch_to``: equal.

The reference's encoder-decoder prefill runs every decoder layer's
cross-attention without the encoder's output (``_apply_stack_prefill``
hands ``_block_train`` no ``enc``), so its prefill never sees the frames;
its decode steps read the cross caches that ``_fill_cross`` fills
afterwards.  The port's prefill reads the encoder as its training forward
and its decode do: whisper's prefill is held to the reference's training
forward, its decode to the reference's ``decode_step`` fed the port's
cache, and the defect is pinned on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.configs import RunConfig as JRun
from repro.models import layers as JL
from repro.models import make_model as j_make_model
from repro.models import transformer as JT
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import RunConfig, get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import (cache_from_numpy, cache_to_numpy, layers as TL,
                                make_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw_init

LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
WHISPER, VLM = "whisper-large-v3", "internvl2-1b"
MODELS = (WHISPER, VLM)
FRAMES, TOKENS = 24, 16


def _runs(**kw):
    kw = dict(dict(seq_len=TOKENS, global_batch=2, dtype="float32"), **kw)
    return RunConfig(**kw), JRun(**kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _jax_params(jcfg, jrun, seed=0):
    """The reference's initial parameters as numpy, norms moved off their
    identity so that the scale and bias paths count."""
    tree = _np_tree(j_make_model(jcfg)["init"](jrun, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        if getattr(path[-1], "key", None) in ("scale", "bias"):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _batch(cfg, b, s, seed=0, labels=True, masked=True):
    """Tokens (and labels, the first three of stream 0 masked unless not
    ``masked``) and the model's frames or patches, from one numpy seed."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if labels:
        out["labels"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        out["labels"][0, :3] = -1 if masked else out["labels"][0, :3]
    n = FRAMES if cfg.family == "encdec" else cfg.n_patches
    key = "frames" if cfg.family == "encdec" else "patches"
    out[key] = rng.normal(size=(b, n, cfg.d_model)).astype(np.float32)
    return out


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_trees_close(got, want, **tol):
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, b, **tol)


def _assert_trees_equal(got, want):
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


class _Models:
    """One architecture's two models over one reference state."""

    def __init__(self, name, **run_kw):
        self.cfg = get_arch(name).reduced()
        self.jcfg = J_ARCHS[name].reduced()
        self.run, self.jrun = _runs(**run_kw)
        self.tree = _jax_params(self.jcfg, self.jrun)
        self.jm = j_make_model(self.jcfg)
        self.jp = jax.tree_util.tree_map(jnp.asarray, self.tree)
        self.m = make_model(self.cfg)
        self.mod = params_from_numpy(self.cfg, self.tree, device="cpu")

    def prefill(self, batch, cache_len=0):
        """The port's prefill: (last logits as numpy, cache)."""
        logits, cache = self.m["prefill"](
            self.mod, tsteps.batch_to(batch, "cpu"), self.run, cache_len)
        return logits.numpy(), cache

    def jprefill(self, batch, cache_len=0):
        logits, cache = jax.jit(lambda p, b: self.jm["prefill"](
            p, b, self.jrun, cache_len))(self.jp, _jbatch(batch))
        return np.asarray(logits), cache

    def jdecode(self):
        return jax.jit(lambda p, c, t, pos: self.jm["decode_step"](
            p, c, t, pos, self.jrun))

    def jforward(self, batch):
        """The reference's training forward of an encoder-decoder, as its
        ``_train_loss_encdec`` computes it: every decoder position's
        logits, the decoder reading the encoder's output."""
        cfg, run, p = self.jcfg, self.jrun, self.jp
        dt = JL._dtype(run)
        frames = jnp.asarray(batch["frames"]).astype(dt) @ \
            p["frontend_proj"].astype(dt)
        enc = JT._apply_stack(p["encoder"], frames, cfg, run,
                              jnp.arange(frames.shape[1])[None, :],
                              kinds=("global",), causal=False)
        enc = JL.apply_norm(p["enc_norm"], enc, cfg)
        x = JT._embed(p, jnp.asarray(batch["tokens"]), cfg, run)
        x = JT._apply_stack(p["blocks"], x, cfg, run,
                            jnp.arange(x.shape[1])[None, :], enc=enc)
        return np.asarray(JT._logits(p, x, cfg, run))

    def forward(self, batch):
        tb = tsteps.batch_to(batch, "cpu")
        with torch.no_grad():
            return TT.forward(self.mod, tb["tokens"], self.cfg, self.run,
                              patches=tb.get("patches"),
                              frames=tb.get("frames")).numpy()


def _grads_tree(cfg, module, grads):
    return params_to_numpy(cfg, module, grads)


def _loss_and_grads(mods, batch, run=None):
    loss = mods.m["train_loss"](mods.mod, tsteps.batch_to(batch, "cpu"),
                                run or mods.run)
    return loss.detach(), torch.autograd.grad(loss,
                                              list(mods.mod.parameters()))


# ---------------------------------------------------------------------------
# repairs and layers
# ---------------------------------------------------------------------------

def test_batch_to_keeps_float_entries_bitwise():
    """``frames`` and ``patches`` stay f32, bit for bit; integer entries
    become int64."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 500, (2, 5)).astype(np.int32),
             "labels": rng.integers(0, 500, (2, 5)).astype(np.int32),
             "frames": rng.normal(size=(2, 3, 8)).astype(np.float32) * 1e3,
             "patches": (rng.normal(size=(2, 4, 8)) + 0.5).astype(np.float32)}
    got = tsteps.batch_to(batch, "cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int64
        np.testing.assert_array_equal(got[k].numpy(), batch[k])
    for k in ("frames", "patches"):
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), batch[k])


@pytest.mark.parametrize("kvh", [4, 2])
def test_cross_attention_train_matches_reference(kvh):
    """Queries from x (16 positions), keys and values from enc (24), no
    RoPE, unmasked; GQA at 2 kv heads too."""
    cfg = dataclasses.replace(get_arch(WHISPER).reduced(), n_kv_heads=kvh)
    jcfg = dataclasses.replace(J_ARCHS[WHISPER].reduced(), n_kv_heads=kvh)
    run, jrun = _runs()
    p = _np_tree(JL.init_attention(jax.random.PRNGKey(3), jcfg, cross=True))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, TOKENS, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, FRAMES, cfg.d_model)).astype(np.float32)
    pos = np.arange(TOKENS)[None, :]
    want = JL.attention_train(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), jcfg, jrun, kind="global",
                              positions=jnp.asarray(pos),
                              enc=jnp.asarray(enc))
    got = TL.attention_train({k: _t(v) for k, v in p.items()}, _t(x), cfg,
                             run, kind="global", positions=_t(pos),
                             enc=_t(enc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("kvh", [4, 2])
def test_cross_attention_decode_matches_reference(kvh):
    """One token against the encoder's K/V, the port's cache head-major
    (B, KV, S_enc, Dh), the reference's (B, S_enc, KV, Dh)."""
    cfg = dataclasses.replace(get_arch(WHISPER).reduced(), n_kv_heads=kvh)
    jcfg = dataclasses.replace(J_ARCHS[WHISPER].reduced(), n_kv_heads=kvh)
    run, jrun = _runs()
    p = _np_tree(JL.init_attention(jax.random.PRNGKey(5), jcfg, cross=True))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.normal(size=(2, FRAMES, kvh, cfg.head_dim_)).astype(
        np.float32) for _ in range(2))
    want = JL.cross_attention_decode(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, jcfg, jrun)
    got = TL.cross_attention_decode(
        {n: _t(a) for n, a in p.items()}, _t(x),
        {"k": _t(k.swapaxes(1, 2)), "v": _t(v.swapaxes(1, 2))}, cfg, run)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# ---------------------------------------------------------------------------
# the model: parameters, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MODELS)
def test_make_model_builds_the_full_width_model(name):
    """The full configuration's module (on the meta device) has the
    reference's parameter tree, shapes and count."""
    cfg = get_arch(name)
    shell = TT.Decoder(cfg, None, "meta")
    want = jax.eval_shape(lambda: j_make_model(J_ARCHS[name])["init"](
        JRun(), jax.random.PRNGKey(0)))
    got = params_to_numpy(cfg, shell, [torch.empty(p.shape) for p in
                                       shell.parameters()])
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    assert [a.shape for a in gl] == [tuple(w.shape) for w in wl]
    assert sum(p.numel() for p in shell.parameters()) == \
        sum(int(np.prod(w.shape)) for w in wl)
    assert TT.modality_inputs(cfg) == (("frames",) if name == WHISPER
                                       else ("patches",))


@pytest.mark.parametrize("name", MODELS)
def test_port_init_has_the_reference_tree_and_scales(name):
    """The port's own initialisation: the reference's tree of shapes, f32;
    ``frontend_proj`` at 1/sqrt(d), layernorm's scale 1 and bias 0."""
    cfg = dataclasses.replace(get_arch(name).reduced(), d_model=128,
                              d_ff=256)
    jcfg = dataclasses.replace(J_ARCHS[name].reduced(), d_model=128,
                               d_ff=256)
    run, jrun = _runs()
    module = make_model(cfg)["init"](run, torch.Generator().manual_seed(0),
                                     "cpu")
    got = params_to_numpy(cfg, module)
    want = _np_tree(j_make_model(jcfg)["init"](jrun, jax.random.PRNGKey(0)))
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    assert [(a.shape, a.dtype) for a in gl] == [(w.shape, w.dtype)
                                                for w in wl]
    assert abs(got["frontend_proj"].std() * np.sqrt(128) - 1) < 0.05
    if name == WHISPER:
        norms = [got["enc_norm"], got["final_norm"]] + \
            [got["blocks"]["scan"][0][n] for n in ("norm1", "cross_norm",
                                                    "norm2")]
        for n in norms:
            assert (n["scale"] == 1).all() and (n["bias"] == 0).all()


@pytest.mark.parametrize("name", MODELS)
def test_params_round_trip_is_bitwise(name):
    _, jrun = _runs()
    cfg, jcfg = get_arch(name).reduced(), J_ARCHS[name].reduced()
    tree = _jax_params(jcfg, jrun)
    _assert_trees_equal(params_to_numpy(cfg, params_from_numpy(cfg, tree,
                                                               "cpu")), tree)


# (arch, flash kernel, text tokens, attn_chunk): the dense decoder path, the
# flash kernel's path, and a sequence long enough for _sdpa_flash (32 > 2 x
# 8; internvl2's 8 patches and 24 tokens, whisper's 32 tokens, whose encoder
# of 24 frames stays dense as every non-causal attention does)
LOSS_CASES = [(name, flash, s, chunk) for name in MODELS
              for flash, s, chunk in [(False, TOKENS, 1024),
                                      (True, TOKENS, 1024),
                                      (False, None, 8)]]


@pytest.mark.parametrize("name,flash,seq,chunk", LOSS_CASES)
def test_train_loss_and_grads_match_reference(name, flash, seq, chunk):
    mods = _Models(name, flash_kernel=flash, attn_chunk=chunk)
    seq = seq or (32 - mods.cfg.n_patches if name == VLM else 32)
    batch = _batch(mods.cfg, 2, seq)
    jloss, jgrads = jax.value_and_grad(lambda p: mods.jm["train_loss"](
        p, _jbatch(batch), mods.jrun))(mods.jp)
    loss, grads = _loss_and_grads(mods, batch)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    _assert_trees_close(_grads_tree(mods.cfg, mods.mod, grads),
                        _np_tree(jgrads), **GRAD_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_remat_matches_the_plain_run_and_the_reference(name):
    """``remat="full"`` (the encoder's body one layer, the decoder's one
    block cycle, the encoder's output read by each checkpointed decoder
    body): the loss and every gradient bitwise the plain run's, and within
    GRAD_TOL of the reference's own remat."""
    mods = _Models(name, remat="full", flash_kernel=True)
    batch = _batch(mods.cfg, 2, TOKENS, seed=1)
    loss, grads = _loss_and_grads(mods, batch)
    plain = _loss_and_grads(mods, batch,
                            dataclasses.replace(mods.run, remat="none"))
    assert torch.equal(loss, plain[0])
    assert all(torch.equal(a, b) for a, b in zip(grads, plain[1]))
    jloss, jgrads = jax.value_and_grad(lambda p: mods.jm["train_loss"](
        p, _jbatch(batch), mods.jrun))(mods.jp)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    _assert_trees_close(_grads_tree(mods.cfg, mods.mod, grads),
                        _np_tree(jgrads), **GRAD_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_missing_modality_input_raises(name):
    mods = _Models(name)
    batch = tsteps.batch_to(_batch(mods.cfg, 2, TOKENS), "cpu")
    key = TT.modality_inputs(mods.cfg)[0]
    del batch[key]
    with pytest.raises(ValueError, match=key):
        mods.m["train_loss"](mods.mod, batch, mods.run)
    with pytest.raises(ValueError, match=key):
        mods.m["prefill"](mods.mod, batch, mods.run)


def test_cross_block_refuses_a_missing_encoder_output():
    """A decoder layer with cross-attention never runs it as a self-
    attention, as the reference's prefill does."""
    mods = _Models(WHISPER)
    x = torch.zeros((2, 4, mods.cfg.d_model))
    pos = torch.arange(4)[None, :]
    with pytest.raises(ValueError, match="encoder's output"):
        mods.mod.blocks[0](x, mods.cfg, mods.run, pos)


# ---------------------------------------------------------------------------
# serving: the vision prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1024, 8])
def test_vlm_prefill_and_decode_match_reference(chunk):
    """internvl2: prefill of 8 patches and 16 tokens (chunk 8: 24 > 16 and
    a multiple of 8, the chunked route) into a cache of 8 + 16 + 8
    positions, then 8 decode steps: each step's logits and the final
    caches against the reference's ``prefill`` and ``decode_step``."""
    mods = _Models(VLM, attn_chunk=chunk)
    s0, k = TOKENS, 8
    batch = _batch(mods.cfg, 2, s0 + k, seed=2, labels=False)
    prompt = dict(batch, tokens=batch["tokens"][:, :s0])
    p0 = mods.cfg.n_patches
    jl, jc = mods.jprefill(prompt, p0 + s0 + k)
    tl, tc = mods.prefill(prompt, p0 + s0 + k)
    np.testing.assert_allclose(tl, jl, **LAYER_TOL)
    _assert_trees_close(cache_to_numpy(mods.cfg, tc), _np_tree(jc),
                        **LAYER_TOL)
    jdec = mods.jdecode()
    toks = batch["tokens"]
    for i in range(k):
        tok = toks[:, s0 + i:s0 + i + 1]
        pos = p0 + s0 + i
        jl, jc = jdec(mods.jp, jc, jnp.asarray(tok), jnp.int32(pos))
        tl, tc2 = mods.m["decode_step"](mods.mod, tc, _t(tok).long(), pos,
                                        mods.run)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LAYER_TOL)
    _assert_trees_close(cache_to_numpy(mods.cfg, tc), _np_tree(jc),
                        **LAYER_TOL)


# ---------------------------------------------------------------------------
# serving: the encoder-decoder
# ---------------------------------------------------------------------------

def test_whisper_prefill_matches_the_reference_training_forward():
    """The port's prefill of 16 tokens against 24 frames: its last logits
    against the reference's training forward with ``enc=`` at the last
    position; the cross caches against the reference's ``_fill_cross``
    (its prefill's), (B, KV, 24, Dh) head-major; the first layer's self
    K/V (upstream of any cross-attention) against the reference's."""
    mods = _Models(WHISPER)
    batch = _batch(mods.cfg, 2, TOKENS, seed=3, labels=False)
    want = mods.jforward(batch)[:, -1]
    tl, tc = mods.prefill(batch, TOKENS + 4)
    np.testing.assert_allclose(tl, want, **LAYER_TOL)
    _, jc = mods.jprefill(batch, TOKENS + 4)
    got = cache_to_numpy(mods.cfg, tc)
    jc = _np_tree(jc)
    for c in tc:
        assert c["cross"]["k"].shape == (2, mods.cfg.n_kv_heads, FRAMES,
                                         mods.cfg.head_dim_)
    _assert_trees_close(got["scan"][0]["cross"], jc["scan"][0]["cross"],
                        **LAYER_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(got["scan"][0][n][0], jc["scan"][0][n][0],
                                   **LAYER_TOL)


def test_whisper_decode_matches_the_reference_decode_step():
    """8 decode steps after the port's prefill: the port from its cache,
    the reference's ``decode_step`` from the same cache carried across
    (``cache_to_numpy``): each step's logits and the final caches, the
    cross caches untouched."""
    mods = _Models(WHISPER)
    s0, k = TOKENS, 8
    batch = _batch(mods.cfg, 2, s0 + k, seed=4, labels=False)
    prompt = dict(batch, tokens=batch["tokens"][:, :s0])
    _, tc = mods.prefill(prompt, s0 + k)
    jc = jax.tree_util.tree_map(jnp.asarray, cache_to_numpy(mods.cfg, tc))
    cross = [{n: t.clone() for n, t in c["cross"].items()} for c in tc]
    jdec = mods.jdecode()
    for i in range(k):
        tok = batch["tokens"][:, s0 + i:s0 + i + 1]
        jl, jc = jdec(mods.jp, jc, jnp.asarray(tok), jnp.int32(s0 + i))
        tl, _ = mods.m["decode_step"](mods.mod, tc, _t(tok).long(), s0 + i,
                                      mods.run)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LAYER_TOL)
    _assert_trees_close(cache_to_numpy(mods.cfg, tc), _np_tree(jc),
                        **LAYER_TOL)
    assert all(torch.equal(c["cross"][n], x[n]) for c, x in zip(tc, cross)
               for n in ("k", "v"))


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_the_training_forward(name):
    """The port against itself: a prompt of 8 tokens, then 8 teacher-forced
    decode steps, each step's logits against the training forward's at its
    position (``transformer.forward`` over all 16 tokens)."""
    mods = _Models(name)
    s0, k = 8, 8
    batch = _batch(mods.cfg, 2, s0 + k, seed=5, labels=False)
    full = mods.forward(batch)
    prompt = dict(batch, tokens=batch["tokens"][:, :s0])
    off = mods.cfg.n_patches if name == VLM else 0
    tl, cache = mods.prefill(prompt, off + s0 + k)
    np.testing.assert_allclose(tl, full[:, s0 - 1], **DECODE_TOL)
    for i in range(k):
        pos = s0 + i
        tok = _t(batch["tokens"][:, pos:pos + 1]).long()
        tl, _ = mods.m["decode_step"](mods.mod, cache, tok, off + pos,
                                      mods.run)
        np.testing.assert_allclose(tl.numpy(), full[:, pos], **DECODE_TOL)


def test_reference_prefill_ignores_the_frames_and_the_port_does_not():
    """The reference's defect, pinned on both sides: its prefill gives the
    same logits whatever the frames and is off its own training forward;
    the port's prefill moves with the frames and agrees with the training
    forward."""
    mods = _Models(WHISPER)
    batch = _batch(mods.cfg, 2, TOKENS, seed=6, labels=False)
    ones = dict(batch, frames=np.ones_like(batch["frames"]))
    jl, _ = mods.jprefill(batch, TOKENS)
    jl1, _ = mods.jprefill(ones, TOKENS)
    np.testing.assert_array_equal(jl, jl1)
    want = mods.jforward(batch)[:, -1]
    assert not np.allclose(jl, want, **DECODE_TOL)
    tl, _ = mods.prefill(batch)
    tl1, _ = mods.prefill(ones)
    assert not np.allclose(tl, tl1, **DECODE_TOL)
    np.testing.assert_allclose(tl, want, **LAYER_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_cache_round_trip_is_bitwise(name):
    """A prefill's cache through ``cache_to_numpy`` and back, and the
    zeroed ``init_cache`` against the reference's tree and shapes (the
    cross entries at ``max_len``, as the reference's)."""
    mods = _Models(name)
    batch = _batch(mods.cfg, 2, TOKENS, seed=7, labels=False)
    _, tc = mods.prefill(batch, 40)
    tree = cache_to_numpy(mods.cfg, tc)
    back = cache_from_numpy(mods.cfg, tree, "cpu")
    _assert_trees_equal(cache_to_numpy(mods.cfg, back), tree)
    zero = mods.m["init_cache"](mods.run, 3, 40, device="cpu")
    want = jax.eval_shape(lambda: mods.jm["init_cache"](mods.jrun, 3, 40))
    gl, gdef = jax.tree_util.tree_flatten(cache_to_numpy(mods.cfg, zero))
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    assert [a.shape for a in gl] == [tuple(w.shape) for w in wl]
    assert not any(a.any() for a in gl)


# ---------------------------------------------------------------------------
# training through build_train_step, checkpoints, the drivers
# ---------------------------------------------------------------------------

def _stream(cfg, run, step, masked=True):
    """Step ``step``'s batch: tokens and labels and the model's frames or
    patches, from a numpy seed of the step."""
    return tsteps.batch_to(_batch(cfg, run.global_batch, run.seq_len,
                                  seed=10 + step, masked=masked), "cpu")


def _steps(cfg, run, params, opt, first, n, masked=True):
    fn = tsteps.build_train_step(cfg, run, device="cpu")["fn"]
    losses = []
    for i in range(first, first + n):
        params, opt, m = fn(params, opt, _stream(cfg, run, i, masked), i)
        losses.append(float(m["loss"]))
    return params, opt, losses


@pytest.mark.parametrize("name", MODELS)
def test_checkpoint_and_resume_is_bitwise(name, tmp_path):
    """2 steps of ``build_train_step`` straight, against 1 step saved
    through the trainer's checkpoint tree (``state_to_numpy``) and 1 more
    after ``restore_state``: losses, parameters and AdamW's moments
    bitwise; the reference's store reads the checkpoint into its own
    tree."""
    cfg = get_arch(name).reduced()
    run, jrun = _runs(warmup=1)
    p2 = make_model(cfg)["init"](run, torch.Generator().manual_seed(0), "cpu")
    p2, o2, straight = _steps(cfg, run, p2, adamw_init(list(p2.parameters())),
                              0, 2)
    p1 = make_model(cfg)["init"](run, torch.Generator().manual_seed(0), "cpu")
    p1, o1, first = _steps(cfg, run, p1, adamw_init(list(p1.parameters())),
                           0, 1)
    store = CheckpointStore(str(tmp_path / "ck"), every=1)
    store.maybe_save(1, ttrain.state_to_numpy(cfg, p1, o1, 1))
    store.wait()
    rp, ro, step = ttrain.restore_state(cfg, store, "cpu")
    assert step == 1 and ro["count"] == 1
    assert all(torch.equal(a, b) for a, b in zip(rp.parameters(),
                                                 p1.parameters()))
    rp, ro, second = _steps(cfg, run, rp, ro, 1, 1)
    assert first + second == straight and ro["count"] == 2
    for a, b in ((list(rp.parameters()), list(p2.parameters())),
                 (ro["mu"], o2["mu"]), (ro["nu"], o2["nu"])):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    from repro.checkpoint import CheckpointStore as JStore
    from repro import optim as joptim
    jp = j_make_model(J_ARCHS[name].reduced())["init"](
        jrun, jax.random.PRNGKey(1))
    tree = JStore(str(tmp_path / "ck")).restore(
        {"params": jp, "opt": joptim.adamw_init(jp), "step": np.int32(0)})
    _assert_trees_close(_np_tree(tree["params"]), params_to_numpy(cfg, p1),
                        rtol=0, atol=0)


@pytest.mark.parametrize("name", MODELS)
def test_microbatch_step_matches_the_whole_batch(name):
    """``microbatch=2`` slices the frames or patches with the tokens: on
    labels without padding (where the mean of the halves' means is the
    whole batch's mean) its loss within LOSS_TOL of the whole batch's, its
    parameters after the step within GRAD_TOL."""
    cfg = get_arch(name).reduced()
    run, _ = _runs(warmup=1)
    out = []
    for k in (0, 2):
        r = dataclasses.replace(run, microbatch=k)
        p = make_model(cfg)["init"](r, torch.Generator().manual_seed(0), "cpu")
        p, _, losses = _steps(cfg, r, p, adamw_init(list(p.parameters())),
                              1, 1, masked=False)
        out.append((losses[0], params_to_numpy(cfg, p)))
    np.testing.assert_allclose(out[1][0], out[0][0], **LOSS_TOL)
    _assert_trees_close(out[1][1], out[0][1], **GRAD_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_serve_and_train_refuse_models_that_read_frames_or_patches(name):
    """The drivers build batches of tokens only, as the reference's do;
    the message names the step builders through which these models run."""
    cfg = get_arch(name).reduced()
    run, _ = _runs()
    prompts = np.zeros((2, 4), np.int32)
    with pytest.raises(ValueError, match="build_prefill_step and "
                                         "build_decode_step"):
        tserve.serve(cfg, run, prompts, 2, device="cpu")
    with pytest.raises(ValueError, match="build_train_step"):
        ttrain.train(cfg, run, 1, device="cpu")
