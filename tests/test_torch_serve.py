"""The serving slice of the port on the CPU: sliding-window attention, the
decode caches, ``prefill``, ``decode_step`` and ``serve``, held to the JAX
reference on the same numpy inputs, weights (``params_from_numpy``) and
caches (``cache_from_numpy``), all in f32.

Tolerances, those of ``tests/test_torch_lm.py`` with their reasons: layers,
logits and caches rtol = atol = 1e-5 (f32 sums in another order across
frameworks); bf16 score blocks rtol = atol = 2**-7 (two bf16 ulps); losses
rtol 1e-5; gradients rtol 2e-4, atol 2e-6.  The port's decode against its
own full forward takes the reference's ``test_decode_matches_full_forward``
tolerance (rtol = atol = 2e-3); tokens are equal.

The reference's ``serve`` builds each global layer's cache at the prompt's
length (its ``build_prefill_step`` leaves ``cache_len`` at 0), so its decode
writes clamp onto the last prompt slot.  The port's ``serve`` sizes the
cache for the prompt and every new token, and is held to the reference's
model functions driven that way.
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
from repro_torch.configs import RunConfig, get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import (cache_from_numpy, cache_to_numpy, layers as TL,
                                make_model, params_from_numpy,
                                params_to_numpy)

LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=2**-7)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
SERVING = ("olmo-1b", "phi3-medium-14b", "gemma3-4b", "h2o-danube-1.8b")
# reduced layers: gemma3's 7 hold one full LLLLLG cycle and a tail layer
LAYERS = {"gemma3-4b": 7, "h2o-danube-1.8b": 3}


def _cfgs(name, **kw):
    layers = LAYERS.get(name, 2)
    return (dataclasses.replace(get_arch(name).reduced(), n_layers=layers,
                                **kw),
            dataclasses.replace(J_ARCHS[name].reduced(), n_layers=layers,
                                **kw))


def _runs(**kw):
    kw = dict(dict(seq_len=16, global_batch=2, dtype="float32"), **kw)
    return RunConfig(**kw), JRun(**kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(jcfg, jrun, seed=0):
    """The reference's initial parameters as numpy, norms moved off their
    identity so that the (1 + scale) paths count."""
    tree = _np_tree(j_make_model(jcfg)["init"](jrun, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        if getattr(path[-1], "key", None) in ("scale", "bias"):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_trees_close(got, want, **tol):
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, b, **tol)


def _qkv_np(seed, b=2, s=32, h=4, kvh=2, dh=16, sk=None):
    rng = np.random.default_rng(seed)
    sk = sk or s
    return (rng.normal(size=(b, s, h, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kvh, dh)).astype(np.float32),
            rng.normal(size=(b, sk, kvh, dh)).astype(np.float32))


class _Models:
    """One architecture's two models over one reference state."""

    def __init__(self, name, **run_kw):
        self.cfg, self.jcfg = _cfgs(name)
        self.run, self.jrun = _runs(**run_kw)
        self.tree = _jax_params(self.jcfg, self.jrun)
        self.jm = j_make_model(self.jcfg)
        self.jp = jax.tree_util.tree_map(jnp.asarray, self.tree)
        self.m = make_model(self.cfg)
        self.mod = params_from_numpy(self.cfg, self.tree, device="cpu")

    def prefill(self, toks, cache_len=0):
        jl, jc = jax.jit(lambda p, b: self.jm["prefill"](
            p, b, self.jrun, cache_len))(self.jp, {"tokens": jnp.asarray(toks)})
        tl, tc = self.m["prefill"](self.mod, {"tokens": _t(toks).long()},
                                   self.run, cache_len)
        return (np.asarray(jl), jc), (tl.numpy(), tc)

    def jdecode(self):
        return jax.jit(lambda p, c, t, pos: self.jm["decode_step"](
            p, c, t, pos, self.jrun))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,q_pos0,kv_pos0,sk", [
    (8, 0, 0, 32), (5, 16, 7, 24), (8, 16, -8, 24), (3, 4, -12, 16),
    (0, 16, -8, 24)])
def test_sdpa_dense_window_and_positions_match_reference(window, q_pos0,
                                                         kv_pos0, sk):
    """Windows, and kv positions below 0 (the left padding)."""
    q, k, v = _qkv_np(10, s=16, sk=sk)
    got = TL._sdpa_dense(_t(q), _t(k), _t(v), causal=True, window=window,
                         q_pos0=q_pos0, kv_pos0=kv_pos0)
    want = JL._sdpa_dense(*map(jnp.asarray, (q, k, v)), causal=True,
                          window=window, q_pos0=q_pos0, kv_pos0=kv_pos0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("f32_scores,dtype", [(True, "float32"),
                                              (False, "float32"),
                                              (False, "bfloat16")])
def test_sdpa_flash_dynamic_skip_matches_reference(f32_scores, dtype):
    q, k, v = _qkv_np(11)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = TL._sdpa_flash(*(_t(a).to(tdt) for a in (q, k, v)), causal=True,
                         chunk=8, dynamic_skip=True, f32_scores=f32_scores)
    want = JL._sdpa_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                          causal=True, chunk=8, dynamic_skip=True,
                          f32_scores=f32_scores)
    tol = LAYER_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    full = TL._sdpa_flash(*(_t(a).to(tdt) for a in (q, k, v)), causal=True,
                          chunk=8, f32_scores=f32_scores)
    np.testing.assert_allclose(got.float().numpy(), full.float().numpy(),
                               **tol)


@pytest.mark.parametrize("b", [1, 2])
def test_flash_kernel_gqa_hands_the_kernel_contiguous_inputs(b, monkeypatch):
    """The kernel takes contiguous (BH, S, Dh) inputs only; at batch 1 the
    (B, S, H, Dh) -> (B*H, S, Dh) reshape alone is a strided view."""
    from repro_torch.kernels import ops
    seen = []

    def flash(q, k, v, causal=True):
        seen.append([t.is_contiguous() for t in (q, k, v)])
        return orig(q, k, v, causal=causal)
    orig = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", flash)
    q, k, v = _qkv_np(24, b=b)
    got = TL._flash_kernel_gqa(_t(q), _t(k), _t(v))
    assert seen == [[True] * 3]
    want = JL._flash_kernel_gqa(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("window,chunk", [(4, 8), (8, 8), (20, 8), (16, 32)])
def test_sdpa_window_matches_reference(window, chunk):
    """A window under, at and over the chunk, and one chunk in all."""
    q, k, v = _qkv_np(12)
    got = TL._sdpa_window(_t(q), _t(k), _t(v), window=window, chunk=chunk)
    want = JL._sdpa_window(*map(jnp.asarray, (q, k, v)), window=window,
                           chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)
    dense = TL._sdpa_dense(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **LAYER_TOL)


@pytest.mark.parametrize("seq,chunk", [(16, 1024), (32, 8)])
def test_local_attention_train_matches_reference(seq, chunk):
    """The dense route and the chunked one (``_sdpa_window``)."""
    cfg, jcfg = _cfgs("h2o-danube-1.8b")
    run, jrun = _runs(seq_len=seq, attn_chunk=chunk)
    p = _jax_params(jcfg, jrun)["blocks"]["scan"][0]["attn"]
    p = {k: a[0] for k, a in p.items()}
    x = np.random.default_rng(13).normal(
        size=(2, seq, cfg.d_model)).astype(np.float32)
    pos = np.arange(seq)[None, :]
    got = TL.attention_train({k: _t(a) for k, a in p.items()}, _t(x), cfg,
                             run, kind="local", positions=_t(pos))
    want = JL.attention_train({k: jnp.asarray(a) for k, a in p.items()},
                              jnp.asarray(x), jcfg, jrun, kind="local",
                              positions=jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# ---------------------------------------------------------------------------
# training through sliding-window layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gemma3-4b", "h2o-danube-1.8b"])
@pytest.mark.parametrize("flash,seq,chunk", [(False, 32, 1024),
                                             (True, 32, 1024),
                                             (False, 32, 8), (True, 32, 8)])
def test_local_train_loss_and_grads_match_reference(name, flash, seq, chunk):
    """Window 16 of 32 tokens binds; chunk 8 takes ``_sdpa_window`` on the
    local layers and ``_sdpa_flash`` (or the flash kernel's plain version)
    on gemma3's global ones."""
    mods = _Models(name, seq_len=seq, flash_kernel=flash, attn_chunk=chunk)
    rng = np.random.default_rng(14)
    batch = {"tokens": _tokens(mods.cfg, 2, seq, 15),
             "labels": rng.integers(0, mods.cfg.vocab, (2, seq))
             .astype(np.int32)}
    batch["labels"][0, :3] = -1
    jloss, jgrads = jax.value_and_grad(lambda p: mods.jm["train_loss"](
        p, {k: jnp.asarray(v) for k, v in batch.items()}, mods.jrun))(mods.jp)
    loss = mods.m["train_loss"](mods.mod, tsteps.batch_to(batch, "cpu"),
                                mods.run)
    grads = torch.autograd.grad(loss, list(mods.mod.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    _assert_trees_close(params_to_numpy(mods.cfg, mods.mod, grads),
                        _np_tree(jgrads), **GRAD_TOL)


# ---------------------------------------------------------------------------
# caches, prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVING)
@pytest.mark.parametrize("max_len", [8, 40])
def test_init_cache_has_the_reference_tree(name, max_len):
    """Shapes (head-major) and dtype of every layer's cache (a local ring
    holds min(max_len, window) slots), zeros, the reference's tree, and
    the round trip."""
    cfg, jcfg = _cfgs(name)
    run, jrun = _runs(dtype="bfloat16")
    ours = make_model(cfg)["init_cache"](run, 3, max_len, device="cpu")
    assert len(ours) == cfg.n_layers
    for c, kind in zip(ours, cfg.layer_kinds()):
        length = min(max_len, cfg.window) if kind == "local" else max_len
        for t in c.values():
            assert t.shape == (3, cfg.n_kv_heads, length, cfg.head_dim_)
            assert t.dtype == torch.bfloat16 and not t.any()
    want = jax.eval_shape(lambda: j_make_model(jcfg)["init_cache"](
        jrun, 3, max_len))
    got = cache_to_numpy(cfg, ours)
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    assert [a.shape for a in gl] == [tuple(w.shape) for w in wl]
    back = cache_from_numpy(cfg, got, "cpu", torch.bfloat16)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(back, ours)
               for k in ("k", "v"))


# (arch, prompt length, cache_len, attn_chunk): cache_len 0 and > s, a
# prompt past the window (reduced window 16), and a chunked prompt (24 > 2 x
# 8 and a multiple of 8: _sdpa_window on local layers, _sdpa_flash with the
# causal skip on global ones)
PREFILL_CASES = [(name, s, cl, chunk) for name in SERVING
                 for s, cl, chunk in [(12, 0, 1024), (12, 20, 1024),
                                      (20, 28, 1024), (24, 30, 8)]]


@pytest.mark.parametrize("name,s,cache_len,chunk", PREFILL_CASES)
def test_prefill_matches_reference(name, s, cache_len, chunk):
    mods = _Models(name, attn_chunk=chunk)
    (jl, jc), (tl, tc) = mods.prefill(_tokens(mods.cfg, 2, s, 16), cache_len)
    np.testing.assert_allclose(tl, jl, **LAYER_TOL)
    assert tl.shape == (2, mods.cfg.vocab_padded)
    _assert_trees_close(cache_to_numpy(mods.cfg, tc), _np_tree(jc),
                        **LAYER_TOL)


@pytest.mark.parametrize("name", SERVING)
def test_decode_steps_past_the_window_match_reference(name):
    """A prompt of 12 tokens, then 10 decode steps to position 21, past
    the reduced window of 16 (the rings wrap), each step's logits and the
    final caches against the reference's, the port's cache updated in place
    and handed back."""
    mods = _Models(name)
    s0, k = 12, 10
    (_, jc), (_, tc) = mods.prefill(_tokens(mods.cfg, 2, s0, 17), s0 + k)
    jdec = mods.jdecode()
    toks = _tokens(mods.cfg, 2, k, 18)
    for i in range(k):
        tok = toks[:, i:i + 1]
        jl, jc = jdec(mods.jp, jc, jnp.asarray(tok), jnp.int32(s0 + i))
        tl, tc2 = mods.m["decode_step"](mods.mod, tc, _t(tok).long(), s0 + i,
                                        mods.run)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LAYER_TOL)
    _assert_trees_close(cache_to_numpy(mods.cfg, tc), _np_tree(jc),
                        **LAYER_TOL)


@pytest.mark.parametrize("name", SERVING)
def test_decode_matches_full_forward(name):
    """The mirror of the reference's test: prefill S - 1 tokens, decode
    token S - 1; its logits equal the full forward's last logits (S = 24,
    past the reduced window)."""
    cfg = dataclasses.replace(get_arch(name).reduced(),
                              n_layers=LAYERS.get(name, 2))
    run, _ = _runs()
    model = make_model(cfg)
    params = model["init"](run, torch.Generator().manual_seed(0), "cpu")
    toks = _t(_tokens(cfg, 2, 24, 19)).long()
    full, _ = model["prefill"](params, {"tokens": toks}, run, 24)
    _, cache = model["prefill"](params, {"tokens": toks[:, :-1]}, run, 24)
    dec, _ = model["decode_step"](params, cache, toks[:, -1:], 23, run)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **DECODE_TOL)


def test_cache_from_numpy_feeds_the_port():
    """A reference cache carried across decodes as the reference's does."""
    mods = _Models("gemma3-4b")
    (_, jc), _ = mods.prefill(_tokens(mods.cfg, 2, 20, 20), 24)
    tc = cache_from_numpy(mods.cfg, _np_tree(jc), "cpu")
    tok = _tokens(mods.cfg, 2, 1, 21)
    jl, _ = mods.jdecode()(mods.jp, jc, jnp.asarray(tok), jnp.int32(20))
    tl, _ = mods.m["decode_step"](mods.mod, tc, _t(tok).long(), 20, mods.run)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LAYER_TOL)


@pytest.mark.parametrize("name", ["gemma3-4b", "h2o-danube-1.8b"])
def test_global_cache_position_guard(name):
    """A decode at pos >= a global cache's length raises (the reference
    clamps the write onto the last slot), and so does one past a local
    ring that is shorter than the window (it would overwrite keys still
    inside the window); a ring of the full window takes any pos."""
    cfg, _ = _cfgs(name)
    run, _ = _runs()
    model = make_model(cfg)
    params = model["init"](run, torch.Generator().manual_seed(0), "cpu")
    toks = _t(_tokens(cfg, 1, 8, 22)).long()
    if "global" in cfg.layer_kinds():
        n, where = cfg.window, "positions of a global layer's cache"
    else:
        n, where = 9, "slots of a local layer's ring, shorter than its window"
    _, cache = model["prefill"](params, {"tokens": toks}, run, n)
    model["decode_step"](params, cache, toks[:, :1], n - 1, run)
    with pytest.raises(IndexError, match=f"outside the {n} {where}"):
        model["decode_step"](params, cache, toks[:, :1], n, run)
    if "global" in cfg.layer_kinds():
        with pytest.raises(ValueError, match="does not fit"):
            model["prefill"](params, {"tokens": toks}, run, 4)
    else:
        _, ring = model["prefill"](params, {"tokens": toks}, run, cfg.window)
        for pos in range(8, cfg.window + 4):
            model["decode_step"](params, ring, toks[:, :1], pos, run)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def _reference_greedy(mods, prompts, new_tokens):
    """The reference's model functions with the cache sized for the prompt
    and every new token, decoded greedily as its serve loop does."""
    s0 = prompts.shape[1]
    logits, cache = jax.jit(lambda p, b: mods.jm["prefill"](
        p, b, mods.jrun, s0 + new_tokens))(mods.jp,
                                           {"tokens": jnp.asarray(prompts)})
    jdec = mods.jdecode()
    out = []
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for i in range(new_tokens):
        out.append(np.asarray(tok)[:, 0])
        logits, cache = jdec(mods.jp, cache, tok, jnp.int32(s0 + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    return np.stack(out, axis=1)


@pytest.mark.parametrize("name,s0,new", [("olmo-1b", 16, 6),
                                         ("gemma3-4b", 12, 8),
                                         ("h2o-danube-1.8b", 12, 8)])
def test_serve_matches_the_reference_model_functions(name, s0, new):
    """olmo as the reference's own serve test sizes it (2 prompts of 16
    tokens from ``default_rng(0)``); gemma3 and h2o-danube past the
    window."""
    mods = _Models(name)
    prompts = np.random.default_rng(0).integers(
        0, mods.cfg.vocab, (2, s0)).astype(np.int32)
    want = _reference_greedy(mods, prompts, new)
    got, stats = tserve.serve(mods.cfg, mods.run, prompts, new,
                              device="cpu", params=mods.mod)
    np.testing.assert_array_equal(got, want)
    assert stats["batch"] == 2 and stats["prompt_len"] == s0
    assert stats["new_tokens"] == new and stats["tokens_per_s"] > 0
    assert set(stats) == {"prefill_s", "decode_s", "tokens_per_s", "batch",
                          "prompt_len", "new_tokens"}


def test_serve_is_greedy_only():
    cfg, _ = _cfgs("olmo-1b")
    with pytest.raises(ValueError, match="greedily only"):
        tserve.serve(cfg, _runs()[0], _tokens(cfg, 1, 4), 2, device="cpu",
                     greedy=False)


def test_serve_mesh_raises():
    """``mesh=`` takes a ``launch.mesh.Mesh`` (serving on one runs in
    ``tests/test_torch_lm_mesh.py``); anything else raises."""
    cfg, _ = _cfgs("olmo-1b")
    with pytest.raises(TypeError, match="launch.mesh.Mesh"):
        tserve.serve(cfg, _runs()[0], _tokens(cfg, 1, 4), 2, device="cpu",
                     mesh=object())


def test_serve_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, _ = _cfgs("olmo-1b")
    run, _ = _runs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve(cfg, run, _tokens(cfg, 1, 4), 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model(cfg)["init_cache"](run, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsteps.build_decode_step(cfg, run)


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--device", "cpu", "--arch", "gemma3-4b", "--batch", "2",
                 "--prompt-len", "8", "--new-tokens", "4"])
    out = capsys.readouterr().out
    assert "[serve] gemma3-4b-smoke" in out and "tokens_per_s" in out
    assert "sample continuation" in out
