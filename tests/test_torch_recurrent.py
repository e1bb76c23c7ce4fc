"""The recurrent slice of the port on the CPU: Griffin's RG-LRU
(recurrentgemma-2b) and Mamba2's SSD (mamba2-370m), layers and models,
training and serving, held to the JAX reference on the same numpy inputs
and weights (``params_from_numpy``) and caches (``cache_to_numpy``), all in
f32.

Two weight settings.  At the reference's initialisation both recurrences
forget within a few steps (the RG-LRU's ``a`` near 0.06, SSD's decay per
step near 0.54, about 1e-34 across a 128-token chunk), so a wrong carry
across chunks or a wrong decode state would not show.  The long-memory
setting edits the weights the same way in both packages: ``lam = -4``
(``a`` in 0.87-1) and ``dt_bias = -5`` (a decay near 0.993 a step, 0.43
across a chunk).

Tolerances, each with its reason:

- layers, logits and states: rtol 1e-4, atol 1e-5.  f32 sums in another
  order across frameworks (the scan's products, the chunk cumsums, the
  einsums' contractions), compounded over up to 256 steps of a state that
  remembers;
- SSD at the default weights over a full 128-token chunk: rtol 1e-4, atol
  1e-4.  There ``cum``, the running sum of ``dt a`` (about -0.8 a step),
  reaches about -100 within a chunk, and the reference's ``exp(cum_i -
  cum_j)`` carries an absolute error of about |cum| 2^-24 in its exponent;
  another order of the cumsum moves it by as much (jax's CPU cumsum
  matches neither a sequential nor an odd/even order), up to 3.5e-5 in
  outputs of order 1 on these inputs;
- losses rtol 1e-5 and gradients rtol 2e-4, atol 2e-6: ``tests/
  test_torch_lm.py``'s, for the same reasons;
- the chunked SSD's gradient against a plain step-by-step recurrence of the
  same function (the reference's own gradient is not finite there):
  rtol 1e-3, and atol 1e-5 of each gradient's largest entry (which
  reaches hundreds: sums over 512 tokens), a backward through 256 steps
  summed in two different orders; 1e-4 of it at the default weights, for
  the reason above (against an f64 step-by-step run the chunked form's
  ``a_log`` gradient is off by 2.2e-5 of its largest entry there, the
  step-by-step one by 8e-7);
- the port's decode against its own training forward: the reference's
  ``test_decode_matches_full_forward`` tolerance, rtol = atol = 2e-3;
- the scan against a sequential loop: rtol = atol = 1e-6; the scan run
  twice, round trips and the port's repeats: equal.
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
from repro_torch.configs import RunConfig, get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import (cache_from_numpy, cache_to_numpy, layers as TL,
                                make_model, params_from_numpy,
                                params_to_numpy, transformer as TT)

STATE_TOL = dict(rtol=1e-4, atol=1e-5)
CHUNK_TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
# rtol, and atol as a share of the gradient's largest entry
STEPWISE_GRAD_TOL = {"long memory": (1e-3, 1e-5), "default": (1e-3, 1e-4)}
SCAN_TOL = dict(rtol=1e-6, atol=1e-6)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
RECURRENT = ("recurrentgemma-2b", "mamba2-370m")
# reduced depth: recurrentgemma's 5 layers hold one (rglru, rglru, local)
# cycle and the 2-layer rglru tail of its 26; mamba2's 3 a scan of 3
LAYERS = {"recurrentgemma-2b": 5, "mamba2-370m": 3}
# the long-memory setting, the same edit in both packages
LONG_MEMORY = {"lam": -4.0, "dt_bias": -5.0}
SETTINGS = ("default", "long memory")


def _cfgs(name, layers=None):
    layers = layers or LAYERS[name]
    return (dataclasses.replace(get_arch(name).reduced(), n_layers=layers),
            dataclasses.replace(J_ARCHS[name].reduced(), n_layers=layers))


def _runs(**kw):
    kw = dict(dict(seq_len=32, global_batch=2, dtype="float32"), **kw)
    return RunConfig(**kw), JRun(**kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(jcfg, jrun, setting="default", seed=0):
    """The reference's initial parameters as numpy, norms moved off their
    identity so that the (1 + scale) paths count; at the long-memory
    setting ``lam`` and ``dt_bias`` set to LONG_MEMORY's values."""
    tree = _np_tree(j_make_model(jcfg)["init"](jrun, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def edit(path, a):
        key = getattr(path[-1], "key", None)
        if key in ("scale", "bias"):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if setting == "long memory" and key in LONG_MEMORY:
            return np.full_like(a, LONG_MEMORY[key])
        return a
    return jax.tree_util.tree_map_with_path(edit, tree)


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


def _layer_params(jcfg, jrun, part, setting):
    """One layer's ``part`` ("rglru" or "ssd") from the reference's tree:
    the first repeat of the first scan position that has it."""
    blocks = _jax_params(jcfg, jrun, setting)["blocks"]["scan"]
    p = next(b[part] for b in blocks if part in b)
    return {k: a[0] for k, a in p.items()}


def _both(p):
    return ({k: _t(a) for k, a in p.items()},
            {k: jnp.asarray(a) for k, a in p.items()})


class _Models:
    """One architecture's two models over one reference state."""

    def __init__(self, name, setting="default", **run_kw):
        self.cfg, self.jcfg = _cfgs(name)
        self.run, self.jrun = _runs(**run_kw)
        self.tree = _jax_params(self.jcfg, self.jrun, setting)
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

@pytest.mark.parametrize("width", [1, 2, 4])
def test_causal_conv_matches_reference(width):
    """Training (taps summed in order) and one decode step against a
    state; a decode step's new state is its input shifted by one."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    w = rng.normal(size=(width, 6)).astype(np.float32)
    got, none = TL._causal_conv(_t(x), _t(w))
    want, _ = JL._causal_conv(jnp.asarray(x), jnp.asarray(w))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE_TOL)
    state = rng.normal(size=(2, width - 1, 6)).astype(np.float32)
    got, new = TL._causal_conv(_t(x[:, :1]), _t(w), _t(state))
    want, jnew = JL._causal_conv(jnp.asarray(x[:, :1]), jnp.asarray(w),
                                 jnp.asarray(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE_TOL)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    # the training conv's last output is the decode step's after its state
    full, _ = TL._causal_conv(_t(np.concatenate([state, x[:, :1]], 1)), _t(w))
    np.testing.assert_allclose(got.numpy(), full[:, -1:].numpy(), **SCAN_TOL)


@pytest.mark.parametrize("s", [1, 2, 7, 64, 129])
def test_scan_is_the_sequential_recurrence_and_repeats_bitwise(s):
    """The odd/even scan of (a, b) pairs against a loop of h = a h + b and
    ``lax.associative_scan``, at odd and even lengths; twice bitwise."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 1.0, size=(2, s, 5)).astype(np.float32)
    b = rng.normal(size=(2, s, 5)).astype(np.float32)
    _, got = TL._scan_pairs(_t(a), _t(b))
    h, want = np.zeros((2, 5), np.float32), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), **SCAN_TOL)
    _, jh = jax.lax.associative_scan(
        lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]),
        (jnp.asarray(a), jnp.asarray(b)), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(jh), **SCAN_TOL)
    assert torch.equal(TL._scan_pairs(_t(a), _t(b))[1], got)


@pytest.mark.parametrize("setting", SETTINGS)
def test_rglru_train_prefill_and_decode_match_reference(setting):
    """``rglru_train``, prefill's final state and conv tail, then 4 decode
    steps from that cache, against the reference's."""
    cfg, jcfg = _cfgs("recurrentgemma-2b")
    run, jrun = _runs()
    tp, jp = _both(_layer_params(jcfg, jrun, "rglru", setting))
    x = np.random.default_rng(3).normal(
        size=(2, 36, cfg.d_model)).astype(np.float32)
    got = TL.rglru_train(tp, _t(x[:, :32]), cfg, run)
    want = JL.rglru_train(jp, jnp.asarray(x[:, :32]), jcfg, jrun)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **STATE_TOL)
    tout, tc = TT._rglru_with_cache(tp, _t(x[:, :32]), cfg, run)
    jout, jc = JT._rglru_with_cache(jp, jnp.asarray(x[:, :32]), jcfg, jrun)
    assert torch.equal(tout, got)
    _assert_trees_close({k: v.numpy() for k, v in tc.items()}, _np_tree(jc),
                        **STATE_TOL)
    for t in range(32, 36):
        ty, tc2 = TL.rglru_decode(tp, _t(x[:, t:t + 1]), tc, cfg, run)
        jy, jc = JL.rglru_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg,
                                 jrun)
        assert tc2 is tc
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **STATE_TOL)
    _assert_trees_close({k: v.numpy() for k, v in tc.items()}, _np_tree(jc),
                        **STATE_TOL)


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("s", [64, 256])
def test_ssd_train_prefill_and_decode_match_reference(s, setting):
    """``ssd_train`` in one chunk (64) and two (256), prefill's final state
    (the reference's ``_ssd_train_with_state``) and conv tail, then 4
    decode steps from that cache."""
    cfg, jcfg = _cfgs("mamba2-370m")
    run, jrun = _runs(seq_len=s)
    tol = CHUNK_TOL if setting == "default" and s >= TL.SSD_CHUNK \
        else STATE_TOL
    tp, jp = _both(_layer_params(jcfg, jrun, "ssd", setting))
    x = np.random.default_rng(4).normal(
        size=(2, s + 4, cfg.d_model)).astype(np.float32)
    got = TL.ssd_train(tp, _t(x[:, :s]), cfg, run)
    want = JL.ssd_train(jp, jnp.asarray(x[:, :s]), jcfg, jrun)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    tout, tc = TT._ssd_with_cache(tp, _t(x[:, :s]), cfg, run)
    jout, jc = JT._ssd_with_cache(jp, jnp.asarray(x[:, :s]), jcfg, jrun)
    assert torch.equal(tout, got)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **tol)
    _assert_trees_close({k: v.numpy() for k, v in tc.items()}, _np_tree(jc),
                        **tol)
    for t in range(s, s + 4):
        ty, tc2 = TL.ssd_decode(tp, _t(x[:, t:t + 1]), tc, cfg, run)
        jy, jc = JL.ssd_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg, jrun)
        assert tc2 is tc
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **tol)
    _assert_trees_close({k: v.numpy() for k, v in tc.items()}, _np_tree(jc),
                        **tol)


def test_long_memory_carries_the_state_across_chunks():
    """The first chunk's first 64 tokens reach the second chunk's outputs
    only through the state carried across chunks (the conv reaches 3
    tokens back): redrawn, they move those outputs at the long-memory
    setting, and at the default one only by the rounding of ``cum`` that
    CHUNK_TOL allows for (their ``dt`` enter the first chunk's ``cum``)."""
    cfg, jcfg = _cfgs("mamba2-370m")
    run, jrun = _runs(seq_len=256)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, 256, cfg.d_model)).astype(np.float32)
    x2 = x.copy()
    x2[:, :64] = rng.normal(size=(1, 64, cfg.d_model))
    moved = {}
    for setting in SETTINGS:
        tp, _ = _both(_layer_params(jcfg, jrun, "ssd", setting))
        y, y2 = (TL.ssd_train(tp, _t(a), cfg, run)[:, 128:] for a in (x, x2))
        moved[setting] = (y - y2).abs().max().item()
    assert moved["default"] < CHUNK_TOL["atol"] < 1e-2 < \
        moved["long memory"], moved


def test_ssd_rejects_a_partial_chunk_as_the_reference_does():
    """A sequence over one chunk and not a multiple of 128 (s = 200): the
    reference's reshape fails, the port raises ``ValueError`` naming the
    chunk, in training and in prefill."""
    mods = _Models("mamba2-370m", seq_len=200)
    toks = _tokens(mods.cfg, 1, 200, 6)
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(TypeError, match="reshape"):
        mods.jm["train_loss"](mods.jp, {k: jnp.asarray(v) for k, v in
                                        batch.items()}, mods.jrun)
    with pytest.raises(TypeError, match="reshape"):
        mods.jm["prefill"](mods.jp, {"tokens": jnp.asarray(toks)}, mods.jrun)
    with pytest.raises(ValueError, match="chunks of 128 tokens"):
        mods.m["train_loss"](mods.mod, tsteps.batch_to(batch, "cpu"),
                             mods.run)
    with pytest.raises(ValueError, match="chunks of 128 tokens"):
        mods.m["prefill"](mods.mod, {"tokens": _t(toks).long()}, mods.run)


# ---------------------------------------------------------------------------
# models: loss, prefill, decode, round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("name", RECURRENT)
def test_train_loss_matches_reference(name, setting):
    """Two SSD chunks (256 tokens), recurrentgemma's local window (16)
    passed 16 times over."""
    mods = _Models(name, setting, seq_len=256)
    toks, labels = _tokens(mods.cfg, 2, 256, 7), _tokens(mods.cfg, 2, 256, 8)
    labels[0, :3] = -1
    batch = {"tokens": toks, "labels": labels}
    jloss = mods.jm["train_loss"](mods.jp, {k: jnp.asarray(v) for k, v in
                                            batch.items()}, mods.jrun)
    with torch.no_grad():
        loss = mods.m["train_loss"](mods.mod, tsteps.batch_to(batch, "cpu"),
                                    mods.run)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("name", RECURRENT)
def test_prefill_and_decode_steps_match_reference(name, setting):
    """A prefill of 256 tokens (two SSD chunks; recurrentgemma's local
    rings wrap), its logits and cache through ``cache_to_numpy`` against
    the reference's tree, then 8 decode steps, each step's logits and the
    final cache, the port's cache updated in place."""
    mods = _Models(name, setting, seq_len=256)
    tol = CHUNK_TOL if setting == "default" and name == "mamba2-370m" \
        else STATE_TOL
    s0, k = 256, 8
    (jl, jc), (tl, tc) = mods.prefill(_tokens(mods.cfg, 2, s0, 9), s0 + k)
    np.testing.assert_allclose(tl, jl, **tol)
    _assert_trees_close(cache_to_numpy(mods.cfg, tc), _np_tree(jc), **tol)
    jdec = mods.jdecode()
    toks = _tokens(mods.cfg, 2, k, 10)
    for i in range(k):
        tok = toks[:, i:i + 1]
        jl, jc = jdec(mods.jp, jc, jnp.asarray(tok), jnp.int32(s0 + i))
        tl, tc2 = mods.m["decode_step"](mods.mod, tc, _t(tok).long(), s0 + i,
                                        mods.run)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    _assert_trees_close(cache_to_numpy(mods.cfg, tc), _np_tree(jc), **tol)


@pytest.mark.parametrize("name", RECURRENT)
def test_params_round_trip_with_the_tail_is_bitwise(name):
    """Scan positions and recurrentgemma's 2-layer tail, across and back."""
    cfg, jcfg = _cfgs(name)
    tree = _jax_params(jcfg, _runs()[1], "long memory")
    back = params_to_numpy(cfg, params_from_numpy(cfg, tree, device="cpu"))
    gl, gdef = jax.tree_util.tree_flatten(back)
    wl, wdef = jax.tree_util.tree_flatten(tree)
    assert gdef == wdef
    assert len(tree["blocks"]["tail"]) == (2 if name == "recurrentgemma-2b"
                                           else 0)
    for a, b in zip(gl, wl):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", RECURRENT)
def test_cache_tree_and_round_trip(name, dtype):
    """``init_cache`` has the reference's tree, shapes and zeros; a cache
    after a prefill goes across and back bitwise; a recurrent ``h`` stays
    f32 in a bf16 cache, and under ``cache_from_numpy(dtype=bf16)``."""
    cfg, jcfg = _cfgs(name)
    run, jrun = _runs(dtype=dtype)
    ours = make_model(cfg)["init_cache"](run, 3, 40, device="cpu")
    want = jax.eval_shape(lambda: j_make_model(jcfg)["init_cache"](
        jrun, 3, 40))
    got = cache_to_numpy(cfg, ours)
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    assert [a.shape for a in gl] == [tuple(w.shape) for w in wl]
    assert not any(a.any() for a in gl)
    for layer, kind in zip(ours, cfg.layer_kinds()):
        if kind in ("rglru", "ssd"):
            assert layer["h"].dtype == torch.float32
            assert layer["conv"].dtype == getattr(torch, dtype)

    model = make_model(cfg)
    params = model["init"](run, torch.Generator().manual_seed(0), "cpu")
    _, cache = model["prefill"](params, {"tokens": _t(_tokens(
        cfg, 2, 24, 11)).long()}, run, 30)
    back = cache_from_numpy(cfg, cache_to_numpy(cfg, cache), "cpu",
                            getattr(torch, dtype))
    for a, b in zip(back, cache):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("name", RECURRENT)
def test_grads_match_reference_at_2x32(name, setting):
    """At 2 x 32 tokens the reference's gradient is finite: the port's
    equals it."""
    mods = _Models(name, setting)
    toks, labels = _tokens(mods.cfg, 2, 32, 12), _tokens(mods.cfg, 2, 32, 13)
    batch = {"tokens": toks, "labels": labels}
    jloss, jgrads = jax.value_and_grad(lambda p: mods.jm["train_loss"](
        p, {k: jnp.asarray(v) for k, v in batch.items()}, mods.jrun))(mods.jp)
    assert all(np.isfinite(g).all() for g in
               jax.tree_util.tree_leaves(_np_tree(jgrads)))
    loss = mods.m["train_loss"](mods.mod, tsteps.batch_to(batch, "cpu"),
                                mods.run)
    grads = torch.autograd.grad(loss, list(mods.mod.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    _assert_trees_close(params_to_numpy(mods.cfg, mods.mod, grads),
                        _np_tree(jgrads), **GRAD_TOL)


def _ssd_stepwise(p, x, cfg, run):
    """SSD as the decode's recurrence over every step, from a zero state:
    ``h = exp(dt a) h + B (x dt)^T``, ``y = C.h + D x``, gated by
    ``silu(z)``; plain ops, autograd through the loop."""
    b, s, _ = x.shape
    din, nst, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    zxbcdt = x @ p["in_proj"]
    z, xbc, dtr = (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * nst],
                   zxbcdt[..., 2 * din + 2 * nst:])
    width = p["conv"].shape[0]
    xp = torch.cat([xbc.new_zeros(b, width - 1, xbc.shape[-1]), xbc], 1)
    xbc = sum(xp[:, i:i + s] * p["conv"][i] for i in range(width))
    dt = torch.nn.functional.softplus(dtr + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    h = x.new_zeros(b, nh, nst, hp)
    ys = []
    for t in range(s):
        xt = xbc[:, t, :din].reshape(b, nh, hp)
        bt, ct = xbc[:, t, din:din + nst], xbc[:, t, din + nst:]
        h = torch.exp(dt[:, t] * a)[..., None, None] * h + \
            bt[:, None, :, None] * (xt * dt[:, t, :, None])[:, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", ct, h) +
                  p["d_skip"][:, None] * xt)
    y = torch.stack(ys, 1).reshape(b, s, din)
    return (y * torch.nn.functional.silu(z)) @ p["out_proj"]


@pytest.mark.parametrize("setting", SETTINGS)
def test_ssd_grads_at_two_chunks_are_finite_and_stepwise(setting):
    """At 2 x 256 tokens, full-width decays overflow the reference's
    ``exp`` above the diagonal and its gradient is not finite (ROADMAP
    Queue 3).  The port's ``ssd_train`` and its gradient (input and every
    parameter) match the step-by-step recurrence, and are finite."""
    cfg, jcfg = _cfgs("mamba2-370m")
    run, jrun = _runs(seq_len=256)
    p = _layer_params(jcfg, jrun, "ssd", setting)
    x = np.random.default_rng(14).normal(
        size=(2, 256, cfg.d_model)).astype(np.float32)
    cot = np.random.default_rng(15).normal(
        size=(2, 256, cfg.d_model)).astype(np.float32)
    outs = []
    for fn in (TL.ssd_train, _ssd_stepwise):
        tp = {k: _t(a).requires_grad_() for k, a in p.items()}
        tx = _t(x).requires_grad_()
        y = fn(tp, tx, cfg, run)
        grads = torch.autograd.grad((y * _t(cot)).sum(),
                                    [tx] + list(tp.values()))
        outs.append((y.detach(), grads))
    (y, grads), (y_step, grads_step) = outs
    np.testing.assert_allclose(y.numpy(), y_step.numpy(),
                               **(CHUNK_TOL if setting == "default"
                                  else STATE_TOL))
    rtol, share = STEPWISE_GRAD_TOL[setting]
    for name, g, w in zip(["x"] + list(p), grads, grads_step):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name,
                                   rtol=rtol, atol=share * w.abs().max())


def test_mamba2_grads_finite_where_the_reference_is_not():
    """The reduced mamba2's loss at 2 x 256 tokens: finite in both
    packages and within LOSS_TOL; the reference's gradient has non-finite
    entries, the port's none (ROADMAP Queue 3's reproduction)."""
    mods = _Models("mamba2-370m", seq_len=256)
    toks, labels = _tokens(mods.cfg, 2, 256, 16), _tokens(mods.cfg, 2, 256, 17)
    batch = {"tokens": toks, "labels": labels}
    jloss, jgrads = jax.value_and_grad(lambda p: mods.jm["train_loss"](
        p, {k: jnp.asarray(v) for k, v in batch.items()}, mods.jrun))(mods.jp)
    loss = mods.m["train_loss"](mods.mod, tsteps.batch_to(batch, "cpu"),
                                mods.run)
    grads = torch.autograd.grad(loss, list(mods.mod.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    assert not all(np.isfinite(g).all() for g in
                   jax.tree_util.tree_leaves(_np_tree(jgrads)))
    assert all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# decode against the training forward, and the check's power
# ---------------------------------------------------------------------------

def _tol_units(got, want, vocab):
    return ((got - want).abs() / (DECODE_TOL["atol"] + DECODE_TOL["rtol"]
                                  * want.abs()))[:, :vocab].max().item()


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("name", RECURRENT)
def test_decode_matches_the_training_forward_and_controls_fail(name, setting):
    """A prefill of 128 tokens, then 128 teacher-forced decode steps, each
    step's logits against one training forward over the 256 tokens, within
    the reference's 2e-3.  A prefill twice and a decode step twice are
    bitwise.  At the long-memory setting, zeroing the first recurrent
    layer's ``h``, and separately its ``conv``, before the first decode
    step leaves the tolerance."""
    mods = _Models(name, setting, seq_len=256)
    cfg, run, model, params = mods.cfg, mods.run, mods.m, mods.mod
    s0, k = 128, 128
    seq = _t(_tokens(cfg, 2, s0 + k, 18)).long()
    with torch.no_grad():
        full = TT.forward(params, seq, cfg, run)
    l1, cache = model["prefill"](params, {"tokens": seq[:, :s0]}, run, s0 + k)
    l2, again = model["prefill"](params, {"tokens": seq[:, :s0]}, run, s0 + k)
    assert torch.equal(l1, l2) and all(
        torch.equal(a[n], b[n]) for a, b in zip(cache, again) for n in a)
    first = next(i for i, kind in enumerate(cfg.layer_kinds())
                 if kind in ("rglru", "ssd"))
    controls = {}
    for part in ("h", "conv"):
        faulty = [{n: t.clone() for n, t in c.items()} for c in cache]
        faulty[first][part].zero_()
        ctl, _ = model["decode_step"](params, faulty, seq[:, s0:s0 + 1], s0,
                                      run)
        controls[part] = _tol_units(ctl, full[:, s0], cfg.vocab)
    dec, _ = model["decode_step"](params, again, seq[:, s0:s0 + 1], s0, run)
    worst = 0.0
    for i in range(k):
        pos = s0 + i
        got, _ = model["decode_step"](params, cache, seq[:, pos:pos + 1], pos,
                                      run)
        if i == 0:
            assert torch.equal(got, dec) and all(
                torch.equal(a[n], b[n]) for a, b in zip(cache, again)
                for n in a)
        worst = max(worst, _tol_units(got, full[:, pos], cfg.vocab))
    assert worst <= 1.0, worst
    if setting == "long memory":
        assert min(controls.values()) > 1.0, controls


# ---------------------------------------------------------------------------
# serve and the command lines
# ---------------------------------------------------------------------------

def _reference_greedy(mods, prompts, new_tokens):
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


@pytest.mark.parametrize("name", RECURRENT)
def test_serve_matches_the_reference_model_functions(name):
    mods = _Models(name, "long memory")
    prompts = np.random.default_rng(0).integers(
        0, mods.cfg.vocab, (2, 24)).astype(np.int32)
    want = _reference_greedy(mods, prompts, 8)
    got, stats = tserve.serve(mods.cfg, mods.run, prompts, 8, device="cpu",
                              params=mods.mod)
    np.testing.assert_array_equal(got, want)
    assert stats["new_tokens"] == 8 and stats["tokens_per_s"] > 0


def test_check_slice_admits_the_recurrent_families():
    """Every run knob of the registry's families builds a train step: the
    recurrent families, and the encoder-decoder and vision prefix, whose
    batches read more than tokens."""
    from repro_torch.launch.steps import build_train_step
    for name in RECURRENT + ("whisper-large-v3", "internvl2-1b"):
        cfg = get_arch(name)
        assert name not in RECURRENT or cfg.family in ("hybrid", "ssm")
        for run in (RunConfig(), RunConfig(fsdp=True, act_shard="seq",
                                           param_dtype="bfloat16")):
            assert callable(build_train_step(cfg, run, device="cpu")["fn"])


@pytest.mark.parametrize("name", RECURRENT)
def test_cli_serves_and_trains_on_the_cpu(name, capsys):
    tserve.main(["--device", "cpu", "--arch", name, "--batch", "2",
                 "--prompt-len", "8", "--new-tokens", "4"])
    ttrain.main(["--device", "cpu", "--arch", name, "--steps", "2",
                 "--d-model", "64", "--layers", "2", "--seq", "16",
                 "--batch", "2"])
    out = capsys.readouterr().out
    assert f"[serve] {name}-smoke" in out and "sample continuation" in out
    assert "[train] first loss" in out
