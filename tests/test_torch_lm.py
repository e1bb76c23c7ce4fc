"""The LM slice of the port on the CPU: configs, layers, the decoder's loss
and gradients, the optimizer, ``TokenStream``, three training steps and the
trainer's checkpoints, held to the JAX reference on the same numpy inputs
and weights (``params_from_numpy``).

Tolerances, each with its reason (all in f32, ``RunConfig(dtype="float32")``):

- losses: rtol 1e-5, as ``tests/test_flash_integration.py`` holds the
  reference's two attention paths to each other: f32 sums over the vocabulary
  and the model width run in another order across frameworks;
- gradients and parameters after training: rtol 2e-4, atol 2e-6, the same
  file's gradient tolerance (a backward pass compounds those orders);
- layers alone: rtol = atol = 1e-5, one layer's f32 rounding; bf16 score
  blocks in ``_sdpa_flash``: rtol = atol = 2**-7, two bf16 ulps;
- configs, ``TokenStream``, the weight round trip and a resumed run against
  an uninterrupted one: equal.

The flash kernel's path runs here through its plain version (a CPU tensor);
``chip_smoke.py`` runs the CUDA kernel on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import ARCHS as J_ARCHS
from repro.checkpoint import CheckpointStore as JCheckpointStore
from repro.configs import RunConfig as JRun
from repro.data import TokenStream as JTokenStream
from repro.models import layers as JL
from repro.models import make_model as j_make_model
from repro_torch import optim as toptim
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import ARCHS, RunConfig, get_arch
from repro_torch.data import TokenStream
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import make_model, params_from_numpy, params_to_numpy

LOSS_TOL = dict(rtol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
RUNNABLE = ("olmo-1b", "phi3-medium-14b", "gemma3-4b", "h2o-danube-1.8b",
            "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "recurrentgemma-2b",
            "mamba2-370m")


def _cfg(name, layers=2):
    return dataclasses.replace(get_arch(name).reduced(), n_layers=layers)


def _jcfg(name, layers=2):
    return dataclasses.replace(J_ARCHS[name].reduced(), n_layers=layers)


def _runs(**kw):
    kw = dict(dict(seq_len=16, global_batch=2, dtype="float32"), **kw)
    return RunConfig(**kw), JRun(**kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_params(jcfg, jrun, seed=0):
    """The reference's initial parameters as numpy, norms moved off their
    identity so that the (1 + scale) and bias paths count."""
    tree = _np_tree(j_make_model(jcfg)["init"](jrun, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)

    def perturb(path, a):
        key = getattr(path[-1], "key", None)
        if key in ("scale", "bias"):
            return (a + 0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb, tree)


def _batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, :3] = -1                          # padding labels are masked
    return {"tokens": toks, "labels": labels}


def _assert_trees_close(got, want, **tol):
    gl, gdef = jax.tree_util.tree_flatten(got)
    wl, wdef = jax.tree_util.tree_flatten(want)
    assert gdef == wdef
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, b, **tol)


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(J_ARCHS))
def test_configs_match_reference(name):
    ours, ref = ARCHS[name], J_ARCHS[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(ref.reduced())
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    assert ours.vocab_padded == ref.vocab_padded
    assert ours.layer_kinds() == ref.layer_kinds()


def test_run_config_defaults_match_reference():
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(JRun())


@pytest.mark.parametrize("kw", [
    dict(vocab=512, seq_len=16, batch=3),
    dict(vocab=50304, seq_len=64, batch=2, seed=7, shard=1, n_shards=2),
    dict(vocab=1000, seq_len=8, batch=4, weights=np.array([0.2, 0.3, 0.5]))])
def test_token_stream_matches_reference_bitwise(kw):
    ours, ref = TokenStream(**kw), JTokenStream(**kw)
    for step in (0, 1, 5):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "nonparametric"])
def test_norm_matches_reference(norm):
    cfg = dataclasses.replace(_cfg("olmo-1b"), norm=norm)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    p = {k: (rng.normal(size=cfg.d_model) * 0.1).astype(np.float32)
         for k in ({"rmsnorm": ["scale"], "layernorm": ["scale", "bias"]}
                   .get(norm, []))}
    got = TL.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_rope_and_qk_norm_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)[None, :]
    np.testing.assert_allclose(
        TL.rope(_t(x), _t(pos), 10_000.0).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)),
        **LAYER_TOL)
    scale = (rng.normal(size=16) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        TL._rms_head(_t(x), _t(scale)).numpy(),
        np.asarray(JL._rms_head(jnp.asarray(x), jnp.asarray(scale))),
        **LAYER_TOL)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    cfg = dataclasses.replace(_cfg("olmo-1b"), act=act)
    rng = np.random.default_rng(3)
    gated = act != "gelu"
    p = {"wi": rng.normal(size=(64, 256 if gated else 128)).astype(np.float32) / 8,
         "wo": rng.normal(size=(128, 64)).astype(np.float32) / 11}
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    run, jrun = _runs()
    got = TL.mlp({k: _t(v) for k, v in p.items()}, _t(x), cfg, run)
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  cfg, jrun)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def _qkv_np(seed, b=2, s=32, h=4, kvh=2, dh=16, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, h, dh)).astype(dtype),
            rng.normal(size=(b, s, kvh, dh)).astype(dtype),
            rng.normal(size=(b, s, kvh, dh)).astype(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_dense_matches_reference(causal):
    q, k, v = _qkv_np(4)
    got = TL._sdpa_dense(_t(q), _t(k), _t(v), causal=causal)
    want = JL._sdpa_dense(*map(jnp.asarray, (q, k, v)), causal=causal,
                          window=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("f32_scores,dtype", [(True, "float32"),
                                              (False, "float32"),
                                              (False, "bfloat16")])
def test_sdpa_flash_matches_reference(f32_scores, dtype):
    q, k, v = _qkv_np(5)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = TL._sdpa_flash(*(_t(a).to(tdt) for a in (q, k, v)), causal=True,
                         chunk=8, f32_scores=f32_scores)
    want = JL._sdpa_flash(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                          causal=True, chunk=8, f32_scores=f32_scores)
    tol = LAYER_TOL if dtype == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_flash_kernel_gqa_matches_reference():
    """The kv-broadcast wrapper (GQA, 4 heads over 2): ``repeat_interleave``
    and the (B*H, S, Dh) layout, through the plain version on the CPU."""
    q, k, v = _qkv_np(6)
    got = TL._flash_kernel_gqa(_t(q), _t(k), _t(v))
    want = JL._flash_kernel_gqa(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# ---------------------------------------------------------------------------
# the decoder: loss and gradients from one state
# ---------------------------------------------------------------------------

def _grads_tree(cfg, module, grads):
    """``grads`` (in ``module.parameters()`` order) as the reference's
    tree, through a copy of the module that holds them as values."""
    with torch.no_grad():
        for p, g in zip(module.parameters(), grads):
            p.copy_(g)
    return params_to_numpy(cfg, module)


# (arch, flash kernel, seq_len, attn_chunk, vocab): the dense path, the
# flash kernel's path, a sequence long enough to take _sdpa_flash, and a
# vocabulary of 500 padded to 512 (its padding columns masked)
LOSS_CASES = [(name, flash, s, chunk, None) for name in RUNNABLE
              for flash, s, chunk in [(False, 16, 1024), (True, 16, 1024),
                                      (False, 32, 8)]] + \
    [(name, True, 16, 1024, 500) for name in RUNNABLE]


@pytest.mark.parametrize("name,flash,seq,chunk,vocab", LOSS_CASES)
def test_train_loss_and_grads_match_reference(name, flash, seq, chunk, vocab):
    run, jrun = _runs(seq_len=seq, flash_kernel=flash, attn_chunk=chunk)
    cfg, jcfg = _cfg(name), _jcfg(name)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
        jcfg = dataclasses.replace(jcfg, vocab=vocab)
        assert cfg.vocab_padded > vocab
    tree = _jax_params(jcfg, jrun)
    batch = _batch(cfg, 2, seq)
    jmodel = j_make_model(jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(
        lambda p: jmodel["train_loss"](p, jbatch, jrun))(jparams)

    module = params_from_numpy(cfg, tree, device="cpu")
    tbatch = tsteps.batch_to(batch, "cpu")
    loss = make_model(cfg)["train_loss"](module, tbatch, run)
    grads = torch.autograd.grad(loss, list(module.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    _assert_trees_close(_grads_tree(cfg, module, grads), _np_tree(jgrads),
                        **GRAD_TOL)


@pytest.mark.parametrize("name", RUNNABLE)
def test_params_round_trip_is_bitwise(name):
    _, jrun = _runs()
    tree = _jax_params(_jcfg(name), jrun)
    back = params_to_numpy(_cfg(name), params_from_numpy(_cfg(name), tree,
                                                         device="cpu"))
    gl, gdef = jax.tree_util.tree_flatten(back)
    wl, wdef = jax.tree_util.tree_flatten(tree)
    assert gdef == wdef
    for a, b in zip(gl, wl):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", RUNNABLE)
def test_port_init_has_the_reference_tree_and_scales(name):
    """The port's own initialisation: the reference's tree of shapes, f32,
    and its scales (1/sqrt(shape[0]), fan_in for a matrix, the expert count
    for the experts' (E, ., .) weights; attention's wo at 1/sqrt(h*dh);
    the recurrent convs at 0.5, ``lam`` 0.5, ``a_log`` and ``dt_bias`` 0,
    ``d_skip`` 1; embed 0.02)."""
    # a full block cycle and a tail layer, so that both the scan and the
    # tail count
    layers = max(3, len(get_arch(name).pattern) + 1)
    cfg = dataclasses.replace(_cfg(name, layers=layers), d_model=128,
                              d_ff=256)
    run, jrun = _runs()
    gen = torch.Generator().manual_seed(0)
    ours = params_to_numpy(cfg, make_model(cfg)["init"](run, gen, "cpu"))
    ref = jax.eval_shape(lambda: j_make_model(cfg)["init"](
        jrun, jax.random.PRNGKey(0)))
    ol, odef = jax.tree_util.tree_flatten(ours)
    rl, rdef = jax.tree_util.tree_flatten(ref)
    assert odef == rdef
    assert [a.shape for a in ol] == [tuple(s.shape) for s in rl]
    h, dh, d = cfg.n_heads, cfg.head_dim_, cfg.d_model
    np.testing.assert_allclose(ours["embed"].std(), 0.02, rtol=0.05)
    scan = ours["blocks"]["scan"]

    def part(key):
        """``key`` of the first scan position that has it, or None."""
        return next((b[key] for b in scan if key in b), None)
    attn, ffn, rglru, ssd = map(part, ("attn", "ffn", "rglru", "ssd"))
    if attn is not None:
        np.testing.assert_allclose(attn["wq"].std(), d ** -0.5, rtol=0.05)
        np.testing.assert_allclose(attn["wo"].std(), (h * dh) ** -0.5,
                                   rtol=0.05)
    if ffn is not None:
        fan = ffn["wo"].shape[1]    # (repeats, f, d) or (repeats, E, f, d)
        assert fan == (cfg.n_experts or cfg.d_ff)
        np.testing.assert_allclose(ffn["wo"].std(), fan ** -0.5, rtol=0.05)
    if rglru is not None:
        for key, scale in (("wx", d ** -0.5), ("wr", cfg.d_inner ** -0.5),
                           ("conv", 0.5)):
            np.testing.assert_allclose(rglru[key].std(), scale, rtol=0.1)
        np.testing.assert_array_equal(rglru["lam"], 0.5)
    if ssd is not None:
        for key, scale in (("in_proj", d ** -0.5), ("conv", 0.5),
                           ("out_proj", cfg.d_inner ** -0.5)):
            np.testing.assert_allclose(ssd[key].std(), scale, rtol=0.1)
        for key, value in (("a_log", 0.0), ("d_skip", 1.0), ("dt_bias", 0.0)):
            np.testing.assert_array_equal(ssd[key], value)
    assert attn is not None or rglru is not None or ssd is not None
    for norm in [ours["final_norm"], scan[0]["norm1"]]:
        for v in norm.values():
            np.testing.assert_array_equal(v, np.zeros_like(v))  # rmsnorm 1+s
    again = params_to_numpy(cfg, make_model(cfg)["init"](
        run, torch.Generator().manual_seed(0), "cpu"))
    np.testing.assert_array_equal(again["embed"], ours["embed"])


# ---------------------------------------------------------------------------
# optimizer and training
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    for step in (0, 1, 7, 100, 101, 5000, 99_999, 100_000, 200_000):
        for warmup in (0, 1, 100):
            got = toptim.lr_schedule(step, 3e-4, warmup)
            want = float(joptim.lr_schedule(jnp.int32(step), 3e-4, warmup))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_and_adamw_match_reference(max_norm):
    rng = np.random.default_rng(9)
    shapes = [(5, 3), (7,), (2, 2, 4)]
    ps = [rng.normal(size=s).astype(np.float32) for s in shapes]
    gs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jg, jn = joptim.clip_by_global_norm([jnp.asarray(g) for g in gs], max_norm)
    tg, tn = toptim.clip_by_global_norm([_t(g).clone() for g in gs], max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_trees_close([g.numpy() for g in tg], _np_tree(jg), **LAYER_TOL)
    jp, jstate = [jnp.asarray(p) for p in ps], joptim.adamw_init(
        [jnp.asarray(p) for p in ps])
    tp = [_t(p).clone() for p in ps]
    tstate = toptim.adamw_init(tp)
    for lr in (1e-2, 3e-3):
        jp, jstate = joptim.adamw_update(jp, jg, jstate, lr=lr,
                                         weight_decay=0.1)
        tp, tstate = toptim.adamw_update(tp, tg, tstate, lr=lr,
                                         weight_decay=0.1)
    assert tstate["count"] == int(jstate["count"]) == 2
    _assert_trees_close([p.numpy() for p in tp], _np_tree(jp), **LAYER_TOL)
    _assert_trees_close([m.numpy() for m in tstate["mu"]],
                        _np_tree(jstate["mu"]), **LAYER_TOL)
    _assert_trees_close([m.numpy() for m in tstate["nu"]],
                        _np_tree(jstate["nu"]), **LAYER_TOL)


def _jax_train(cfg, run, tree, steps):
    """The reference's three pieces around its model, as its
    ``build_train_step`` composes them (no mesh)."""
    model = j_make_model(cfg)
    stream = JTokenStream(vocab=cfg.vocab, seq_len=run.seq_len,
                          batch=run.global_batch, seed=run.seed)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt = joptim.adamw_init(params)

    @jax.jit
    def step_fn(params, opt, batch, step):
        loss, grads = jax.value_and_grad(
            lambda p: model["train_loss"](p, batch, run))(params)
        grads, _ = joptim.clip_by_global_norm(grads, run.grad_clip)
        lr = joptim.lr_schedule(step, run.learning_rate, run.warmup)
        params, opt = joptim.adamw_update(params, grads, opt, lr=lr,
                                          weight_decay=run.weight_decay)
        return params, opt, loss

    losses = []
    for i in range(steps):
        batch = {k: jnp.asarray(v) for k, v in stream.batch_at(i).items()}
        params, opt, loss = step_fn(params, opt, batch, jnp.int32(i))
        losses.append(float(loss))
    return _np_tree(params), losses


@pytest.mark.parametrize("flash", [False, True])
def test_three_train_steps_match_reference(flash):
    """Reduced olmo (GQA: 4 heads over 2 kv heads), 3 steps of ``train``
    from one state; warmup 1 so that steps 1 and 2 move the weights (the
    schedule gives 0 at step 0)."""
    run, jrun = _runs(warmup=1, flash_kernel=flash)
    cfg, jcfg = _cfg("olmo-1b"), _jcfg("olmo-1b")
    tree = _jax_params(jcfg, jrun)
    want_params, want_losses = _jax_train(jcfg, jrun, tree, 3)
    params, opt, losses, tel = ttrain.train(
        cfg, run, 3, device="cpu", params=params_from_numpy(cfg, tree, "cpu"),
        log_every=0)
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    assert losses[1] != losses[0] and opt["count"] == 3
    assert tel.summary()["steps"] == 3
    _assert_trees_close(params_to_numpy(cfg, params), want_params, **GRAD_TOL)
    moved = params_to_numpy(cfg, params)["embed"] - tree["embed"]
    assert np.abs(moved).max() > 1e-5


# ---------------------------------------------------------------------------
# remat and gradient microbatching
# ---------------------------------------------------------------------------

# gemma3's 7 reduced layers: one LLLLLG cycle under remat and a tail layer
# outside it; qwen3-moe's 2: two cycles of one layer, with experts
REMAT_ARCHS = (("gemma3-4b", 7), ("qwen3-moe-30b-a3b", 2))


def _loss_and_grads(module, cfg, run, batch):
    loss = make_model(cfg)["train_loss"](module, tsteps.batch_to(batch, "cpu"),
                                         run)
    return loss.detach(), torch.autograd.grad(loss, list(module.parameters()))


@pytest.mark.parametrize("name,layers", REMAT_ARCHS)
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_is_bitwise_the_plain_run_and_matches_reference(name, layers,
                                                              remat):
    """The loss and every gradient bitwise those of ``remat="none"``, and
    within GRAD_TOL of the reference's own remat."""
    run, jrun = _runs(remat=remat, flash_kernel=True)
    cfg, jcfg = _cfg(name, layers), _jcfg(name, layers)
    tree = _jax_params(jcfg, jrun)
    batch = _batch(cfg, 2, 16)
    module = params_from_numpy(cfg, tree, device="cpu")
    loss, grads = _loss_and_grads(module, cfg, run, batch)
    plain = _loss_and_grads(module, cfg, dataclasses.replace(run, remat="none"),
                            batch)
    assert torch.equal(loss, plain[0])
    assert all(torch.equal(a, b) for a, b in zip(grads, plain[1]))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: j_make_model(jcfg)[
        "train_loss"](p, jbatch, jrun))(jax.tree_util.tree_map(jnp.asarray,
                                                               tree))
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    _assert_trees_close(_grads_tree(cfg, module, grads), _np_tree(jgrads),
                        **GRAD_TOL)


def test_remat_dots_saves_the_products_without_batch_dims():
    """The ops that the backward runs, recomputation included: "dots" runs
    the plain backward's ``mm``s and no more (the forward's are saved) and
    recomputes the ``bmm``s (attention's, the experts'); "full" recomputes
    both."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen[func] += 1
            return func(*args, **(kwargs or {}))
    cfg = _cfg("qwen3-moe-30b-a3b")
    batch = tsteps.batch_to(_batch(cfg, 2, 16), "cpu")
    seen = {}
    for remat in ("none", "full", "dots"):
        run, _ = _runs(remat=remat)
        module = make_model(cfg)["init"](run, torch.Generator().manual_seed(0),
                                         "cpu")
        loss = make_model(cfg)["train_loss"](module, batch, run)
        with Ops() as ops:
            torch.autograd.grad(loss, list(module.parameters()))
        seen[remat] = ops.seen
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert seen["dots"][mm] == seen["none"][mm] < seen["full"][mm]
    assert seen["none"][bmm] < seen["dots"][bmm] == seen["full"][bmm]


@pytest.mark.parametrize("name", ["olmo-1b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("k", [2, 4])
def test_microbatch_step_matches_reference(name, k):
    """One step at ``microbatch = k`` over a batch of 4 against the
    reference's ``build_train_step`` (its ``lax.scan`` over the slices) on
    one state: the loss, the grad norm and the accumulated gradients, at
    the tolerances of ``test_three_train_steps_match_reference``.  With
    experts each slice routes under its own capacity, in both packages.

    The gradients are read from AdamW's first moment, ``(1 - b1) g`` after
    one step.  The parameters themselves are not compared: AdamW's first
    step moves each by ``lr g / (|g| + eps)``, and an embedding gradient
    that the slices' sum cancels to ~1e-10 (rounding noise, of either sign
    in either framework) moves its parameter by up to lr ``|g| / eps``."""
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import build_train_step as j_build_train_step
    from repro.launch.steps import jit_train_step
    run, jrun = _runs(global_batch=4, microbatch=k, warmup=1)
    cfg, jcfg = _cfg(name), _jcfg(name)
    tree = _jax_params(jcfg, jrun)
    batch = JTokenStream(vocab=cfg.vocab, seq_len=16, batch=4,
                         seed=0).batch_at(1)
    mesh = make_host_mesh()
    built = j_build_train_step(jcfg, jrun, mesh)
    fn = jit_train_step(built, mesh, jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    _, jo, jm = fn(jparams, joptim.adamw_init(jparams), batch, jnp.int32(1))
    module = params_from_numpy(cfg, tree, "cpu")
    step = tsteps.build_train_step(cfg, run, device="cpu")["fn"]
    params, opt, m = step(module, toptim.adamw_init(list(module.parameters())),
                          tsteps.batch_to(batch, "cpu"), 1)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **LOSS_TOL)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                               **GRAD_TOL)
    assert opt["count"] == 1
    b1 = 0.1                       # 1 - beta1, AdamW's default in both
    grads = jax.tree_util.tree_map(
        lambda m: m / b1, params_to_numpy(cfg, params, opt["mu"]))
    _assert_trees_close(grads, jax.tree_util.tree_map(
        lambda m: np.asarray(m) / b1, jo["mu"]), **GRAD_TOL)


def test_microbatch_must_divide_the_batch():
    run, _ = _runs(global_batch=4, microbatch=3)
    with pytest.raises(ValueError, match="does not divide"):
        tsteps.build_train_step(_cfg("olmo-1b"), run, device="cpu")


# ---------------------------------------------------------------------------
# the trainer's checkpoints
# ---------------------------------------------------------------------------

def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path):
    """4 steps straight through against 2 steps saved at step 2 and 2
    resumed in a fresh ``train`` call: losses, parameters and AdamW state
    bitwise; the restored state is bitwise the saved one."""
    run, _ = _runs(warmup=1)
    cfg = _cfg("olmo-1b")
    p4, o4, l4, _ = ttrain.train(cfg, run, 4, device="cpu", log_every=0)
    d = str(tmp_path / "ck")
    p2, o2, l2, _ = ttrain.train(cfg, run, 2, device="cpu", log_every=0,
                                 checkpoint_dir=d, checkpoint_every=2)
    assert CheckpointStore(d).latest() == 2
    rp, ro, rstep = ttrain.restore_state(cfg, CheckpointStore(d), "cpu")
    assert rstep == 2 and ro["count"] == o2["count"] == 2
    assert _leaves_equal(rp.parameters(), p2.parameters())
    assert _leaves_equal(ro["mu"], o2["mu"]) and _leaves_equal(ro["nu"],
                                                               o2["nu"])
    pr, orr, lr_, _ = ttrain.train(cfg, run, 2, device="cpu", log_every=0,
                                   checkpoint_dir=d, checkpoint_every=2)
    assert l2 + lr_ == l4
    assert orr["count"] == o4["count"] == 4
    assert _leaves_equal(pr.parameters(), p4.parameters())
    assert _leaves_equal(orr["mu"], o4["mu"])
    assert _leaves_equal(orr["nu"], o4["nu"])
    assert CheckpointStore(d).latest() == 4
    with pytest.raises(ValueError, match="both give the start"):
        ttrain.train(cfg, run, 1, device="cpu", params=pr, checkpoint_dir=d)


def test_start_step_overrides_the_resume_step(tmp_path):
    run, _ = _runs(warmup=1)
    cfg = _cfg("olmo-1b")
    d = str(tmp_path / "ck")
    ttrain.train(cfg, run, 2, device="cpu", log_every=0, checkpoint_dir=d,
                 checkpoint_every=2)
    params, _, _ = ttrain.restore_state(cfg, CheckpointStore(d), "cpu")
    batch = tsteps.batch_to(TokenStream(
        vocab=cfg.vocab, seq_len=run.seq_len, batch=run.global_batch,
        seed=run.seed).batch_at(5), "cpu")
    with torch.no_grad():
        want = float(make_model(cfg)["train_loss"](params, batch, run))
    _, opt, losses, _ = ttrain.train(cfg, run, 1, device="cpu", log_every=0,
                                     checkpoint_dir=d, checkpoint_every=2,
                                     start_step=5)
    assert losses == [want] and opt["count"] == 3
    assert CheckpointStore(d).latest() == 6


def test_lm_trainer_end_to_end(tmp_path):
    """The mirror of ``tests/test_system.py::test_lm_trainer_end_to_end``:
    8 steps with checkpoints every 4, then a resume from step 8."""
    cfg = _cfg("olmo-1b")
    run = RunConfig(seq_len=32, global_batch=4, dtype="float32",
                    learning_rate=3e-3, warmup=0)
    d = str(tmp_path / "ck")
    _, _, losses, tel = ttrain.train(cfg, run, 8, device="cpu",
                                     checkpoint_dir=d, checkpoint_every=4,
                                     log_every=0)
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] + 0.1
    assert tel.summary()["steps"] == 8
    assert CheckpointStore(d).latest() == 8
    _, opt, losses2, _ = ttrain.train(cfg, run, 2, device="cpu",
                                      checkpoint_dir=d, checkpoint_every=4,
                                      log_every=0)
    assert len(losses2) == 2 and np.isfinite(losses2).all()
    assert opt["count"] == 10


def test_port_checkpoint_feeds_the_reference(tmp_path):
    """The reference's store reads a port checkpoint into its own trees;
    its ``train_loss`` on the saved parameters is the port's loss."""
    run, jrun = _runs(warmup=1)
    cfg, jcfg = _cfg("gemma3-4b", layers=7), _jcfg("gemma3-4b", layers=7)
    d = str(tmp_path / "ck")
    params, opt, _, _ = ttrain.train(cfg, run, 2, device="cpu", log_every=0,
                                     checkpoint_dir=d, checkpoint_every=2)
    jparams = j_make_model(jcfg)["init"](jrun, jax.random.PRNGKey(1))
    tree = JCheckpointStore(d).restore({
        "params": jparams, "opt": joptim.adamw_init(jparams),
        "step": np.int32(0)})
    assert int(tree["step"]) == 2 and int(tree["opt"]["count"]) == 2
    _assert_trees_close(_np_tree(tree["params"]), params_to_numpy(cfg, params),
                        rtol=0, atol=0)
    _assert_trees_close(_np_tree(tree["opt"]["nu"]),
                        params_to_numpy(cfg, params, opt["nu"]), rtol=0, atol=0)
    batch = _batch(cfg, 2, run.seq_len, seed=3)
    jloss = j_make_model(jcfg)["train_loss"](
        jax.tree_util.tree_map(jnp.asarray, tree["params"]),
        {k: jnp.asarray(v) for k, v in batch.items()}, jrun)
    with torch.no_grad():
        loss = make_model(cfg)["train_loss"](params, tsteps.batch_to(
            batch, "cpu"), run)
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)


# ---------------------------------------------------------------------------
# bf16 parameters (f32 in both packages), and the device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["olmo-1b", "qwen3-moe-30b-a3b"])
def test_param_dtype_keeps_f32_parameters_as_the_reference(name):
    """The reference reads ``param_dtype`` nowhere: its ``_init`` makes f32
    parameters whatever it says, so a bf16 run's loss is its default's.
    The port's loss and train step are bitwise its default's, and match
    the reference's loss."""
    run, jrun = _runs(param_dtype="bfloat16")
    run0, jrun0 = _runs()
    cfg, jcfg = _cfg(name), _jcfg(name)
    batch = _batch(cfg, 2, run.seq_len)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = j_make_model(jcfg)
    jp = jmodel["init"](jrun, jax.random.PRNGKey(0))
    assert all(x.dtype == jnp.float32 for x in jax.tree_util.tree_leaves(jp))
    jloss = jmodel["train_loss"](jp, jbatch, jrun)
    assert float(jloss) == float(jmodel["train_loss"](jp, jbatch, jrun0))
    tree = _np_tree(jp)
    tbatch = tsteps.batch_to(batch, "cpu")
    out = {}
    for r in (run, run0):
        module = params_from_numpy(cfg, tree, device="cpu")
        assert all(p.dtype == torch.float32 for p in module.parameters())
        built = tsteps.build_train_step(cfg, r, device="cpu")
        opt = toptim.adamw_init(list(module.parameters()))
        _, _, m = built["fn"](module, opt, tbatch, 1)
        out[r.param_dtype] = (m["loss"], [p.detach().clone()
                                          for p in module.parameters()])
    (lb, pb), (lf, pf) = out["bfloat16"], out["float32"]
    assert torch.equal(lb, lf)
    assert all(torch.equal(a, b) for a, b in zip(pb, pf))
    np.testing.assert_allclose(float(lb), float(jloss), **LOSS_TOL)


def test_device_none_means_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run, _ = _runs()
    cfg = _cfg("olmo-1b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.train(cfg, run, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_model(cfg)["init"](run)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy(cfg, {})


def test_train_cli_runs_on_the_cpu(capsys):
    ttrain.main(["--device", "cpu", "--steps", "2", "--d-model", "64",
                 "--layers", "1", "--seq", "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert "[train] first loss" in out and "telemetry" in out


def test_train_cli_checkpoints(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--steps", "2", "--d-model", "64", "--layers",
            "1", "--seq", "16", "--batch", "2", "--ckpt-dir", d,
            "--ckpt-every", "1"]
    ttrain.main(argv)
    assert CheckpointStore(d).latest() == 2
    ttrain.main(argv)
    assert CheckpointStore(d).latest() == 4
    assert capsys.readouterr().out.count("[train] first loss") == 2
