"""The experts of the port on the CPU: routing, ``moe_mlp``, the MoE
decoders' prefill, decode and ``serve``, and a resumed MoE trainer, held to
the JAX reference on the same numpy inputs and weights
(``params_from_numpy``), all in f32.

Tolerances, those of ``tests/test_torch_lm.py`` and
``tests/test_torch_serve.py`` with their reasons: layers and logits
rtol = atol = 1e-5 (f32 sums in another order across frameworks);
gradients rtol 2e-4, atol 2e-6; decode against prefill rtol = atol = 2e-3
(the reference's ``test_decode_matches_full_forward``).  Routing: ``take``
equal, ``w_slot`` within 1e-6 (a softmax of k f32 logits).

Capacity: the reference sizes each call's expert slots from its own token
count, ``ceil(n k / E * moe_capacity)``.  A decode call has n = B, so at
the default capacity decode drops assignments that prefill keeps, and the
reference's decode differs from its prefill; at ``moe_capacity = E / k``
no assignment is dropped and they agree.  The port matches the
reference's decode, not its prefill.
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
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import RunConfig, get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as TL
from repro_torch.models import make_model, params_from_numpy, params_to_numpy

GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
W_TOL = dict(rtol=0, atol=1e-6)
MOE = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")


def _cfgs(name, **kw):
    return (dataclasses.replace(get_arch(name).reduced(), n_layers=2, **kw),
            dataclasses.replace(J_ARCHS[name].reduced(), n_layers=2, **kw))


def _runs(**kw):
    kw = dict(dict(seq_len=16, global_batch=2, dtype="float32"), **kw)
    return RunConfig(**kw), JRun(**kw)


def _no_drop(cfg):
    """The capacity factor E / k: every assignment keeps its slot."""
    return cfg.n_experts / cfg.experts_per_tok


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


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

    def jprefill(self, toks, cache_len=0):
        return jax.jit(lambda p, b: self.jm["prefill"](
            p, b, self.jrun, cache_len))(self.jp, {"tokens": jnp.asarray(toks)})

    def jdecode(self):
        return jax.jit(lambda p, c, t, pos: self.jm["decode_step"](
            p, c, t, pos, self.jrun))


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _tied_logits(seed, n, e, k):
    """(n, e) f32 logits with ties: on a grid of 0.25, and in every other
    row the k-th and (k+1)-th largest set equal, so that the k-th place is
    a tie that decides which expert is picked."""
    rng = np.random.default_rng(seed)
    lg = (np.round(rng.normal(size=(n, e)) * 4) / 4).astype(np.float32)
    for i in range(0, n, 2):
        order = np.argsort(-lg[i], kind="stable")
        lg[i, order[k]] = lg[i, order[k - 1]]
    return lg


# (seed, n tokens, experts, top k, capacity): tight and loose capacities,
# one slot an expert, and no drop at all
ROUTE_CASES = [(0, 64, 8, 2, 10), (1, 64, 8, 2, 3), (2, 40, 16, 4, 1),
               (3, 33, 8, 3, 33), (4, 128, 64, 6, 16)]


@pytest.mark.parametrize("seed,n,e,k,cap", ROUTE_CASES)
def test_moe_route_matches_reference_with_ties(seed, n, e, k, cap):
    """The router's logits through the identity: ``take`` bitwise, w_slot
    within 1e-6, with ties at the k-th place (``lax.top_k`` puts the lower
    expert first; the port's stable descending sort does the same)."""
    lg = _tied_logits(seed, n, e, k)
    eye = np.eye(e, dtype=np.float32)
    jt, jw = JL._moe_route(jnp.asarray(lg), jnp.asarray(eye), k, e, cap,
                           jnp.float32)
    tt, tw, inv = TL._moe_route(_t(lg), _t(eye), k, cap, torch.float32)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **W_TOL)
    # the inverse map: each token's kept slots in slot order, then E * cap
    take = tt.numpy().reshape(-1)
    for t in range(n):
        kept = np.flatnonzero(take == t)
        want = np.concatenate([kept, np.full(k - len(kept), e * cap)])
        np.testing.assert_array_equal(inv[t].numpy(), want)


def test_topk_order_breaks_ties_by_the_lower_index():
    """The tie rule that the routing relies on, on the sort itself."""
    lg = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    _, ids = torch.sort(lg, dim=-1, descending=True, stable=True)
    assert ids[0, :3].tolist() == [1, 2, 4]
    _, jids = jax.lax.top_k(jnp.asarray(lg.numpy()), 3)
    assert np.asarray(jids)[0].tolist() == [1, 2, 4]


# ---------------------------------------------------------------------------
# moe_mlp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("capacity", [0.5, 1.25, "E/k"])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_mlp_and_grads_match_reference(name, capacity, groups):
    cfg, jcfg = _cfgs(name)
    capacity = _no_drop(cfg) if capacity == "E/k" else capacity
    run, jrun = _runs(moe_capacity=capacity, moe_groups=groups)
    rng = np.random.default_rng(5)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(size=(d, e)).astype(np.float32) / 8,
         "wi": rng.normal(size=(e, d, 2 * f)).astype(np.float32) / 8,
         "wo": rng.normal(size=(e, f, d)).astype(np.float32) / 11}
    x = rng.normal(size=(2, 12, d)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)

    def jloss(pp, xx):
        return (JL.moe_mlp(pp, xx, jcfg, jrun) * g).sum()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = JL.moe_mlp(jp, jnp.asarray(x), jcfg, jrun)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tx = _t(x).requires_grad_()
    got = TL.moe_mlp(tp, tx, cfg, run)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LAYER_TOL)
    grads = torch.autograd.grad((got * _t(g)).sum(), [*tp.values(), tx])
    for a, b in zip(grads, [*(jgp[k] for k in tp), jgx]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_dispatch_and_combine_gradients_are_exact():
    """``_Dispatch`` and ``_Combine`` (the ordered sums standing in for a
    scatter-add) pass ``gradcheck`` in f64."""
    rng = np.random.default_rng(6)
    lg = _t(_tied_logits(7, 12, 4, 2)).double()
    take, _, inv = TL._route_from_logits(lg.float(), 2, 5)
    take, inv = take[None], inv[None]
    xt = _t(rng.normal(size=(1, 12, 3))).requires_grad_()
    contrib = _t(rng.normal(size=(1, 4, 5, 3))).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a: TL._Dispatch.apply(a, take, inv), (xt,))
    assert torch.autograd.gradcheck(
        lambda a: TL._Combine.apply(a, take, inv), (contrib,))


def test_combine_adds_in_slot_order_in_the_run_dtype():
    """In bf16 the combine is each token's contributions added from zero in
    slot order, rounded after every add, bit for bit: a fixed order, so
    that a decode step twice gives the same bits."""
    lg = _t(_tied_logits(8, 16, 8, 3))
    take, _, inv = TL._route_from_logits(lg, 3, 6)
    contrib = torch.randn(1, 8, 6, 5, generator=torch.Generator()
                          .manual_seed(9)).bfloat16()
    got = TL._Combine.apply(contrib, take[None], inv[None])[0]
    want = torch.zeros(17, 5, dtype=torch.bfloat16)
    for s, t in enumerate(take.reshape(-1).tolist()):
        want[t] = want[t] + contrib.reshape(-1, 5)[s]
    assert torch.equal(got, want[:16])


# ---------------------------------------------------------------------------
# the decoders: prefill, decode, serve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("capacity", ["default", "E/k"])
def test_prefill_and_decode_match_reference(name, capacity):
    """A 12-token prompt, then 4 decode steps: each call's logits against
    the reference's within DECODE_TOL (at the default capacity each call
    routes under its own capacity, as the reference's)."""
    cfg, _ = _cfgs(name)
    kw = {} if capacity == "default" else dict(moe_capacity=_no_drop(cfg))
    mods = _Models(name, **kw)
    s0, k = 12, 4
    toks = _tokens(mods.cfg, 2, s0 + k, 30)
    jl, jc = mods.jprefill(toks[:, :s0], s0 + k)
    tl, tc = mods.m["prefill"](mods.mod, {"tokens": _t(toks[:, :s0]).long()},
                               mods.run, s0 + k)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)
    jdec = mods.jdecode()
    for i in range(k):
        tok = toks[:, s0 + i:s0 + i + 1]
        jl, jc = jdec(mods.jp, jc, jnp.asarray(tok), jnp.int32(s0 + i))
        tl, tc = mods.m["decode_step"](mods.mod, tc, _t(tok).long(), s0 + i,
                                       mods.run)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **DECODE_TOL)


def _decode_against_prefill(m, params, run, toks, s0):
    """The largest |decode - prefill of the growing prefix| over the
    teacher-forced steps, in units of DECODE_TOL's atol + rtol |prefill|."""
    _, cache = m["prefill"](params, {"tokens": toks[:, :s0]}, run,
                            toks.shape[1])
    worst = 0.0
    for pos in range(s0, toks.shape[1]):
        dec, _ = m["decode_step"](params, cache, toks[:, pos:pos + 1], pos,
                                  run)
        full, _ = m["prefill"](params, {"tokens": toks[:, :pos + 1]}, run)
        worst = max(worst, float(((dec - full).abs() / (
            DECODE_TOL["atol"] + DECODE_TOL["rtol"] * full.abs())).max()))
    return worst


@pytest.mark.parametrize("name", MOE)
def test_decode_differs_from_prefill_at_the_default_capacity(name):
    """Batch 8, 16-token prompts, 4 decode steps: at ``moe_capacity = E/k``
    decode is prefill of the growing prefix within DECODE_TOL; at the
    default 1.25 a decode call of 8 tokens has one slot an expert, drops
    assignments that prefill keeps, and leaves the tolerance, in the port
    as in the reference."""
    cfg, jcfg = _cfgs(name)
    toks = _tokens(cfg, 8, 20, 31)
    for capacity, agree in ((_no_drop(cfg), True), (1.25, False)):
        run, jrun = _runs(moe_capacity=capacity)
        m = make_model(cfg)
        params = m["init"](run, torch.Generator().manual_seed(0), "cpu")
        worst = _decode_against_prefill(m, params, run, _t(toks).long(), 16)
        assert (worst <= 1.0) == agree, (capacity, worst)
        jm = j_make_model(jcfg)
        jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(cfg, params))
        _, jc = jm["prefill"](jp, {"tokens": jnp.asarray(toks[:, :16])}, jrun,
                              20)
        jdec, _ = jm["decode_step"](jp, jc, jnp.asarray(toks[:, 16:17]),
                                    jnp.int32(16), jrun)
        jfull, _ = jm["prefill"](jp, {"tokens": jnp.asarray(toks[:, :17])},
                                 jrun)
        close = np.allclose(np.asarray(jdec), np.asarray(jfull), **DECODE_TOL)
        assert close == agree, capacity


@pytest.mark.parametrize("name", MOE)
def test_serve_matches_the_reference_model_functions(name):
    """Greedy ``serve`` of 2 prompts against the reference's model
    functions with the cache sized for every new token."""
    mods = _Models(name)
    s0, new = 12, 6
    prompts = _tokens(mods.cfg, 2, s0, 32)
    logits, cache = mods.jprefill(prompts, s0 + new)
    jdec = mods.jdecode()
    want, tok = [], jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for i in range(new):
        want.append(np.asarray(tok)[:, 0])
        logits, cache = jdec(mods.jp, cache, tok, jnp.int32(s0 + i))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    got, stats = tserve.serve(mods.cfg, mods.run, prompts, new, device="cpu",
                              params=mods.mod)
    np.testing.assert_array_equal(got, np.stack(want, axis=1))
    assert stats["new_tokens"] == new


def test_decode_step_twice_is_bitwise():
    mods = _Models("qwen3-moe-30b-a3b")
    toks = _t(_tokens(mods.cfg, 2, 9, 33)).long()
    _, cache = mods.m["prefill"](mods.mod, {"tokens": toks[:, :8]}, mods.run,
                                 9)
    twins = [[{k: t.clone() for k, t in c.items()} for c in cache]
             for _ in range(2)]
    outs = [mods.m["decode_step"](mods.mod, c, toks[:, 8:], 8, mods.run)[0]
            for c in twins]
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_moe_trainer_resumes_bitwise(tmp_path):
    """qwen3-moe reduced: 4 steps straight against 2 saved and 2 resumed
    through ``train``'s checkpoints; losses, parameters and AdamW state
    bitwise."""
    run, _ = _runs(warmup=1)
    cfg, _ = _cfgs("qwen3-moe-30b-a3b")
    p4, o4, l4, _ = ttrain.train(cfg, run, 4, device="cpu", log_every=0)
    d = str(tmp_path / "ck")
    ttrain.train(cfg, run, 2, device="cpu", log_every=0, checkpoint_dir=d,
                 checkpoint_every=2)
    pr, orr, lr_, _ = ttrain.train(cfg, run, 2, device="cpu", log_every=0,
                                   checkpoint_dir=d, checkpoint_every=2)
    assert CheckpointStore(d).latest() == 4 and orr["count"] == 4
    assert l4[2:] == lr_
    assert all(torch.equal(a, b) for a, b in zip(pr.parameters(),
                                                  p4.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(orr["nu"], o4["nu"]))


def test_moe_cli_serves_and_trains_on_the_cpu(capsys):
    tserve.main(["--device", "cpu", "--arch", "qwen3-moe-30b-a3b", "--batch",
                 "2", "--prompt-len", "8", "--new-tokens", "4"])
    ttrain.main(["--device", "cpu", "--arch", "moonshot-v1-16b-a3b",
                 "--steps", "2", "--d-model", "64", "--layers", "1", "--seq",
                 "16", "--batch", "2"])
    out = capsys.readouterr().out
    assert "[serve] qwen3-moe-30b-a3b-smoke" in out
    assert "[train] first loss" in out
