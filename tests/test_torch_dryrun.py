"""The port's dry run (``launch.dryrun``, ``step_cost``, ``roofline``,
``collective_histo``, ``models.input_specs``, ``kernels.work``) held to the
reference's tools and to the port's own runs.

- **Inputs**: every enabled (arch x shape) cell's ``input_specs`` leaf by
  leaf against the reference's, shape and dtype (the decode cache through
  the layout map its docstring gives).
- **Roofline**: the reference's ``roofline``, ``train_model_flops`` and
  ``decode_model_flops`` with the H100's constants swapped in give the
  port's numbers.
- **FLOPs**: a reduced olmo-1b train step's products outside attention
  against the reference's ``hlo_cost`` count of its compiled step.
- **Payload**: the dry group's payload by key equal, as integers, to a real
  CPU run's, for a reduced olmo-1b on (2, 2) with FSDP, reduced whisper
  and internvl2 prefill and decode steps on (2, 2), and LDA VMP on 4
  ``"inferspark"`` shards; the paper's claim at 256 shards.
- **Kernel work**: the bounds ``PERF.md`` reports where shapes alone define
  them; a ``meta`` tensor outside a count raises at every kernel entry;
  peak bytes of a two-product function against a hand count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.compat import make_mesh
from repro.launch import hlo_cost
from repro.launch import roofline as rroof
from repro.launch import steps as rsteps
from repro.models import input_specs as r_input_specs
from repro_torch.configs import ARCHS, SHAPES, RunConfig, cell_enabled, get_arch
from repro_torch.core import models
from repro_torch.core.partition import ShardingPlan, make_distributed_step
from repro_torch.core.vmp import init_state
from repro_torch.data import SyntheticCorpus
from repro_torch.kernels import ops, work
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as RL
from repro_torch.launch import steps as S
from repro_torch.launch.dist import DryGroup, ShardGroup
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.step_cost import count
from repro_torch.launch.train import to_mesh
from repro_torch.models import input_specs, make_model
from repro_torch.models.parallel import ShardedParams
from repro_torch.models.transformer import _cycle_info, init_cache

META = "meta"
CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES
         if cell_enabled(ARCHS[a], s)[0]]


# ---------------------------------------------------------------------------
# (a) input_specs against the reference's
# ---------------------------------------------------------------------------

def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _port_cache_as_reference(cfg, cache):
    """The port's per-layer cache as the reference's ``{"scan", "tail"}``
    shapes and dtypes: K/V (B, KV, S, Dh) -> (B, S, KV, Dh), layer
    ``r * c + i`` at ``scan[i]``'s stacked entry ``r``."""
    def leaf(name, t):
        if isinstance(t, dict):
            return {n: leaf(n, u) for n, u in t.items()}
        shape = tuple(t.shape)
        if name in ("k", "v"):
            shape = (shape[0], shape[2], shape[1]) + shape[3:]
        return shape, _dtype_name(t.dtype)
    layers = [{n: leaf(n, t) for n, t in c.items()} for c in cache]
    c, repeats = _cycle_info(cfg)

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        (shape, dt) = trees[0]
        assert all(t == trees[0] for t in trees)
        return (len(trees),) + shape, dt
    scan = [stack([layers[r * c + i] for r in range(repeats)])
            for i in range(c)] if repeats else None
    return {"scan": scan, "tail": layers[repeats * c:]}


def _reference_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _reference_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_reference_tree(v) for v in tree]
    return tuple(tree.shape), str(jnp.dtype(tree.dtype))


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_match_the_reference(arch, shape):
    kind, seq, batch = SHAPES[shape]
    run = RunConfig(seq_len=seq, global_batch=batch)
    rrun = rconfigs.RunConfig(seq_len=seq, global_batch=batch)
    got = input_specs(get_arch(arch), shape, run)
    want = r_input_specs(rconfigs.get_arch(arch), shape, rrun)
    assert sorted(got) == sorted(want)
    if kind != "decode":
        assert {k: (tuple(v.shape), _dtype_name(v.dtype))
                for k, v in got["batch"].items()} == \
            _reference_tree(want["batch"])
        assert all(v.device.type == META for v in got["batch"].values())
        return
    assert got["tokens"].device.type == META
    assert (tuple(got["tokens"].shape), _dtype_name(got["tokens"].dtype)) \
        == _reference_tree(want["tokens"])
    assert (tuple(got["pos"].shape), _dtype_name(got["pos"].dtype)) == \
        _reference_tree(want["pos"])
    assert int(got["pos"]) == seq - 1
    port = _port_cache_as_reference(get_arch(arch), got["cache"])
    ref = _reference_tree(want["cache"])
    ref["scan"] = [dict(sorted(d.items())) for d in ref["scan"] or []] or None
    assert port == ref


# ---------------------------------------------------------------------------
# (b) roofline against the reference's, the constants swapped
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ({"flops": 3.2e15, "bytes accessed": 1.1e12}, {"total_bytes": 5e9}, 1,
     7.4e15, True),
    ({"flops": 1e12, "bytes accessed": 9e12}, {"total_bytes": 2e11}, 256,
     1e14, True),
    ({"flops": 8e16, "bytes accessed": 1e10}, {"total_bytes": 0}, 512, 0.0,
     False)])
def test_roofline_is_the_references_on_h100_constants(case, monkeypatch):
    cost, coll, n, mflops, per_device = case
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(rroof, name, getattr(RL, name))
    want = rroof.roofline(cost, coll, n, model_flops=mflops,
                          per_device_cost=per_device)
    got = RL.roofline(cost, coll, n, model_flops=mflops,
                      per_device_cost=per_device)
    assert got == want
    assert RL.train_model_flops(1_234_567, 8192) == \
        rroof.train_model_flops(1_234_567, 8192)
    assert RL.decode_model_flops(1_234_567, 64) == \
        rroof.decode_model_flops(1_234_567, 64)


def test_h100_constants_are_the_data_sheets():
    assert (RL.PEAK_FLOPS, RL.F32_FLOPS, RL.HBM_BW, RL.LINK_BW) == \
        (989e12, 67e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# (c) FLOPs against the reference's hlo_cost
# ---------------------------------------------------------------------------

SEQ, BATCH = 64, 4


def _meta_batch(cfg, b, s):
    return {"tokens": torch.empty((b, s), dtype=torch.int32, device=META),
            "labels": torch.empty((b, s), dtype=torch.int32, device=META)}


def _port_mesh_step(cfg, run, mesh, batch=None):
    """``(Costs, group)`` of one train step of ``cfg`` on ``mesh`` traced on
    meta tensors."""
    built = S.build_train_step(cfg, run, device=META, mesh=mesh)
    params = make_model(cfg)["init"](run, device=META)
    params, opt = to_mesh(built["layout"], params, None)
    batch = batch or _meta_batch(cfg, run.global_batch, run.seq_len)
    data = S.place_batch(batch, mesh, built["rules"], META)
    return count(built["fn"], params, opt, data, 0, group=mesh.group)


def test_products_outside_attention_match_hlo_cost(monkeypatch):
    """A reduced olmo-1b train step (2 layers, ``remat="none"``, f32) on a
    one-device mesh: the FLOPs of the products outside attention (the
    projections, the MLP, the logits, and their gradients) within 1% of the
    reference's ``hlo_cost`` count of its compiled step.

    Attention is counted differently by the two, so it is left out of the
    comparison.  The port counts the flash kernel's forward at the (query,
    key) pairs the causal mask keeps, 4 Dh operations a pair
    (``kernels.work.flash_attention``), and its backward at what the plain
    recompute runs, the dense S x S products (batched ``bmm``).  The
    reference compiles its dense path here (S <= 2 attn_chunk), whose
    batched dots span every (query, key) pair; at long sequences its
    chunked flash loop has a dynamic trip count that ``hlo_cost`` counts at
    a hint (``dryrun.py:113``: S / (2 attn_chunk)).  The products outside
    attention have no batch dimensions: ``mm`` and ``addmm`` in the port,
    dots without ``lhs_batch_dims`` in the HLO."""
    rcfg = rconfigs.get_arch("olmo-1b").reduced()
    rrun = rconfigs.RunConfig(seq_len=SEQ, global_batch=BATCH, remat="none",
                              dtype="float32")
    mesh = make_mesh((1, 1), ("data", "model"))
    built = rsteps.build_train_step(rcfg, rrun, mesh)
    pa, oa = built["abstract_state"]
    sds = jax.ShapeDtypeStruct
    batch = {"tokens": sds((BATCH, SEQ), jnp.int32),
             "labels": sds((BATCH, SEQ), jnp.int32)}
    hlo = rsteps.jit_train_step(built, mesh, batch).lower(
        pa, oa, batch, sds((), jnp.int32)).compile().as_text()
    dot = hlo_cost._dot_flops
    monkeypatch.setattr(hlo_cost, "_dot_flops", lambda op, c: 0.0 if
                        "lhs_batch_dims" in op.rest else dot(op, c))
    want = hlo_cost.analyze(hlo).flops
    assert want > 0

    cfg = get_arch("olmo-1b").reduced()
    run = RunConfig(seq_len=SEQ, global_batch=BATCH, remat="none",
                    dtype="float32", flash_kernel=True)
    costs = _port_mesh_step(cfg, run, Mesh((1, 1), ("data", "model")))
    got = sum(costs.flops_by_op.get(op, 0) for op in ("aten.mm",
                                                      "aten.addmm"))
    assert abs(got - want) <= 0.01 * want, (got, want)
    # the kernel's forward is counted too, one launch a layer
    assert costs.launches["flash_attention"] == {
        "count": cfg.n_layers, "routes": {"mma": cfg.n_layers}}


# ---------------------------------------------------------------------------
# (d) payload: the dry group against real CPU runs
# ---------------------------------------------------------------------------

def test_payload_of_a_dry_fsdp_step_is_the_real_runs():
    cfg = get_arch("olmo-1b").reduced()
    run = RunConfig(seq_len=16, global_batch=4, dtype="float32", fsdp=True,
                    flash_kernel=True)
    dry = Mesh((2, 2), ("data", "model"), DryGroup(4))
    _port_mesh_step(cfg, run, dry)

    real = Mesh((2, 2), ("data", "model"), ShardGroup(4))
    built = S.build_train_step(cfg, run, device="cpu", mesh=real)
    params = make_model(cfg)["init"](run, device="cpu")
    params, opt = to_mesh(built["layout"], params, None)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    built["fn"](params, opt, S.place_batch(batch, real, built["rules"],
                                           "cpu"), 0)
    assert dry.group.payload == real.group.payload
    assert dry.group.histogram == real.group.histogram
    assert dry.group.calls == real.group.calls
    # rank 0 of 4 processes: 2 (4 - 1) hops of each 8-byte-aligned piece
    assert dry.group.wire_bytes > 0 and real.group.wire_bytes == 0


def _serving_step(cfg, run, kind, mesh, device):
    """One prefill or decode step of ``cfg`` on ``mesh`` on ``device``:
    on ``meta`` counted (``step_cost.count``), else run.  The prompt is 4 x
    8 tokens with whisper's 12 frames or internvl2's patches; decode writes
    the last of 24 positions."""
    b, s, cache_len = 4, 8, 24
    built = (S.build_prefill_step if kind == "prefill" else
             S.build_decode_step)(cfg, run, device, mesh=mesh)
    server = built["server"]
    params = ShardedParams.from_module(
        server.layout, make_model(cfg)["init"](run, device=device))
    if kind == "prefill":
        n, key = (12, "frames") if cfg.family == "encdec" else \
            (cfg.n_patches, "patches")
        args = (params, {"tokens": torch.zeros((b, s), dtype=torch.int64,
                                               device=device),
                         key: torch.zeros((b, n, cfg.d_model),
                                          device=device)})
    else:
        cache = init_cache(cfg, run, b, cache_len, device=device)
        args = (params, server.place_cache(cache, cache_len),
                torch.zeros((b, 1), dtype=torch.int64, device=device),
                cache_len - 1)
    if device == META:
        return count(built["fn"], *args, group=mesh.group)
    return built["fn"](*args)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", ["whisper-large-v3", "internvl2-1b"])
def test_payload_of_a_dry_modality_serving_step_is_the_real_runs(name, kind):
    """Serving an encoder-decoder (its encoder, cross-attention and cross
    K/V) and a vision prefix on (2, 2): the dry group's payload by key,
    histogram and exchanges equal those of the same step run on the CPU."""
    cfg = get_arch(name).reduced()
    run = RunConfig(seq_len=8, global_batch=4, dtype="float32",
                    flash_kernel=True)
    dry = Mesh((2, 2), ("data", "model"), DryGroup(4))
    _serving_step(cfg, run, kind, dry, META)
    real = Mesh((2, 2), ("data", "model"), ShardGroup(4))
    _serving_step(cfg, run, kind, real, "cpu")
    assert dry.group.payload == real.group.payload
    assert dry.group.histogram == real.group.histogram
    assert dry.group.calls == real.group.calls
    if cfg.family == "encdec" and kind == "decode":
        assert real.group.payload["cross_attn_heads"] > 0


def _lda(n_docs=40, k=6, v=50):
    corpus = SyntheticCorpus(n_docs=n_docs, vocab=v, n_topics=k,
                             mean_len=30, seed=0).generate()
    m = models.make("lda", alpha=0.1, beta=0.05, K=k, V=v)
    m["x"].observe(corpus["tokens"], segment_ids=corpus["doc_ids"])
    return m.compile()


def test_payload_of_a_dry_vmp_step_is_the_real_runs():
    prog = _lda()
    step, state = dryrun.vmp_step(prog, 4)
    costs = count(step, state, group=step.plan.group)
    plan = ShardingPlan(4, "inferspark")
    real, s0 = make_distributed_step(prog, plan, device="cpu",
                                     state=init_state(prog, 0, "cpu"))
    real(s0)
    assert step.plan.group.payload == plan.group.payload
    phi = prog.dirichlets["phi"]
    assert plan.group.payload == {"elbo": 4 * 4, "phi": 4 * phi.g * phi.k * 4}
    assert costs.launches["zstats"]["count"] == 1
    assert costs.launches["dirichlet_expectation"]["count"] == 2


def test_a_dry_vmp_step_counts_the_dirichlet_terms_work():
    """A VMP step on meta counts one ELBO-term and one update launch per
    Dirichlet at the route its table takes (phi's Elog a transposed view),
    and the two kernels' counted work is ``kernels/work.py``'s."""
    from repro_torch.core import runtime
    prog = _lda(n_docs=40, k=6, v=5000)
    state = init_state(prog, 0, META)
    costs = count(runtime.make_step(prog, device=META), state)
    assert costs.launches["dirichlet_elbo_term"] == {
        "count": 2, "routes": {"rows": 1, "chunks": 1}}
    assert costs.launches["dirichlet_update"] == {"count": 2, "routes": {}}
    phi = state.posteriors["phi"]
    elog = torch.empty(phi.shape[::-1], device=META).T
    m = lambda *s: torch.empty(s, device=META)              # noqa: E731
    for call, want in [
            (lambda: ops.dirichlet_elbo_term(m(1, 5000), phi, elog),
             work.dirichlet_elbo_term(phi, elog)),
            (lambda: ops.dirichlet_update(m(1, 5000), phi),
             work.dirichlet_update(phi))]:
        one = count(call)
        assert (one.flops, one.traffic) == want
    assert work.dirichlet_elbo_term(phi, elog)[1] == 8 * 6 * 5000 + 4 * 5000 \
        + 4


# ---------------------------------------------------------------------------
# (e) the paper's claim at 256 shards
# ---------------------------------------------------------------------------

def test_the_papers_claim_at_256_shards():
    res = dryrun.run_vmp_cell(False, verbose=False)
    assert res["n_chips"] == 256 and res["mesh"] == "16x16"
    pay = res["payload_by_key"]
    assert pay["phi"] == 256 * res["topics"] * res["vocab"] * 4
    assert [k for k, v in pay.items() if v > dryrun.MB] == ["phi"]
    assert "theta" not in pay
    assert res["collectives"]["all-reduce"]["bytes"] == sum(pay.values())
    assert res["launches"]["zstats"]["routes"] == {"pieces": 1}


# ---------------------------------------------------------------------------
# (f) kernel work reproduces PERF.md's bounds; (g) meta outside a count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,want", [((64, 2048, 128), 0.0695),
                                        ((128, 2048, 128), 0.1390)])
def test_flash_work_gives_perf_md_bounds(shape, want):
    q = torch.empty(shape, dtype=torch.bfloat16, device=META)
    ops_, nbytes = work.flash_attention(q, q, q, True)
    ms, by = RL.bound(nbytes, ops_, RL.PEAK_FLOPS)
    assert (round(ms, 4), by) == (want, "operations")
    assert nbytes == 4 * shape[0] * shape[1] * shape[2] * 2


def test_elog_work_gives_perf_md_bound():
    phi = torch.empty((100, 102660), device=META)
    ms, by = RL.bound(*reversed(work.dirichlet_expectation(phi)))
    assert (round(ms, 4), by) == (0.0245, "bytes")


def _meta_calls():
    k, g, v, n = 4, 6, 10, 20
    rng = np.random.default_rng(1)
    rows = rng.integers(0, g, n).astype(np.int32)
    vals = rng.integers(0, v, n).astype(np.int32)
    zmap = np.sort(rng.integers(0, 5, n)).astype(np.int32)
    stand = np.broadcast_to(np.float32(0), (v, k)).T
    flat = ops.host_plan((g, k), rows, (ops.ZChild(elog=stand, values=vals),))
    seg = ops.host_plan((5, k), np.arange(5, dtype=np.int32), (
        ops.ZChild(elog=stand, values=vals, zmap=zmap),))
    m = lambda *s: torch.empty(s, device=META)              # noqa: E731
    mi = lambda a: torch.from_numpy(a).to(META)             # noqa: E731
    child = ops.ZChild(elog=m(k, v), values=mi(vals))
    zchild = ops.ZChild(elog=m(k, v), values=mi(vals), zmap=mi(zmap))
    return {
        "zstats": lambda: ops.zstats(m(g, k), mi(rows), (child,), plan=flat),
        "zmap_logits": lambda: ops.zmap_logits((zchild,), 5, k, plan=seg),
        "dirichlet_expectation": lambda: ops.dirichlet_expectation(m(g, k)),
        "dirichlet_elbo_term": lambda: ops.dirichlet_elbo_term(
            m(1, k), m(g, k), m(g, k)),
        "dirichlet_update": lambda: ops.dirichlet_update(m(1, k), m(g, k)),
        "zstep": lambda: ops.zstep(m(n, k)),
        "flash_attention": lambda: ops.flash_attention(m(2, 8, 16), m(2, 8, 16),
                                                       m(2, 8, 16)),
    }


@pytest.mark.parametrize("name", ["zstats", "zmap_logits",
                                  "dirichlet_expectation",
                                  "dirichlet_elbo_term", "dirichlet_update",
                                  "zstep", "flash_attention"])
def test_meta_outside_a_count_raises(name):
    call = _meta_calls()[name]
    with pytest.raises(ValueError, match="meta tensor runs no kernel"):
        call()
    costs = count(call)                  # inside a count: one launch
    assert costs.launches[name]["count"] == 1


# ---------------------------------------------------------------------------
# (h) peak bytes against a hand count
# ---------------------------------------------------------------------------

def test_peak_bytes_of_two_products_is_a_hand_count():
    m, k, n, p = 64, 128, 256, 32
    a, b, c = (torch.empty(s, device=META) for s in ((m, k), (k, n), (n, p)))

    def two(a, b, c):
        return (a @ b) @ c
    costs = count(two, a, b, c)
    f32 = 4
    inputs = (m * k + k * n + n * p) * f32
    # a @ b is live while the second product writes its output
    assert costs.peak_bytes == inputs + (m * n + m * p) * f32
    assert costs.flops == 2 * m * k * n + 2 * m * n * p
    assert costs.traffic == ((m * k + k * n + m * n)
                             + (m * n + n * p + m * p)) * f32
    assert tuple(costs.out.shape) == (m, p)


def test_histogram_of_a_dry_group():
    g = DryGroup(8)
    x = torch.empty((3, 4), device=META)
    got = g.gather({0: [x, x]}, ["a", "b"])
    g.sum({0: [x]}, ["a"])
    assert len(got) == 8 and all(t.shape == x.shape for row in got
                                 for t in row)
    assert g.histogram[("all-gather", "a", (3, 4))] == [1, 8 * 48]
    assert g.histogram[("all-reduce", "a", (3, 4))] == [1, 8 * 48]
    assert g.wire == {"a": 2 * 14 * 48, "b": 14 * 48}
