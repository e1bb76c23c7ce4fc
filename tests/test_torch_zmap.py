"""Segment latents (SLDA, naive Bayes) in the port, on the CPU: the plain
``zstats`` and ``zmap_logits``, the ``fused_zmap`` owner plan, and
``make_engine("vmp")``, held to the JAX reference on the same numpy inputs.

Tolerances, each with its reason:

- port against ``repro.kernels.ref`` and against the reference's Pallas
  kernel run in interpret mode: rtol = atol = 2e-4, lse rtol 2e-5 (the
  reference's own ``_assert_zstats_close``): f32 sums run in another order
  across frameworks, and the interpret kernel sums by one-hot matmuls;
- the plan emulation (numpy, float64) against the port's f32 plain version:
  rtol = atol = 1e-5, the f32 rounding of sums of a few hundred terms;
- ``zmap_logits`` against ``jax.ops.segment_sum``: rtol = atol = 1e-5, one
  f32 segment sum in either order;
- ``zmap_logits`` and ``zstats`` on long documents near a tie against the
  same sums in f64: half an f32 ulp for the logits (one rounding of an f64
  sum), the reference's zstats tolerance above for r and the stats;
- the engine against ``Model.infer`` in the same package: bitwise.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds them to
these plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import InferenceResult as JInferenceResult
from repro.kernels import fused_zmap as jfzm
from repro.kernels import ref as jref
from repro_torch.core import engine as tengine
from repro_torch.core import make_engine, models as tmodels
from repro_torch.core import vmp as tvmp
from repro_torch.kernels import fused_zmap as tfzm
from repro_torch.kernels import fused_zstats as tfz
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# (n tokens, k, gp, [(gf, kf, stride, base?, mask?, zmap?)...], zmask, nz):
# the reference's ZMAP_KERNEL_CASES (masked specialized, strided with base,
# zmap child beside a flat child), two zmap children, and four instances of
# about 500 tokens each (over tfz.PIECE = 256)
ZMAP_CASES = {
    "masked": (240, 3, 10, [(3, 15, 1, False, True, True)], True, 40),
    "strided": (200, 3, 9, [(30, 11, 3, True, True, True)], False, 35),
    "zmap+flat": (300, 3, 8, [(3, 12, 1, False, False, True),
                              (21, 9, 7, True, True, False)], True, 50),
    "two-zmap": (400, 4, 6, [(4, 20, 1, False, True, True),
                             (4, 9, 1, False, False, True)], False, 60),
    "long-instances": (2000, 5, 1, [(5, 300, 1, False, True, True)], False, 4),
}
# the reference's ALPHA_CASES "zmap": seed 24, concentration tables
ALPHA_ZMAP = (24, 240, 3, 10, [(3, 15, 1, False, True, True)], True, 40)


def _zcase(seed, n, k, gp, cfgs, zmask=False, nz=None, positive=False):
    """numpy ``(table_prior, prior_rows, [child dicts], zmask)``, drawn in
    the reference's ``_zcase`` order; ``positive`` redraws the tables as
    concentrations, as its ``_gamma_case`` does."""
    rng = np.random.default_rng(seed)
    nz = nz or n
    et = rng.normal(size=(gp, k)).astype(np.float32)
    rows = rng.integers(0, gp, nz).astype(np.int32)
    children = []
    for (gf, kf, stride, has_base, has_mask, has_zmap) in cfgs:
        nt = n if has_zmap else nz
        c = {"values": rng.integers(0, kf, nt).astype(np.int32),
             "stride": stride, "base": None, "mask": None, "zmap": None}
        if has_base:
            c["base"] = rng.integers(0, max(gf - stride * (k - 1), 1),
                                     nt).astype(np.int32)
        if has_mask:
            c["mask"] = (rng.random(nt) > 0.25).astype(np.float32)
        if has_zmap:
            c["zmap"] = np.sort(rng.integers(0, nz, nt)).astype(np.int32)
        c["table"] = rng.normal(size=(gf, kf)).astype(np.float32)
        children.append(c)
    zm = (rng.random(nz) > 0.15).astype(np.float32) if zmask else None
    if positive:
        prng = np.random.default_rng(101)

        def pos(t):
            return (prng.gamma(1.0, 1.0, t.shape) + 1e-2).astype(np.float32)
        et = pos(et)
        for c in children:
            c["table"] = pos(c["table"])
    return et, rows, children, zm


def _unsorted(seed):
    """The zmap+flat case with the zmap child's tokens in a random order."""
    et, rows, children, zm = _zcase(seed, *ZMAP_CASES["zmap+flat"])
    perm = np.random.default_rng(seed + 1).permutation(len(children[0]["values"]))
    for key in ("values", "zmap"):
        children[0][key] = children[0][key][perm]
    return et, rows, children, zm


def _empty_and_masked(seed):
    """The masked case with instance 0 holding no token and every token of
    instance 2 masked out."""
    et, rows, children, zm = _zcase(seed, *ZMAP_CASES["masked"])
    c = children[0]
    c["zmap"] = np.where(c["zmap"] == 0, 1, c["zmap"]).astype(np.int32)
    c["mask"] = np.where(c["zmap"] == 2, 0.0, c["mask"]).astype(np.float32)
    return et, rows, children, zm


VARIANTS = {"unsorted": _unsorted, "empty-and-masked": _empty_and_masked}


def _opt(conv, a):
    return None if a is None else conv(a)


def _run_jax(case, tables="elog", bf16=False):
    et, rows, children, zm = case
    tab = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if bf16 else jnp.asarray
    kids = tuple(jref.ZChild(tab(c["table"]), jnp.asarray(c["values"]),
                             c["stride"], _opt(jnp.asarray, c["zmap"]),
                             _opt(jnp.asarray, c["base"]),
                             _opt(jnp.asarray, c["mask"])) for c in children)
    return jref.zstats(tab(et), jnp.asarray(rows), kids,
                       _opt(jnp.asarray, zm), tables=tables)


def _torch_children(children, bf16=False):
    tab = (lambda a: torch.from_numpy(a).to(torch.bfloat16)) if bf16 \
        else torch.from_numpy
    return tuple(tref.ZChild(tab(c["table"]), torch.from_numpy(c["values"]),
                             c["stride"], _opt(torch.from_numpy, c["zmap"]),
                             _opt(torch.from_numpy, c["base"]),
                             _opt(torch.from_numpy, c["mask"]))
                 for c in children)


def _run_torch(case, tables="elog", bf16=False):
    et, rows, children, zm = case
    prior = torch.from_numpy(et)
    if bf16:
        prior = prior.to(torch.bfloat16)
    return tops.zstats(prior, torch.from_numpy(rows),
                       _torch_children(children, bf16),
                       _opt(torch.from_numpy, zm), tables=tables)


def _assert_zstats_close(got, want, rtol=2e-4, atol=2e-4):
    np.testing.assert_allclose(float(got[0]), float(want[0]),
                               rtol=2e-5 if rtol > 1e-5 else rtol, atol=atol)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=rtol, atol=atol)
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# the plain version against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tables", ["elog", "alpha"])
@pytest.mark.parametrize("name", list(ZMAP_CASES))
def test_zstats_zmap_matches_jax_ref(name, tables):
    data = _zcase(50, *ZMAP_CASES[name], positive=tables == "alpha")
    _assert_zstats_close(_run_torch(data, tables), _run_jax(data, tables))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_zstats_zmap_variants_match_jax_ref(variant):
    data = VARIANTS[variant](60)
    _assert_zstats_close(_run_torch(data), _run_jax(data))


def test_zstats_zmap_alpha_case_matches_jax_ref():
    data = _zcase(*ALPHA_ZMAP, positive=True)
    _assert_zstats_close(_run_torch(data, "alpha"), _run_jax(data, "alpha"))


@pytest.mark.parametrize("tables", ["elog", "alpha"])
def test_zstats_zmap_bf16_tables_match_jax_ref(tables):
    """bf16 tables round the same way in both frameworks and are upcast
    before any arithmetic, so the f32 tolerance holds."""
    data = _zcase(70, *ZMAP_CASES["zmap+flat"], positive=tables == "alpha")
    got = _run_torch(data, tables, bf16=True)
    assert got[1].dtype == torch.float32
    _assert_zstats_close(got, _run_jax(data, tables, bf16=True))


@pytest.mark.parametrize("case", range(3))
def test_pallas_interpret_kernel_matches_port(case):
    """The reference's two-phase Pallas kernel, run in interpret mode on the
    same inputs (its ZMAP_KERNEL_CASES), agrees with the port's plain
    version at f32 tolerance (not bitwise: the kernel sums by one-hot
    matmuls, in another order)."""
    data = _zcase(1000 + case, *list(ZMAP_CASES.values())[case])
    et, rows, children, zm = data
    kids = tuple(jref.ZChild(jnp.asarray(c["table"]), jnp.asarray(c["values"]),
                             c["stride"], _opt(jnp.asarray, c["zmap"]),
                             _opt(jnp.asarray, c["base"]),
                             _opt(jnp.asarray, c["mask"])) for c in children)
    want = jfzm.zstats_zmap(jnp.asarray(et), jnp.asarray(rows), kids,
                            _opt(jnp.asarray, zm), interpret=True)
    _assert_zstats_close(_run_torch(data), want)


@pytest.mark.parametrize("name", list(ZMAP_CASES))
def test_zmap_logits_matches_jax_segment_sum(name):
    """Phase 1 alone: each zmap child's masked messages summed per instance
    with ``jax.ops.segment_sum``, children in order."""
    et, rows, children, _ = _zcase(80, *ZMAP_CASES[name])
    k, nz = et.shape[1], len(rows)
    zkids = [c for c in children if c["zmap"] is not None]
    want = 0.0
    for c in zkids:
        jc = jref.ZChild(jnp.asarray(c["table"]), jnp.asarray(c["values"]),
                         c["stride"], jnp.asarray(c["zmap"]),
                         _opt(jnp.asarray, c["base"]),
                         _opt(jnp.asarray, c["mask"]))
        e = jref._child_messages(jc, jc.values, jc.base, jc.mask, k)
        want = want + jax.ops.segment_sum(e, jc.zmap, num_segments=nz)
    got = tops.zmap_logits(_torch_children(zkids), nz, k)
    assert got.shape == (nz, k) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _long_documents(seed):
    """Two naive-Bayes-like documents of 300 and 400 tokens over K = 2
    classes whose messages are about -15 nats each: logits of thousands of
    nats, the classes 0.5 nats apart in the first document."""
    rng = np.random.default_rng(seed)
    tab = (-15.0 + rng.normal(size=(2, 50))).astype(np.float32)
    vals = rng.integers(0, 50, 700).astype(np.int32)
    zmap = np.repeat(np.arange(2, dtype=np.int32), [300, 400])
    exact = np.zeros((2, 2))
    np.add.at(exact, zmap, tab[:, vals].T.astype(np.float64))
    prior = np.zeros((1, 2), np.float32)
    prior[0, 0] = np.float32(exact[0, 1] - exact[0, 0] + 0.5)
    return tab, vals, zmap, exact, prior


def test_zmap_logits_round_an_f64_sum_once():
    """Phase 1 sums each instance's messages in f64 and rounds once (as the
    kernel does): within half an f32 ulp of the exact sum, where a running
    f32 sum of the same messages is off by more than a whole ulp.  The
    exact sum is numpy's, in f64."""
    tab, vals, zmap, exact, _ = _long_documents(7)
    child = tref.ZChild(elog=torch.from_numpy(tab), values=torch.from_numpy(vals),
                        zmap=torch.from_numpy(zmap))
    got = tref.zmap_logits((child,), 2, 2).numpy().astype(np.float64)
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got - exact) <= 0.5 * ulp + 1e-9)
    running = np.zeros((2, 2), np.float32)
    for t in range(len(vals)):
        running[zmap[t]] += tab[:, vals[t]]
    assert np.abs(running - exact).max() > ulp.max()


def test_zstats_near_a_tie_matches_f64():
    """A document 0.5 nats from a tie between its two classes, with logits
    of thousands of nats: the plain ``zstats`` (f64 phase 1, f32 softmax
    and stats) against the same sums in f64, at the reference's zstats
    tolerance (rtol = atol = 2e-4, lse rtol 2e-5)."""
    tab, vals, zmap, exact, prior = _long_documents(7)
    child = tref.ZChild(elog=torch.from_numpy(tab), values=torch.from_numpy(vals),
                        zmap=torch.from_numpy(zmap))
    rows = torch.zeros(2, dtype=torch.int32)
    lse, pstats, (cstats,) = tref.zstats(torch.from_numpy(prior), rows, (child,))
    logits = exact + prior.astype(np.float64)
    r = np.exp(logits - logits.max(1, keepdims=True))
    r /= r.sum(1, keepdims=True)
    assert 0.3 < r[0].min()                 # the first document is near a tie
    want_c = np.zeros((2, 50))
    np.add.at(want_c.T, vals, r[zmap])
    want_lse = (logits.max(1) + np.log(np.exp(
        logits - logits.max(1, keepdims=True)).sum(1))).sum()
    np.testing.assert_allclose(float(lse), want_lse, rtol=2e-5)
    np.testing.assert_allclose(pstats.numpy(), r.sum(0, keepdims=True),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(cstats.numpy(), want_c, rtol=2e-4, atol=2e-4)


def test_zmap_logits_alpha_tables_and_rejects_flat_children():
    et, rows, children, _ = _zcase(81, *ZMAP_CASES["masked"], positive=True)
    kids = _torch_children(children)
    elog = tuple(c._replace(elog=tref.dirichlet_expectation(c.elog))
                 for c in kids)
    np.testing.assert_array_equal(
        tref.zmap_logits(kids, len(rows), 3, tables="alpha").numpy(),
        tref.zmap_logits(elog, len(rows), 3).numpy())
    with pytest.raises(ValueError, match="zmap"):
        tref.zmap_logits((kids[0]._replace(zmap=None),), len(rows), 3)


# ---------------------------------------------------------------------------
# the owner plan
# ---------------------------------------------------------------------------

def _owner(g, w):
    """Each key's pieces summed in plan order: (n_keys, k)."""
    k = w.shape[1]
    part = np.stack([w[g.perm[g.piece_start[p]:g.piece_start[p + 1]]].sum(0)
                     for p in range(g.n_pieces)]) if g.n_pieces \
        else np.zeros((0, k))
    return np.stack([part[g.key_pieces[s]:g.key_pieces[s + 1]].sum(0)
                     for s in range(g.n_keys)]).reshape(g.n_keys, k)


def _messages(c, k):
    """(n, k) float64 masked messages of one child."""
    if c["base"] is None and c["stride"] == 1:
        e = c["table"][:, c["values"]].T
    else:
        rws = c["base"][:, None] if c["base"] is not None else 0
        e = c["table"][rws + c["stride"] * np.arange(k)[None, :],
                       c["values"][:, None]]
    mask = c["mask"][:, None] if c["mask"] is not None else 1.0
    return e.astype(np.float64) * mask


def _column_walk(c, g, w, k):
    """A strided child's stats: each value column's tokens in plan order."""
    out = np.zeros(c["table"].shape)
    base = c["base"] if c["base"] is not None else np.zeros(len(w), np.int64)
    for v in range(g.n_keys):
        for i in g.perm[g.key_start[v]:g.key_start[v + 1]]:
            out[base[i] + c["stride"] * np.arange(k), v] += w[i]
    return out


def _stream(plan, name, g, c, field):
    """Pass ``name``'s stream of ``field`` in its piece order: the plan's
    gathered array, or the call's own where the grouping keeps its order."""
    if (name, field) in plan.streams:
        return plan.streams[name, field]
    assert g.identity
    return c[field]


def _phase1_emulation(plan, zkids, n_latent, k):
    """Phase 1 as the kernel runs it, driven by the plan alone: each piece
    sums its tokens' f64 masked messages in stream order (from a zero, one
    token at a time); a one-piece instance writes its f32 row (a later
    child adds to it), the others go through f64 partials that the finish
    adds in order."""
    logits = np.zeros((n_latent, k), np.float32)
    for j, (c, g) in enumerate(zip(zkids, plan.by_latent)):
        name = f"latent{j}"
        route = {f: plan.streams[name, f] for f in ("slot", "fkeys", "fstart")}
        vals = _stream(plan, name, g, c, "values")
        mask = _stream(plan, name, g, c, "mask") if c["mask"] is not None \
            else np.ones(len(vals), np.float32)
        base = _stream(plan, name, g, c, "base") if c["base"] is not None \
            else np.zeros(len(vals), np.int32)
        if c["base"] is None and c["stride"] == 1:
            msg = c["table"][:, vals].T
        else:
            msg = c["table"][base[:, None] + c["stride"] * np.arange(k)[None, :],
                             vals[:, None]]
        terms = msg.astype(np.float64) * mask.astype(np.float64)[:, None]
        partial = np.zeros((int(route["fstart"][-1]), k))
        for p in range(g.n_pieces):
            ts = slice(g.piece_start[p], g.piece_start[p + 1])
            acc = np.cumsum(np.concatenate([np.zeros((1, k)), terms[ts]]),
                            axis=0)[-1]
            key, s = g.piece_key[p], route["slot"][p]
            if s >= 0:
                partial[s] = acc
            else:
                logits[key] = (logits[key] + acc if j else acc).astype(np.float32)
        for m, key in enumerate(route["fkeys"]):
            acc = np.cumsum(np.concatenate(
                [np.zeros((1, k)),
                 partial[route["fstart"][m]:route["fstart"][m + 1]]]),
                axis=0)[-1]
            logits[key] = (logits[key] + acc if j else acc).astype(np.float32)
    return logits


def _zmap_owner_emulation(case, piece):
    """The kernel's three phases in numpy, driven only by the plan: phase 1
    as :func:`_phase1_emulation`, phase 2a the prior pass over the
    instances, phase 2b each value's pieces of mask * r[zmap] over the
    pass's own streams.  Returns the outputs and phase 1's f32 logits."""
    et, rows, children, zm = case
    plan = tfzm.build_zmap_plan(rows, _torch_children(children), et.shape,
                                piece)
    k = et.shape[1]
    zkids = [c for c in children if c["zmap"] is not None]
    flat = [c for c in children if c["zmap"] is None]
    zlogits = _phase1_emulation(plan, zkids, len(rows), k)
    logits = et[rows].astype(np.float64) + zlogits
    for c in flat:
        logits = logits + _messages(c, k)
    m = logits.max(1, keepdims=True)
    ex = np.exp(logits - m)
    zmv = zm if zm is not None else np.ones(len(rows))
    r = ex / ex.sum(1, keepdims=True) * zmv[:, None]
    lse = (m[:, 0] + np.log(ex.sum(1))) * zmv
    pstats = _owner(plan.flat.prior, r)

    def stats(c, g, w):
        if c["base"] is None and c["stride"] == 1:
            return _owner(g, w).T.copy()
        return _column_walk(c, g, w, k)

    def zstats(j, c, g):
        """Phase 2b: each piece's tokens in the pass's stream order."""
        name = f"value{j}"
        zs = _stream(plan, name, g, c, "zmap")
        w = r[zs] * (_stream(plan, name, g, c, "mask")[:, None]
                     if c["mask"] is not None else 1.0)
        ident = dataclasses.replace(g, perm=np.arange(len(zs), dtype=np.int32))
        if c["base"] is None and c["stride"] == 1:
            return _owner(ident, w).T.copy()
        walk = dict(c, base=_stream(plan, name, g, c, "base")
                    if c["base"] is not None else None)
        return _column_walk(walk, ident, w, k)

    out, zi, fi = [], iter(range(len(zkids))), iter(range(len(flat)))
    for c in children:
        if c["zmap"] is not None:
            j = next(zi)
            out.append(zstats(j, c, plan.by_value[j]))
        else:
            j = next(fi)
            mask = c["mask"][:, None] if c["mask"] is not None else 1.0
            out.append(stats(c, plan.flat.children[j], r * mask))
    return (torch.tensor(lse.sum()), torch.from_numpy(pstats),
            tuple(torch.from_numpy(s) for s in out)), zlogits


CASES_AND_VARIANTS = [(n, lambda s, n=n: _zcase(s, *ZMAP_CASES[n]))
                      for n in ZMAP_CASES] + list(VARIANTS.items())


@pytest.mark.parametrize("name,make", CASES_AND_VARIANTS,
                         ids=[n for n, _ in CASES_AND_VARIANTS])
def test_zmap_plan_reproduces_zstats(name, make):
    """Summing by the plan's owners gives the plain version: every token
    reaches one piece of its instance (phase 1) and of its value (phase
    2b), every instance one piece of its prior row (phase 2a).  Phase 1,
    routed as the kernel routes it (one-piece instances written directly,
    the others through f64 partials), is bitwise the plain ``zmap_logits``:
    both add f64 terms in token order and round once."""
    data = make(90)
    got, zlogits = _zmap_owner_emulation(data, piece=7)
    _assert_zstats_close(got, _run_torch(data), rtol=1e-5, atol=1e-5)
    et, rows, children, _ = data
    zkids = [c for c in children if c["zmap"] is not None]
    want = tops.zmap_logits(_torch_children(zkids), len(rows), et.shape[1])
    np.testing.assert_array_equal(zlogits, want.numpy())


@pytest.mark.parametrize("name,make", CASES_AND_VARIANTS,
                         ids=[n for n, _ in CASES_AND_VARIANTS])
def test_zmap_streams_are_the_originals_through_perm(name, make):
    """Phase 1's streams (values, base, mask of each zmap child) and phase
    2b's (zmap, base, mask) are the call's arrays gathered through the
    pass's grouping; a grouping that keeps the call's order has none; the
    plan holds no other stream, and its device copy holds them all."""
    et, rows, children, _ = make(95)
    plan = tfzm.build_zmap_plan(rows, _torch_children(children), et.shape, 7)
    zkids = [c for c in children if c["zmap"] is not None]
    seen = set()
    for kind, groups, fields in (("latent", plan.by_latent,
                                  ("values", "base", "mask")),
                                 ("value", plan.by_value,
                                  ("zmap", "base", "mask"))):
        for j, (c, g) in enumerate(zip(zkids, groups)):
            for f in fields:
                key = (f"{kind}{j}", f)
                if g.identity or c[f] is None:
                    assert key not in plan.streams
                    continue
                np.testing.assert_array_equal(plan.streams[key], c[f][g.perm])
                assert plan.streams[key].dtype == c[f].dtype
                seen.add(key)
    routes = {k for k in plan.streams if k[1] in ("slot", "fkeys", "fstart")}
    assert routes == {(f"latent{j}", f) for j in range(len(zkids))
                      for f in ("slot", "fkeys", "fstart")}
    assert set(plan.streams) == seen | routes
    on_dev = plan.to("cpu")
    for key, a in plan.streams.items():
        np.testing.assert_array_equal(on_dev.tensors[key].numpy(), a)


@pytest.mark.parametrize("name,piece", [("masked", 7), ("long-instances", 256),
                                        ("long-instances", 7),
                                        ("empty-and-masked", 3)])
def test_latent_route_sends_one_piece_instances_straight(name, piece):
    """Phase 1's route: a piece that is its instance's only one has slot -1
    (it writes the row); the pieces of an instance of several take
    consecutive partial rows in piece order, and the finish lists exactly
    the instances of several pieces or of none, with their row ranges."""
    make = dict(CASES_AND_VARIANTS)[name]
    et, rows, children, _ = make(96)
    plan = tfzm.build_zmap_plan(rows, _torch_children(children), et.shape,
                                piece)
    g = plan.by_latent[0]
    route = tfzm.latent_route(g)
    n_per = np.diff(g.key_pieces)
    np.testing.assert_array_equal(route["fkeys"], np.flatnonzero(n_per != 1))
    np.testing.assert_array_equal(np.diff(route["fstart"]),
                                  n_per[route["fkeys"]])
    single = n_per[g.piece_key] == 1
    assert (route["slot"][single] == -1).all()
    for m, key in enumerate(route["fkeys"]):
        pieces = np.arange(g.key_pieces[key], g.key_pieces[key + 1])
        np.testing.assert_array_equal(
            route["slot"][pieces],
            np.arange(route["fstart"][m], route["fstart"][m + 1]))
    for f in ("slot", "fkeys", "fstart"):
        assert route[f].dtype == np.int32
        np.testing.assert_array_equal(plan.streams["latent0", f], route[f])
    if name == "empty-and-masked":
        assert 0 in route["fkeys"]            # instance 0 has no token
    if name == "long-instances" and piece == 256:
        assert len(route["fkeys"]) == 4 and not single.any()
    if name == "masked" and piece == 7:
        assert single.any()


@pytest.mark.parametrize("name,want", [("masked", "group"),
                                       ("long-instances", "warp")])
def test_logits_route_gives_long_instances_a_warp(name, want):
    """Phase 1 takes its lane-group kernel where every instance is one piece
    (SLDA's sentences) and a warp a piece where instances take several
    (naive Bayes' documents)."""
    et, rows, children, _ = _zcase(97, *ZMAP_CASES[name])
    plan = tfzm.build_zmap_plan(rows, _torch_children(children), et.shape)
    assert tfzm.logits_route(plan.by_latent[0]) == want


def test_zmap_plan_cuts_long_instances_into_pieces():
    """Naive Bayes' regime: instances of about 500 tokens take several
    pieces of at most PIECE tokens each."""
    et, rows, children, _ = _zcase(91, *ZMAP_CASES["long-instances"])
    plan = tfzm.build_zmap_plan(rows, _torch_children(children), et.shape)
    g = plan.by_latent[0]
    assert g.n_keys == 4 and g.n_pieces > 4
    assert np.diff(g.piece_start).max() <= tfz.PIECE
    assert (np.diff(g.key_pieces) >= 2).all()


def test_zmap_plan_of_sorted_zmap_is_identity():
    et, rows, children, _ = _zcase(92, *ZMAP_CASES["masked"])
    plan = tfzm.build_zmap_plan(rows, _torch_children(children), et.shape)
    np.testing.assert_array_equal(plan.by_latent[0].perm,
                                  np.arange(len(children[0]["values"])))


@pytest.mark.parametrize("bad", ["zmap", "value", "strided-row", "prior-row",
                                 "no-zmap"])
def test_build_zmap_plan_rejects_out_of_range(bad):
    name = "strided" if bad == "strided-row" else "zmap+flat"
    et, rows, children, _ = _zcase(93, *ZMAP_CASES[name])
    c = children[0]
    if bad == "zmap":
        c["zmap"] = c["zmap"].copy()
        c["zmap"][-1] = len(rows)
    elif bad == "value":
        c["values"] = c["values"].copy()
        c["values"][0] = c["table"].shape[1]
    elif bad == "strided-row":
        c["base"] = c["base"] + 100
    elif bad == "prior-row":
        rows = rows.copy()
        rows[0] = et.shape[0]
    else:
        c["zmap"] = None
        c["values"] = c["values"][:len(rows)]
    with pytest.raises(ValueError):
        tfzm.build_zmap_plan(rows, _torch_children(children), et.shape)


def test_zmap_plan_device_copy_holds_every_array():
    et, rows, children, _ = _zcase(94, *ZMAP_CASES["zmap+flat"])
    plan = tfzm.build_zmap_plan(rows, _torch_children(children),
                                et.shape).to("cpu")
    assert plan.device == torch.device("cpu")
    assert plan.flat.device == torch.device("cpu")
    for name, g in [("latent0", plan.by_latent[0]),
                    ("value0", plan.by_value[0])]:
        for field in ("perm", "key_start", "piece_start", "key_pieces"):
            np.testing.assert_array_equal(plan.tensors[name, field].numpy(),
                                          getattr(g, field))
    assert len(plan.flat.children) == 1


# ---------------------------------------------------------------------------
# make_engine("vmp")
# ---------------------------------------------------------------------------

def _observe(name, m, seed=0):
    rng = np.random.default_rng(seed)
    if name == "slda":
        S = 40
        sent_doc = np.sort(rng.integers(0, 9, size=S)).astype(np.int32)
        tok_sent = np.repeat(np.arange(S, dtype=np.int32),
                             rng.integers(3, 9, size=S))
        m["x"].observe(rng.integers(0, 20, size=len(tok_sent)).astype(np.int32),
                       segment_ids=tok_sent)
        m.bind("sents", sent_doc)
    else:
        docs = np.repeat(np.arange(14, dtype=np.int32),
                         rng.integers(8, 30, size=14))
        m["x"].observe(rng.integers(0, 25, size=len(docs)).astype(np.int32),
                       segment_ids=docs)
    return m


MODELS = {"slda": dict(alpha=0.2, beta=0.2, K=3, V=20),
          "naive_bayes": dict(alpha=1.0, beta=0.3, C=3, V=25)}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_engine_fit_equals_model_infer(name):
    m = _observe(name, tmodels.make(name, **MODELS[name]))
    m.infer(steps=4, seed=0, device="cpu")          # fit must start fresh
    res = make_engine("vmp", steps=5, seed=3, device="cpu").fit(m)
    ref_m = _observe(name, tmodels.make(name, **MODELS[name]))
    ref_m.infer(steps=5, seed=3, device="cpu")
    assert res.backend == "vmp" and res.heldout_trace == []
    assert res.elbo_trace == ref_m.elbo_trace and len(res.elbo_trace) == 5
    assert set(res.posteriors) == set(ref_m.compile().dirichlets)
    for n, p in res.posteriors.items():
        assert isinstance(p, np.ndarray)
        np.testing.assert_array_equal(p, ref_m[n].get_result())
    assert np.isnan(res.heldout_elbo)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_engine_bf16_tables_close_to_f32(name):
    """``elog_dtype="bfloat16"`` narrows the concentration tables the
    segment latent reads (``tables="alpha"``); rtol 2e-2 is their bf16
    rounding."""
    m = _observe(name, tmodels.make(name, **MODELS[name]))
    t32 = make_engine("vmp", steps=4, device="cpu").fit(m).elbo_trace
    t16 = make_engine("vmp", steps=4, device="cpu",
                      elog_dtype="bfloat16").fit(m).elbo_trace
    np.testing.assert_allclose(t16, t32, rtol=2e-2)
    assert t16 != t32


def test_engine_takes_config_objects_and_dicts():
    m = _observe("slda", tmodels.make("slda", **MODELS["slda"]))
    a = make_engine(tengine.EngineConfig(steps=3, device="cpu")).fit(m)
    b = make_engine({"backend": "vmp", "steps": 2, "device": "cpu"},
                    steps=3).fit(m)
    assert a.elbo_trace == b.elbo_trace and len(a.elbo_trace) == 3


def test_topics_equal_jax_result_topics():
    rng = np.random.default_rng(5)
    posts = {"theta": (rng.gamma(1.0, 1.0, (6, 4)) + 0.1).astype(np.float32),
             "phi": (rng.gamma(1.0, 1.0, (4, 30)) + 0.1).astype(np.float32)}
    got = tengine.InferenceResult("vmp", posts, [], [], {})
    want = JInferenceResult("vmp", posts, [], [], {})
    for n in posts:
        np.testing.assert_array_equal(got.topics(n), want.topics(n))
    with pytest.raises(KeyError, match="available"):
        got.topics("pi")


@pytest.mark.parametrize("knob", [
    dict(backend="gibbs"), dict(hosts=object()), dict(validate=True),
    dict(burnin=3), dict(thin=2)])
def test_later_slice_knobs_raise(knob):
    m = _observe("slda", tmodels.make("slda", **MODELS["slda"]))
    with pytest.raises(NotImplementedError, match="slice of the port"):
        make_engine(tengine.EngineConfig(device="cpu", **knob)).fit(m)


@pytest.mark.parametrize("knob", [
    dict(checkpoint_dir="ckpt"), dict(prefetch=False), dict(growing=True),
    dict(capacity_docs=10), dict(population_size=10),
    dict(checkpoint_every=5), dict(resume=True)])
def test_ported_knobs_leave_a_full_batch_fit_alone(knob, tmp_path):
    """The out-of-core and session knobs belong to SVI: as in the
    reference, a full-batch VMP fit ignores them, bit for bit, and writes
    no checkpoint."""
    if "checkpoint_dir" in knob:
        knob = dict(checkpoint_dir=str(tmp_path / "ck"))
    m = _observe("slda", tmodels.make("slda", **MODELS["slda"]))
    want = make_engine(tengine.EngineConfig(device="cpu", steps=2)).fit(m)
    got = make_engine(tengine.EngineConfig(device="cpu", steps=2,
                                           **knob)).fit(m)
    assert got.elbo_trace == want.elbo_trace
    for n in want.posteriors:
        np.testing.assert_array_equal(got.posteriors[n], want.posteriors[n])
    assert not (tmp_path / "ck").exists()


def test_freeze_and_unknown_backend_raise():
    res = tengine.InferenceResult("vmp", {}, [], [], {})
    with pytest.raises(NotImplementedError, match="query slice"):
        res.freeze(None)
    with pytest.raises(ValueError, match="unknown backend"):
        make_engine("mcmc")


def test_default_device_without_a_card_raises():
    """``device=None`` means the card: without one, fit raises before it
    touches the model."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    m = _observe("slda", tmodels.make("slda", **MODELS["slda"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine("vmp", steps=2).fit(m)


def test_segment_responsibilities_go_through_zmap_logits(monkeypatch):
    """``get_result`` of a segment latent sums its children's messages per
    instance with ``ops.zmap_logits`` (a fixed order on every device), and
    still matches the step's own softmax."""
    calls = []
    orig = tops.zmap_logits
    monkeypatch.setattr(tops, "zmap_logits",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    m = _observe("slda", tmodels.make("slda", **MODELS["slda"]))
    m.infer(steps=2, device="cpu")
    r = m["z"].get_result()
    assert calls == [1]
    prog = m.compile()
    spec = prog.latents[0]
    arrays = tvmp._program_arrays(prog, torch.device("cpu"))
    elog = {n: tref.dirichlet_expectation(p)
            for n, p in m._state.posteriors.items()}
    c = spec.children[0]
    e = elog[c.dir_name][:, arrays[c.x_name]["values"].long()].T
    logits = elog[spec.prior_dir][arrays[spec.name]["prior_rows"].long()] + \
        torch.zeros((spec.n, spec.k)).index_add_(
            0, arrays[c.x_name]["zmap"].long(), e)
    np.testing.assert_allclose(r, torch.softmax(logits, -1).numpy(),
                               rtol=1e-5, atol=1e-6)
