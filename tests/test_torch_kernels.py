"""The port's kernel modules on the CPU: plain versions held to the JAX
reference's ``ref`` oracles, the ``zstats`` owner plan, and the wrappers'
device rules.

The same numpy-seeded inputs go through ``repro.kernels.ref`` (the JAX
package's CPU backend; its Pallas interpret paths drift by an ulp on this
toolchain) and through the port.  Tolerances are the reference's own
``_assert_zstats_close`` (rtol = atol = 2e-4, lse rtol 2e-5): f32 sums run in
another order across frameworks.  The CUDA and Triton kernels themselves
run only on the card, where ``chip_smoke.py`` holds them to these plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import dirichlet_expectation as tde
from repro_torch.kernels import fused_zstats as tfz
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import vmp_zstep as tzs

SHAPES = [(1, 2), (3, 5), (7, 128), (33, 96), (128, 130), (257, 4),
          (64, 300), (1000, 3)]

# (n, k, gp, [(gf, kf, stride, base?, mask?, zmap?)...], zmask, nz) — the
# shapes of the reference's tests/test_kernels.py ZSTATS_CASES
ZSTATS_CASES = [
    (64, 3, 5, [(3, 17, 1, False, False, False)], False, None),
    (300, 4, 20, [(4, 33, 1, False, False, False)], False, None),
    (129, 130, 7, [(130, 5, 1, False, False, False)], False, None),
    (200, 4, 12, [(4, 21, 1, False, True, False)], True, None),
    (150, 3, 9, [(30, 11, 3, True, False, False)], False, None),
    (150, 3, 9, [(30, 11, 3, True, True, False)], True, None),
    (100, 5, 8, [(5, 12, 1, True, False, False)], False, None),
    (120, 3, 6, [(3, 19, 1, False, False, False),
                 (21, 9, 7, True, True, False)], True, None),
    (240, 3, 10, [(3, 15, 1, False, False, True)], False, 40),
    (240, 3, 10, [(3, 15, 1, False, True, True)], True, 40),
]

# ... and its ALPHA_CASES (concentration tables): resident, strided+masked,
# the V = 33,000 child, the G = 70,000 prior, and a zmap latent
ALPHA_CASES = [
    ("resident", (20, 300, 4, 20, [(4, 33, 1, False, False, False)], False,
                  None)),
    ("strided-masked", (21, 150, 3, 9, [(30, 11, 3, True, True, False)],
                        True, None)),
    ("streamed-child", (22, 4000, 4, 11,
                        [(4, 33000, 1, False, False, False)], False, None)),
    ("streamed-prior", (23, 4000, 16, 70000,
                        [(16, 33, 1, False, False, False)], True, None)),
    ("zmap", (24, 240, 3, 10, [(3, 15, 1, False, True, True)], True, 40)),
]


def _zcase(seed, n, k, gp, cfgs, zmask=False, nz=None, positive=False):
    """numpy (table_prior, prior_rows, [child dicts], zmask), drawn in the
    reference's ``_zcase`` order; ``positive`` redraws the tables as
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
            hi = max(gf - stride * (k - 1), 1)
            c["base"] = rng.integers(0, hi, nt).astype(np.int32)
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


def _opt(conv, a):
    return None if a is None else conv(a)


def _run_jax(case, tables, bf16=False):
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


def _run_torch(case, tables, bf16=False, fn=None, **kw):
    et, rows, children, zm = case
    prior = torch.from_numpy(et)
    if bf16:
        prior = prior.to(torch.bfloat16)
    return (fn or tops.zstats)(prior, torch.from_numpy(rows),
                               _torch_children(children, bf16),
                               _opt(torch.from_numpy, zm), tables=tables, **kw)


def _assert_zstats_close(got, want, rtol=2e-4, atol=2e-4):
    np.testing.assert_allclose(float(got[0]), float(want[0]),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=rtol, atol=atol)
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("tables", ["elog", "alpha"])
@pytest.mark.parametrize("case", range(len(ZSTATS_CASES)))
def test_zstats_matches_jax_ref(case, tables):
    data = _zcase(case, *ZSTATS_CASES[case], positive=tables == "alpha")
    _assert_zstats_close(_run_torch(data, tables), _run_jax(data, tables))


@pytest.mark.parametrize("name,case_args", ALPHA_CASES)
def test_zstats_alpha_cases_match_jax_ref(name, case_args):
    data = _zcase(*case_args, positive=True)
    _assert_zstats_close(_run_torch(data, "alpha"), _run_jax(data, "alpha"))


@pytest.mark.parametrize("tables", ["elog", "alpha"])
def test_zstats_bf16_tables_match_jax_ref(tables):
    """bf16 tables are rounded the same way in both frameworks and upcast
    before any arithmetic, so the f32 tolerance holds."""
    data = _zcase(30, 300, 4, 20, [(4, 33, 1, False, False, False)], False,
                  None, positive=tables == "alpha")
    got = _run_torch(data, tables, bf16=True)
    assert got[1].dtype == torch.float32
    _assert_zstats_close(got, _run_jax(data, tables, bf16=True))


def test_zstats_chunking_is_transparent():
    data = _zcase(1, *ZSTATS_CASES[7])
    _assert_zstats_close(_run_torch(data, "elog", fn=tref.zstats, chunk=49),
                         _run_torch(data, "elog", fn=tref.zstats),
                         rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_dirichlet_expectation_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    a = (rng.gamma(1.0, 1.0, size=shape) + 1e-2).astype(np.float32)
    want = np.asarray(jref.dirichlet_expectation(jnp.asarray(a)))
    got = tops.dirichlet_expectation(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    got_t = tops.dirichlet_expectation(torch.from_numpy(a), transpose=True)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy().T)


@pytest.mark.parametrize("shape", SHAPES)
def test_zstep_matches_jax(shape):
    rng = np.random.default_rng(sum(shape) + 1)
    x = (rng.normal(size=shape) * 4).astype(np.float32)
    r_w, l_w = jref.zstep(jnp.asarray(x))
    r_g, l_g = tops.zstep(torch.from_numpy(x))
    np.testing.assert_allclose(r_g.numpy(), np.asarray(r_w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(l_g.numpy(), np.asarray(l_w), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the host-side owner plan
# ---------------------------------------------------------------------------

def _check_grouping(g, keys, n_keys, piece):
    keys = np.asarray(keys)
    assert sorted(g.perm.tolist()) == list(range(len(keys)))
    for s in range(n_keys):
        toks = g.perm[g.key_start[s]:g.key_start[s + 1]]
        assert (keys[toks] == s).all()
        assert (np.diff(toks) > 0).all()              # original order kept
        p0, p1 = g.key_pieces[s], g.key_pieces[s + 1]
        assert g.piece_start[p0] == g.key_start[s] or p0 == p1
        assert p1 == p0 or g.piece_start[p1] == g.key_start[s + 1]
    lens = np.diff(g.piece_start)
    assert (lens >= 1).all() and (lens <= piece).all()
    assert g.piece_start[-1] == len(keys) and g.n_pieces == len(lens)


@pytest.mark.parametrize("keys,n_keys,piece", [
    ([0, 0, 1, 1, 1, 3], 4, 2),            # sorted (identity), empty key 2
    ([2, 0, 2, 1, 0, 2, 2], 3, 2),         # unsorted, hot key 2 split
    ([1] * 9, 3, 4),                       # one key, three pieces
    ([], 3, 4),                            # no tokens
])
def test_group_tokens_small_cases(keys, n_keys, piece):
    g = tfz.group_tokens(np.asarray(keys, np.int32), n_keys, piece)
    _check_grouping(g, keys, n_keys, piece)
    assert g.perm.dtype == np.int32 and g.piece_start.dtype == np.int32


def test_group_tokens_exact_layout():
    g = tfz.group_tokens(np.array([2, 0, 2, 1, 0, 2, 2], np.int32), 3, 2)
    np.testing.assert_array_equal(g.perm, [1, 4, 3, 0, 2, 5, 6])
    np.testing.assert_array_equal(g.key_start, [0, 2, 3, 7])
    np.testing.assert_array_equal(g.piece_start, [0, 2, 3, 5, 7])
    np.testing.assert_array_equal(g.key_pieces, [0, 1, 2, 4])


def test_group_tokens_sorted_keys_are_identity():
    keys = np.repeat(np.arange(50, dtype=np.int32), 7)
    g = tfz.group_tokens(keys, 50, 3)
    np.testing.assert_array_equal(g.perm, np.arange(len(keys)))
    _check_grouping(g, keys, 50, 3)


def test_group_tokens_rejects_out_of_range():
    with pytest.raises(ValueError):
        tfz.group_tokens(np.array([0, 3], np.int32), 3)


def _owner_emulation(case, piece):
    """The kernel's owner passes in numpy, driven only by the plan: each
    piece sums its tokens' r in plan order, each key sums its pieces."""
    et, rows, children, zm = case
    tkids = _torch_children(children)
    plan = tfz.build_plan(rows, tkids, et.shape, piece)
    k = et.shape[1]
    logits = et[rows].astype(np.float64)
    for c in children:
        if c["base"] is None and c["stride"] == 1:
            e = c["table"][:, c["values"]].T
        else:
            rws = c["base"][:, None] if c["base"] is not None else 0
            e = c["table"][rws + c["stride"] * np.arange(k)[None, :],
                           c["values"][:, None]]
        logits = logits + e * (c["mask"][:, None] if c["mask"] is not None
                               else 1.0)
    m = logits.max(1, keepdims=True)
    ex = np.exp(logits - m)
    zmv = zm if zm is not None else np.ones(len(rows))
    r = ex / ex.sum(1, keepdims=True) * zmv[:, None]
    lse = (m[:, 0] + np.log(ex.sum(1))) * zmv

    def owner(g, w):
        part = np.stack([w[g.perm[g.piece_start[p]:g.piece_start[p + 1]]]
                         .sum(0) for p in range(g.n_pieces)]) \
            if g.n_pieces else np.zeros((0, k))
        return np.stack([part[g.key_pieces[s]:g.key_pieces[s + 1]].sum(0)
                         for s in range(g.n_keys)])

    pstats = owner(plan.prior, r)
    cstats = []
    for c, g in zip(children, plan.children):
        w = r * (c["mask"][:, None] if c["mask"] is not None else 1.0)
        if c["base"] is None and c["stride"] == 1:
            cstats.append(torch.from_numpy(owner(g, w).T.copy()))
        else:                                  # column owner, token order
            out = np.zeros(c["table"].shape)
            base = c["base"] if c["base"] is not None else np.zeros_like(rows)
            for v in range(g.n_keys):
                for i in g.perm[g.key_start[v]:g.key_start[v + 1]]:
                    out[base[i] + c["stride"] * np.arange(k), v] += w[i]
            cstats.append(torch.from_numpy(out))
    return (torch.tensor(lse.sum()), torch.from_numpy(pstats), tuple(cstats))


@pytest.mark.parametrize("case", range(8))
def test_owner_plan_reproduces_zstats(case):
    """Summing by the plan's owners gives ref.zstats: every token reaches
    exactly one piece of its key, for the prior and every child."""
    data = _zcase(case, *ZSTATS_CASES[case])
    got = _owner_emulation(data, piece=7)
    _assert_zstats_close(got, _run_torch(data, "elog", fn=tref.zstats),
                         rtol=1e-5, atol=1e-5)


def test_build_plan_rejects_rows_outside_strided_table():
    data = _zcase(4, *ZSTATS_CASES[4])
    et, rows, children, _ = data
    children[0]["base"] = children[0]["base"] + 100
    with pytest.raises(ValueError, match="outside"):
        tfz.build_plan(rows, _torch_children(children), et.shape)


def test_plan_device_copy_holds_every_array():
    data = _zcase(7, *ZSTATS_CASES[7])
    et, rows, children, _ = data
    plan = tfz.build_plan(rows, _torch_children(children), et.shape).to("cpu")
    assert plan.device == torch.device("cpu")
    for name, g in [("prior", plan.prior), ("child0", plan.children[0]),
                    ("child1", plan.children[1])]:
        for field in ("perm", "key_start", "piece_start", "key_pieces"):
            np.testing.assert_array_equal(plan.tensors[name, field].numpy(),
                                          getattr(g, field))


# ---------------------------------------------------------------------------
# the wrappers' device rules
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_plain_versions_without_launches():
    tops.reset_launch_counts()
    data = _zcase(1, *ZSTATS_CASES[1])
    _run_torch(data, "alpha")
    tops.dirichlet_expectation(torch.rand(3, 4) + 0.1)
    tops.zstep(torch.randn(5, 3))
    assert tops.launch_counts() == {"zstats": 0, "dirichlet_expectation": 0,
                                    "zstep": 0}
    assert tops.zstats_plan(torch.zeros(2, 3), torch.zeros(4, dtype=torch.int32),
                            ()) is None


def test_zmap_latent_off_cpu_raises_not_implemented():
    """Off the CPU a segment latent raises; it never reaches a plain
    version (meta tensors stand in for CUDA ones here)."""
    meta = dict(device="meta")
    child = tref.ZChild(torch.empty(3, 15, **meta),
                        torch.empty(240, dtype=torch.int32, **meta),
                        zmap=torch.empty(240, dtype=torch.int32, **meta))
    with pytest.raises(NotImplementedError, match="fused_zmap"):
        tops.zstats(torch.empty(10, 3, **meta),
                    torch.empty(40, dtype=torch.int32, **meta), (child,))


def test_wrappers_refuse_devices_without_kernels():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tops.zstats(torch.empty(10, 3, **meta),
                    torch.empty(40, dtype=torch.int32, **meta), ())
    with pytest.raises(ValueError, match="no kernel"):
        tops.dirichlet_expectation(torch.empty(4, 3, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        tops.zstep(torch.empty(4, 3, **meta))


@pytest.mark.parametrize("bad,error,match", [
    ("rank", ValueError, "shape"), ("dtype", TypeError, "float"),
    ("layout", ValueError, "contiguous")])
def test_wrappers_check_inputs(bad, error, match):
    """The kernel wrappers reject bad inputs before they look at the
    device."""
    x = {"rank": torch.rand(2, 3, 4), "dtype": torch.rand(4, 3).double(),
         "layout": torch.rand(3, 4).T}[bad]
    with pytest.raises(error, match=match):
        tde.dirichlet_expectation(x)
    with pytest.raises(error, match=match):
        tzs.zstep(x)


@pytest.mark.parametrize("wrapper", ["zstats", "dirichlet_expectation",
                                     "zstep"])
def test_kernel_wrappers_take_cuda_tensors_only(wrapper):
    """The kernel wrappers never run a plain version: ``ops`` alone sends a
    CPU tensor to ``ref``."""
    call = {"zstats": lambda: tfz.zstats(torch.rand(4, 3),
                                         torch.zeros(5, dtype=torch.int32), ()),
            "dirichlet_expectation": lambda: tde.dirichlet_expectation(
                torch.rand(4, 3) + 0.1),
            "zstep": lambda: tzs.zstep(torch.rand(4, 3))}[wrapper]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        call()
