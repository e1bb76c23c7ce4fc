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
from repro_torch.kernels import dirichlet_terms as tdt
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


def _pairs_digamma(x: torch.Tensor) -> torch.Tensor:
    """The Triton kernels' digamma in f32 torch: the shift by 8 with its
    reciprocals taken in pairs, 1/x + 1/(x+1) = (2x+1)/(x(x+1)), then the
    asymptotic series (the kernel's divisions are approximate, 2 ulp)."""
    acc = torch.zeros_like(x)
    for _ in range(4):
        y = x + 1.0
        acc = acc + (x + y) / (x * y)
        x = y + 1.0
    inv = 1.0 / x
    inv2 = inv * inv
    series = (torch.log(x) - 0.5 * inv
              - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0)))
    return series - acc


def _chunked_elog(a: torch.Tensor, n_sm: int = 132) -> torch.Tensor:
    """The Elog pass in torch, in the kernels' fixed structure: each row cut
    into ``row_chunks`` chunks of whole column blocks; a chunk's lanes add
    their columns block after block, then meet in one sum; a row's chunk
    partials meet in one more; the kernels' digamma of that, subtracted
    from theirs of each element."""
    g, k = a.shape
    c, chunk = tde.row_chunks(g, k, n_sm)
    _, bk = tde._blocks(k)
    pad = torch.zeros((g, c * chunk), dtype=torch.float32)
    pad[:, :k] = a
    lanes = pad.view(g, c, chunk // bk, bk)
    acc = lanes[:, :, 0]
    for b in range(1, chunk // bk):
        acc = acc + lanes[:, :, b]
    part = acc.sum(-1)
    return _pairs_digamma(a) - _pairs_digamma(part.sum(-1, keepdim=True))


@pytest.mark.parametrize("shape", SHAPES + [(5, 102660), (100, 102660),
                                            (20, 61188)])
def test_chunked_row_sums_match_jax(shape):
    """The Elog pass's chunked row sums, emulated in their fixed order at
    each shape's chunk count, with the kernels' digamma, give the
    reference's E[log theta] within chip_smoke.py's DE_TOL (rtol = atol =
    2e-4): f32 sums in another order, the shift's reciprocals in pairs."""
    rng = np.random.default_rng(sum(shape) + 2)
    a = (rng.gamma(1.0, 1.0, size=shape) + 1e-2).astype(np.float32)
    want = np.asarray(jref.dirichlet_expectation(jnp.asarray(a)))
    got = _chunked_elog(torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("g,k,n_sm", [(100, 102660, 132), (30000, 100, 132),
                                      (5, 102660, 132), (20, 61188, 132),
                                      (1, 2, 132), (100, 102660, 114),
                                      (1, 10 ** 6, 132), (7, 1025, 8)])
def test_row_chunks_cover_each_row_in_whole_blocks(g, k, n_sm):
    """Each row is cut into chunks of whole column blocks that cover it
    once (the last one shorter): the shortest chunks that keep their count
    within the count that gives _WAVES programs an SM and within
    _MAX_CHUNKS."""
    c, chunk = tde.row_chunks(g, k, n_sm)
    br, bk = tde._blocks(k)
    blocks, per = -(-k // bk), chunk // bk
    limit = min(-(-tde._WAVES * n_sm // -(-g // br)), blocks, tde._MAX_CHUNKS)
    assert chunk % bk == 0 and 1 <= c <= limit
    assert (c - 1) * chunk < k <= c * chunk
    assert c == -(-blocks // per)
    assert per == 1 or -(-blocks // (per - 1)) > limit


def test_row_chunks_at_the_paths_shapes():
    """phi at the NYTimes widths gets 11 chunks of 10 blocks (1,100
    row-sum programs for its 100 rows); theta's rows of K = 100 stay whole."""
    assert tde.row_chunks(100, 102660) == (11, 10240)
    assert tde.row_chunks(30000, 100) == (1, 128)


# ---------------------------------------------------------------------------
# the Dirichlet terms: the ELBO term and the prior + stats update
# ---------------------------------------------------------------------------

# (g, k, Elog a transposed view): one row, Beta's k = 2, theta-like rows,
# long rows read through a transposed Elog view (LDA's phi), a ragged k
DIRICHLET_SHAPES = [(1, 7, False), (500, 2, False), (3000, 100, False),
                    (4, 20000, True), (37, 1237, False)]


def _dirichlet_case(g, k, transpose, seed=0):
    """(prior row, posterior, its Elog table, stats) of a (g, k) Dirichlet;
    with ``transpose`` the Elog table is the (g, k) view of a (k, g)
    table, as LDA's phi."""
    rng = np.random.default_rng(seed + g + k)
    prior = torch.from_numpy(rng.uniform(0.02, 0.5, (1, k)).astype(np.float32))
    stats = torch.from_numpy(
        (rng.gamma(0.3, 4.0, (g, k)) * (rng.random((g, k)) < 0.3))
        .astype(np.float32))
    post = prior * torch.ones_like(stats) + stats
    elog = tref.dirichlet_expectation(post)
    if transpose:
        elog = elog.T.contiguous().T
    return prior, post, elog, stats


@pytest.mark.parametrize("g,k,transpose", DIRICHLET_SHAPES)
def test_dirichlet_terms_plain_versions_are_dists_and_updated(g, k,
                                                              transpose):
    """On the CPU ``ops`` runs ``ref``'s versions, which are bit for bit
    ``dists.dirichlet_elbo_term`` and the VMP step's ``prior + stats``
    update (``vmp._updated``), the transposed Elog view included."""
    from types import SimpleNamespace

    from repro_torch.core import dists, vmp
    prior, post, elog, stats = _dirichlet_case(g, k, transpose)
    assert tdt.transposed(elog) == transpose
    want = dists.dirichlet_elbo_term(prior, post, elog)
    for got in (tref.dirichlet_elbo_term(prior, post, elog),
                tops.dirichlet_elbo_term(prior, post, elog)):
        assert got.shape == () and got.dtype == torch.float32
        assert torch.equal(got, want)
    prog = SimpleNamespace(dirichlets={"d": SimpleNamespace(
        prior=prior[0].numpy())})
    upd = vmp._updated(prog, {"d": stats}, "cpu")["d"]
    assert torch.equal(upd, prior * torch.ones_like(stats) + stats)
    assert torch.equal(tref.dirichlet_update(prior, stats), upd)
    assert torch.equal(tops.dirichlet_update(prior, stats), upd)
    assert torch.equal(upd, post)


def _emulated_elbo_term(prior, post, elog):
    """The card's ELBO term emulated on the CPU from its plan: per (row,
    chunk) three f64 sums of each cell's f32 excess over its prior
    (lgamma(post) - lgamma(prior), post - prior, (post - prior) * elog),
    each row's chunk partials added, its term in f64 from the prior's f64
    sum, the rows summed in f64."""
    g, k = post.shape
    plan = tdt.elbo_plan(g, k, tdt.transposed(elog))
    lg = s = x = 0
    for c in range(plan.chunks):
        cols = slice(c * plan.chunk_cols, min((c + 1) * plan.chunk_cols, k))
        a, e, p = post[:, cols], elog[:, cols], prior[0, cols]
        d = a - p
        lg = lg + (torch.lgamma(a) - torch.lgamma(p)).double().sum(1)
        s = s + d.double().sum(1)
        x = x + (d * e).double().sum(1)
    sp = prior.double().sum()
    norm = torch.lgamma(sp + s) - torch.lgamma(sp)
    return (lg - norm - x).sum().float()


@pytest.mark.parametrize("g,k,transpose", DIRICHLET_SHAPES)
def test_dirichlet_elbo_chunks_cover_each_row_once(g, k, transpose):
    """The kernel's decomposition (chunk partials of each cell's excess
    over its prior, rows in f64) gives the ELBO term of an f64 evaluation
    within the limit the card's kernel is held to, and within 1e-7 of the
    sum of the parts' magnitudes, as the plain f32 version does; and
    exactly 0 for a table that is all prior, where the plain version's
    f32 sums need not cancel."""
    prior, post, elog, _ = _dirichlet_case(g, k, transpose, seed=1)
    p64, a64, e64 = prior.double(), post.double(), elog.double()
    truth = float(tref.dirichlet_elbo_term(p64, a64, e64))
    scale = float(torch.lgamma(a64).abs().sum() + (a64 * e64.abs()).sum())
    got = float(_emulated_elbo_term(prior, post, elog))
    plain = float(tref.dirichlet_elbo_term(prior, post, elog))
    assert abs(got - truth) <= tdt.error_limit(abs(plain - truth), truth)
    assert abs(got - truth) <= 1e-7 * scale
    assert abs(plain - truth) <= 1e-7 * scale
    flat = prior * torch.ones_like(post)
    assert float(_emulated_elbo_term(prior, flat, elog)) == 0.0


@pytest.mark.parametrize("g,k,transpose,route,block,chunks", [
    (150000, 12419, False, "rows", (4, 256), 1),         # DCM-LDA's phi
    (100, 102660, True, "chunks", (16, 64), 146),        # LDA's phi
    (300000, 100, False, "rows", (4, 128), 1),           # LDA's theta
    (1500, 100, False, "rows", (4, 128), 1),             # DCM-LDA's theta
    (100, 102660, False, "chunks", (4, 256), 41),
    (10, 2, False, "rows", (256, 2), 1)])
def test_dirichlet_elbo_plan_at_the_paths_shapes(g, k, transpose, route,
                                                 block, chunks):
    """The ELBO term's tiles: whole rows where there are rows enough to fill
    the card, else each row cut into chunks of whole column blocks that
    cover it once, within the count that gives _WAVES programs an SM."""
    plan = tdt.elbo_plan(g, k, transpose)
    br, bk = plan.block
    assert (plan.route, plan.block, plan.chunks) == (route, block, chunks)
    assert plan.warps in (4, 8)
    assert transpose or plan.warps * 32 * tdt._PER_THREAD == br * bk
    assert plan.chunk_cols % bk == 0
    assert (plan.chunks - 1) * plan.chunk_cols < k <= plan.chunks * \
        plan.chunk_cols
    programs = -(-g // br) * plan.chunks
    assert plan.chunks == 1 or programs <= tde._WAVES * tdt.N_SM + -(-g // br)
    assert plan.chunks <= tdt._MAX_CHUNKS


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


def test_group_tokens_orders_each_key_by_then():
    """With ``then``, a key's tokens are ordered by it (ties in the original
    order); the pieces and key runs are those of the plain grouping."""
    keys = np.array([1, 0, 1, 0, 1, 1], np.int32)
    then = np.array([5, 3, 2, 3, 2, 0], np.int32)
    g = tfz.group_tokens(keys, 2, 2, then)
    np.testing.assert_array_equal(g.perm, [1, 3, 5, 2, 4, 0])
    plain = tfz.group_tokens(keys, 2, 2)
    for f in ("key_start", "piece_start", "key_pieces", "piece_key"):
        np.testing.assert_array_equal(getattr(g, f), getattr(plain, f))
    assert not g.identity and not plain.identity
    ordered = tfz.group_tokens(np.array([0, 0, 1], np.int32), 2, 4,
                               np.array([1, 2, 0], np.int32))
    assert ordered.identity


def test_build_plan_orders_the_priors_tokens_by_the_first_child():
    data = _zcase(1, *ZSTATS_CASES[1])
    et, rows, children, _ = data
    plan = tfz.build_plan(rows, _torch_children(children), et.shape)
    g = plan.prior
    for s in range(g.n_keys):
        toks = g.perm[g.key_start[s]:g.key_start[s + 1]]
        v = children[0]["values"][toks]
        assert (rows[toks] == s).all() and (np.diff(v) >= 0).all()


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
        else:        # a value column's or a (base, value) run's owner
            out = np.zeros(c["table"].shape)
            base = c["base"] if c["base"] is not None else np.zeros_like(rows)
            for s in range(g.n_keys):
                for i in g.perm[g.key_start[s]:g.key_start[s + 1]]:
                    out[base[i] + c["stride"] * np.arange(k),
                        c["values"][i]] += w[i]
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


def _flat_plan(case, piece=7):
    """The flat passes' plan of a case: ``build_plan``'s, or for a segment
    latent the flat part of ``build_zmap_plan``'s (its children without a
    zmap); with the flat children as dicts."""
    from repro_torch.kernels import fused_zmap as tfzm
    et, rows, children, _ = case
    tkids = _torch_children(children)
    flat = [c for c in children if c["zmap"] is None]
    if len(flat) < len(children):
        return tfzm.build_zmap_plan(rows, tkids, et.shape, piece).flat, flat
    return tfz.build_plan(rows, tkids, et.shape, piece), flat


def _specialized(c):
    return c["base"] is None and c["stride"] == 1


@pytest.mark.parametrize("case", range(len(ZSTATS_CASES)))
def test_piece_ordered_streams_are_the_originals_through_perm(case):
    """Each pass's streams are the call's arrays gathered through its
    grouping's perm; a grouping that keeps the call's order has none; a pass
    has no stream of its own key; the softmax statistics' slots map every
    pass's token t to the slot of the same token in the first child's
    order."""
    data = _zcase(case, *ZSTATS_CASES[case])
    plan, flat = _flat_plan(data)
    rows = data[1]
    originals = {"prior_rows": rows}
    for i, c in enumerate(flat):
        for field in ("values", "base", "mask"):
            if c[field] is not None:
                originals[f"{field}{i}"] = c[field]
    seen = set()
    for name, g in plan.passes():
        target = None if name == "prior" else int(name[len("child"):])
        for field, orig in originals.items():
            key = (name, field)
            own = (field == "prior_rows" and target is None) or (
                target is not None and field == f"values{target}"
                and _specialized(flat[target]))
            if g.identity or own:
                assert key not in plan.streams
            else:
                np.testing.assert_array_equal(plan.streams[key], orig[g.perm])
                assert plan.streams[key].dtype == orig.dtype
                seen.add(key)
    assert seen == {k for k in plan.streams if k[1] != "spos"}
    if flat:
        first = plan.children[0].perm
        for name, g in plan.passes():
            spos = plan.streams.get((name, "spos"), np.arange(len(g.perm)))
            np.testing.assert_array_equal(first[spos], g.perm)
        assert ("child0", "spos") not in plan.streams
    else:
        assert not any(k[1] == "spos" for k in plan.streams)
    on_dev = plan.to("cpu")
    for key, a in plan.streams.items():
        np.testing.assert_array_equal(on_dev.tensors[key].numpy(), a)


def _stream_emulation(case, piece):
    """The flat passes as the kernel runs them, in numpy.  Each pass walks
    its pieces in order and reads its token streams at position t of its
    own order: the plan's gathered stream, or the call's array where the
    grouping keeps the call's order; the piece's key gives its own row.
    The prior's pass takes each token's softmax in f32 and stores (max,
    zmask / sum) at the token's slot; each child's pass rebuilds the logits
    from its own streams and makes r from the stored pair.  Returns the
    outputs (sums in f64, each owner's in plan order) and, per child pass,
    its r beside the r of a softmax recomputed in that pass."""
    et, rows, children, zm = case
    plan = tfz.build_plan(rows, _torch_children(children), et.shape, piece)
    k, n = et.shape[1], len(rows)
    zm = zm if zm is not None else np.ones(n, np.float32)
    one = np.ones(n, np.float32)

    def stream(name, g, field, orig):
        return plan.streams.get((name, field), orig if g.identity else None)

    def logits(name, g, target, ts, key):
        if target is None:
            x = np.repeat(et[key][None, :], len(ts), 0)
        else:
            x = et[stream(name, g, "prior_rows", rows)[ts]]
        for i, c in enumerate(children):
            mk = stream(name, g, f"mask{i}", c["mask"])[ts] \
                if c["mask"] is not None else one[ts]
            if _specialized(c):
                v = np.full(len(ts), key) if i == target else \
                    stream(name, g, f"values{i}", c["values"])[ts]
                e = c["table"][:, v].T
            else:
                v = stream(name, g, f"values{i}", c["values"])[ts]
                b = stream(name, g, f"base{i}", c["base"])[ts][:, None] \
                    if c["base"] is not None else 0
                e = c["table"][b + c["stride"] * np.arange(k)[None, :],
                               v[:, None]]
            x = x + e * mk[:, None]
        return x.astype(np.float32)

    def softmax(x, zmv):
        m = x.max(1)
        ex = np.exp(x - m[:, None])
        s = ex.sum(1, dtype=np.float32)
        scale = (zmv / s).astype(np.float32)
        return m, s, scale, ex * scale[:, None]

    # the prior's pass
    stats = np.zeros((n, 2), np.float32)
    g = plan.prior
    spos = plan.streams.get(("prior", "spos"), np.arange(n))
    zms = zm[g.perm]
    lse, ppart = 0.0, []
    for p in range(g.n_pieces):
        ts = np.arange(g.piece_start[p], g.piece_start[p + 1])
        m, s, scale, r = softmax(logits("prior", g, None, ts, g.piece_key[p]),
                                 zms[ts])
        lse += float(((m + np.log(s)) * zms[ts]).astype(np.float64).sum())
        stats[spos[ts]] = np.stack([m, scale], 1)
        ppart.append(r.astype(np.float64).sum(0))
    pstats = np.stack([np.sum(ppart[g.key_pieces[s]:g.key_pieces[s + 1]],
                              0) if g.key_pieces[s + 1] > g.key_pieces[s]
                       else np.zeros(k) for s in range(g.n_keys)])
    # the children's passes
    cstats, pairs = [], []
    for i, (c, g) in enumerate(zip(children, plan.children)):
        name = f"child{i}"
        spos = plan.streams.get((name, "spos"), np.arange(n))
        wm = stream(name, g, f"mask{i}", c["mask"]) \
            if c["mask"] is not None else one
        out = np.zeros(c["table"].shape)
        for key in range(g.n_keys):
            ts = np.arange(g.key_start[key], g.key_start[key + 1])
            if not len(ts):
                continue
            x = logits(name, g, i, ts, key)
            st = stats[spos[ts]]
            r = np.exp(x - st[:, :1]) * st[:, 1:]
            pairs.append((r, softmax(x, zm[g.perm[ts]])[3]))
            w = (r * wm[ts][:, None]).astype(np.float64)
            if _specialized(c):          # pieces in order, then their sum
                parts = [w[a - ts[0]:b - ts[0]].sum(0) for a, b in zip(
                    g.piece_start[g.key_pieces[key]:g.key_pieces[key + 1]],
                    g.piece_start[g.key_pieces[key] + 1:
                                  g.key_pieces[key + 1] + 1])]
                out[:, key] = np.sum(parts, 0)
            else:          # the column's, or the run's, tokens in order
                b = stream(name, g, f"base{i}", c["base"])[ts] \
                    if c["base"] is not None else np.zeros(len(ts), int)
                v = stream(name, g, f"values{i}", c["values"])[ts]
                for j in range(len(ts)):
                    out[b[j] + c["stride"] * np.arange(k), v[j]] += w[j]
        cstats.append(torch.from_numpy(out))
    return (torch.tensor(lse), torch.from_numpy(pstats), tuple(cstats)), pairs


@pytest.mark.parametrize("case", range(8))
def test_stream_emulation_reproduces_zstats(case):
    """The kernel's passes over piece-ordered streams, the children's r made
    from the prior pass's stored (max, zmask / sum), give ref.zstats; and
    each child pass's r is bitwise the r of a softmax recomputed there:
    the streams hand every pass the same logits."""
    data = _zcase(case, *ZSTATS_CASES[case])
    got, pairs = _stream_emulation(data, piece=7)
    _assert_zstats_close(got, _run_torch(data, "elog", fn=tref.zstats),
                         rtol=1e-5, atol=1e-5)
    assert pairs
    for reused, recomputed in pairs:
        np.testing.assert_array_equal(reused, recomputed)


# ---------------------------------------------------------------------------
# strided children: the "runs" pass where rows base + stride * k are one to
# one over the bases, the per-column "strided" pass elsewhere
# ---------------------------------------------------------------------------

def _dcm_case(seed=5, docs=60, k=16, vocab=200, masked=False):
    """numpy inputs of a DCM-LDA layout: theta's row is the document, phi's
    rows are documents x topics (base = doc * K, stride 1), words from a
    skewed distribution; documents 0 and 1 run past PIECE tokens and one
    word fills half of document 0 (a hot run of 200 tokens)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(20, 120, docs)
    lens[:2] = (400, 300)
    doc = np.repeat(np.arange(docs), lens).astype(np.int32)
    words = rng.choice(vocab, len(doc),
                       p=rng.dirichlet(np.full(vocab, 0.1))).astype(np.int32)
    words[:400:2] = 7
    child = {"values": words, "stride": 1, "base": (doc * k).astype(np.int32),
             "mask": None, "zmap": None,
             "table": rng.normal(size=(docs * k, vocab)).astype(np.float32)}
    zm = None
    if masked:
        child["mask"] = (rng.random(len(doc)) > 0.25).astype(np.float32)
        zm = (rng.random(len(doc)) > 0.15).astype(np.float32)
    return rng.normal(size=(docs, k)).astype(np.float32), doc, [child], zm


def _spaced_case(seed=6):
    """A strided child at stride 3, K = 3, whose bases of each residue mod
    3 lie 3 strides apart or more: rows one to one, bases not a range."""
    data = _zcase(seed, *ZSTATS_CASES[5])
    bases = np.array([0, 9, 18, 27, 1, 10, 20], np.int32)
    data[2][0]["base"] = bases[np.random.default_rng(seed).integers(
        0, len(bases), len(data[1]))]
    data[2][0]["table"] = np.random.default_rng(seed + 1).normal(
        size=(36, 11)).astype(np.float32)
    return data


RUNS_CASES = {
    "stride1-base": lambda: _zcase(6, *ZSTATS_CASES[6]),
    "multi-child": lambda: _zcase(7, *ZSTATS_CASES[7]),
    "spaced-bases": _spaced_case,
    "dcm": _dcm_case,
    "dcm-masked": lambda: _dcm_case(8, masked=True),
}


def _f32_weights(case):
    """Each token's f32 r (a softmax over the f32 logits, times zmask) and,
    per child, r times the child's mask: the terms a stats pass adds."""
    et, rows, children, zm = case
    k = et.shape[1]
    x = et[rows].astype(np.float32)
    for c in children:
        if _specialized(c):
            e = c["table"][:, c["values"]].T
        else:
            b = c["base"][:, None] if c["base"] is not None else 0
            e = c["table"][b + c["stride"] * np.arange(k)[None, :],
                           c["values"][:, None]]
        x = x + e * (c["mask"][:, None] if c["mask"] is not None
                     else np.float32(1))
    ex = np.exp(x - x.max(1, keepdims=True))
    zmv = zm if zm is not None else np.ones(len(rows), np.float32)
    r = ex * (zmv / ex.sum(1, dtype=np.float32))[:, None]
    return [(r * (c["mask"][:, None] if c["mask"] is not None
                  else np.float32(1))).astype(np.float32) for c in children]


def _walk(c, g, w, k, by_run):
    """A strided child's f32 stats from the terms ``w``, each key of ``g``
    walked in its order: ``by_run``, each run summed from 0 on its own and
    its K cells stored once (the runs pass); else each token added into the
    zeroed table in turn (the per-column pass)."""
    out = np.zeros(c["table"].shape, np.float32)
    base = c["base"] if c["base"] is not None else np.zeros(len(w), np.int32)
    rows = c["stride"] * np.arange(k)
    for s in range(g.n_keys):
        toks = g.perm[g.key_start[s]:g.key_start[s + 1]]
        if by_run:
            acc = np.zeros(k, np.float32)
            for i in toks:
                acc = acc + w[i]
            out[base[toks[0]] + rows, c["values"][toks[0]]] = acc
        else:
            for i in toks:
                out[base[i] + rows, c["values"][i]] += w[i]
    return out


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", list(RUNS_CASES))
def test_run_walk_is_bitwise_the_column_walk(name):
    """Where the plan picks "runs", its runs (tokens of one (base, value),
    in (base, value) order, each in token order) summed from 0 and stored
    once give child stats bitwise equal to the per-column walk's token by
    token adds into a zeroed table: each cell sums the same terms in the
    same order."""
    case = RUNS_CASES[name]()
    et, rows, children, _ = case
    k = et.shape[1]
    plan = tfz.build_plan(rows, _torch_children(children), et.shape)
    strided = [i for i, c in enumerate(children) if not _specialized(c)]
    assert strided and all(plan.kinds[i] == "runs" for i in strided)
    for i, w in zip(strided, [_f32_weights(case)[i] for i in strided]):
        c, g = children[i], plan.children[i]
        base = c["base"] if c["base"] is not None else np.zeros(len(rows))
        keys = base.astype(np.int64) * c["table"].shape[1] + c["values"]
        for s in range(g.n_keys):
            toks = g.perm[g.key_start[s]:g.key_start[s + 1]]
            assert len(toks) and (keys[toks] == keys[toks[0]]).all()
            assert (np.diff(toks) > 0).all()
        assert (np.diff(keys[g.perm]) >= 0).all()
        cols = tfz.group_tokens(c["values"], c["table"].shape[1])
        got = _walk(c, g, w, k, by_run=True)
        want = _walk(c, cols, w, k, by_run=False)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_run_walk_loses_adds_where_rows_collide():
    """The rule's reason: at strided-base (stride 3, bases 0..23, K = 3)
    rows meet across bases, and runs stored on their own overwrite each
    other's adds."""
    case = _zcase(4, *ZSTATS_CASES[4])
    et, rows, children, _ = case
    c = children[0]
    g = tfz.group_runs(c["values"], c["base"], c["table"].shape[1])
    w = _f32_weights(case)[0]
    cols = tfz.group_tokens(c["values"], c["table"].shape[1])
    assert not np.array_equal(_walk(c, g, w, 3, by_run=True),
                              _walk(c, cols, w, 3, by_run=False))


def _one_to_one_by_count(base, stride, k):
    b = np.unique(base) if base is not None else np.zeros(1, np.int64)
    rows = b.astype(np.int64)[:, None] + stride * np.arange(k)[None, :]
    return len(np.unique(rows)) == rows.size


def test_rows_one_to_one_against_a_count_of_rows():
    rng = np.random.default_rng(11)
    seen = set()
    for _ in range(400):
        stride, k = int(rng.choice([0, 1, 2, 3, 5, 7])), int(rng.integers(1, 6))
        base = rng.integers(0, 40, int(rng.integers(1, 6))) * \
            int(rng.choice([1, k, 2 * k]))
        want = _one_to_one_by_count(base, stride, k)
        assert tfz.rows_one_to_one(base, stride, k) == want, (base, stride, k)
        seen.add(want)
    assert seen == {True, False}
    assert tfz.rows_one_to_one(None, 0, 1) and not \
        tfz.rows_one_to_one(None, 0, 2)
    assert tfz.rows_one_to_one(np.zeros(0, np.int32), 3, 4)


@pytest.mark.parametrize("name,make,kinds", [
    ("strided-base", lambda: _zcase(4, *ZSTATS_CASES[4]), ("strided",)),
    ("strided-masked", lambda: _zcase(5, *ZSTATS_CASES[5]), ("strided",)),
    ("k100-multi", lambda: _zcase(9, 250, 100, 9, [
        (100, 33, 1, False, False, False), (300, 11, 2, True, True, False)],
        True), ("pieces", "strided")),
    ("stride1-base", RUNS_CASES["stride1-base"], ("runs",)),
    ("multi-child", RUNS_CASES["multi-child"], ("pieces", "runs")),
    ("spaced-bases", _spaced_case, ("runs",)),
    ("dcm", _dcm_case, ("runs",)),
])
def test_plan_takes_runs_exactly_where_rows_are_one_to_one(name, make, kinds):
    """The plan's pass is "runs" exactly where (base, k) -> base + stride *
    k is one to one over the bases the tokens use (counted here row by
    row), and ``routing`` names it."""
    et, rows, children, _ = make()
    k = et.shape[1]
    tkids = _torch_children(children)
    plan = tfz.build_plan(rows, tkids, et.shape)
    assert plan.kinds == kinds
    for c, kind in zip(children, kinds):
        if not _specialized(c):
            assert (kind == "runs") == _one_to_one_by_count(
                c["base"], c["stride"], k)
    assert tops.routing(et, rows, tkids).passes == kinds
    assert plan.to("cpu").kinds == kinds


@pytest.mark.parametrize("masked", [False, True])
def test_dcmlda_zstats_matches_jax_ref(masked):
    """A small DCM-LDA program of the port's DSL (K = 16, 60 documents, V =
    200, two documents over PIECE tokens): its zstats call's index streams
    with seeded Elog tables give, through the port's ``zstats`` (the plain
    version here) and through the kernel's passes emulated over the plan
    (the runs pass for phi), the JAX reference's results within its
    tolerance; the plan routes phi to "runs"."""
    from repro_torch.core import models as tmodels
    from repro_torch.core import vmp as tvmp
    et, doc, (child,), zm = _dcm_case(12, masked=masked)
    k, vocab = et.shape[1], child["table"].shape[1]
    m = tmodels.make("dcmlda", alpha=0.1, beta=0.05, K=k, V=vocab)
    m["x"].observe(child["values"], segment_ids=doc)
    prog = m.compile()
    arrays = tvmp._program_arrays(prog, torch.device("cpu"))
    spec = prog.latents[0]
    (f,) = spec.children
    got = dict(rows=arrays[spec.name]["prior_rows"].numpy(),
               values=arrays[f.x_name]["values"].numpy(),
               base=arrays[f.x_name]["base"].numpy())
    np.testing.assert_array_equal(got["rows"], doc)
    np.testing.assert_array_equal(got["values"], child["values"])
    np.testing.assert_array_equal(got["base"], child["base"])
    assert f.stride == child["stride"]
    case = (et, got["rows"], [child], zm)
    want = _run_jax(case, "elog")
    _assert_zstats_close(_run_torch(case, "elog"), want)
    emulated, pairs = _stream_emulation(case, piece=tfz.PIECE)
    _assert_zstats_close(emulated, want)
    for reused, recomputed in pairs:
        np.testing.assert_array_equal(reused, recomputed)
    tabs = {n: np.broadcast_to(np.float32(0), (d.g, d.k))
            for n, d in prog.dirichlets.items()}
    route = tops.routing(tabs[spec.prior_dir], got["rows"],
                         tvmp._latent_children(spec, tabs, arrays))
    assert route.label == "flat passes=runs"


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
    zdata = _zcase(2, *ZSTATS_CASES[9])
    _run_torch(zdata, "elog")
    zkids = _torch_children(zdata[2])
    tops.zmap_logits(zkids, 40, 3)
    tops.dirichlet_expectation(torch.rand(3, 4) + 0.1)
    prior, post, elog, stats = _dirichlet_case(3, 4, False)
    tops.dirichlet_elbo_term(prior, post, elog)
    tops.dirichlet_update(prior, stats)
    tops.zstep(torch.randn(5, 3))
    tops.flash_attention(*torch.randn(3, 2, 9, 8))
    assert tops.launch_counts() == {"zstats": 0, "zstats_zmap": 0,
                                    "zmap_logits": 0,
                                    "dirichlet_expectation": 0,
                                    "dirichlet_elbo_term": 0,
                                    "dirichlet_update": 0, "zstep": 0,
                                    "flash_attention": 0}
    assert tops.route_counts()["dirichlet_elbo_term"] == {"rows": 0,
                                                          "chunks": 0}
    assert tops.zstats_plan(torch.zeros(2, 3), torch.zeros(4, dtype=torch.int32),
                            ()) is None
    assert tops.zstats_plan(torch.zeros(10, 3), torch.from_numpy(zdata[1]),
                            zkids) is None


def test_zmap_latent_off_cpu_raises_not_implemented(monkeypatch):
    """Off the CPU a segment latent goes to the ``fused_zmap`` wrapper, which
    refuses a device without a kernel; it never reaches a plain version
    (meta tensors stand in for CUDA ones here, the dry run's branch for
    meta switched off)."""
    from repro_torch.kernels import fused_zmap as tfzm
    monkeypatch.setattr(tops, "_dry", lambda t: False)
    calls = []
    orig = tfzm.zstats_zmap
    monkeypatch.setattr(tfzm, "zstats_zmap",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    monkeypatch.setattr(tref, "zstats", None)        # no plain version
    meta = dict(device="meta")
    child = tref.ZChild(torch.empty(3, 15, **meta),
                        torch.empty(240, dtype=torch.int32, **meta),
                        zmap=torch.empty(240, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tops.zstats(torch.empty(10, 3, **meta),
                    torch.empty(40, dtype=torch.int32, **meta), (child,))
    assert calls == [1]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tops.zmap_logits((child,), 40, 3)
    with pytest.raises(ValueError, match="fused_zmap"):
        tfz.zstats(torch.empty(10, 3, **meta),
                   torch.empty(40, dtype=torch.int32, **meta), (child,))


def test_wrappers_refuse_devices_without_kernels(monkeypatch):
    """Off the CPU the dispatch reaches the kernels' wrappers, which refuse a
    device without a kernel (meta tensors stand in for CUDA ones here, the
    dry run's branch for meta switched off).  With that branch on, a meta
    tensor outside a cost count raises the dry run's own error instead."""
    meta = dict(device="meta")
    calls = [
        lambda: tops.zstats(torch.empty(10, 3, **meta),
                            torch.empty(40, dtype=torch.int32, **meta), ()),
        lambda: tops.dirichlet_expectation(torch.empty(4, 3, **meta)),
        lambda: tops.dirichlet_elbo_term(torch.empty(1, 3, **meta),
                                         torch.empty(4, 3, **meta),
                                         torch.empty(4, 3, **meta)),
        lambda: tops.dirichlet_update(torch.empty(1, 3, **meta),
                                      torch.empty(4, 3, **meta)),
        lambda: tops.zstep(torch.empty(4, 3, **meta))]
    for call in calls:
        with pytest.raises(ValueError, match="count the call"):
            call()
    monkeypatch.setattr(tops, "_dry", lambda t: False)
    for call in calls:
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()


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


@pytest.mark.parametrize("bad,error,match", [
    ("rank", ValueError, "shape"), ("dtype", TypeError, "float32"),
    ("shapes", ValueError, "differ"), ("prior", ValueError, "prior row"),
    ("layout", ValueError, "contiguous"), ("offsets", ValueError, "2\\^31")])
def test_dirichlet_terms_check_inputs(bad, error, match):
    """The Dirichlet terms' wrappers reject bad inputs before they look at
    the device: the update takes contiguous stats, the ELBO term any
    strides (a transposed Elog view is no bad input) whose column offsets
    stay within 2^31 elements."""
    prior, post, elog, stats = _dirichlet_case(4, 3, True)
    far = torch.empty_strided((4, 3), (1, 2 ** 30), device="meta")
    args = {"rank": (prior, post[None], elog[None]),
            "dtype": (prior, post.double(), elog.double()),
            "shapes": (prior, post, elog[:3]),
            "prior": (prior[:, :2], post, elog),
            "layout": (prior, stats.T.contiguous().T, elog),
            "offsets": (prior, post, far)}[bad]
    if bad != "layout":                      # the ELBO term takes any strides
        with pytest.raises(error, match=match):
            tdt.elbo_term(*args)
    if bad not in ("shapes", "offsets"):     # the update takes one table
        with pytest.raises(error, match=match):
            tdt.update(*args[:2])
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tdt.elbo_term(prior, post, elog)


@pytest.mark.parametrize("wrapper", ["zstats", "zstats_zmap", "zmap_logits",
                                     "dirichlet_expectation",
                                     "dirichlet_elbo_term", "dirichlet_update",
                                     "zstep"])
def test_kernel_wrappers_take_cuda_tensors_only(wrapper):
    """The kernel wrappers never run a plain version: ``ops`` alone sends a
    CPU tensor to ``ref``."""
    from repro_torch.kernels import fused_zmap as tfzm
    et, rows, children, zm = _zcase(3, *ZSTATS_CASES[9])
    zkids = _torch_children(children)
    call = {"zstats": lambda: tfz.zstats(torch.rand(4, 3),
                                         torch.zeros(5, dtype=torch.int32), ()),
            "zstats_zmap": lambda: tfzm.zstats_zmap(
                torch.from_numpy(et), torch.from_numpy(rows), zkids,
                torch.from_numpy(zm)),
            "zmap_logits": lambda: tfzm.zmap_logits(zkids, len(rows), 3),
            "dirichlet_expectation": lambda: tde.dirichlet_expectation(
                torch.rand(4, 3) + 0.1),
            "dirichlet_elbo_term": lambda: tdt.elbo_term(
                *_dirichlet_case(4, 3, False)[:3]),
            "dirichlet_update": lambda: tdt.update(
                *_dirichlet_case(4, 3, True)[::3]),
            "zstep": lambda: tzs.zstep(torch.rand(4, 3))}[wrapper]
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        call()
