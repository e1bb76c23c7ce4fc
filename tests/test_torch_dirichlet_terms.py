"""The Dirichlet terms' kernels (``kernels/dirichlet_terms.py``) on the card.

Marked ``card``: they need a CUDA card and skip without one (on the chip:
``python -m pytest tests/test_torch_dirichlet_terms.py -m card``).  The
ELBO term is held to an f64 evaluation of the plain version, within
``dirichlet_terms.error_limit`` (set by the plain f32 version's own error)
and within 1e-7 of the sum of the parts' magnitudes, at a DCM-LDA-like
phi, at LDA's theta and at LDA's phi read through its transposed Elog
table; two calls give the same bits, and a table that is all prior gives
exactly 0; the update is bit for bit ``prior * ones + stats``.  The CPU
tests of the same module (plans, plain versions, input checks) are in
``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import dirichlet_terms as dt
from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(g, k, transpose, device, seed=0):
    """(prior row, posterior, Elog table, stats) of a (g, k) Dirichlet on
    ``device``, the stats sparse as a corpus's; with ``transpose`` the
    Elog table is the (g, k) view of a (k, g) table (LDA's phi)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    prior = torch.full((1, k), 0.05, device=device)
    u = torch.rand((g, k), generator=gen, device=device)
    stats = torch.where(u < 0.2, u * 40.0, torch.zeros((), device=device))
    post = prior * torch.ones_like(stats) + stats
    elog = ops.dirichlet_expectation(post, transpose=transpose)
    return prior, post, elog.T if transpose else elog, stats


@pytest.mark.card
@pytest.mark.parametrize("g,k,transpose,route", [
    (20000, 12419, False, "rows"),          # DCM-LDA's phi, fewer rows
    (300000, 100, False, "rows"),           # LDA's theta
    (100, 102660, True, "chunks")])         # LDA's phi as (K, V) of (V, K)
def test_the_elbo_term_and_update_on_the_card(cuda, g, k, transpose, route):
    prior, post, elog, stats = _case(g, k, transpose, cuda)
    assert dt.transposed(elog) == transpose
    ops.reset_launch_counts()
    got = ops.dirichlet_elbo_term(prior, post, elog)
    again = ops.dirichlet_elbo_term(prior, post, elog)
    assert ops.route_counts()["dirichlet_elbo_term"][route] == 2
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, again)
    # a table that is all prior: every cell's excess is 0, and so the term
    flat = prior.expand(g, k).contiguous()
    assert float(ops.dirichlet_elbo_term(prior, flat, elog)) == 0.0
    del flat
    plain = float(ref.dirichlet_elbo_term(prior, post, elog))
    p64, a64 = prior.double(), post.double()
    truth = scale = 0.0
    for lo in range(0, g, 4096):                 # f64 in blocks of rows
        a, e = a64[lo:lo + 4096], elog[lo:lo + 4096].double()
        truth += float(ref.dirichlet_elbo_term(p64, a, e))
        scale += float(torch.lgamma(a).abs().sum() + (a * e.abs()).sum())
    err, plain_err = abs(float(got) - truth), abs(plain - truth)
    assert err <= dt.error_limit(plain_err, truth), (err, plain_err, truth)
    assert err <= 1e-7 * scale, (err, plain_err, scale)

    upd = ops.dirichlet_update(prior, stats)
    assert upd.is_contiguous() and upd.dtype == torch.float32
    assert torch.equal(upd, prior * torch.ones_like(stats) + stats)
    assert torch.equal(upd, ops.dirichlet_update(prior, stats))
    assert ops.launch_counts()["dirichlet_update"] == 2


@pytest.mark.card
def test_an_empty_table_and_a_single_row(cuda):
    prior, post, elog, _ = _case(1, 7, False, cuda, seed=2)
    assert float(ops.dirichlet_elbo_term(prior, post[:0], elog[:0])) == 0.0
    got = float(ops.dirichlet_elbo_term(prior, post, elog))
    want = float(ref.dirichlet_elbo_term(prior.double(), post.double(),
                                         elog.double()))
    assert np.isclose(got, want, rtol=1e-6, atol=1e-5)
