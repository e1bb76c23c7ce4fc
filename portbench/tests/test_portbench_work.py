"""The frozen counts against hand-worked values."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import peaks  # noqa: E402
from work import vmp_step, zstats  # noqa: E402

I32 = dict(dtype=torch.int32)


def test_zstats_lda_by_hand():
    # 5 tokens in 3 of 4 documents, words {1, 2, 4} of V = 6, K = 2
    rows = torch.tensor([0, 0, 2, 3, 3], **I32)
    words = torch.tensor([1, 2, 2, 4, 1], **I32)
    ops, nbytes = zstats.count((4, 2), rows, [zstats.Child((2, 6), words)])
    assert ops == 8 * 5 * 2
    # rows 20 B + 3 docs x 2 cells + theta stats 8 cells + lse 4 B;
    # words 20 B + 3 words x 2 cells + phi stats 12 cells
    assert nbytes == 20 + 6 * 4 + 8 * 4 + 4 + 20 + 6 * 4 + 12 * 4


def test_zstats_strided_by_hand():
    # DCM-LDA: 2 documents, K = 2, V = 3, phi on (doc * K + k) rows
    rows = torch.tensor([0, 0, 1], **I32)
    words = torch.tensor([2, 2, 0], **I32)
    base = rows * 2
    ops, nbytes = zstats.count((2, 2), rows,
                               [zstats.Child((4, 3), words, base)])
    assert ops == 8 * 3 * 2
    # distinct (base, word): (0, 2), (2, 0) -> 2 x 2 cells
    assert nbytes == (12 + 2 * 2 * 4 + 4 * 4 + 4) + \
        (12 + 12 + 2 * 2 * 4 + 12 * 4)


def test_mask_keeps_tokens():
    rows = torch.tensor([0, 1, 1], **I32)
    words = torch.tensor([0, 1, 2], **I32)
    mask = torch.tensor([1.0, 0.0, 1.0])
    ops, _ = zstats.count((2, 4), rows, [zstats.Child((4, 3), words,
                                                      mask=mask)])
    assert ops == 8 * 2 * 4


def test_dirichlet_parts_by_hand():
    ops, nbytes = vmp_step.dirichlet(3, 5)
    assert ops == 15 * (30 + 33 + 1)
    assert nbytes == 15 * 24 + 4


def test_step_of_model_adds_its_parts():
    from reference.flat import Child, FlatModel
    rows = torch.tensor([0, 0, 2, 3, 3], **I32)
    words = torch.tensor([1, 2, 2, 4, 1], **I32)
    dirs = {"theta": (4, 2, 0.1), "phi": (2, 6, 0.05)}
    model = FlatModel(dirs, "theta", rows, (Child("phi", words),))
    ops, nbytes = vmp_step.of_model(model)
    zo, zb = zstats.count((4, 2), rows, [zstats.Child((2, 6), words)])
    do = [vmp_step.dirichlet(g, k) for g, k, _ in dirs.values()]
    assert ops == zo + sum(o for o, _ in do)
    assert nbytes == zb + sum(b for _, b in do)


@pytest.mark.parametrize("ops,nbytes,by", [(67e12, 1.0, "operations"),
                                           (1.0, 3.35e12, "bytes")])
def test_bound_is_the_larger_term(ops, nbytes, by):
    s, which = peaks.bound_s(ops, nbytes)
    assert which == by and s == pytest.approx(1.0)


def test_frozen_count_matches_the_ports_at_these_streams():
    """The copy agrees with the port's own count (kernels/work.py) today;
    a later change to the port's count does not move this one."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import work as port_work
    rows = torch.tensor([0, 0, 2, 3, 3, 1], **I32)
    words = torch.tensor([1, 2, 2, 4, 1, 5], **I32)
    base = rows * 2
    for table, b in (((2, 6), None), ((8, 6), base)):
        want = port_work.zstats(torch.zeros(4, 2), rows, (kops.ZChild(
            torch.zeros(table), words, base=b),))
        assert zstats.count((4, 2), rows, [zstats.Child(table, words, b)]) \
            == want


def test_zstats_zmap_by_hand():
    # SLDA: 3 sentences (rows: their documents 0, 0, 1) over 5 tokens,
    # words {1, 2, 4} of V = 6, K = 2
    rows = torch.tensor([0, 0, 1], **I32)
    zmap = torch.tensor([0, 0, 1, 2, 2], **I32)
    words = torch.tensor([1, 2, 2, 4, 1], **I32)
    kid = zstats.Child((2, 6), words, zmap=zmap)
    ops, nbytes = zstats.count_zmap((2, 2), rows, [kid])
    assert ops == 8 * 3 * 2 + 4 * 5 * 2
    # rows 12 B + 2 docs x 2 cells + theta stats 4 cells + lse 4 B;
    # words and zmap 40 B + 3 words x 2 cells + phi stats 12 cells
    assert nbytes == 12 + 4 * 4 + 4 * 4 + 4 + 40 + 6 * 4 + 12 * 4
    assert nbytes == zstats.count((2, 2), rows, [kid])[1]


def test_count_zmap_matches_the_ports_at_these_streams():
    """The copy agrees with the port's own ``zstats_zmap`` count
    (kernels/work.py) today, for a plain and a strided child and a mask."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import work as port_work
    rows = torch.tensor([0, 0, 1, 3], **I32)
    zmap = torch.tensor([0, 0, 0, 1, 2, 2, 3], **I32)
    words = torch.tensor([1, 2, 2, 4, 1, 5, 0], **I32)
    base = rows[zmap.long()] * 2
    zmask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    for table, b, zm in (((2, 6), None, None), ((8, 6), base, None),
                         ((2, 6), None, zmask)):
        want = port_work.zstats_zmap(torch.zeros(4, 2), rows, (kops.ZChild(
            torch.zeros(table), words, zmap=zmap, base=b),), zm)
        got = zstats.count_zmap((4, 2), rows, [zstats.Child(
            table, words, b, zmap=zmap)], zm)
        assert got == want


#: ``vmp_step.of_model`` of two flat models, as counted before segment
#: latents were counted apart: LDA's phi and DCM-LDA's strided one
FLAT_COUNTS = {"lda": (2112, 1024), "dcmlda": (5568, 2592)}


@pytest.mark.parametrize("name", sorted(FLAT_COUNTS))
def test_flat_step_counts_keep_their_values(name):
    from reference.flat import Child, FlatModel
    rows = torch.tensor([0, 0, 1, 1, 1, 2, 3, 3], **I32)
    words = torch.tensor([4, 2, 2, 0, 4, 1, 5, 5], **I32)
    if name == "lda":
        model = FlatModel({"theta": (4, 3, 0.1), "phi": (3, 6, 0.05)},
                          "theta", rows, (Child("phi", words),))
    else:
        model = FlatModel({"theta": (4, 3, 0.1), "phi": (12, 6, 0.05)},
                          "theta", rows, (Child("phi", words, rows * 3),))
    assert vmp_step.of_model(model) == FLAT_COUNTS[name]


def test_step_of_segment_model_counts_its_plate_as_zmap():
    from reference import slda
    cfg = {"dsl": {"K": 2, "V": 6, "alpha": 0.1, "beta": 0.05},
           "corpus": {"docs": 2}}
    corpus = {"tokens": torch.tensor([1, 2, 2, 4, 1], **I32),
              "sent_ids": torch.tensor([0, 0, 1, 2, 2], **I32),
              "sent_doc": torch.tensor([0, 0, 1], **I32)}
    ops, nbytes = vmp_step.of_model(slda.model(cfg, corpus))
    zo, zb = zstats.count_zmap((2, 2), corpus["sent_doc"], [zstats.Child(
        (2, 6), corpus["tokens"], zmap=corpus["sent_ids"])])
    do = [vmp_step.dirichlet(2, 2), vmp_step.dirichlet(2, 6)]
    assert ops == zo + sum(o for o, _ in do)
    assert nbytes == zb + sum(b for _, b in do)
