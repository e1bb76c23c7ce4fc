"""DCM-SLDA for the plain reference: SLDA's topic per sentence (the paper's
Figure 21; Jo and Oh, WSDM 2011) over DCM-LDA's per-document topic-word
tables (Figure 22; Doyle and Elkan, ICML 2009).  theta ``(D, K)`` on
documents, phi ``(D * K, V)`` on documents x topics, and one topic per
sentence, shared by all its words; a sentence's topic reads theta's row of
its document, and each of its words under topic k reads phi's row ``d * K
+ k`` of the sentence's document d at the word.  It follows that model as
written and departs from it nowhere; the step is ``reference/segment.py``'s.
"""

from __future__ import annotations

import torch

from reference.flat import Child
from reference.segment import FAULTS, SegmentModel, step  # noqa: F401


def dirichlets(cfg: dict) -> dict:
    """``{name: (rows, dim, prior)}`` of the configuration."""
    c, dsl = cfg["corpus"], cfg["dsl"]
    d, k = int(c["docs"]), int(dsl["K"])
    return {"theta": (d, k, float(dsl["alpha"])),
            "phi": (d * k, int(dsl["V"]), float(dsl["beta"]))}


def model(cfg: dict, corpus: dict) -> SegmentModel:
    """The plain model over a corpus of ``tokens``, ``sent_ids`` and
    ``sent_doc``: each token's phi rows start at its sentence's document
    times K (int32, as the corpus's streams)."""
    k = int(cfg["dsl"]["K"])
    base = (corpus["sent_doc"][corpus["sent_ids"].long()] * k).to(torch.int32)
    return SegmentModel(dirichlets(cfg), "theta", corpus["sent_doc"],
                        corpus["sent_ids"],
                        (Child("phi", corpus["tokens"], base, 1),))
