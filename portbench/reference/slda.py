"""SLDA (Sentence-LDA, the paper's Figure 21; Jo and Oh, WSDM 2011) for the
plain reference: theta ``(D, K)`` on documents, phi ``(K, V)`` on topics,
and one topic per sentence, shared by all its words; a sentence's topic
reads theta's row of its document, and each of its words reads phi's row
of the topic at the word."""

from __future__ import annotations

from reference.flat import Child
from reference.segment import FAULTS, SegmentModel, step  # noqa: F401


def dirichlets(cfg: dict) -> dict:
    """``{name: (rows, dim, prior)}`` of the configuration."""
    c, dsl = cfg["corpus"], cfg["dsl"]
    return {"theta": (int(c["docs"]), int(dsl["K"]), float(dsl["alpha"])),
            "phi": (int(dsl["K"]), int(dsl["V"]), float(dsl["beta"]))}


def model(cfg: dict, corpus: dict) -> SegmentModel:
    """The plain model over a corpus of ``tokens``, ``sent_ids`` and
    ``sent_doc``."""
    return SegmentModel(dirichlets(cfg), "theta", corpus["sent_doc"],
                        corpus["sent_ids"], (Child("phi", corpus["tokens"]),))
