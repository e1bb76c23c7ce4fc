"""DCM-LDA (the paper's Figure 22) for the plain reference: theta ``(D,
K)`` on documents and a topic-word table per document, phi ``(D * K, V)``
on documents x topics; a token of document d under topic k reads phi's row
``d * K + k`` at its word."""

from __future__ import annotations

from reference.flat import Child, FlatModel


def dirichlets(cfg: dict) -> dict:
    """``{name: (rows, dim, prior)}`` of the configuration."""
    c, dsl = cfg["corpus"], cfg["dsl"]
    d, k = int(c["docs"]), int(dsl["K"])
    return {"theta": (d, k, float(dsl["alpha"])),
            "phi": (d * k, int(dsl["V"]), float(dsl["beta"]))}


def model(cfg: dict, corpus: dict) -> FlatModel:
    """The plain model over a corpus of ``tokens`` and ``doc_ids``."""
    k = int(cfg["dsl"]["K"])
    base = corpus["doc_ids"].long() * k
    return FlatModel(dirichlets(cfg), "theta", corpus["doc_ids"],
                     (Child("phi", corpus["tokens"], base, 1),))
