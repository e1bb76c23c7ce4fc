"""LDA (the paper's Figure 1) for the plain reference: theta ``(D, K)`` on
documents, phi ``(K, V)`` on topics; a token's topic reads theta's row of
its document and phi's row of the topic, at its word."""

from __future__ import annotations

from reference.flat import Child, FlatModel


def dirichlets(cfg: dict) -> dict:
    """``{name: (rows, dim, prior)}`` of the configuration."""
    c, dsl = cfg["corpus"], cfg["dsl"]
    return {"theta": (int(c["docs"]), int(dsl["K"]), float(dsl["alpha"])),
            "phi": (int(dsl["K"]), int(dsl["V"]), float(dsl["beta"]))}


def model(cfg: dict, corpus: dict) -> FlatModel:
    """The plain model over a corpus of ``tokens`` and ``doc_ids``."""
    return FlatModel(dirichlets(cfg), "theta", corpus["doc_ids"],
                     (Child("phi", corpus["tokens"]),))
