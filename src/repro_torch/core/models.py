"""The paper's model zoo, each in a handful of DSL lines.

The paper's headline claim is succinctness: LDA in 7 lines of Scala
(Figure 1), SLDA and DCMLDA in <= 9 (Figures 21-22), versus 503 lines in
MLlib.  The definitions below are the same models, one DSL call per paper
"val" line (``tests/test_dsl.py`` checks the line counts).
"""

from __future__ import annotations

from .dsl import Model, ModelBuilder


def two_coins(m: ModelBuilder, alpha: float = 1.0, beta: float = 1.0):
    """Paper Figure 7: pick one of two biased coins, then toss it."""
    pi = m.beta("pi", alpha)
    phi = m.beta("phi", beta, plate=m.plate(2, name="coins"))
    tosses = m.plate("?", name="tosses")
    z = m.categorical("z", given=pi, plate=tosses)
    m.categorical("x", given=phi, plate=tosses, selector=z)


def lda(m: ModelBuilder, alpha: float, beta: float, K: int, V: int):
    """Paper Figure 1: Latent Dirichlet Allocation."""
    docs = m.plate("?", name="docs")
    tokens = m.plate("?", name="tokens", within=docs)
    theta = m.dirichlet("theta", alpha, dim=K, plate=docs)
    phi = m.dirichlet("phi", beta, dim=V, plate=m.plate(K, name="topics"))
    z = m.categorical("z", given=theta, plate=tokens)
    m.categorical("x", given=phi, plate=tokens, selector=z)


def slda(m: ModelBuilder, alpha: float, beta: float, K: int, V: int):
    """Paper Figure 21: Sentence-LDA — one topic per sentence, shared by all
    words in it (aspect discovery in reviews, [Jo & Oh 2011])."""
    docs = m.plate("?", name="docs")
    sents = m.plate("?", name="sents", within=docs)
    tokens = m.plate("?", name="tokens", within=sents)
    theta = m.dirichlet("theta", alpha, dim=K, plate=docs)
    phi = m.dirichlet("phi", beta, dim=V, plate=m.plate(K, name="topics"))
    z = m.categorical("z", given=theta, plate=sents)
    m.categorical("x", given=phi, plate=tokens, selector=z)


def dcmlda(m: ModelBuilder, alpha: float, beta: float, K: int, V: int):
    """Paper Figure 22: DCM-LDA — per-document topic-word distributions
    (burstiness, [Doyle & Elkan 2009]); phi lives on docs x topics."""
    docs = m.plate("?", name="docs")
    tokens = m.plate("?", name="tokens", within=docs)
    theta = m.dirichlet("theta", alpha, dim=K, plate=docs)
    phi = m.dirichlet("phi", beta, dim=V,
                      plate=m.plate(K, name="topics", within=docs))
    z = m.categorical("z", given=theta, plate=tokens)
    m.categorical("x", given=phi, plate=tokens, selector=z)


def naive_bayes(m: ModelBuilder, alpha: float, beta: float, C: int, V: int):
    """Bayesian naive Bayes (the paper's spam-filtering motivation [19]):
    one latent class per doc, words conditionally independent given it."""
    docs = m.plate("?", name="docs")
    tokens = m.plate("?", name="tokens", within=docs)
    pi = m.dirichlet("pi", alpha, dim=C)
    phi = m.dirichlet("phi", beta, dim=V, plate=m.plate(C, name="classes"))
    c = m.categorical("c", given=pi, plate=docs)
    m.categorical("x", given=phi, plate=tokens, selector=c)


def make(name: str, **params) -> Model:
    """Instantiate a paper model by name."""
    defs = {"two_coins": two_coins, "lda": lda, "slda": slda,
            "dcmlda": dcmlda, "naive_bayes": naive_bayes}
    return Model(defs[name], **params)
