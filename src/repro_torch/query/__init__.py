"""Posterior query & serving: everything downstream of ``fit()``.

The port of ``repro.query``, the train-once/query-many layer:

  - :class:`Posterior` — frozen, versioned posterior artifacts with
    direct statistical queries (means, credible intervals, top-k,
    pairwise similarity); built via ``InferenceResult.freeze()``; the
    reference's on-disk format, so each package loads the other's.
  - :class:`FoldIn` — local-only inference for unseen documents
    (predictive log-likelihood, perplexity, MAP mixtures) on the port's
    kernels, one scorer per padded length bucket.
  - :class:`QueryServer` / :class:`QueryClient` — micro-batched dispatch
    of concurrent fold-in queries with latency/throughput accounting.
"""

from .foldin import FoldIn, FoldInConfig, FoldInResult  # noqa: F401
from .posterior import FORMAT_VERSION, Posterior  # noqa: F401
from .server import QueryClient, QueryResponse, QueryServer  # noqa: F401

__all__ = ["Posterior", "FORMAT_VERSION", "FoldIn", "FoldInConfig",
           "FoldInResult", "QueryServer", "QueryClient", "QueryResponse"]
