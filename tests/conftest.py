"""Shared fixtures and the ``slow`` marker.

The default suite (tier-1: ``PYTHONPATH=src python -m pytest -x -q``) must
finish in minutes, so full-length seed runs are marked ``slow`` and skipped
unless ``--runslow`` is passed or the marker is selected with ``-m slow``.
"""

import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run tests marked slow (full-length variants)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: full-length run, skipped by default "
        "(enable with --runslow or -m slow)")
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run them on "
        "the chip: python -m pytest tests/test_torch_trace.py "
        "tests/test_torch_dirichlet_terms.py -m card)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    if "slow" in (config.option.markexpr or ""):
        return                        # user selected them explicitly
    skip = pytest.mark.skip(reason="slow: pass --runslow or -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True)
def _reset_kernel_backend_cache():
    """The kernel dispatch backend is cached per process (it sits on the
    VMP hot loop); tests that flip ``REPRO_FORCE_PALLAS`` via monkeypatch
    need the cache cleared on both sides so routing follows the env var."""
    from repro.kernels import ops
    ops.reset_backend_cache()
    yield
    ops.reset_backend_cache()


# ---------------------------------------------------------------------------
# shared model/corpus fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="session")
def small_corpus():
    """A small planted-topic corpus shared across modules (generation is
    the slow part; the dict is treated as read-only)."""
    from repro.data import SyntheticCorpus
    return SyntheticCorpus(n_docs=50, vocab=30, n_topics=3, mean_len=60,
                           seed=0).generate()


@pytest.fixture
def lda_model(small_corpus):
    """A fresh LDA model observing the shared corpus (models are stateful:
    function-scoped)."""
    from repro.core import models
    m = models.make("lda", alpha=0.1, beta=0.05, K=3, V=30)
    m["x"].observe(small_corpus["tokens"],
                   segment_ids=small_corpus["doc_ids"])
    return m


@pytest.fixture(scope="session")
def lda_program(small_corpus):
    """A compiled LDA program over the shared corpus (programs are
    immutable metadata: session-cached)."""
    from repro.core import models
    m = models.make("lda", alpha=0.1, beta=0.05, K=3, V=30)
    m["x"].observe(small_corpus["tokens"],
                   segment_ids=small_corpus["doc_ids"])
    return m.compile()


@pytest.fixture
def rng_key():
    import jax
    return jax.random.PRNGKey(0)


@pytest.fixture
def np_rng():
    return np.random.default_rng(0)
