from .pipeline import SyntheticCorpus  # noqa: F401
