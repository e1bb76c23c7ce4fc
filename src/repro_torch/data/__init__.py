from .pipeline import SyntheticCorpus, TokenStream  # noqa: F401
