from .pipeline import (GrowingMinibatchSampler,  # noqa: F401
                       MinibatchSampler, SyntheticCorpus,
                       TokenStream, holdout_split)
