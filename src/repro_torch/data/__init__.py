from .pipeline import (GrowingMinibatchSampler,  # noqa: F401
                       MinibatchSampler, SyntheticCorpus,
                       TokenStream, holdout_split)
from .store import (ShardedCorpus, ShardedCorpusWriter,  # noqa: F401
                    ShardedMinibatchSampler, sharded_caps, sharded_template,
                    slice_sharded, write_sharded_corpus)
