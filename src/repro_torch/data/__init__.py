from .pipeline import (GrowingMinibatchSampler,  # noqa: F401
                       MinibatchSampler, SyntheticCorpus,
                       TokenStream, holdout_split)
from .store import (HostAssignment, ShardedCorpus,  # noqa: F401
                    ShardedCorpusWriter, ShardedMinibatchSampler,
                    doc_ownership, shard_ownership, sharded_caps,
                    sharded_template, slice_sharded, write_sharded_corpus)
