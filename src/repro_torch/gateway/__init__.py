"""Multi-tenant serving gateway with a declarative statistical query
language: the port of ``repro.gateway``, over the port's query layer.

One gateway process hosts many versioned posterior artifacts
(``registry``), meters tenants with token-bucket quotas (``admission``),
answers a small SQL-flavored query language (``ql`` -> ``plan``) —
``TOPICS OF phi TOP 5``, ``SIMILARITY BETWEEN phi[0] AND phi[2] USING
hellinger``, ``CREDIBLE INTERVAL 0.9 FOR theta[3]``, ``PREDICT LL FOR
DOCS $batch USING ARTIFACT 'lda-v7'``, plus ``EXPLAIN`` — and serves
compacted (bf16 + top-k, measured-error) artifact replicas (``compact``).
PREDICT runs the port's fold-in on the gateway's device (``Gateway(device=)``,
``None`` means ``"cuda"``); EXPLAIN names its Hopper kernel routes.
"""

from .admission import (AdmissionController, QuotaExceededError,
                        TenantQuota, TokenBucket)
from .compact import CompactedPosterior, compact_posterior, load_compacted
from .gateway import Gateway
from .plan import GatewayResult
from .ql import QLSyntaxError, parse, parse_script
from .registry import ArtifactEntry, ArtifactRegistry, UnknownArtifactError

__all__ = ["Gateway", "GatewayResult", "ArtifactRegistry", "ArtifactEntry",
           "UnknownArtifactError", "AdmissionController", "TenantQuota",
           "TokenBucket", "QuotaExceededError", "CompactedPosterior",
           "compact_posterior", "load_compacted", "parse", "parse_script",
           "QLSyntaxError"]
