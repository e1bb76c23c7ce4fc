"""gemma3-4b — dense, 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt family scaling; unverified]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    norm="rmsnorm",
    act="geglu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    subquadratic=True,     # 5/6 of layers are SWA; global layers linear at decode
    source="hf:google/gemma-3-1b-pt; unverified",
)
