"""olmo-1b — dense, non-parametric LayerNorm, full attention.

[arXiv:2402.00838; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    pattern=("global",),
    norm="nonparametric",
    act="swiglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=False,
    source="arXiv:2402.00838; hf",
)
