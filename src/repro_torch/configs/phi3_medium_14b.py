"""phi3-medium-14b — dense, RoPE + SwiGLU + GQA, full attention.

[arXiv:2404.14219; unverified]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab=100352,
    pattern=("global",),
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
    subquadratic=False,    # pure full attention -> long_500k skipped
    source="arXiv:2404.14219; unverified",
)
