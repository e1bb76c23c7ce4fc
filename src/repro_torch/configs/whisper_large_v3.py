"""whisper-large-v3 — encoder-decoder audio backbone; conv frontend stubbed
to precomputed frame embeddings per the assignment.

[arXiv:2212.04356; unverified]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,               # decoder layers
    n_enc_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    pattern=("global",),
    norm="layernorm",
    act="gelu",
    frontend="audio",
    rope_theta=10_000.0,
    subquadratic=False,
    source="arXiv:2212.04356; unverified",
)
