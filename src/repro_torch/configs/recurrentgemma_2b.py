"""recurrentgemma-2b — hybrid: RG-LRU recurrent blocks + local attention, 2:1.

[arXiv:2402.19427; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,              # MQA in the attention blocks
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    pattern=("rglru", "rglru", "local"),
    window=2048,
    ssm_expand=1,              # RG-LRU width = d_model (lru_width)
    norm="rmsnorm",
    act="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    subquadratic=True,         # recurrence + windowed attention
    source="arXiv:2402.19427; hf",
)
