"""internvl2-1b — VLM: InternViT patch embeddings (stub) + InternLM2/qwen2
language backbone.

[arXiv:2404.16821; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    pattern=("global",),
    norm="rmsnorm",
    act="swiglu",
    frontend="vision",
    n_patches=256,
    rope_theta=1_000_000.0,
    subquadratic=False,
    source="arXiv:2404.16821; hf",
)
