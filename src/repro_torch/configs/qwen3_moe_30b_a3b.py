"""qwen3-moe-30b-a3b — MoE, 128 experts top-8, QK-norm, full attention.

[hf:Qwen/Qwen3-30B-A3B; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                  # per-expert FFN width
    vocab=151936,
    pattern=("global",),
    n_experts=128,
    experts_per_tok=8,
    norm="rmsnorm",
    act="swiglu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    subquadratic=False,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
