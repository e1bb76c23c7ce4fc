"""moonshot-v1-16b-a3b — MoE (kimi/moonlight), 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                 # per-expert FFN width
    vocab=163840,
    pattern=("global",),
    n_experts=64,
    experts_per_tok=6,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=50_000.0,
    subquadratic=False,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
)
