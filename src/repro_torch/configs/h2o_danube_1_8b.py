"""h2o-danube-1.8b — dense, llama+mistral mix with sliding-window attention.

[arXiv:2401.16818; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    pattern=("local",),
    window=4096,
    norm="rmsnorm",
    act="swiglu",
    rope_theta=10_000.0,
    subquadratic=True,     # Mistral-style SWA everywhere
    source="arXiv:2401.16818; hf",
)
