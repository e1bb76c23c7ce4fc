"""mamba2-370m — attention-free SSM with the SSD (state-space duality) block.

[arXiv:2405.21060; unverified]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                    # no separate MLP; the SSD block is the mixer
    vocab=50280,
    pattern=("ssd",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
    subquadratic=True,
    source="arXiv:2405.21060; unverified",
)
