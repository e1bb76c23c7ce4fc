"""Architecture + run configuration schema: the port's copy of
``repro.configs.base``, field for field, so that both packages read one
configuration the same way.

Every assigned architecture is a frozen :class:`ArchConfig`; reduced smoke
variants derive from the full config via :meth:`ArchConfig.reduced`.  The
port's LM slices run every family of the registry: the decoders (dense,
experts, hybrid, SSM), the vision prefix and the encoder-decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, to: int) -> int:
    return (x + to - 1) // to * to


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None    # default d_model // n_heads
    # per-layer block pattern, cycled over layers:
    #   "global" (full attn) | "local" (sliding window) | "rglru" | "ssd"
    pattern: tuple = ("global",)
    window: int = 0                   # sliding-window size for "local"
    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # encoder-decoder
    n_enc_layers: int = 0
    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    n_patches: int = 256              # vision stub prefix length
    # norm / activation / embedding details
    norm: str = "rmsnorm"             # rmsnorm | layernorm | nonparametric
    act: str = "swiglu"               # swiglu | geglu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    # long-context eligibility: True iff attention cost is sub-quadratic
    # (SWA/recurrent/SSM); pure full-attention archs skip long_500k
    subquadratic: bool = False
    source: str = ""                  # provenance note

    # ---- derived -------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up so the logits dim shards over any mesh axis."""
        return _round_up(self.vocab, 256)

    @property
    def d_inner(self) -> int:         # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_kinds(self) -> tuple:
        """Per-layer block kind, the pattern cycled over n_layers."""
        c = len(self.pattern)
        return tuple(self.pattern[i % c] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), used for the
        MODEL_FLOPS = 6*N*D roofline term."""
        d, v = self.d_model, self.vocab
        h, kv, hd = self.n_heads, self.n_kv_heads, self.head_dim_
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        gated = self.act in ("swiglu", "geglu")
        per_mlp = (3 if gated else 2) * d * self.d_ff
        if self.n_experts:
            per_mlp = self.n_experts * per_mlp + d * self.n_experts
        per_rglru = 2 * d * self.d_inner + self.d_inner * d + 3 * self.d_inner
        per_ssd = d * (2 * self.d_inner + 2 * self.ssm_state) + self.d_inner * d
        total = emb
        for kind in self.layer_kinds():
            if kind in ("global", "local"):
                total += per_attn + per_mlp
            elif kind == "rglru":
                total += per_rglru + per_mlp
            elif kind == "ssd":
                total += per_ssd
        if self.n_enc_layers:
            total += self.n_enc_layers * (per_attn + per_mlp)
            total += self.n_layers * per_attn        # cross-attention
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        gated = self.act in ("swiglu", "geglu")
        per_exp = (3 if gated else 2) * d * self.d_ff
        dense = self.param_count() - self.n_layers * self.n_experts * per_exp
        return dense + self.n_layers * self.experts_per_tok * per_exp

    def reduced(self) -> "ArchConfig":
        """Small same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, max(2, len(self.pattern))),
            d_model=64,
            n_heads=max(4, min(self.n_heads, 4)),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab=512,
            window=min(self.window, 16) if self.window else 0,
            n_experts=min(self.n_experts, 8),
            experts_per_tok=min(self.experts_per_tok, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_patches=8,
        )


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving run knobs (the perf-hillclimb surface)."""
    seq_len: int = 4096
    global_batch: int = 256
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "none"               # none | full | dots
    fsdp: bool = False                # shard params over the data axis too
    attn_chunk: int = 1024            # flash-attention chunk length
    microbatch: int = 0               # >0: grad accumulation steps
    moe_capacity: float = 1.25
    # perf knobs (see EXPERIMENTS.md section Perf):
    moe_groups: int = 0               # >1: group-local MoE routing (no global sort)
    moe_ep_local: bool = False        # True: pin dispatch buffers expert-sharded
    act_shard: str = "none"           # "seq": Megatron-SP style residual sharding
    attn_f32_scores: bool = True      # False: bf16 score blocks (f32 max/sum)
    flash_kernel: bool = False        # True: the flash-attention kernel
                                      # (CUDA; its plain version on the CPU)
    learning_rate: float = 3e-4
    warmup: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
