"""Architecture registry of the port: ``--arch <id>`` resolves here.

The ten architecture files are copies of ``repro.configs``'s, as data.
"""

from __future__ import annotations

from .base import ArchConfig, RunConfig  # noqa: F401

from . import (gemma3_4b, h2o_danube_1_8b, internvl2_1b, mamba2_370m,
               moonshot_v1_16b_a3b, olmo_1b, phi3_medium_14b,
               qwen3_moe_30b_a3b, recurrentgemma_2b, whisper_large_v3)

ARCHS: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (gemma3_4b, h2o_danube_1_8b, phi3_medium_14b, olmo_1b,
              qwen3_moe_30b_a3b, moonshot_v1_16b_a3b, recurrentgemma_2b,
              whisper_large_v3, mamba2_370m, internvl2_1b)
}

# the assigned input-shape grid: name -> (kind, seq_len, global_batch)
SHAPES: dict[str, tuple[str, int, int]] = {
    "train_4k": ("train", 4_096, 256),
    "prefill_32k": ("prefill", 32_768, 32),
    "decode_32k": ("decode", 32_768, 128),
    "long_500k": ("decode", 524_288, 1),
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cell_enabled(arch: ArchConfig, shape: str) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs, and why not if skipped."""
    if shape == "long_500k" and not arch.subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
