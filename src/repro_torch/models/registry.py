"""Arch registry of the port: resolve an ArchConfig to its model functions
(decoders of attention, RG-LRU and SSD layers, the vision prefix and the
encoder-decoder: every architecture of the registry).

The bundle has the reference's keys and signatures: ``init`` and
``train_loss`` for training; ``prefill``, ``init_cache`` and
``decode_step`` for serving.
"""

from __future__ import annotations

from ..configs.base import ArchConfig
from . import transformer as T


def make_model(cfg: ArchConfig) -> dict:
    """The model bundle for an architecture: ``init(run, generator=None,
    device=None)`` gives a :class:`~repro_torch.models.transformer.Decoder`,
    ``train_loss(params, batch, run)`` its loss, ``prefill(params, batch,
    run, cache_len=0)`` the last logits and the decode cache,
    ``init_cache(run, batch, max_len, device=None)`` a zeroed cache and
    ``decode_step(params, cache, tokens, pos, run)`` one token's logits."""
    return {
        "init": lambda run, generator=None, device=None: T.init_params(
            cfg, run, generator, device),
        "train_loss": lambda p, b, run: T.train_loss(p, b, cfg, run),
        "prefill": lambda p, b, run, cache_len=0: T.prefill(
            p, b, cfg, run, cache_len),
        "init_cache": lambda run, batch, max_len, device=None: T.init_cache(
            cfg, run, batch, max_len, device),
        "decode_step": lambda p, c, tokens, pos, run: T.decode_step(
            p, c, tokens, pos, cfg, run),
    }
