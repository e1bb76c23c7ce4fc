"""Arch registry of the port: resolve an ArchConfig to its model functions.

The bundle has the reference's keys.  This slice runs training: ``init``
and ``train_loss``.  Serving (``prefill``, ``init_cache``, ``decode_step``)
raises ``NotImplementedError`` until the serving slice of the port.
"""

from __future__ import annotations

from ..configs.base import ArchConfig
from . import transformer as T


def _serving(name: str):
    def raise_(*args, **kwargs):
        T.later_slice(name, "serving (prefill and decode caches)")
    return raise_


def make_model(cfg: ArchConfig) -> dict:
    """The model bundle for an architecture: ``init(run, generator=None,
    device=None)`` gives a :class:`~repro_torch.models.transformer.Decoder`,
    ``train_loss(params, batch, run)`` its loss."""
    T.check_slice(cfg)
    return {
        "init": lambda run, generator=None, device=None: T.init_params(
            cfg, run, generator, device),
        "train_loss": lambda p, b, run: T.train_loss(p, b, cfg, run),
        "prefill": _serving("prefill"),
        "init_cache": _serving("init_cache"),
        "decode_step": _serving("decode_step"),
    }
