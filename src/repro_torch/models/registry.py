"""Arch registry of the port: resolve an ArchConfig to its model functions
(decoders of attention, RG-LRU and SSD layers, the vision prefix and the
encoder-decoder: every architecture of the registry), and the stand-ins
of a cell's inputs that the dry run traces against.

The bundle has the reference's keys and signatures: ``init`` and
``train_loss`` for training; ``prefill``, ``init_cache`` and
``decode_step`` for serving.  :func:`input_specs` gives the reference's
``input_specs`` as ``meta`` tensors.
"""

from __future__ import annotations

from ..configs.base import ArchConfig, RunConfig
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


def input_specs(cfg: ArchConfig, shape_name: str, run: RunConfig) -> dict:
    """Stand-ins for every model input of one (arch x shape) cell, of the
    reference's shapes and dtypes: ``meta`` tensors (no data, no
    allocation), what a dry run (``launch.dryrun``) traces against.

    train  -> ``{"batch"}``: tokens and labels (B, S) int32, an
              encoder-decoder's ``frames`` (B, S, d) f32, a vision model's
              ``patches`` (B, P, d) f32 before S - P text tokens;
    prefill-> the prompt batch, the same without labels;
    decode -> ``{"cache", "tokens", "pos"}``: a cache of ``seq_len``
              positions (``transformer.init_cache`` on ``meta``), one new
              token (B, 1) int32, and its position, a 0-d int32 host
              tensor holding ``seq_len - 1`` (the port's decode reads the
              position on the host to pick the cache slot it writes; the
              reference's is a traced scalar).

    The port's cache is a list over layers in layer order, K/V head-major
    (B, KV, length, Dh); the reference's is ``{"scan", "tail"}`` with K/V
    (B, length, KV, Dh): layer ``r * c + i`` of a block cycle of ``c``
    layers is ``scan[i]``'s entry ``r`` on its leading stacked dim, the
    rest ``tail`` in order, K/V transposed on their middle two dims
    (``transformer.cache_to_numpy`` moves values the same way).  The
    recurrent states ``h`` and ``conv`` have one layout in both.
    """
    import torch

    from ..configs import SHAPES

    kind, seq, batch = SHAPES[shape_name]
    i32, f32 = torch.int32, torch.float32

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind in ("train", "prefill"):
        if cfg.family == "encdec":
            b = {"frames": sds((batch, seq, cfg.d_model), f32),
                 "tokens": sds((batch, seq), i32)}
            if kind == "train":
                b["labels"] = sds((batch, seq), i32)
            return {"batch": b}
        if cfg.frontend == "vision":
            n_text = seq - cfg.n_patches
            b = {"patches": sds((batch, cfg.n_patches, cfg.d_model), f32),
                 "tokens": sds((batch, n_text), i32)}
            if kind == "train":
                b["labels"] = sds((batch, n_text), i32)
            return {"batch": b}
        b = {"tokens": sds((batch, seq), i32)}
        if kind == "train":
            b["labels"] = sds((batch, seq), i32)
        return {"batch": b}

    # decode: cache of seq_len + one token
    return {"cache": T.init_cache(cfg, run, batch, seq, device="meta"),
            "tokens": sds((batch, 1), i32),
            "pos": torch.tensor(seq - 1, dtype=i32)}
