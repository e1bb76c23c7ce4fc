"""Model assembly of the port's LM slices: the LMs of
``repro.models.transformer`` (dense, experts, hybrid, SSM, the vision
prefix and the whisper-style encoder-decoder), op for op, as an
``nn.Module``.

:class:`Decoder` holds the f32 parameters: ``embed`` (V_padded, d), one
:class:`Block` per layer, ``final_norm`` and, untied, ``lm_head`` (d,
V_padded); with a modality frontend (``cfg.frontend``) ``frontend_proj``
(d, d), which projects the stub's frame or patch embeddings; for an
encoder-decoder (``cfg.family == "encdec"``) an :class:`Encoder` of
``cfg.n_enc_layers`` blocks and its norm.  A block's parts follow its kind
(``_PARTS``): an attention layer ("global", "local") has ``norm1``,
``attn``, ``norm2`` and ``ffn`` (the MLP's ``wi``, ``wo``, or with experts
``router``, ``wi``, ``wo``), and in an encoder-decoder's decoder also
``cross_norm`` and ``cross`` (cross-attention to the encoder's output,
between the self-attention and ``norm2``); an "rglru" layer ``norm1``,
``rglru``, ``norm2`` and an MLP ``ffn``; an "ssd" layer ``norm1`` and
``ssd``.  The reference stacks its blocks for ``lax.scan`` over repeats of
the block cycle; here they are a ``ModuleList`` in layer order, and
:func:`params_from_numpy` / :func:`params_to_numpy` carry weights across
(layer ``r * c + pos`` is the reference's ``blocks.scan[pos][r]``, then
``blocks.tail`` in order; the encoder's cycle is one layer, so its
``scan[0]`` stacks every layer and its tail is empty).

Entry points: :func:`init_params` (the port's own initialisation, from a
``torch.Generator``, at the reference's scales), :func:`forward` (every
text position's logits) and :func:`train_loss` (its masked CE;
``run.remat`` checkpoints each repeat of the block cycle, as the
reference's scan body), and serving: :func:`init_cache`, :func:`prefill`
(the prompt's forward, building the decode cache) and :func:`decode_step`
(one token against the cache, updated in place).  A vision model's batch
also holds ``patches`` (B, P, d), a prefix before the text that the
positions and the cache cover and the logits leave out; an
encoder-decoder's holds ``frames`` (B, S_enc, d), which the encoder reads
unmasked.  The cache is a list, one entry per layer in layer order:
``{"k", "v"}`` of (B, KV, length, Dh) for an attention layer (with
``"cross": {"k", "v"}`` of (B, KV, S_enc, Dh), the encoder's keys and
values, in a decoder layer of an encoder-decoder), the reference's
``{"h", "conv"}`` for a recurrent one (the state in f32, the conv tail of
pre-conv inputs in the run dtype).  :func:`cache_from_numpy` /
:func:`cache_to_numpy` carry it across from and to the reference's
``{"scan", "tail"}`` tree (K/V there (B, length, KV, Dh)) by the
parameters' rule.  The parameters are f32 whatever ``run.param_dtype``
says, as the reference's ``_init`` makes them; on a mesh the model runs
through :mod:`models.parallel`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig, RunConfig
from . import layers as L

def modality_inputs(cfg: ArchConfig) -> tuple:
    """The batch entries besides ``tokens`` (and ``labels``) that the
    model reads: ``("frames",)`` for an encoder-decoder, ``("patches",)``
    for the vision prefix, ``()`` for a decoder alone."""
    if cfg.family == "encdec":
        return ("frames",)
    return ("patches",) if cfg.frontend == "vision" else ()


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

# a block's parts by its kind, in the order they are applied; "cross" is
# an attention layer of an encoder-decoder's decoder
_KINDS = ("global", "local", "rglru", "ssd")
_PARTS = {"global": ("norm1", "attn", "norm2", "ffn"),
          "local": ("norm1", "attn", "norm2", "ffn"),
          "rglru": ("norm1", "rglru", "norm2", "ffn"),
          "ssd": ("norm1", "ssd"),
          "cross": ("norm1", "attn", "cross_norm", "cross", "norm2", "ffn")}


class Block(nn.Module):
    """One pre-norm block of ``kind``: attention ("global" or "local") or
    the RG-LRU ("rglru"), then the feed-forward (the MLP, or for attention
    the experts when ``cfg.n_experts``), each added to the residual
    stream; or SSD alone ("ssd").  ``cross`` adds cross-attention to the
    encoder's output between an attention layer's two halves."""

    def __init__(self, cfg: ArchConfig, gen, device, kind: str,
                 cross: bool = False):
        super().__init__()
        if kind not in _KINDS:
            raise ValueError(f"block kind {kind!r} not in {list(_KINDS)}")
        self.kind = kind
        self.parts = _PARTS["cross" if cross else kind]
        self.norm1 = L.init_norm(cfg, device)
        if kind == "ssd":
            self.ssd = L.init_ssd(gen, cfg, device)
            return
        if kind == "rglru":
            self.rglru = L.init_rglru(gen, cfg, device)
        else:
            self.attn = L.init_attention(gen, cfg, device)
        if cross:
            self.cross_norm = L.init_norm(cfg, device)
            self.cross = L.init_attention(gen, cfg, device)
        self.norm2 = L.init_norm(cfg, device)
        self.ffn = (L.init_moe(gen, cfg, device)
                    if cfg.n_experts and kind != "rglru"
                    else L.init_mlp(gen, cfg, device))

    def cross_step(self, x, cfg: ArchConfig, run: RunConfig, positions, enc):
        """``x`` plus the cross-attention of its norm to ``enc``, the
        encoder's output; ``x`` itself for a block without it.  A block
        with it refuses ``enc=None``: the reference's prefill runs the
        cross weights as a causal self-attention there."""
        if "cross" not in self.parts:
            return x
        if enc is None:
            raise ValueError("a decoder layer with cross-attention needs the "
                             "encoder's output")
        hc = L.apply_norm(self.cross_norm, x, cfg)
        return x + L.attention_train(self.cross, hc, cfg, run, kind="global",
                                     positions=positions, enc=enc)

    def feed_forward(self, x, cfg: ArchConfig, run: RunConfig):
        """The block's second half: ``x`` plus the feed-forward of its
        norm; ``x`` itself for SSD, which has none."""
        if self.kind == "ssd":
            return x
        h2 = L.apply_norm(self.norm2, x, cfg)
        ffn = L.moe_mlp if "router" in self.ffn else L.mlp
        return x + ffn(self.ffn, h2, cfg, run)

    def forward(self, x, cfg: ArchConfig, run: RunConfig, positions,
                enc=None, causal: bool = True):
        h = L.apply_norm(self.norm1, x, cfg)
        if self.kind == "rglru":
            out = L.rglru_train(self.rglru, h, cfg, run)
        elif self.kind == "ssd":
            out = L.ssd_train(self.ssd, h, cfg, run)
        else:
            out = L.attention_train(self.attn, h, cfg, run, kind=self.kind,
                                    positions=positions, causal=causal)
        x = self.cross_step(x + out, cfg, run, positions, enc)
        return self.feed_forward(x, cfg, run)


class Encoder(nn.Module):
    """An encoder-decoder's encoder: ``cfg.n_enc_layers`` "global" blocks
    without cross-attention, which attend unmasked, then ``norm`` (the
    reference's ``enc_norm``)."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, generator, device, "global")
                                    for _ in range(cfg.n_enc_layers))
        self.norm = L.init_norm(cfg, device)


class Decoder(nn.Module):
    """The model's f32 parameters, drawn from ``generator`` on ``device``
    (``generator=None`` only on the ``meta`` device, for a shell to load
    weights into): the decoder's, and ``frontend_proj`` and the
    :class:`Encoder` where the architecture has them (``None`` where it
    has not)."""

    def __init__(self, cfg: ArchConfig, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        d, vp = cfg.d_model, cfg.vocab_padded
        cross = cfg.family == "encdec"
        self.embed = L._init(generator, (vp, d), device, scale=0.02)
        self.blocks = nn.ModuleList(Block(cfg, generator, device, kind, cross)
                                    for kind in cfg.layer_kinds())
        self.final_norm = L.init_norm(cfg, device)
        self.lm_head = None if cfg.tie_embeddings else \
            L._init(generator, (d, vp), device)
        self.encoder = Encoder(cfg, generator, device) if cross else None
        self.frontend_proj = None if cfg.frontend is None else \
            L._init(generator, (d, d), device)


def init_params(cfg: ArchConfig, run: RunConfig, generator=None,
                device=None) -> Decoder:
    """f32 parameters from ``generator`` (seeded with ``run.seed`` on
    ``device``, ``None`` meaning ``"cuda"``, when not given): N(0, 1/fan_in)
    weights (``frontend_proj`` too), ``wo`` at 1/sqrt(h*dh), ``embed``
    at 0.02, norms at their identity.  On ``device="meta"`` (a dry run's
    shapes, no values) no generator is made: torch has none for ``meta``."""
    from ..core.vmp import resolve_device
    if generator is None:
        device = resolve_device(device)
        if device.type == "meta":
            return Decoder(cfg, None, device)
        generator = torch.Generator(device=device)
        generator.manual_seed(run.seed)
    return Decoder(cfg, generator, generator.device)


# ---------------------------------------------------------------------------
# embedding / head / loss
# ---------------------------------------------------------------------------

def _embed(params: Decoder, tokens, cfg: ArchConfig, run: RunConfig):
    x = params.embed[tokens].to(L._dtype(run))
    return x * math.sqrt(cfg.d_model)


def _logits(params: Decoder, x, cfg: ArchConfig, run: RunConfig):
    xn = L.apply_norm(params.final_norm, x, cfg)
    w = (params.embed.T if cfg.tie_embeddings else params.lm_head) \
        .to(L._dtype(run))
    logits = (xn @ w).float()
    if cfg.vocab_padded != cfg.vocab:       # mask the padding columns
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = torch.where(pad, -1e30, logits)
    return logits


def _ce_loss(logits, labels):
    """Masked mean CE; labels == -1 are padding."""
    valid = labels >= 0
    lab = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lab[..., None])[..., 0]
    losses = (logz - ll) * valid
    return losses.sum() / valid.sum().clamp_min(1)


# "dots": the reference's dots_with_no_batch_dims_saveable.  A product
# without batch dimensions is an ``mm`` here ((B, S, d) @ (d, n) folds to
# one); the batched ones (attention's, the experts') are ``bmm`` and are
# recomputed with everything else
_DOTS_SAVED = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(fn, run: RunConfig):
    """``fn`` under the reference's ``jax.checkpoint`` of ``run.remat``:
    "full" saves only its inputs and recomputes the rest in the backward,
    "dots" also saves the outputs of the products without batch
    dimensions."""
    if run.remat == "full":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if run.remat == "dots":
        return lambda *a: checkpoint(
            fn, *a, use_reentrant=False, context_fn=lambda:
            create_selective_checkpoint_contexts(_DOTS_SAVED))
    if run.remat != "none":
        raise ValueError(f"remat {run.remat!r} not in ('none', 'full', "
                         f"'dots')")
    return fn


def _apply_blocks(blocks: list, x, cfg: ArchConfig, run: RunConfig,
                  positions, cycle: tuple, enc=None, causal: bool = True):
    """``blocks`` in order: each of the ``repeats`` repeats of a block
    cycle of ``c`` layers (``cycle = (c, repeats)``) as one body under
    :func:`_remat`, then the tail unchecked, as the reference's scan and
    its unrolled tail."""
    c, repeats = cycle

    def cycle_body(xc, r):
        for block in blocks[r * c:(r + 1) * c]:
            xc = block(xc, cfg, run, positions, enc, causal)
        return xc
    body = _remat(cycle_body, run)
    for r in range(repeats):
        x = body(x, r)
    for block in blocks[repeats * c:]:
        x = block(x, cfg, run, positions, enc, causal)
    return x


def _apply_stack(params: Decoder, x, cfg: ArchConfig, run: RunConfig,
                 positions, enc=None):
    """The decoder's blocks (:func:`_apply_blocks` over the block cycle),
    their cross-attention reading ``enc``."""
    return _apply_blocks(list(params.blocks), x, cfg, run, positions,
                         _cycle_info(cfg), enc)


def _frontend(params: Decoder, emb, run: RunConfig):
    """The stub's frame or patch embeddings (B, n, d) through
    ``frontend_proj`` in the run dtype, unscaled."""
    dt = L._dtype(run)
    return emb.to(dt) @ params.frontend_proj.to(dt)


def _encode(params: Decoder, frames, cfg: ArchConfig, run: RunConfig):
    """The encoder's output (B, S_enc, d): ``frames`` through the frontend,
    the encoder's blocks, unmasked (its cycle is one layer), and its
    norm."""
    x = _frontend(params, frames, run)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _apply_blocks(list(params.encoder.blocks), x, cfg, run, positions,
                      _cycle_info(cfg, encoder=True), causal=False)
    return L.apply_norm(params.encoder.norm, x, cfg)


def _inputs(params: Decoder, batch: dict, cfg: ArchConfig, run: RunConfig):
    """``(x, positions, enc, offset)``: the embedded tokens after the
    projected patch prefix (vision; ``offset`` its length, 0 otherwise),
    positions over both, and the encoder's output (encoder-decoder;
    ``None`` otherwise).  A missing modality entry raises ``ValueError``."""
    missing = [k for k in modality_inputs(cfg) if batch.get(k) is None]
    if missing:
        raise ValueError(f"{cfg.name} reads batch entries {missing} besides "
                         f"the tokens")
    x = _embed(params, batch["tokens"], cfg, run)
    enc, offset = None, 0
    if cfg.family == "encdec":
        enc = _encode(params, batch["frames"], cfg, run)
    elif cfg.frontend == "vision":
        prefix = _frontend(params, batch["patches"], run)
        x = torch.cat([prefix, x], dim=1)
        offset = prefix.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    return x, positions, enc, offset


def forward(params: Decoder, tokens, cfg: ArchConfig, run: RunConfig, *,
            patches=None, frames=None) -> torch.Tensor:
    """The training forward of ``tokens`` (B, S): every text position's
    logits (B, S, V_padded) f32.  A vision model also takes ``patches``
    (B, P, d), the prefix before the text; an encoder-decoder ``frames``
    (B, S_enc, d), which the encoder reads."""
    x, positions, enc, offset = _inputs(
        params, {"tokens": tokens, "patches": patches, "frames": frames},
        cfg, run)
    x = _apply_stack(params, x, cfg, run, positions, enc)
    return _logits(params, x[:, offset:], cfg, run)


def train_loss(params: Decoder, batch: dict, cfg: ArchConfig,
               run: RunConfig) -> torch.Tensor:
    """Mean next-token CE of ``batch`` (``tokens`` and ``labels``, (B, S)
    int tensors on the parameters' device, and the f32 ``patches`` or
    ``frames`` that :func:`modality_inputs` names) as an f32 scalar."""
    return _ce_loss(forward(params, batch["tokens"], cfg, run,
                            patches=batch.get("patches"),
                            frames=batch.get("frames")), batch["labels"])


# ---------------------------------------------------------------------------
# serving: prefill builds the decode cache, decode_step extends it
# ---------------------------------------------------------------------------

def _attn_with_cache(p, h, cfg: ArchConfig, run: RunConfig, kind: str,
                     positions, cache_len: int):
    """Prefill's attention of one layer, and the layer's decode cache: a
    "global" layer's K/V in slots [0, s) of ``cache_len``, a "local"
    layer's last ``min(window, s)`` positions at their ring slots
    ``t % w`` of ``w = min(window, cache_len)``."""
    q, k, v = L._qkv(p, h, h, cfg, run)
    q = L.rope(q, positions, cfg.rope_theta)
    kr = L.rope(k, positions, cfg.rope_theta)
    b, s = h.shape[:2]
    window = cfg.window if kind == "local" else 0
    chunked = s > 2 * run.attn_chunk and s % run.attn_chunk == 0
    if window and chunked:
        out = L._sdpa_window(q, kr, v, window=window, chunk=run.attn_chunk)
    elif chunked:
        # prefill is forward-only: the causal skip is legal
        out = L._sdpa_flash(q, kr, v, causal=True, chunk=run.attn_chunk,
                            dynamic_skip=True, f32_scores=run.attn_f32_scores)
    else:
        out = L._sdpa_dense(q, kr, v, causal=True, window=window)
    y = out.reshape(b, s, -1) @ p["wo"].to(L._dtype(run))

    cache = L.init_attn_cache(cfg, run, b, cache_len, kind, device=h.device)
    if kind == "local":
        w = cache["k"].shape[2]
        t0 = s - min(w, s)
        slots = torch.remainder(torch.arange(t0, s, device=h.device), w)
        cache["k"][:, :, slots] = kr[:, t0:].transpose(1, 2)
        cache["v"][:, :, slots] = v[:, t0:].transpose(1, 2)
    else:
        if s > cache_len:
            raise ValueError(f"a prompt of {s} tokens does not fit a cache "
                             f"of {cache_len} positions")
        cache["k"][:, :, :s] = kr.transpose(1, 2)
        cache["v"][:, :, :s] = v.transpose(1, 2)
    return y, cache


def _conv_state(x_pre, cfg: ArchConfig):
    """The decode conv state after a prompt: its last W-1 pre-conv inputs
    (B, W-1, C), zeros before a prompt shorter than that."""
    width = cfg.ssm_conv - 1
    return F.pad(x_pre, (0, 0, max(0, width - x_pre.shape[1]), 0))[:, -width:]


def _rglru_with_cache(p, h, cfg: ArchConfig, run: RunConfig):
    out, hs, xb_pre = L._rglru_forward(p, h, cfg, run)
    return out, {"h": hs[:, -1], "conv": _conv_state(xb_pre, cfg)}


def _ssd_with_cache(p, h, cfg: ArchConfig, run: RunConfig):
    out, h_final, xbc_pre = L._ssd_forward(p, h, cfg, run)
    return out, {"conv": _conv_state(xbc_pre, cfg), "h": h_final}


def _cross_kv(p, enc, cfg: ArchConfig, run: RunConfig) -> dict:
    """A decoder layer's cross cache: the encoder's keys and values through
    its ``cross`` weights, ``{"k", "v"}`` of (B, KV, S_enc, Dh) in the run
    dtype (no qk-norm, as the reference's ``_fill_cross``)."""
    dt = L._dtype(run)
    b, s = enc.shape[:2]
    return {n: (enc @ p[w].to(dt)).reshape(b, s, cfg.n_kv_heads,
                                           cfg.head_dim_)
            .transpose(1, 2).contiguous() for n, w in (("k", "wk"),
                                                       ("v", "wv"))}


def _block_prefill(block: Block, x, cfg: ArchConfig, run: RunConfig,
                   positions, cache_len: int, enc=None):
    """A block's prefill: its output and its decode cache.  A decoder layer
    of an encoder-decoder runs its cross-attention on ``enc``, as the
    training forward and the decode step do (the reference's prefill hands
    it no ``enc``), and caches the encoder's keys and values in
    ``"cross"``."""
    h = L.apply_norm(block.norm1, x, cfg)
    if block.kind == "rglru":
        out, cache = _rglru_with_cache(block.rglru, h, cfg, run)
    elif block.kind == "ssd":
        out, cache = _ssd_with_cache(block.ssd, h, cfg, run)
    else:
        out, cache = _attn_with_cache(block.attn, h, cfg, run, block.kind,
                                      positions, cache_len)
    x = block.cross_step(x + out, cfg, run, positions, enc)
    if "cross" in block.parts:
        cache["cross"] = _cross_kv(block.cross, enc, cfg, run)
    return block.feed_forward(x, cfg, run), cache


def _block_decode(block: Block, x, cache: dict, cfg: ArchConfig,
                  run: RunConfig, pos: int):
    h = L.apply_norm(block.norm1, x, cfg)
    if block.kind == "rglru":
        out, cache = L.rglru_decode(block.rglru, h, cache, cfg, run)
    elif block.kind == "ssd":
        out, cache = L.ssd_decode(block.ssd, h, cache, cfg, run)
    else:
        out, cache = L.attention_decode(block.attn, h, cache, pos, cfg, run,
                                        kind=block.kind)
    x = x + out
    if "cross" in block.parts:
        hc = L.apply_norm(block.cross_norm, x, cfg)
        x = x + L.cross_attention_decode(block.cross, hc, cache["cross"],
                                         cfg, run)
    return block.feed_forward(x, cfg, run), cache


def _apply_stack_prefill(params: Decoder, x, cfg: ArchConfig, run: RunConfig,
                         positions, cache_len: int, enc=None):
    caches = []
    for block in params.blocks:
        x, cache = _block_prefill(block, x, cfg, run, positions, cache_len,
                                  enc)
        caches.append(cache)
    return x, caches


def _apply_stack_decode(params: Decoder, caches: list, x, cfg: ArchConfig,
                        run: RunConfig, pos: int):
    for block, cache in zip(params.blocks, caches):
        x, _ = _block_decode(block, x, cache, cfg, run, pos)
    return x, caches


@torch.inference_mode()
def init_cache(cfg: ArchConfig, run: RunConfig, batch: int, max_len: int,
               device=None) -> list:
    """A zeroed decode cache for ``batch`` sequences of up to ``max_len``
    positions on ``device`` (``None`` means ``"cuda"``): one entry per
    layer, ``{"k", "v"}`` for attention (:func:`layers.init_attn_cache`),
    ``{"h", "conv"}`` for the RG-LRU and SSD.  An encoder-decoder's
    layers also hold ``"cross": {"k", "v"}`` at the reference's shape, (B,
    KV, max_len, Dh) head-major; :func:`prefill` replaces them by the
    encoder's keys and values at the encoder's length."""
    from ..core.vmp import resolve_device
    device = resolve_device(device)

    def one(kind):
        if kind == "rglru":
            return L.init_rglru_cache(cfg, run, batch, device=device)
        if kind == "ssd":
            return L.init_ssd_cache(cfg, run, batch, device=device)
        c = L.init_attn_cache(cfg, run, batch, max_len, kind, device=device)
        if cfg.family == "encdec":
            c["cross"] = {n: torch.zeros_like(t) for n, t in c.items()}
        return c
    return [one(kind) for kind in cfg.layer_kinds()]


@torch.inference_mode()
def prefill(params: Decoder, batch: dict, cfg: ArchConfig, run: RunConfig,
            cache_len: int = 0):
    """The prompt ``batch["tokens"]`` (B, S) through the model: ``(the last
    position's logits (B, V_padded) f32, the decode cache)``, the cache
    sized for ``cache_len`` positions (the prompt's length when 0), so that
    ``decode_step`` can write positions S .. cache_len - 1.  A vision
    model's ``batch["patches"]`` (B, P, d) come first: the prompt then
    fills positions 0 .. P + S - 1, and ``cache_len`` counts them.  An
    encoder-decoder's ``batch["frames"]`` (B, S_enc, d) go through the
    encoder, whose output every decoder layer's cross-attention reads here
    as in training, and whose keys and values each layer's ``"cross"``
    cache holds for the decode steps."""
    x, positions, enc, _ = _inputs(params, batch, cfg, run)
    x, caches = _apply_stack_prefill(params, x, cfg, run, positions,
                                     cache_len or x.shape[1], enc)
    return _logits(params, x[:, -1:], cfg, run)[:, 0], caches


@torch.inference_mode()
def decode_step(params: Decoder, cache: list, tokens, pos: int,
                cfg: ArchConfig, run: RunConfig):
    """``tokens`` (B, 1) at position ``pos`` (the next one to write) against
    ``cache``, which is updated in place: ``(logits (B, V_padded) f32,
    cache)``."""
    x = _embed(params, tokens, cfg, run)
    x, cache = _apply_stack_decode(params, cache, x, cfg, run, int(pos))
    return _logits(params, x, cfg, run)[:, 0], cache


# ---------------------------------------------------------------------------
# weights carried across from and to the reference's parameter tree
# ---------------------------------------------------------------------------

def _cycle_info(cfg: ArchConfig, encoder: bool = False):
    """(cycle length, full repeats of the cycle): the reference's scan of
    the decoder's blocks, or with ``encoder`` of the encoder's, whose cycle
    is one "global" layer."""
    if encoder:
        return 1, cfg.n_enc_layers
    c = len(cfg.pattern)
    return c, cfg.n_layers // c


def _stack_layers(cfg: ArchConfig, trees: list, encoder: bool = False) -> dict:
    """Per-layer trees in layer order as the reference's ``{"scan",
    "tail"}``: ``scan[pos]`` stacks layer ``r * c + pos`` over the repeats
    ``r`` of the block cycle, ``tail`` holds the rest in order."""
    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return np.stack(ts)
    c, repeats = _cycle_info(cfg, encoder)
    scan = [stack([trees[r * c + pos] for r in range(repeats)])
            for pos in range(c)] if repeats else None
    return {"scan": scan, "tail": list(trees[repeats * c:])}


def _unstack_layers(cfg: ArchConfig, tree: dict, encoder: bool = False) -> list:
    """The inverse of :func:`_stack_layers`: per-layer trees in layer
    order."""
    def index(t, r):
        return {k: index(v, r) for k, v in t.items()} \
            if isinstance(t, dict) else t[r]
    c, repeats = _cycle_info(cfg, encoder)
    return [index(tree["scan"][pos], r) for r in range(repeats)
            for pos in range(c)] + list(tree["tail"])


def params_to_numpy(cfg: ArchConfig, module: Decoder, leaves=None) -> dict:
    """The module's parameters as the reference's pytree of numpy arrays
    (``blocks``, and an encoder-decoder's ``encoder``, as
    :func:`_stack_layers` lays them out).  ``leaves``, tensors in
    ``module.parameters()`` order, take the parameters' places (the AdamW
    moments, in the parameters' tree)."""
    values = {} if leaves is None else \
        dict(zip(map(id, module.parameters()), leaves))

    def host(p):
        return values.get(id(p), p).detach().cpu().numpy()

    def layers(blocks):
        return [{name: {k: host(p) for k, p in getattr(b, name).items()}
                 for name in b.parts} for b in blocks]
    tree = {"embed": host(module.embed),
            "final_norm": {k: host(p) for k, p in module.final_norm.items()},
            "blocks": _stack_layers(cfg, layers(module.blocks))}
    if module.lm_head is not None:
        tree["lm_head"] = host(module.lm_head)
    if module.encoder is not None:
        tree["encoder"] = _stack_layers(cfg, layers(module.encoder.blocks),
                                        encoder=True)
        tree["enc_norm"] = {k: host(p)
                            for k, p in module.encoder.norm.items()}
    if module.frontend_proj is not None:
        tree["frontend_proj"] = host(module.frontend_proj)
    return tree


def _block_pairs(blocks, trees: list) -> list:
    """(parameter, array) pairs of ``blocks`` from their per-layer trees,
    each tree checked against the block's parts."""
    pairs = []
    for block, bt in zip(blocks, trees):
        if set(bt) != set(block.parts):
            raise ValueError(f"a {block.kind!r} layer has parts "
                             f"{list(block.parts)}, not {sorted(bt)}")
        for name in block.parts:
            sub = getattr(block, name)
            if set(sub.keys()) != set(bt[name]):
                raise ValueError(f"{name}: parameters {sorted(bt[name])} do "
                                 f"not fit {sorted(sub.keys())}")
            pairs += [(p, bt[name][k]) for k, p in sub.items()]
    return pairs


def params_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> Decoder:
    """A :class:`Decoder` on ``device`` (``None`` means ``"cuda"``) holding
    the reference's parameter pytree ``tree`` (numpy arrays, as
    :func:`params_to_numpy` gives them)."""
    from ..core.vmp import resolve_device
    device = resolve_device(device)
    module = Decoder(cfg, None, "meta").to_empty(device=device)
    pairs = [(module.embed, tree["embed"])]
    pairs += [(p, tree["final_norm"][k]) for k, p in module.final_norm.items()]
    pairs += _block_pairs(module.blocks, _unstack_layers(cfg, tree["blocks"]))
    if module.lm_head is not None:
        pairs.append((module.lm_head, tree["lm_head"]))
    if module.encoder is not None:
        pairs += _block_pairs(module.encoder.blocks, _unstack_layers(
            cfg, tree["encoder"], encoder=True))
        pairs += [(p, tree["enc_norm"][k])
                  for k, p in module.encoder.norm.items()]
    if module.frontend_proj is not None:
        pairs.append((module.frontend_proj, tree["frontend_proj"]))
    with torch.no_grad():
        for p, a in pairs:
            a = np.asarray(a)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"shape {a.shape} does not fit {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, np.float32)))
    return module


# cache entries laid out head-major in the port, (B, length, KV, Dh) in the
# reference (the "cross" K/V too); the recurrent states ("h", "conv") have
# one layout in both
_KV = ("k", "v")


def cache_to_numpy(cfg: ArchConfig, cache: list) -> dict:
    """A decode cache as the reference's tree of numpy arrays (layers laid
    out as :func:`_stack_layers` does, K/V as (B, length, KV, Dh)); bf16
    entries widen to f32 (numpy has no bf16)."""
    def host(k, t):
        if isinstance(t, dict):
            return {n: host(n, u) for n, u in t.items()}
        t = t.detach()
        t = (t.transpose(1, 2) if k in _KV else t).cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _stack_layers(cfg, [{k: host(k, t) for k, t in c.items()}
                               for c in cache])


def cache_from_numpy(cfg: ArchConfig, tree: dict, device=None,
                     dtype=None) -> list:
    """The reference's decode-cache tree as the port's list of per-layer
    entries on ``device`` (``None`` means ``"cuda"``), in ``dtype`` (the
    arrays' own when ``None``; f32 for the ``bfloat16`` arrays of JAX).  A
    recurrent state ``h`` stays f32 whatever ``dtype`` says, as the
    reference keeps it."""
    from ..core.vmp import resolve_device
    device = resolve_device(device)

    def dev(k, a):
        if isinstance(a, dict):
            return {n: dev(n, b) for n, b in a.items()}
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(
            a.swapaxes(1, 2) if k in _KV else a))
        return t.to(device, torch.float32 if k == "h" else dtype or t.dtype)
    return [{k: dev(k, a) for k, a in layer.items()}
            for layer in _unstack_layers(cfg, tree)]
