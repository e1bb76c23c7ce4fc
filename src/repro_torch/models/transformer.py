"""Model assembly of the port's LM slices: the decoder-only LMs of
``repro.models.transformer`` (dense, experts, hybrid and SSM), op for op,
as an ``nn.Module``.

:class:`Decoder` holds the f32 parameters: ``embed`` (V_padded, d), one
:class:`Block` per layer, ``final_norm`` and, untied, ``lm_head`` (d,
V_padded).  A block's parts follow its kind (``_PARTS``): an attention
layer ("global", "local") has ``norm1``, ``attn``, ``norm2`` and ``ffn``
(the MLP's ``wi``, ``wo``, or with experts ``router``, ``wi``, ``wo``); an
"rglru" layer ``norm1``, ``rglru``, ``norm2`` and an MLP ``ffn``; an "ssd"
layer ``norm1`` and ``ssd``.  The reference stacks its blocks for
``lax.scan`` over repeats of the block cycle; here they are a
``ModuleList`` in layer order, and :func:`params_from_numpy` /
:func:`params_to_numpy` carry weights across (layer ``r * c + pos`` is the
reference's ``blocks.scan[pos][r]``, then ``blocks.tail`` in order).

Entry points: :func:`init_params` (the port's own initialisation, from a
``torch.Generator``, at the reference's scales), :func:`forward` (every
position's logits) and :func:`train_loss` (its masked CE; ``run.remat``
checkpoints each repeat of the block cycle, as the reference's scan body),
and serving: :func:`init_cache`, :func:`prefill` (the prompt's forward,
building the decode cache) and :func:`decode_step` (one token against the
cache, updated in place).  The cache is a list, one entry per layer in
layer order: ``{"k", "v"}`` of (B, KV, length, Dh) for an attention
layer, the reference's ``{"h", "conv"}`` for a recurrent one (the state in
f32, the conv tail of pre-conv inputs in the run dtype).
:func:`cache_from_numpy` / :func:`cache_to_numpy` carry it across from and
to the reference's ``{"scan", "tail"}`` tree (K/V there (B, length, KV,
Dh)) by the parameters' rule.  What this slice does not run raises
``NotImplementedError`` naming the slice that will (:func:`check_slice`).
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

# what the slice does not run, and the slice that will: cfg and run knobs
_ARCH_SLICE = (
    (lambda c: c.n_enc_layers > 0 or c.family == "encdec", "an encoder",
     "encoder and frontend"),
    (lambda c: c.frontend is not None, "a modality frontend",
     "encoder and frontend"),
)
_RUN_SLICE = (
    (lambda r: r.fsdp, "fsdp", "LM sharding"),
    (lambda r: r.act_shard != "none", "act_shard", "LM sharding"),
    (lambda r: r.param_dtype != "float32", "param_dtype other than float32",
     "mixed-precision parameter"),
)


def later_slice(what: str, slice_name: str):
    raise NotImplementedError(f"{what} arrives with the {slice_name} slice "
                              f"of the port")


def check_slice(cfg: ArchConfig | None = None, run: RunConfig | None = None):
    """Raise ``NotImplementedError`` on what this slice does not run: an
    architecture with an encoder or a modality frontend, or a run knob of
    a later slice (LM sharding, bf16 parameters) set away from its
    default."""
    for test, what, slice_name in _ARCH_SLICE if cfg is not None else ():
        if test(cfg):
            later_slice(f"{cfg.name}: {what}", slice_name)
    for test, what, slice_name in _RUN_SLICE if run is not None else ():
        if test(run):
            later_slice(what, slice_name)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

# a block's parts by its kind, in the order they are applied
_PARTS = {"global": ("norm1", "attn", "norm2", "ffn"),
          "local": ("norm1", "attn", "norm2", "ffn"),
          "rglru": ("norm1", "rglru", "norm2", "ffn"),
          "ssd": ("norm1", "ssd")}


class Block(nn.Module):
    """One pre-norm decoder block of ``kind``: attention ("global" or
    "local") or the RG-LRU ("rglru"), then the feed-forward (the MLP, or
    for attention the experts when ``cfg.n_experts``), each added to the
    residual stream; or SSD alone ("ssd")."""

    def __init__(self, cfg: ArchConfig, gen, device, kind: str):
        super().__init__()
        if kind not in _PARTS:
            raise ValueError(f"block kind {kind!r} not in {sorted(_PARTS)}")
        self.kind = kind
        self.norm1 = L.init_norm(cfg, device)
        if kind == "ssd":
            self.ssd = L.init_ssd(gen, cfg, device)
            return
        if kind == "rglru":
            self.rglru = L.init_rglru(gen, cfg, device)
        else:
            self.attn = L.init_attention(gen, cfg, device)
        self.norm2 = L.init_norm(cfg, device)
        self.ffn = (L.init_moe(gen, cfg, device)
                    if cfg.n_experts and kind != "rglru"
                    else L.init_mlp(gen, cfg, device))

    def feed_forward(self, x, cfg: ArchConfig, run: RunConfig):
        """The block's second half: ``x`` plus the feed-forward of its
        norm; ``x`` itself for SSD, which has none."""
        if self.kind == "ssd":
            return x
        h2 = L.apply_norm(self.norm2, x, cfg)
        ffn = L.moe_mlp if "router" in self.ffn else L.mlp
        return x + ffn(self.ffn, h2, cfg, run)

    def forward(self, x, cfg: ArchConfig, run: RunConfig, positions):
        h = L.apply_norm(self.norm1, x, cfg)
        if self.kind == "rglru":
            out = L.rglru_train(self.rglru, h, cfg, run)
        elif self.kind == "ssd":
            out = L.ssd_train(self.ssd, h, cfg, run)
        else:
            out = L.attention_train(self.attn, h, cfg, run, kind=self.kind,
                                    positions=positions)
        return self.feed_forward(x + out, cfg, run)


class Decoder(nn.Module):
    """The decoder's f32 parameters, drawn from ``generator`` on ``device``
    (``generator=None`` only on the ``meta`` device, for a shell to load
    weights into)."""

    def __init__(self, cfg: ArchConfig, generator=None, device=None):
        super().__init__()
        check_slice(cfg)
        self.cfg = cfg
        d, vp = cfg.d_model, cfg.vocab_padded
        self.embed = L._init(generator, (vp, d), device, scale=0.02)
        self.blocks = nn.ModuleList(Block(cfg, generator, device, kind)
                                    for kind in cfg.layer_kinds())
        self.final_norm = L.init_norm(cfg, device)
        self.lm_head = None if cfg.tie_embeddings else \
            L._init(generator, (d, vp), device)


def init_params(cfg: ArchConfig, run: RunConfig, generator=None,
                device=None) -> Decoder:
    """f32 parameters from ``generator`` (seeded with ``run.seed`` on
    ``device``, ``None`` meaning ``"cuda"``, when not given): N(0, 1/fan_in)
    weights, ``wo`` at 1/sqrt(h*dh), ``embed``
    at 0.02, norms at their identity."""
    from ..core.vmp import resolve_device
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
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


def _apply_stack(params: Decoder, x, cfg: ArchConfig, run: RunConfig,
                 positions):
    """The blocks in layer order: each repeat of the block cycle as one
    body under :func:`_remat`, then the tail unchecked, as the reference's
    scan and its unrolled tail."""
    c, repeats = _cycle_info(cfg)
    blocks = list(params.blocks)

    def cycle(xc, r):
        for block in blocks[r * c:(r + 1) * c]:
            xc = block(xc, cfg, run, positions)
        return xc
    body = _remat(cycle, run)
    for r in range(repeats):
        x = body(x, r)
    for block in blocks[repeats * c:]:
        x = block(x, cfg, run, positions)
    return x


def forward(params: Decoder, tokens, cfg: ArchConfig,
            run: RunConfig) -> torch.Tensor:
    """The training forward of ``tokens`` (B, S): every position's logits
    (B, S, V_padded) f32."""
    check_slice(cfg, run)
    x = _embed(params, tokens, cfg, run)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _apply_stack(params, x, cfg, run, positions)
    return _logits(params, x, cfg, run)


def train_loss(params: Decoder, batch: dict, cfg: ArchConfig,
               run: RunConfig) -> torch.Tensor:
    """Mean next-token CE of ``batch`` (``tokens`` and ``labels``, (B, S)
    int tensors on the parameters' device) as an f32 scalar."""
    return _ce_loss(forward(params, batch["tokens"], cfg, run),
                    batch["labels"])


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


def _block_prefill(block: Block, x, cfg: ArchConfig, run: RunConfig,
                   positions, cache_len: int):
    h = L.apply_norm(block.norm1, x, cfg)
    if block.kind == "rglru":
        out, cache = _rglru_with_cache(block.rglru, h, cfg, run)
    elif block.kind == "ssd":
        out, cache = _ssd_with_cache(block.ssd, h, cfg, run)
    else:
        out, cache = _attn_with_cache(block.attn, h, cfg, run, block.kind,
                                      positions, cache_len)
    return block.feed_forward(x + out, cfg, run), cache


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
    return block.feed_forward(x + out, cfg, run), cache


def _apply_stack_prefill(params: Decoder, x, cfg: ArchConfig, run: RunConfig,
                         positions, cache_len: int):
    caches = []
    for block in params.blocks:
        x, cache = _block_prefill(block, x, cfg, run, positions, cache_len)
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
    ``{"h", "conv"}`` for the RG-LRU and SSD."""
    from ..core.vmp import resolve_device
    device = resolve_device(device)

    def one(kind):
        if kind == "rglru":
            return L.init_rglru_cache(cfg, run, batch, device=device)
        if kind == "ssd":
            return L.init_ssd_cache(cfg, run, batch, device=device)
        return L.init_attn_cache(cfg, run, batch, max_len, kind,
                                 device=device)
    return [one(kind) for kind in cfg.layer_kinds()]


@torch.inference_mode()
def prefill(params: Decoder, batch: dict, cfg: ArchConfig, run: RunConfig,
            cache_len: int = 0):
    """The prompt ``batch["tokens"]`` (B, S) through the model: ``(the last
    position's logits (B, V_padded) f32, the decode cache)``, the cache
    sized for ``cache_len`` positions (the prompt's length when 0), so that
    ``decode_step`` can write positions S .. cache_len - 1."""
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg, run)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, caches = _apply_stack_prefill(params, x, cfg, run, positions,
                                     cache_len or x.shape[1])
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

def _cycle_info(cfg: ArchConfig):
    """(cycle length, full repeats of the cycle): the reference's scan."""
    c = len(cfg.pattern)
    return c, cfg.n_layers // c


def _stack_layers(cfg: ArchConfig, trees: list) -> dict:
    """Per-layer trees in layer order as the reference's ``{"scan",
    "tail"}``: ``scan[pos]`` stacks layer ``r * c + pos`` over the repeats
    ``r`` of the block cycle, ``tail`` holds the rest in order."""
    def stack(ts):
        if isinstance(ts[0], dict):
            return {k: stack([t[k] for t in ts]) for k in ts[0]}
        return np.stack(ts)
    c, repeats = _cycle_info(cfg)
    scan = [stack([trees[r * c + pos] for r in range(repeats)])
            for pos in range(c)] if repeats else None
    return {"scan": scan, "tail": list(trees[repeats * c:])}


def _unstack_layers(cfg: ArchConfig, tree: dict) -> list:
    """The inverse of :func:`_stack_layers`: per-layer trees in layer
    order."""
    def index(t, r):
        return {k: index(v, r) for k, v in t.items()} \
            if isinstance(t, dict) else t[r]
    c, repeats = _cycle_info(cfg)
    return [index(tree["scan"][pos], r) for r in range(repeats)
            for pos in range(c)] + list(tree["tail"])


def params_to_numpy(cfg: ArchConfig, module: Decoder, leaves=None) -> dict:
    """The module's parameters as the reference's pytree of numpy arrays
    (``blocks`` as :func:`_stack_layers` lays them out).  ``leaves``,
    tensors in ``module.parameters()`` order, take the parameters' places
    (the AdamW moments, in the parameters' tree)."""
    values = {} if leaves is None else \
        dict(zip(map(id, module.parameters()), leaves))

    def host(p):
        return values.get(id(p), p).detach().cpu().numpy()
    trees = [{name: {k: host(p) for k, p in getattr(b, name).items()}
              for name in _PARTS[b.kind]}
             for b in module.blocks]
    tree = {"embed": host(module.embed),
            "final_norm": {k: host(p) for k, p in module.final_norm.items()},
            "blocks": _stack_layers(cfg, trees)}
    if module.lm_head is not None:
        tree["lm_head"] = host(module.lm_head)
    return tree


def params_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> Decoder:
    """A :class:`Decoder` on ``device`` (``None`` means ``"cuda"``) holding
    the reference's parameter pytree ``tree`` (numpy arrays, as
    :func:`params_to_numpy` gives them)."""
    from ..core.vmp import resolve_device
    device = resolve_device(device)
    module = Decoder(cfg, None, "meta").to_empty(device=device)
    blocks = _unstack_layers(cfg, tree["blocks"])
    pairs = [(module.embed, tree["embed"])]
    pairs += [(p, tree["final_norm"][k]) for k, p in module.final_norm.items()]
    for block, bt in zip(module.blocks, blocks):
        if set(bt) != set(_PARTS[block.kind]):
            raise ValueError(f"a {block.kind!r} layer has parts "
                             f"{list(_PARTS[block.kind])}, not {sorted(bt)}")
        for name in _PARTS[block.kind]:
            sub = getattr(block, name)
            if set(sub.keys()) != set(bt[name]):
                raise ValueError(f"{name}: parameters {sorted(bt[name])} do "
                                 f"not fit {sorted(sub.keys())}")
            pairs += [(p, bt[name][k]) for k, p in sub.items()]
    if module.lm_head is not None:
        pairs.append((module.lm_head, tree["lm_head"]))
    with torch.no_grad():
        for p, a in pairs:
            a = np.asarray(a)
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"shape {a.shape} does not fit {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(a, np.float32)))
    return module


# cache entries laid out head-major in the port, (B, length, KV, Dh) in the
# reference; the recurrent states ("h", "conv") have one layout in both
_KV = ("k", "v")


def cache_to_numpy(cfg: ArchConfig, cache: list) -> dict:
    """A decode cache as the reference's tree of numpy arrays (layers laid
    out as :func:`_stack_layers` does, K/V as (B, length, KV, Dh)); bf16
    entries widen to f32 (numpy has no bf16)."""
    def host(k, t):
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
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(
            a.swapaxes(1, 2) if k in _KV else a))
        return t.to(device, torch.float32 if k == "h" else dtype or t.dtype)
    return [{k: dev(k, a) for k, a in layer.items()}
            for layer in _unstack_layers(cfg, tree)]
