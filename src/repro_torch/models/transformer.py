"""Model assembly of the port's LM slice: the dense decoder-only LM of
``repro.models.transformer``, op for op, as an ``nn.Module``.

:class:`Decoder` holds the f32 parameters: ``embed`` (V_padded, d), one
:class:`Block` per layer (``norm1``, ``attn``, ``norm2``, ``ffn``),
``final_norm`` and, untied, ``lm_head`` (d, V_padded).  The reference
stacks its blocks for ``lax.scan`` over repeats of the block cycle; here
they are a ``ModuleList`` in layer order, and :func:`params_from_numpy` /
:func:`params_to_numpy` carry weights across (layer ``r * c + pos`` is the
reference's ``blocks.scan[pos][r]``, then ``blocks.tail`` in order).

Entry points: :func:`init_params` (the port's own initialisation, from a
``torch.Generator``, at the reference's scales) and :func:`train_loss`
(full-sequence forward + masked CE).  What this slice does not run raises
``NotImplementedError`` naming the slice that will (:func:`check_slice`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..configs.base import ArchConfig, RunConfig
from . import layers as L

# what the slice does not run, and the slice that will: cfg and run knobs
_ARCH_SLICE = (
    (lambda c: any(k == "local" for k in c.layer_kinds()),
     "'local' (sliding-window) layers", "local-window"),
    (lambda c: any(k in ("rglru", "ssd") for k in c.layer_kinds()),
     "'rglru' and 'ssd' layers", "recurrent (rglru, ssd)"),
    (lambda c: c.n_experts > 0, "experts", "experts"),
    (lambda c: c.n_enc_layers > 0 or c.family == "encdec", "an encoder",
     "encoder and frontend"),
    (lambda c: c.frontend is not None, "a modality frontend",
     "encoder and frontend"),
    (lambda c: c.family != "dense", "a family other than 'dense'",
     "non-dense family"),
)
_RUN_SLICE = (
    (lambda r: r.remat != "none", "remat", "remat and microbatch"),
    (lambda r: r.microbatch > 1, "microbatch > 1", "remat and microbatch"),
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
    architecture other than a dense "global"-attention decoder, or a run
    knob of a later slice set away from its default."""
    for test, what, slice_name in _ARCH_SLICE if cfg is not None else ():
        if test(cfg):
            later_slice(f"{cfg.name}: {what}", slice_name)
    for test, what, slice_name in _RUN_SLICE if run is not None else ():
        if test(run):
            later_slice(what, slice_name)


# ---------------------------------------------------------------------------
# the module
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm decoder block: attention then the MLP, each added to
    the residual stream."""

    def __init__(self, cfg: ArchConfig, gen, device):
        super().__init__()
        self.norm1 = L.init_norm(cfg, device)
        self.attn = L.init_attention(gen, cfg, device)
        self.norm2 = L.init_norm(cfg, device)
        self.ffn = L.init_mlp(gen, cfg, device)

    def forward(self, x, cfg: ArchConfig, run: RunConfig, positions):
        h = L.apply_norm(self.norm1, x, cfg)
        x = x + L.attention_train(self.attn, h, cfg, run, kind="global",
                                  positions=positions)
        h2 = L.apply_norm(self.norm2, x, cfg)
        return x + L.mlp(self.ffn, h2, cfg, run)


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
        self.blocks = nn.ModuleList(Block(cfg, generator, device)
                                    for _ in range(cfg.n_layers))
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


def _apply_stack(params: Decoder, x, cfg: ArchConfig, run: RunConfig,
                 positions):
    for block in params.blocks:
        x = block(x, cfg, run, positions)
    return x


def train_loss(params: Decoder, batch: dict, cfg: ArchConfig,
               run: RunConfig) -> torch.Tensor:
    """Mean next-token CE of ``batch`` (``tokens`` and ``labels``, (B, S)
    int tensors on the parameters' device) as an f32 scalar."""
    check_slice(cfg, run)
    tokens = batch["tokens"]
    x = _embed(params, tokens, cfg, run)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _apply_stack(params, x, cfg, run, positions)
    logits = _logits(params, x, cfg, run)
    return _ce_loss(logits, batch["labels"])


# ---------------------------------------------------------------------------
# weights carried across from and to the reference's parameter tree
# ---------------------------------------------------------------------------

def _cycle_info(cfg: ArchConfig):
    """(cycle length, full repeats of the cycle): the reference's scan."""
    c = len(cfg.pattern)
    return c, cfg.n_layers // c


def _block_tree(block: Block) -> dict:
    return {name: {k: p.detach().cpu().numpy() for k, p in sub.items()}
            for name, sub in (("norm1", block.norm1), ("attn", block.attn),
                              ("norm2", block.norm2), ("ffn", block.ffn))}


def params_to_numpy(cfg: ArchConfig, module: Decoder) -> dict:
    """The module's parameters as the reference's pytree of numpy arrays:
    ``blocks.scan[pos]`` stacks layer ``r * c + pos`` over the repeats ``r``
    of the block cycle, and ``blocks.tail`` holds the rest in order."""
    c, repeats = _cycle_info(cfg)
    trees = [_block_tree(b) for b in module.blocks]
    scan = None
    if repeats:
        scan = []
        for pos in range(c):
            reps = [trees[r * c + pos] for r in range(repeats)]
            scan.append({name: {k: np.stack([t[name][k] for t in reps])
                                for k in reps[0][name]} for name in reps[0]})
    tree = {"embed": module.embed.detach().cpu().numpy(),
            "final_norm": {k: p.detach().cpu().numpy()
                           for k, p in module.final_norm.items()},
            "blocks": {"scan": scan, "tail": trees[repeats * c:]}}
    if module.lm_head is not None:
        tree["lm_head"] = module.lm_head.detach().cpu().numpy()
    return tree


def params_from_numpy(cfg: ArchConfig, tree: dict, device=None) -> Decoder:
    """A :class:`Decoder` on ``device`` (``None`` means ``"cuda"``) holding
    the reference's parameter pytree ``tree`` (numpy arrays, as
    :func:`params_to_numpy` gives them)."""
    from ..core.vmp import resolve_device
    device = resolve_device(device)
    module = Decoder(cfg, None, "meta").to_empty(device=device)
    c, repeats = _cycle_info(cfg)
    blocks = [None] * cfg.n_layers
    for pos in range(c if repeats else 0):
        for r in range(repeats):
            blocks[r * c + pos] = {
                name: {k: a[r] for k, a in sub.items()}
                for name, sub in tree["blocks"]["scan"][pos].items()}
    blocks[repeats * c:] = tree["blocks"]["tail"]
    pairs = [(module.embed, tree["embed"])]
    pairs += [(p, tree["final_norm"][k]) for k, p in module.final_norm.items()]
    for block, bt in zip(module.blocks, blocks):
        for name in ("norm1", "attn", "norm2", "ffn"):
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
