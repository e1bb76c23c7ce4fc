"""Neural building blocks of the port's LM slices: the attention,
feed-forward and recurrent parts of ``repro.models.layers``, op for op.

``init_*`` build f32 parameters as ``nn.ParameterDict``s, drawn from an
explicit ``torch.Generator`` at the reference's scales; the apply functions
take such a dict (or any mapping of tensors) and run over a full sequence.
Compute runs in the run dtype (bf16 by default): each weight is cast to it
at its use, and norms and softmax run in f32, as in the reference.

Blocks: RMS/LayerNorm (with olmo's non-parametric one), RoPE, GQA attention
(full and sliding-window: dense, flash-style chunked for long sequences, or
the flash kernel for full causal layers; one token against a decode cache,
a ring buffer of ``window`` slots for sliding-window layers; the encoder's
unmasked self-attention and the decoder's cross-attention, dense), the
SwiGLU/GEGLU/GELU MLPs and the token-choice top-k experts (``moe_mlp``,
whose dispatch and combine sum in a fixed order, so that every run is
bitwise repeatable), Griffin's RG-LRU and Mamba2's SSD (chunked over 128
tokens), each with a depthwise causal conv and a one-token decode against
its state.  The recurrences are plain tensor ops: the RG-LRU's scan is
``lax.associative_scan``'s odd/even recursion (log depth, linear work, an
autograd graph of its own), SSD's chunk states a loop over the chunks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ArchConfig, RunConfig
from ..kernels import ops as kops

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _dtype(run: RunConfig) -> torch.dtype:
    if run.dtype not in _DTYPES:
        raise ValueError(f"run dtype {run.dtype!r} not in {sorted(_DTYPES)}")
    return _DTYPES[run.dtype]


def _init(gen, shape, device, scale=None) -> nn.Parameter:
    """f32 normal draws from ``gen`` on ``device``, times ``scale``
    (``1/sqrt(fan_in)`` by default)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=gen, device=device,
                    dtype=torch.float32) * scale
    return nn.Parameter(w)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ArchConfig, device=None) -> nn.ParameterDict:
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.norm == "nonparametric":
        return nn.ParameterDict()
    if cfg.norm == "layernorm":
        return nn.ParameterDict({
            "scale": nn.Parameter(torch.ones(cfg.d_model, **f32)),
            "bias": nn.Parameter(torch.zeros(cfg.d_model, **f32))})
    return nn.ParameterDict(                                   # rmsnorm (1+s)
        {"scale": nn.Parameter(torch.zeros(cfg.d_model, **f32))})


def apply_norm(p, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + 1e-6)
        out = out * p["scale"] + p["bias"]
    else:
        out = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
        if cfg.norm != "nonparametric":
            out = out * (1.0 + p["scale"])
    return out.to(x.dtype)


def _rms_head(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """qk-norm: rmsnorm over the head dim."""
    xf = x.float()
    out = xf * torch.rsqrt((xf ** 2).mean(-1, keepdim=True) + 1e-6)
    return (out * (1.0 + scale)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) int.  Rotate-half over the
    two halves of the head dim (not interleaved)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                  # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA: dense, flash-chunked, or the flash kernel)
# ---------------------------------------------------------------------------

def init_attention(gen, cfg: ArchConfig, device) -> nn.ParameterDict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = nn.ParameterDict({
        "wq": _init(gen, (d, h * dh), device),
        "wk": _init(gen, (d, kv * dh), device),
        "wv": _init(gen, (d, kv * dh), device),
        "wo": _init(gen, (h * dh, d), device, scale=1.0 / math.sqrt(h * dh))})
    if cfg.qk_norm:
        f32 = dict(dtype=torch.float32, device=device)
        p["q_scale"] = nn.Parameter(torch.zeros(dh, **f32))
        p["k_scale"] = nn.Parameter(torch.zeros(dh, **f32))
    return p


def _qkv(p, xq, xkv, cfg: ArchConfig, run: RunConfig):
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    dt = _dtype(run)
    q = (xq @ p["wq"].to(dt)).reshape(*xq.shape[:-1], h, dh)
    k = (xkv @ p["wk"].to(dt)).reshape(*xkv.shape[:-1], kv, dh)
    v = (xkv @ p["wv"].to(dt)).reshape(*xkv.shape[:-1], kv, dh)
    if cfg.qk_norm:
        q = _rms_head(q, p["q_scale"])
        k = _rms_head(k, p["k_scale"])
    return q, k, v


def _sdpa_dense(q, k, v, *, causal: bool, window: int = 0, q_pos0: int = 0,
                kv_pos0: int = 0):
    """Dense masked attention.  q: (B,Sq,H,Dh), k/v: (B,Sk,KV,Dh); query
    ``i`` sits at position ``q_pos0 + i`` and key ``j`` at ``kv_pos0 + j``
    (negative: left padding, masked under ``causal``); ``window`` keeps the
    keys within ``window - 1`` positions before each query."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q = q.reshape(b, sq, kvh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k) / math.sqrt(dh)
    qi = q_pos0 + torch.arange(sq, device=q.device)[:, None]
    ki = kv_pos0 + torch.arange(sk, device=q.device)[None, :]
    mask = None
    if causal:
        mask = (ki <= qi) & (ki >= 0)
    if window:
        mask = ki > qi - window if mask is None else mask & (ki > qi - window)
    scores = scores.float() if mask is None else \
        torch.where(mask, scores.float(), -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h, dh)


def _sdpa_flash(q, k, v, *, causal: bool, chunk: int, dynamic_skip: bool = False,
                f32_scores: bool = True):
    """Flash-style double-chunked attention for long full-attention layers:
    an outer loop over query chunks, an inner one over the kv chunks.  The
    train path scans every kv chunk under the mask, as the reference's
    does; ``dynamic_skip`` (forward-only, prefill) stops each query chunk's
    scan at the last kv chunk its causal mask reaches, the triangular
    ~S^2/2 of the work."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    cq = ck = min(chunk, s)
    nq, nk = s // cq, s // ck
    qc = q.reshape(b, nq, cq, kvh, g, dh)
    kc = k.reshape(b, nk, ck, kvh, dh)
    vc = v.reshape(b, nk, ck, kvh, dh)
    scale = 1.0 / math.sqrt(dh)
    sdt = torch.float32 if f32_scores else q.dtype
    f32 = dict(dtype=torch.float32, device=q.device)
    outs = []
    for qi in range(nq):
        qb = qc[:, qi]                                # (b, cq, kvh, g, dh)
        m = torch.full((b, kvh, g, cq), -1e30, **f32)
        l = torch.zeros((b, kvh, g, cq), **f32)
        acc = torch.zeros((b, kvh, g, cq, dh), **f32)
        n_blocks = min(-(-(qi + 1) * cq // ck), nk) if dynamic_skip and causal \
            else nk
        for ki in range(n_blocks):
            kb, vb = kc[:, ki], vc[:, ki]
            # bf16 score blocks halve their traffic; max and sum stay f32
            sc = torch.einsum("bqkgd,bskd->bkgqs", qb, kb).to(sdt) * \
                torch.tensor(scale, dtype=sdt, device=q.device)
            if causal:
                qpos = qi * cq + torch.arange(cq, device=q.device)[:, None]
                kpos = ki * ck + torch.arange(ck, device=q.device)[None, :]
                sc = torch.where(kpos <= qpos, sc,
                                 torch.tensor(-1e30, dtype=sdt, device=q.device))
            m_new = torch.maximum(m, sc.amax(-1).float())
            p = torch.exp(sc - m_new[..., None].to(sdt))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1, dtype=torch.float32)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vb.dtype), vb).float()
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))       # (b, cq, kvh, g, dh)
    out = torch.stack(outs, dim=1).reshape(b, s, h, dh)
    return out.to(q.dtype)


def _sdpa_window(q, k, v, *, window: int, chunk: int):
    """Sliding-window attention over a long sequence: each query chunk sees
    the statically sized kv slice [chunk start - window, chunk end) of k/v
    padded on the left by ``window``: O(S * W)."""
    b, s, h, dh = q.shape
    cq = min(chunk, s)
    span = window + cq
    kp = F.pad(k, (0, 0, 0, 0, window, 0))
    vp = F.pad(v, (0, 0, 0, 0, window, 0))
    outs = []
    for start in range(0, s, cq):
        # query t sits at start + t, kv slice entry j at start + j - window
        # (negative: the left padding, masked by _sdpa_dense's ki >= 0)
        outs.append(_sdpa_dense(q[:, start:start + cq],
                                kp[:, start:start + span],
                                vp[:, start:start + span], causal=True,
                                window=window, q_pos0=start,
                                kv_pos0=start - window))
    return torch.cat(outs, dim=1)


def _flash_kernel_gqa(q, k, v):
    """Route GQA attention through the flash kernel: broadcast kv heads to
    query heads and flatten (B, H) into the kernel's batch dim, contiguous
    as the kernel takes it (at B = 1 the reshape alone is a strided
    view)."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    kb = k.repeat_interleave(g, dim=2)
    vb = v.repeat_interleave(g, dim=2)
    qf, kf, vf = (t.transpose(1, 2).reshape(b * h, s, dh).contiguous()
                  for t in (q, kb, vb))
    out = kops.flash_attention(qf, kf, vf, causal=True)
    return out.reshape(b, h, s, dh).transpose(1, 2)


def attention_train(p, x, cfg: ArchConfig, run: RunConfig, *, kind: str,
                    positions, causal: bool = True, enc=None):
    """Full-sequence self-attention of a "global" or "local" (sliding
    window) layer, by the reference's route order: the flash kernel for
    full causal layers when ``run.flash_kernel``, then the windowed or the
    flash-style chunks for long sequences, else dense.  ``enc`` (B, S_enc,
    d) makes it cross-attention: queries from ``x``, keys and values from
    ``enc``, no RoPE, dense and unmasked.  A non-causal self-attention (the
    encoder's) is dense too, whatever its length."""
    xkv = enc if enc is not None else x
    q, k, v = _qkv(p, x, xkv, cfg, run)
    if enc is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    window = cfg.window if kind == "local" else 0
    chunked = s > 2 * run.attn_chunk and s % run.attn_chunk == 0
    if enc is not None:
        out = _sdpa_dense(q, k, v, causal=False)
    elif run.flash_kernel and causal and not window:
        out = _flash_kernel_gqa(q, k, v)
    elif window and chunked:
        out = _sdpa_window(q, k, v, window=window, chunk=run.attn_chunk)
    elif chunked and causal:
        out = _sdpa_flash(q, k, v, causal=True, chunk=run.attn_chunk,
                          f32_scores=run.attn_f32_scores)
    else:
        out = _sdpa_dense(q, k, v, causal=causal, window=window)
    b, s_, h, dh = out.shape
    return out.reshape(b, s_, h * dh) @ p["wo"].to(_dtype(run))


def init_attn_cache(cfg: ArchConfig, run: RunConfig, batch: int, max_len: int,
                    kind: str, device=None) -> dict:
    """A zeroed decode cache ``{"k", "v"}`` of (batch, KV, length, Dh) in
    the run dtype: a "global" layer holds ``max_len`` positions, a "local"
    one a ring of ``min(max_len, window)`` slots.  Head-major, so that the
    decode's products read it in place; the reference's (batch, length,
    KV, Dh) would be permuted into this layout by every step."""
    length = min(max_len, cfg.window) if kind == "local" else max_len
    shape = (batch, cfg.n_kv_heads, length, cfg.head_dim_)
    dt = _dtype(run)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def attention_decode(p, x, cache: dict, pos: int, cfg: ArchConfig,
                     run: RunConfig, *, kind: str):
    """One token ``x`` (B, 1, d) at position ``pos`` against ``cache``:
    its K/V written in place at slot ``pos`` ("global") or ``pos % length``
    (the "local" ring), then attention over the valid slots.  Returns
    ``(y (B, 1, d), cache)``.  A "global" cache has no slot past its
    length, and a "local" ring shorter than the window would overwrite keys
    still inside it: either way ``pos >= length`` raises ``IndexError``
    (the reference's ``dynamic_update_slice`` clamps a global write onto
    the last slot, and its ring wraps early)."""
    length = cache["k"].shape[2]
    if kind != "local" and not 0 <= pos < length:
        raise IndexError(f"decode position {pos} outside the {length} "
                         f"positions of a global layer's cache")
    if kind == "local" and length < cfg.window and not 0 <= pos < length:
        raise IndexError(f"decode position {pos} outside the {length} "
                         f"slots of a local layer's ring, shorter than its "
                         f"window of {cfg.window}")
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, x, x, cfg, run)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    slot = pos % length if kind == "local" else pos
    cache["k"][:, :, slot] = k[:, 0]
    cache["v"][:, :, slot] = v[:, 0]

    b, _, h, dh = q.shape
    kvh = cache["k"].shape[1]
    qh = q.reshape(b, kvh, h // kvh, dh)
    scores = (qh @ cache["k"].transpose(-1, -2)) / math.sqrt(dh)
    idx = torch.arange(length, device=x.device)
    if kind == "local":
        # ring slot s holds time t = pos - ((pos - s) mod length)
        t = pos - torch.remainder(pos - idx, length)
        valid = (t >= 0) & (t <= pos)
    else:
        valid = idx <= pos
    scores = torch.where(valid, scores.float(), -1e30)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = (w @ cache["v"]).reshape(b, 1, h * dh)
    return out @ p["wo"].to(_dtype(run)), cache


def cross_attention_decode(p, x, enc_cache: dict, cfg: ArchConfig,
                           run: RunConfig) -> torch.Tensor:
    """One token ``x`` (B, 1, d) against the encoder's K/V ``enc_cache``
    (``{"k", "v"}`` of (B, KV, S_enc, Dh), head-major): ``y (B, 1, d)``.
    No qk-norm, no RoPE and no mask, as the reference's."""
    dt = _dtype(run)
    h, dh, kvh = cfg.n_heads, cfg.head_dim_, cfg.n_kv_heads
    b = x.shape[0]
    q = (x @ p["wq"].to(dt)).reshape(b, kvh, h // kvh, dh)
    scores = (q @ enc_cache["k"].transpose(-1, -2)) / math.sqrt(dh)
    w = torch.softmax(scores.float(), dim=-1).to(dt)
    out = (w @ enc_cache["v"]).reshape(b, 1, h * dh)
    return out @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg: ArchConfig, device) -> nn.ParameterDict:
    d, f = cfg.d_model, cfg.d_ff
    gated = cfg.act in ("swiglu", "geglu")
    return nn.ParameterDict({
        "wi": _init(gen, (d, 2 * f if gated else f), device),
        "wo": _init(gen, (f, d), device)})


def _act(h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.act == "swiglu":
        a, b = torch.chunk(h, 2, dim=-1)
        return F.silu(a) * b
    if cfg.act == "geglu":
        a, b = torch.chunk(h, 2, dim=-1)
        return F.gelu(a, approximate="tanh") * b
    return F.gelu(h, approximate="tanh")        # jax.nn.gelu's default


def mlp(p, x: torch.Tensor, cfg: ArchConfig, run: RunConfig) -> torch.Tensor:
    dt = _dtype(run)
    h = _act(x @ p["wi"].to(dt), cfg)
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# experts (token-choice top-k, sort-based dispatch, static capacity)
# ---------------------------------------------------------------------------

def init_moe(gen, cfg: ArchConfig, device) -> nn.ParameterDict:
    """``router`` (d, E), ``wi`` (E, d, 2f or f) and ``wo`` (E, f, d), each
    at the reference's 1/sqrt(shape[0])."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    gated = cfg.act in ("swiglu", "geglu")
    return nn.ParameterDict({
        "router": _init(gen, (d, e), device),
        "wi": _init(gen, (e, d, 2 * f if gated else f), device),
        "wo": _init(gen, (e, f, d), device)})


def _route_from_logits(logits: torch.Tensor, k: int, cap: int):
    """The reference's routing of one group from its router logits (n, E)
    f32: ``(take (E, cap), w_slot (E, cap) f32, inv (n, k))``.

    Top-k by a stable descending sort (a tie goes to the lower expert, as
    ``lax.top_k`` breaks it; ``torch.topk`` does not promise that), a
    softmax over the k selected logits, then a stable sort of the flattened
    expert ids: an assignment keeps its place ``pos`` among its expert's
    assignments in token order, and ``pos < cap`` keeps it in slot
    ``e * cap + pos``.  ``take`` names each slot's token (``n``, the zero
    pad row, when empty) and ``w_slot`` its weight (0 when empty).
    ``inv`` is the port's inverse map: each token's k slots in slot order,
    which is expert order, ``E * cap`` for a dropped assignment."""
    n, e = logits.shape
    dev = logits.device
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    top_w = torch.softmax(vals[:, :k], dim=-1)
    flat_e = ids[:, :k].reshape(-1)
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)
    se, order = torch.sort(flat_e, stable=True)
    st, sw = flat_t[order], top_w.reshape(-1)[order]
    offsets = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(n * k, device=dev) - offsets[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)     # overflow slot
    take = torch.full((e * cap + 1,), n, dtype=torch.int64,
                      device=dev).index_put((slot,), st)
    w_slot = torch.zeros(e * cap + 1, dtype=torch.float32,
                         device=dev).index_put((slot,), sw * keep)
    inv = torch.empty_like(slot).index_put((order,), slot)
    inv = torch.sort(inv.view(n, k), dim=-1).values
    return (take[:e * cap].view(e, cap), w_slot[:e * cap].view(e, cap),
            inv)


def _moe_route(xt: torch.Tensor, router: torch.Tensor, k: int, cap: int,
               dt: torch.dtype):
    """Routing for one group, as the reference's: ``xt`` (n, d) through
    the router in ``dt``, the logits in f32, then
    :func:`_route_from_logits`: ``(take, w_slot, inv)``."""
    return _route_from_logits((xt @ router.to(dt)).float(), k, cap)


def _ordered_sum(rows: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """``out[g, t] = rows[g, inv[g, t, 0]] + rows[g, inv[g, t, 1]] + ...``,
    added from zero in that order in ``rows``' dtype; the index ``M``
    (``rows.shape[1]``) reads a zero row.  rows (G, M, d), inv (G, n, k).
    A fixed order and no atomics: the same bits on every run."""
    g, _, d = rows.shape
    rows = torch.cat([rows, rows.new_zeros(g, 1, d)], dim=1)
    gidx = torch.arange(g, device=rows.device)[:, None]
    out = rows.new_zeros(g, inv.shape[1], d)
    for j in range(inv.shape[2]):
        out = out + rows[gidx, inv[..., j]]
    return out


class _Dispatch(torch.autograd.Function):
    """``hb[g, e, c] = xt[g, take[g, e, c]]``, the token ``n`` a zero pad
    row (the reference's ``xt_pad[gidx, take]``).  Its backward gives each
    token the sum of its slots' gradients in slot order
    (:func:`_ordered_sum`), where a scatter-add would use atomics."""

    @staticmethod
    def forward(ctx, xt, take, inv):
        g, _, d = xt.shape
        ctx.save_for_backward(inv)
        xt_pad = torch.cat([xt, xt.new_zeros(g, 1, d)], dim=1)
        gidx = torch.arange(g, device=xt.device)[:, None, None]
        return xt_pad[gidx, take]

    @staticmethod
    def backward(ctx, grad):
        inv, = ctx.saved_tensors
        g, e, c, d = grad.shape
        return _ordered_sum(grad.reshape(g, e * c, d), inv), None, None


class _Combine(torch.autograd.Function):
    """``out[g, t]``: the sum of token ``t``'s slot contributions in slot
    order, from zero, in their dtype (the reference's
    ``zeros(dt).at[gidx, take].add(contrib)``, whose scatter adds them in
    that order); an empty or dropped slot adds nothing.  Its backward is
    the gather ``grad[g, take[g, e, c]]``, 0 for an empty slot."""

    @staticmethod
    def forward(ctx, contrib, take, inv):
        g, e, c, d = contrib.shape
        ctx.save_for_backward(take)
        return _ordered_sum(contrib.reshape(g, e * c, d), inv)

    @staticmethod
    def backward(ctx, grad):
        take, = ctx.saved_tensors
        g, _, d = grad.shape
        pad = torch.cat([grad, grad.new_zeros(g, 1, d)], dim=1)
        gidx = torch.arange(g, device=grad.device)[:, None, None]
        return pad[gidx, take], None, None


def moe_mlp(p, x: torch.Tensor, cfg: ArchConfig, run: RunConfig):
    """x (B, S, d) -> (B, S, d): each token's top-k experts by the router,
    softmax weights over the selected ones (qwen3-style), a gather-based
    dispatch into each expert's ``cap`` slots, the expert products as
    batched matmuls over the expert dimension, and the weighted combine.

    ``run.moe_groups > 1`` routes each group of tokens on its own (when
    the groups divide the tokens), with its own capacity of
    ``ceil(n/groups * k / E * run.moe_capacity)`` slots an expert.  The
    reference's sharding constraints (``sharding_ctx.constrain``,
    ``run.moe_ep_local``) place its buffers on a mesh and change no value;
    on one device they change nothing there, and the port has no
    counterpart to them.  The dispatch's backward and the combine sum in
    slot order (``_Dispatch``, ``_Combine``), so that a step run twice
    gives the same bits."""
    dt = _dtype(run)
    b, s, d = x.shape
    n = b * s
    e, k = cfg.n_experts, cfg.experts_per_tok
    g = run.moe_groups if run.moe_groups and n % run.moe_groups == 0 else 1
    cap = max(1, int(math.ceil(n // g * k / e * run.moe_capacity)))
    xt = x.reshape(g, n // g, d)
    take, w_slot, inv = (torch.stack(t) for t in zip(*[
        _moe_route(xt[i], p["router"], k, cap, dt) for i in range(g)]))
    hb = _Dispatch.apply(xt, take, inv)                 # (G, E, C, d)
    h = _act(torch.einsum("gecd,edf->gecf", hb, p["wi"].to(dt)), cfg)
    yb = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))
    contrib = yb * w_slot[..., None].to(dt)
    return _Combine.apply(contrib, take, inv).reshape(b, s, d)


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma / Griffin)
# ---------------------------------------------------------------------------

def init_rglru(gen, cfg: ArchConfig, device) -> nn.ParameterDict:
    """``wx``, ``wgate`` (d, L), ``conv`` (W, L) at 0.5, ``wr``, ``wi``
    (L, L), ``lam`` (L,) at 0.5 and ``wo`` (L, d); L = ``cfg.d_inner``."""
    d, width = cfg.d_model, cfg.d_inner
    return nn.ParameterDict({
        "wx": _init(gen, (d, width), device),
        "wgate": _init(gen, (d, width), device),
        "conv": _init(gen, (cfg.ssm_conv, width), device, scale=0.5),
        "wr": _init(gen, (width, width), device),
        "wi": _init(gen, (width, width), device),
        "lam": nn.Parameter(torch.full((width,), 0.5, dtype=torch.float32,
                                       device=device)),
        "wo": _init(gen, (width, d), device)})


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv over time in ``x``'s dtype.  x: (B, S, C), w:
    (W, C): ``(y, None)``, the taps summed in order i = 0 .. W-1.  With
    ``state`` (B, W-1, C), the inputs before ``x``: one decode step,
    ``(y (B, 1, C), the new state)``."""
    wdt = w.to(x.dtype)
    if state is not None:
        xin = torch.cat([state, x], dim=1)                     # (B, W, C)
        y = (xin * wdt[None]).sum(dim=1, keepdim=True)
        return y, xin[:, 1:]
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    y = xp[:, :s] * wdt[0]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * wdt[i]
    return y, None


def _combine(a1, b1, a2, b2):
    """The RG-LRU's pair (a, b) after (a1, b1) then (a2, b2):
    ``h -> a2 (a1 h + b1) + b2``."""
    return a1 * a2, a2 * b1 + b2


def _scan_pairs(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of the pairs (a, b) along dim 1 under
    :func:`_combine`, by ``lax.associative_scan``'s recursion: combine
    adjacent pairs, scan the half, then fill in the even places.  Depth
    2 log2(S), linear work; elementwise ops only, so every run gives the
    same bits."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _scan_pairs(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea, eb = torch.cat([a[:, :1], ea], 1), torch.cat([b[:, :1], eb], 1)

    def interleave(even, odd):
        if odd.shape[1] < even.shape[1]:
            odd = torch.cat([odd, even[:, -1:]], 1)        # cut off below
        return torch.stack([even, odd], 2).flatten(1, 2)[:, :n]
    return interleave(ea, oa), interleave(eb, ob)


def _rglru_gates(xf, r, i, lam):
    """``(a, b)`` of ``h_t = a_t h_{t-1} + b_t``: ``a = exp(-8 softplus(lam)
    r)``, ``b = sqrt(max(1 - a^2, 1e-12)) (i x)``, in f32."""
    log_a = -8.0 * F.softplus(lam) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * \
        (i * xf)
    return a, b


def _rglru_core(xf, r, i, lam):
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t) from h_{-1} = 0, over
    (B, S, L) f32."""
    return _scan_pairs(*_rglru_gates(xf, r, i, lam))[1]


def _rglru_inputs(p, x, run: RunConfig):
    """What the scan reads over a sequence: ``(the pre-conv inputs (B, S,
    L), gate, and the f32 x, r, i of :func:`_rglru_core`)``."""
    dt = _dtype(run)
    xb_pre = x @ p["wx"].to(dt)
    xb, _ = _causal_conv(xb_pre, p["conv"])
    gate = F.gelu(x @ p["wgate"].to(dt), approximate="tanh")
    xf = xb.float()
    r = torch.sigmoid(xf @ p["wr"])
    i = torch.sigmoid(xf @ p["wi"])
    return xb_pre, gate, xf, r, i


def _rglru_forward(p, x, cfg: ArchConfig, run: RunConfig):
    """The RG-LRU over a sequence: ``(y (B, S, d), h (B, S, L) f32, the
    pre-conv inputs (B, S, L))``."""
    dt = _dtype(run)
    xb_pre, gate, xf, r, i = _rglru_inputs(p, x, run)
    h = _rglru_core(xf, r, i, p["lam"])
    y = (gate.float() * h).to(dt) @ p["wo"].to(dt)
    return y, h, xb_pre


def rglru_train(p, x, cfg: ArchConfig, run: RunConfig) -> torch.Tensor:
    return _rglru_forward(p, x, cfg, run)[0]


def init_rglru_cache(cfg: ArchConfig, run: RunConfig, batch: int,
                     device=None) -> dict:
    """``{"h": (B, L) f32, "conv": (B, W-1, L)}`` zeros, the conv state in
    the run dtype."""
    width = cfg.d_inner
    return {"h": torch.zeros((batch, width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, width),
                                dtype=_dtype(run), device=device)}


def rglru_decode(p, x, cache: dict, cfg: ArchConfig, run: RunConfig):
    """One token ``x`` (B, 1, d) against ``cache``, which takes the new
    state in place: ``(y (B, 1, d), cache)``."""
    dt = _dtype(run)
    xb = x @ p["wx"].to(dt)                                   # (B, 1, L)
    xb, conv_state = _causal_conv(xb, p["conv"], cache["conv"])
    gate = F.gelu(x @ p["wgate"].to(dt), approximate="tanh")
    xf = xb[:, 0].float()
    r = torch.sigmoid(xf @ p["wr"])
    i = torch.sigmoid(xf @ p["wi"])
    a, b = _rglru_gates(xf, r, i, p["lam"])
    h = a * cache["h"] + b
    y = (gate[:, 0].float() * h).to(dt) @ p["wo"].to(dt)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return y[:, None], cache


# ---------------------------------------------------------------------------
# Mamba2 SSD block (chunked state-space dual form)
# ---------------------------------------------------------------------------

SSD_CHUNK = 128


def init_ssd(gen, cfg: ArchConfig, device) -> nn.ParameterDict:
    """``in_proj`` (d, 2 d_inner + 2 N + H), ``conv`` (W, d_inner + 2 N) at
    0.5, ``a_log`` 0, ``d_skip`` 1, ``dt_bias`` 0 (H,) and ``out_proj``
    (d_inner, d)."""
    d, din, nst, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    f32 = dict(dtype=torch.float32, device=device)
    return nn.ParameterDict({
        "in_proj": _init(gen, (d, 2 * din + 2 * nst + nh), device),
        "conv": _init(gen, (cfg.ssm_conv, din + 2 * nst), device, scale=0.5),
        "a_log": nn.Parameter(torch.zeros(nh, **f32)),
        "d_skip": nn.Parameter(torch.ones(nh, **f32)),
        "dt_bias": nn.Parameter(torch.zeros(nh, **f32)),
        "out_proj": _init(gen, (din, d), device)})


def _ssd_split(p, x, cfg: ArchConfig, run: RunConfig):
    """``(z, xBC, dt)`` of the input projection, in the run dtype."""
    din, nst = cfg.d_inner, cfg.ssm_state
    zxbcdt = x @ p["in_proj"].to(_dtype(run))
    return (zxbcdt[..., :din], zxbcdt[..., din:2 * din + 2 * nst],
            zxbcdt[..., 2 * din + 2 * nst:])


def _ssd_forward(p, x, cfg: ArchConfig, run: RunConfig):
    """Chunked SSD over a sequence: ``(y (B, S, d), the final state (B, H,
    N, P) f32, the pre-conv xBC (B, S, d_inner + 2N))``.

    Within a chunk the quadratic form ``Y_i = sum_{j <= i} C_i.B_j
    exp(cum_i - cum_j) x_j dt_j``, with ``exp`` taken after the entries
    above the diagonal are set to -inf: their decay is positive and
    overflows f32 at full width, and the reference's ``where`` after the
    ``exp`` gives the same values but a backward of 0 * inf.  Across chunks
    ``H_c = exp(tot_c) H_{c-1} + S_c`` in a loop over the chunks.  A
    sequence longer than ``SSD_CHUNK`` and not a multiple of it raises
    ``ValueError``, where the reference's reshape fails."""
    dt_ = _dtype(run)
    b, s, _ = x.shape
    din, nst, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    q = min(SSD_CHUNK, s)
    if s % q:
        raise ValueError(f"SSD runs in chunks of {SSD_CHUNK} tokens: a "
                         f"sequence of {s} is neither at most one "
                         f"{SSD_CHUNK}-token chunk nor a multiple of it")
    nc = s // q
    z, xbc_pre, dtr = _ssd_split(p, x, cfg, run)
    xbc, _ = _causal_conv(xbc_pre, p["conv"])
    xs = xbc[..., :din]
    b_c = xbc[..., din:din + nst].float().reshape(b, nc, q, nst)
    c_c = xbc[..., din + nst:].float().reshape(b, nc, q, nst)
    dt = F.softplus(dtr.float() + p["dt_bias"])                # (B, S, H)
    da = dt * -torch.exp(p["a_log"])
    xh = xs.reshape(b, s, nh, hp).float()
    xdt_c = (xh * dt[..., None]).reshape(b, nc, q, nh, hp)
    cum = torch.cumsum(da.reshape(b, nc, q, nh), dim=2)       # (B, nc, q, H)
    tot = cum[:, :, -1]                                       # (B, nc, H)

    # intra-chunk, head-major: (B, nc, H, q, q) weights on (B, nc, H, q, P)
    cum_h = cum.transpose(2, 3)
    decay = cum_h[..., :, None] - cum_h[..., None, :]
    causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    att = c_c @ b_c.transpose(-1, -2)                         # (B, nc, q, q)
    w = torch.exp(decay.masked_fill(~causal, float("-inf"))) * att[:, :, None]
    y_intra = (w @ xdt_c.permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)

    # chunk states S_c = sum_j exp(tot - cum_j) B_j (x_j dt_j)^T
    xw = torch.exp(tot[:, :, None] - cum)[..., None] * xdt_c  # (B,nc,q,H,P)
    states = torch.einsum("bcjn,bcjhp->bchnp", b_c, xw)

    # inter-chunk: H_c = exp(tot_c) H_{c-1} + S_c, each chunk reading H_{c-1}
    h = torch.zeros((b, nh, nst, hp), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * torch.exp(tot[:, c])[..., None, None] + states[:, c]
    h_prev = torch.stack(h_prev, 1)                           # (B,nc,H,N,P)
    y_inter = torch.einsum("bcin,bchnp->bcihp", c_c, h_prev) * \
        torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(b, s, nh, hp) + p["d_skip"][:, None] * xh
    y = (y.reshape(b, s, din) * F.silu(z.float())).to(dt_)
    return y @ p["out_proj"].to(dt_), h, xbc_pre


def ssd_train(p, x, cfg: ArchConfig, run: RunConfig) -> torch.Tensor:
    return _ssd_forward(p, x, cfg, run)[0]


def init_ssd_cache(cfg: ArchConfig, run: RunConfig, batch: int,
                   device=None) -> dict:
    """``{"conv": (B, W-1, d_inner + 2N) in the run dtype, "h": (B, H, N,
    P) f32}`` zeros."""
    return {"conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state),
                                dtype=_dtype(run), device=device),
            "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device)}


def ssd_decode(p, x, cache: dict, cfg: ArchConfig, run: RunConfig):
    """One token ``x`` (B, 1, d) against ``cache``, which takes the new
    state in place: ``(y (B, 1, d), cache)``."""
    dt_ = _dtype(run)
    b = x.shape[0]
    din, nst, nh, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xbc, dtr = _ssd_split(p, x, cfg, run)
    xbc, conv_state = _causal_conv(xbc, p["conv"], cache["conv"])
    xs = xbc[:, 0, :din].reshape(b, nh, hp).float()
    bvec = xbc[:, 0, din:din + nst].float()
    cvec = xbc[:, 0, din + nst:].float()
    dt = F.softplus(dtr[:, 0].float() + p["dt_bias"])         # (B, H)
    da = torch.exp(dt * -torch.exp(p["a_log"]))
    xh = xs * dt[..., None]
    h = cache["h"] * da[..., None, None] + bvec[:, None, :, None] * \
        xh[:, :, None, :]
    y = (cvec[:, None, None, :] @ h)[:, :, 0]                 # (B, H, P)
    y = y + p["d_skip"][None, :, None] * xs
    y = y.reshape(b, din) * F.silu(z[:, 0].float())
    y = y.to(dt_) @ p["out_proj"].to(dt_)
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return y[:, None], cache
