"""Neural building blocks of the port's LM slice: the dense part of
``repro.models.layers``, op for op.

``init_*`` build f32 parameters as ``nn.ParameterDict``s, drawn from an
explicit ``torch.Generator`` at the reference's scales; the apply functions
take such a dict (or any mapping of tensors) and run over a full sequence.
Compute runs in the run dtype (bf16 by default): each weight is cast to it
at its use, and norms and softmax run in f32, as in the reference.

Blocks: RMS/LayerNorm (with olmo's non-parametric one), RoPE, GQA attention
(dense, flash-style chunked for long sequences, or the flash kernel) and the
SwiGLU/GEGLU/GELU MLPs.  Sliding windows, caches, experts, RG-LRU and SSD
belong to later slices.
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


def _sdpa_dense(q, k, v, *, causal: bool):
    """Dense masked attention.  q: (B,Sq,H,Dh), k/v: (B,Sk,KV,Dh)."""
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q = q.reshape(b, sq, kvh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k) / math.sqrt(dh)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores.float(), -1e30)
    else:
        scores = scores.float()
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h, dh)


def _sdpa_flash(q, k, v, *, causal: bool, chunk: int, f32_scores: bool = True):
    """Flash-style double-chunked attention for long full-attention layers:
    an outer loop over query chunks, an inner one over every kv chunk (the
    masked full scan of the reference's train path)."""
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
        for ki in range(nk):
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


def _flash_kernel_gqa(q, k, v):
    """Route GQA attention through the flash kernel: broadcast kv heads to
    query heads and flatten (B, H) into the kernel's batch dim."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    kb = k.repeat_interleave(g, dim=2)
    vb = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, s, dh)
    kf = kb.transpose(1, 2).reshape(b * h, s, dh)
    vf = vb.transpose(1, 2).reshape(b * h, s, dh)
    out = kops.flash_attention(qf, kf, vf, causal=True)
    return out.reshape(b, h, s, dh).transpose(1, 2)


def attention_train(p, x, cfg: ArchConfig, run: RunConfig, *, kind: str,
                    positions, causal: bool = True):
    """Full-sequence self-attention of a "global" layer."""
    if kind != "global":
        raise NotImplementedError(
            f"{kind!r} attention (sliding windows) belongs to a later slice "
            f"of the port; this slice runs 'global' layers")
    q, k, v = _qkv(p, x, x, cfg, run)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    s = x.shape[1]
    chunked = s > 2 * run.attn_chunk and s % run.attn_chunk == 0
    if run.flash_kernel and causal:
        out = _flash_kernel_gqa(q, k, v)
    elif chunked and causal:
        out = _sdpa_flash(q, k, v, causal=True, chunk=run.attn_chunk,
                          f32_scores=run.attn_f32_scores)
    else:
        out = _sdpa_dense(q, k, v, causal=causal)
    b, s_, h, dh = out.shape
    return out.reshape(b, s_, h * dh) @ p["wo"].to(_dtype(run))


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
