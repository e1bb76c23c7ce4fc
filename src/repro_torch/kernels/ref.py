"""Plain PyTorch versions of every kernel in this package.

These are the semantics, ported from ``repro.kernels.ref``: the CUDA and
Triton kernels must match them (``chip_smoke.py`` compares them on the card
at the main path's shapes), and on the CPU the dispatch layer in ``ops.py``
runs them in place of the kernels.  They repeat the kernels' arithmetic;
they are no yardstick of speed.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


def dirichlet_expectation(alpha: torch.Tensor) -> torch.Tensor:
    """E[log theta] rowwise: digamma(a) - digamma(a.sum(-1))."""
    return torch.special.digamma(alpha) - torch.special.digamma(
        alpha.sum(dim=-1, keepdim=True))


def dirichlet_elbo_term(prior: torch.Tensor, post: torch.Tensor,
                        elog: torch.Tensor) -> torch.Tensor:
    """A Dirichlet's ELBO term, ``E_q[log p(theta)] - E_q[log q(theta)]``
    summed over the rows of ``post``, against a prior that broadcasts
    against it and its Elog table, a 0-d tensor: the rows' log-normalizers
    ``sum lgamma(a) - lgamma(sum a)`` of the posterior less the prior's,
    plus ``sum (prior - post) * elog`` (``core.dists.dirichlet_elbo_term``
    is this function)."""
    prior = torch.broadcast_to(prior, post.shape)
    term = (torch.lgamma(post).sum(dim=-1) - torch.lgamma(post.sum(dim=-1))
            - (torch.lgamma(prior).sum(dim=-1)
               - torch.lgamma(prior.sum(dim=-1))))
    term = term + ((prior - post) * elog).sum(dim=-1)
    return term.sum()


def dirichlet_update(prior: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """A Dirichlet's posterior update ``prior + stats``, the prior row
    broadcast over the rows of ``stats``."""
    return prior * torch.ones_like(stats) + stats


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Plain version of the flash kernel: dense masked attention.
    q: (BH, Sq, Dh); k/v: (BH, Sk, Dh).  Scores in f32, masked with -1e30
    where ``kpos > qpos`` (both counted from 0), the result in q's dtype."""
    dh = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(dh)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.arange(sk, device=q.device)[None, :] <= \
            torch.arange(sq, device=q.device)[:, None]
        s = torch.where(mask, s, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)


def zstep(logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused responsibility update: (softmax(logits), logsumexp(logits)).

    The logsumexp is the per-instance ELBO contribution of a latent at its
    coordinate optimum (see core/vmp.py).
    """
    m = logits.max(dim=-1, keepdim=True).values
    e = torch.exp(logits - m)
    s = e.sum(dim=-1, keepdim=True)
    return e / s, (m + torch.log(s))[..., 0]


# ---------------------------------------------------------------------------
# fused token-plate substep: gather -> softmax -> sufficient statistics
# ---------------------------------------------------------------------------

class ZChild(NamedTuple):
    """Kernel-level view of one observed child factor of a latent selector.

    The parent Dirichlet row of token ``i`` under topic ``k`` is
    ``base[i] + stride * k`` (``base is None`` means all-zero; ``base is None
    and stride == 1`` is the specialized LDA fast path where the row IS the
    selector value).  ``zmap`` maps tokens to latent instances when the token
    plate is nested below the latent plate (SLDA); ``None`` means identity.
    ``elog`` holds the parent's message table: E[log theta] values under
    ``zstats(..., tables="elog")``, or the Dirichlet posterior
    concentrations under ``tables="alpha"``.
    """
    elog: torch.Tensor                    # (G_f, K_f) parent message table
    values: torch.Tensor                  # (Nt,) observed category per token
    stride: int = 1
    zmap: Optional[torch.Tensor] = None   # (Nt,) token -> latent instance
    base: Optional[torch.Tensor] = None   # (Nt,) static row base
    mask: Optional[torch.Tensor] = None   # (Nt,) 1.0/0.0 token validity

    @property
    def specialized(self) -> bool:
        """LDA fast path: the Dirichlet row IS the selector value (mirrors
        ``compiler.ChildFactor.specialized``)."""
        return self.base is None and self.stride == 1


ZSTATS_CHUNK = 32768                   # token rows per chunk


def _rows(child: ZChild, base, k: int) -> torch.Tensor:
    """(n, k) int64 parent rows ``base + stride * kk`` of a strided child."""
    kk = torch.arange(k, dtype=torch.int64, device=child.elog.device)
    b = base.long()[:, None] if base is not None else 0
    return b + child.stride * kk[None, :]


def _child_messages(child: ZChild, vals, base, mask, k: int) -> torch.Tensor:
    """Per-token Elog message rows of one child factor -> (n, k) f32."""
    if child.specialized:
        e = child.elog[:, vals.long()].T
    else:
        e = child.elog[_rows(child, base, k), vals.long()[:, None]]
    e = e.float()
    if mask is not None:
        e = e * mask[:, None]
    return e


def _child_stats_native(child: ZChild, acc, w, vals, base, mask,
                        k: int) -> torch.Tensor:
    """Accumulate one chunk's responsibility-weighted counts into ``acc``.

    Specialized children accumulate in the scatter-native (K_f, G_f) layout
    — i.e. (V, K) for LDA — so the per-chunk loop is a plain row scatter;
    the single transpose to the Dirichlet's (G_f, K_f) layout happens once,
    in :func:`_child_stats_finish`.
    """
    if mask is not None:
        w = w * mask[:, None]
    gf, kf = child.elog.shape
    if child.specialized:
        return acc.index_add_(0, vals.long(), w)       # (kf, gf) native
    flat = _rows(child, base, k) * kf + vals.long()[:, None]
    acc.view(-1).index_add_(0, flat.reshape(-1), w.reshape(-1))
    return acc


def _child_stats_init(child: ZChild) -> torch.Tensor:
    gf, kf = child.elog.shape
    shape = (kf, gf) if child.specialized else (gf, kf)
    return torch.zeros(shape, dtype=torch.float32, device=child.elog.device)


def _child_stats_finish(child: ZChild, acc: torch.Tensor) -> torch.Tensor:
    if child.specialized:
        return acc.T.contiguous()
    return acc


def _scan_chunks(xs: dict, n: int, chunk: int, init, body):
    """Fold ``body(carry, xs_chunk)`` over ``chunk``-sized row slices of every
    tensor in ``xs``, in order; the last chunk holds the remainder rows.
    Single-chunk inputs run ``body`` once over everything."""
    carry = init
    for lo in range(0, max(n, 1), chunk):
        carry = body(carry, {name: a[lo:lo + chunk] for name, a in xs.items()})
    return carry


def _token_xs(child: ZChild, i: int) -> dict:
    xs = {f"values{i}": child.values}
    if child.zmap is not None:
        xs[f"zmap{i}"] = child.zmap
    if child.base is not None:
        xs[f"base{i}"] = child.base
    if child.mask is not None:
        xs[f"mask{i}"] = child.mask
    return xs


def zstats(elog_prior: torch.Tensor, prior_rows: torch.Tensor,
           children: tuple, zmask: Optional[torch.Tensor] = None,
           chunk: int = ZSTATS_CHUNK, *, tables: str = "elog"):
    """Fused z-substep semantics: one streaming pass over the token plate.

    Computes, without materializing the (N, K) responsibilities or logits
    beyond one chunk at a time:

        logits_i = elog_prior[prior_rows[i]] + sum_f message_f(i)
        r_i, lse_i = softmax/logsumexp(logits_i)          (masked by zmask)
        lse_sum = sum_i lse_i
        prior_stats[prior_rows[i]] += r_i
        child_stats_f = responsibility-weighted count scatter of factor f

    Returns ``(lse_sum, prior_stats, child_stats_tuple)``.

    Latents whose children carry a ``zmap`` (segment latents, e.g. SLDA
    sentences) need a cross-token reduction before the softmax, so they
    materialize the (n_latent, K) logits.

    ``tables="alpha"`` treats ``elog_prior`` and every child ``elog`` as
    Dirichlet *concentration* tables and computes the expectations here
    (upcast to f32 first: narrow tables stay narrow only in memory).
    """
    if tables == "alpha":
        elog_prior = dirichlet_expectation(elog_prior.float())
        children = tuple(c._replace(elog=dirichlet_expectation(c.elog.float()))
                         for c in children)
    k = elog_prior.shape[1]
    if any(c.zmap is not None for c in children):
        return _zstats_segmented(elog_prior, prior_rows, children, zmask,
                                 chunk, k)
    return _zstats_flat(elog_prior, prior_rows, children, zmask, chunk, k)


def _zstats_flat(elog_prior, prior_rows, children, zmask, chunk, k):
    """Token plate == latent plate: a single chunked pass, nothing (N, K)."""
    n = prior_rows.shape[0]
    gp = elog_prior.shape[0]
    dev = elog_prior.device

    def body(carry, xs):
        lse_acc, pstats, cstats = carry
        rows = xs["prior_rows"].long()
        zm = xs.get("zmask")
        logits = elog_prior[rows].float()
        for i, c in enumerate(children):
            logits = logits + _child_messages(
                c, xs[f"values{i}"], xs.get(f"base{i}"), xs.get(f"mask{i}"), k)
        r, lse = zstep(logits)
        if zm is not None:
            r = r * zm[:, None]
            lse = lse * zm
        lse_acc = lse_acc + lse.sum()
        pstats.index_add_(0, rows, r)
        cstats = tuple(
            _child_stats_native(c, cs, r, xs[f"values{i}"],
                                xs.get(f"base{i}"), xs.get(f"mask{i}"), k)
            for i, (c, cs) in enumerate(zip(children, cstats)))
        return lse_acc, pstats, cstats

    xs = {"prior_rows": prior_rows}
    if zmask is not None:
        xs["zmask"] = zmask
    for i, c in enumerate(children):
        xs.update(_token_xs(c, i))
    init = (torch.zeros((), dtype=torch.float32, device=dev),
            torch.zeros((gp, k), dtype=torch.float32, device=dev),
            tuple(_child_stats_init(c) for c in children))
    lse_sum, pstats, cstats = _scan_chunks(xs, n, chunk, init, body)
    return lse_sum, pstats, tuple(_child_stats_finish(c, cs)
                                  for c, cs in zip(children, cstats))


def _segment_messages(c: ZChild, nz: int, k: int, chunk: int) -> torch.Tensor:
    """(nz, k) f64: a zmap child's masked messages summed into the rows of
    their latent instances, token chunk by token chunk.  The sum is f64: a
    naive Bayes document's logits reach thousands of nats, where an f32 sum
    of its few hundred messages loses the hundredths of a nat that decide r
    for a document near a tie between two classes."""
    def body(acc, xs):
        e = _child_messages(c, xs["values0"], xs.get("base0"), xs.get("mask0"), k)
        return acc.index_add_(0, xs["zmap0"].long(), e.double())

    return _scan_chunks(_token_xs(c, 0), c.values.shape[0], chunk,
                        torch.zeros((nz, k), dtype=torch.float64,
                                    device=c.elog.device), body)


def zmap_logits(children: tuple, n_latent: int, k: int,
                chunk: int = ZSTATS_CHUNK, *, tables: str = "elog"):
    """Phase 1 of a segment latent alone: the ``(n_latent, K)`` f32 sum,
    over ``children`` (each with a ``zmap``) in order, of each token's
    masked message into row ``zmap[t]``.  ``tables`` as in :func:`zstats`."""
    if not children or any(c.zmap is None for c in children):
        raise ValueError("zmap_logits takes children that all have a zmap")
    if tables == "alpha":
        children = tuple(c._replace(elog=dirichlet_expectation(c.elog.float()))
                         for c in children)
    out = _segment_messages(children[0], n_latent, k, chunk).float()
    for c in children[1:]:
        out = (out + _segment_messages(c, n_latent, k, chunk)).float()
    return out


def _zstats_segmented(elog_prior, prior_rows, children, zmask, chunk, k):
    """Segment latents: accumulate per-instance logits (cross-token
    reduction), then stream the child token plates against them."""
    nz = prior_rows.shape[0]
    gp = elog_prior.shape[0]
    dev = elog_prior.device
    rows = prior_rows.long()
    # the prior row, the zmap children's f32 logits, then the other children
    logits = elog_prior[rows].float() + zmap_logits(
        tuple(c for c in children if c.zmap is not None), nz, k, chunk)
    for c in children:
        if c.zmap is None:
            logits = logits + _child_messages(c, c.values, c.base, c.mask, k)

    r, lse = zstep(logits)
    if zmask is not None:
        r = r * zmask[:, None]
        lse = lse * zmask
    lse_sum = lse.sum()
    pstats = torch.zeros((gp, k), dtype=torch.float32,
                         device=dev).index_add_(0, rows, r)

    cstats = []
    for i, c in enumerate(children):
        if c.zmap is None:
            s = _child_stats_native(c, _child_stats_init(c), r, c.values,
                                    c.base, c.mask, k)
            cstats.append(_child_stats_finish(c, s))
            continue

        def st_body(cs, xs, c=c, i=i):
            w = r[xs[f"zmap{i}"].long()]
            return _child_stats_native(c, cs, w, xs[f"values{i}"],
                                       xs.get(f"base{i}"),
                                       xs.get(f"mask{i}"), k)

        s = _scan_chunks(_token_xs(c, i), c.values.shape[0], chunk,
                         _child_stats_init(c), st_body)
        cstats.append(_child_stats_finish(c, s))
    return lse_sum, pstats, tuple(cstats)
