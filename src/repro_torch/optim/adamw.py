"""AdamW + global-norm clipping + warmup-cosine schedule: the port's copy of
``repro.optim.adamw``, as plain functions on lists of tensors.

The reference's pytrees become lists (``list(module.parameters())``, their
gradients, and the moments in the same order).  ``adamw_update`` updates the
parameters and moments in place, with ``torch._foreach_*`` kernels, so a
step allocates no second copy of the 19 GB of olmo-1b's state; it is the
reference's update in the reference's order (``torch.optim.AdamW`` orders
the decay differently).  The schedule and the bias corrections are computed
in f32 on the host, as the reference computes them in f32.
:func:`compress_init` and :func:`compress_decompress` are the reference's
int8 error-feedback compression of gradients, for an exchange of 4x fewer
bytes; the trainer does not call them, as the reference's does not.
"""

from __future__ import annotations

import math

import torch

_F32 = torch.float32


def lr_schedule(step: int, base_lr: float, warmup: int,
                total: int = 100_000) -> float:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine to
    a tenth of it at ``total``; the f32 value as a Python float."""
    step = torch.tensor(step, dtype=_F32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(torch.tensor(math.pi, dtype=_F32) * prog))
    return float(base_lr * warm * (0.1 + 0.9 * cos))


def clip_by_global_norm(grads: list, max_norm: float):
    """``(grads scaled in place to global norm <= max_norm, the norm before
    scaling)``; the norm is an f32 0-d tensor on the gradients' device."""
    gn = torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([g.float() for g in grads])))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, gn


def adamw_init(params: list) -> dict:
    """Zero f32 moments like ``params`` and a step count of 0."""
    zeros = [torch.zeros_like(p, dtype=_F32) for p in params]
    return {"mu": zeros, "nu": [torch.zeros_like(z) for z in zeros],
            "count": 0}


@torch.no_grad()
def adamw_update(params: list, grads: list, state: dict, *, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0):
    """One AdamW step on f32 leaves, in place: ``p -= lr * (mu_hat /
    (sqrt(nu_hat) + eps) + weight_decay * p)`` on every leaf.  Returns
    ``(params, state)`` with the count advanced."""
    count = state["count"] + 1
    c1 = float(1.0 - torch.tensor(b1, dtype=_F32) ** float(count))
    c2 = float(1.0 - torch.tensor(b2, dtype=_F32) ** float(count))
    mu, nu = state["mu"], state["nu"]
    g = [x.float() for x in grads]
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, torch._foreach_mul(g, 1 - b1))
    torch._foreach_mul_(nu, b2)
    torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, 1 - b2),
                                               g))
    del g
    # step = (mu / c1) / (sqrt(nu / c2) + eps)
    den = torch._foreach_div(nu, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    step = torch._foreach_div(mu, c1)
    torch._foreach_div_(step, den)
    del den
    torch._foreach_add_(step, torch._foreach_mul(params, weight_decay))
    torch._foreach_mul_(step, lr)
    torch._foreach_sub_(params, step)
    return params, {"mu": mu, "nu": nu, "count": count}


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

def compress_init(params: list) -> list:
    """Zero f32 residuals like ``params``."""
    return [torch.zeros_like(p, dtype=_F32) for p in params]


def compress_decompress(grads: list, residual: list):
    """``(dequantized grads, new residuals)``: each gradient plus its
    residual quantized to int8 at a per-tensor scale (max |x| / 127,
    rounded half to even), dequantized in the gradient's dtype, and the
    error kept as the next residual, which keeps the bias bounded."""
    deq, res = [], []
    for g, r in zip(grads, residual):
        x = g.to(_F32) + r
        scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        d = q.to(_F32) * scale
        deq.append(d.to(g.dtype))
        res.append(x - d)
    return deq, res
