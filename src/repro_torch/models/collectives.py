"""Where a model's shards meet: the autograd functions of tensor
parallelism over a :class:`~repro_torch.launch.mesh.Mesh`.

Each function takes the tensors of every local shard at once (one per
shard, in ``mesh.local_shards`` order) and returns one per shard, so that
autograd sees one node for the exchange and each sum is taken by the mesh
in shard order, never by autograd's own accumulation.  The pairs are
Megatron's, with the data row's model shards as the group:

- :func:`model_sum`: the ordered sum over the row's model shards forward
  (a row-parallel layer's output), the identity backward;
- :func:`model_copy`: the identity forward, the ordered sum of the
  gradients backward (a column-parallel layer's input);
- :func:`keep`: each model shard's chunk of a replicated tensor along a
  dim forward, the gradients' chunks gathered backward;
- :func:`gather_kept`: the chunks gathered forward, the own chunk of the
  gradient backward;
- :func:`gather_rows`: the data rows' tensors gathered along dim 0 forward
  (the whole batch, in row order), the own rows of the gradient backward:
  for a computation that needs every row's tokens and gives each row the
  gradient of its own alone (the experts' routing).

Downstream of a ``model_sum`` or ``gather_kept`` every model shard of a row
computes the same values with the same ops, so each holds the whole
gradient of its copy; that is what the backward of the first and the last
pair rely on.  With one model shard each is the identity.
"""

from __future__ import annotations

import torch


def _chunk(x, dim: int, i: int, n: int):
    size = x.shape[dim] // n
    return x.narrow(dim, i * size, size)


def _distinct(outs: list) -> tuple:
    """Outputs of a Function: a tensor that the mesh shared between local
    shards is copied for every shard after its first."""
    seen, res = set(), []
    for t in outs:
        res.append(t.clone() if id(t) in seen else t)
        seen.add(id(t))
    return tuple(res)


def _meta(xs) -> list:
    return [(x.shape, x.dtype, x.device) for x in xs]


def _grads(gs, meta):
    """The gradients, zeros for an output that received none."""
    return [torch.zeros(s, dtype=d, device=v) if g is None else g
            for g, (s, d, v) in zip(gs, meta)]


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, key, *xs):
        return _distinct([o[0] for o in mesh.sum_model([[x] for x in xs],
                                                       key)])

    @staticmethod
    def backward(ctx, *gs):
        return (None, None) + gs


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, key, *xs):
        ctx.mesh, ctx.key, ctx.meta = mesh, key, _meta(xs)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = _grads(gs, ctx.meta)
        return (None, None) + _distinct(
            [o[0] for o in ctx.mesh.sum_model([[g] for g in gs], ctx.key)])


class _Keep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, key, dim, *xs):
        ctx.mesh, ctx.key, ctx.dim = mesh, key, dim
        n = mesh.n_model
        out = [_chunk(x, dim, mesh.model_index(s), n).contiguous()
               for x, s in zip(xs, mesh.local_shards)]
        ctx.meta = _meta(out)
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        gs = [g.contiguous() for g in _grads(gs, ctx.meta)]
        rows = ctx.mesh.gather_model([[g] for g in gs], ctx.key)
        return (None, None, None) + tuple(
            torch.cat([r[0] for r in row], dim=ctx.dim) for row in rows)


class _GatherKept(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, key, dim, *xs):
        ctx.mesh, ctx.dim = mesh, dim
        rows = mesh.gather_model([[x.contiguous()] for x in xs], key)
        return tuple(torch.cat([r[0] for r in row], dim=dim) for row in rows)

    @staticmethod
    def backward(ctx, *gs):
        mesh, n = ctx.mesh, ctx.mesh.n_model
        return (None, None, None) + tuple(
            None if g is None else
            _chunk(g, ctx.dim, mesh.model_index(s), n).contiguous()
            for g, s in zip(gs, mesh.local_shards))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, key, *xs):
        ctx.mesh = mesh
        cols = mesh.gather_data([[x.contiguous()] for x in xs], key)
        return tuple(torch.cat([c[0] for c in col], dim=0) for col in cols)

    @staticmethod
    def backward(ctx, *gs):
        mesh = ctx.mesh
        return (None, None) + tuple(
            None if g is None else
            _chunk(g, 0, mesh.data_index(s), mesh.n_data).contiguous()
            for g, s in zip(gs, mesh.local_shards))


def model_sum(mesh, xs: list, key: str = "model_sum") -> list:
    if mesh.n_model == 1:
        return list(xs)
    return list(_ModelSum.apply(mesh, key, *xs))


def model_copy(mesh, xs: list, key: str = "model_copy") -> list:
    if mesh.n_model == 1:
        return list(xs)
    return list(_ModelCopy.apply(mesh, key, *xs))


def keep(mesh, xs: list, dim: int, key: str = "keep") -> list:
    """Each local shard's chunk of its ``xs`` along ``dim``; a tensor that
    needs no gradient (an index map) is simply sliced."""
    if mesh.n_model == 1:
        return list(xs)
    if not any(x.requires_grad for x in xs):
        return [_chunk(x, dim, mesh.model_index(s), mesh.n_model).contiguous()
                for x, s in zip(xs, mesh.local_shards)]
    return list(_Keep.apply(mesh, key, dim, *xs))


def gather_kept(mesh, xs: list, dim: int, key: str = "gather") -> list:
    if mesh.n_model == 1:
        return list(xs)
    return list(_GatherKept.apply(mesh, key, dim, *xs))


def gather_rows(mesh, xs: list, key: str = "rows") -> list:
    if mesh.n_data == 1:
        return list(xs)
    return list(_GatherRows.apply(mesh, key, *xs))
