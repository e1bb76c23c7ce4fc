"""Sharding rules: ``repro.launch.shardings.Rules``, op for op, and the
slices that they give each shard of a port :class:`~repro_torch.launch.
mesh.Mesh`.

Doctrine (the InferSpark partitioning carried to the LM side): shard the big
axes, replicate the small ones, and only shard a dim when it divides the mesh
axis, otherwise replicate that dim.

- TP ("model" axis): vocab/logits, attention heads (or head_dim when the
  head count does not divide the axis), d_ff, MoE experts (EP), RG-LRU/SSD
  inner width.
- DP ("pod", "data"): batch; the sequence axis instead when the batch does
  not divide (long-context parallelism).
- FSDP (optional, "data" only): the non-TP dim of every matrix, ZeRO-style;
  optimizer states follow params.

A spec is a tuple over a leaf's dims of an axis name, a tuple of names, or
``None``: the reference's ``PartitionSpec`` as a tuple.  :meth:`Rules.params`
and :meth:`Rules.cache` take the reference's trees (nested dicts and lists of
anything with a ``shape``; the paths are the reference's, stacked leading
dims included).  :func:`shard_slices` gives the slice of a leaf that a shard
holds under a spec, :func:`place` a full tensor's slices for this rank's
shards, and :func:`owns` whether a shard is the one that counts a
replicated slice (index 0 on every axis that the spec does not name).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .mesh import axis_size, data_axes, model_axis


def _div(n: int, mesh, axes) -> bool:
    return axes is not None and n % axis_size(mesh, axes) == 0


class Rules:
    def __init__(self, cfg, run, mesh):
        self.cfg, self.run, self.mesh = cfg, run, mesh
        self.dp = data_axes(mesh)
        self.tp = model_axis(mesh)
        self.fsdp = "data" if (run.fsdp and "data" in mesh.axis_names) else None

    # -- helpers ----------------------------------------------------------
    def _mt(self, dim: int):
        """'model' if it divides, else None."""
        return self.tp if _div(dim, self.mesh, self.tp) else None

    def _fs(self, dim: int):
        return self.fsdp if _div(dim, self.mesh, self.fsdp) else None

    def _mat(self, shape, tp_dim: int):
        """Spec for a (possibly layer-stacked) matrix: TP on ``tp_dim`` of the
        trailing 2, FSDP on the other."""
        other = 1 - tp_dim
        spec = [None, None]
        spec[tp_dim] = self._mt(shape[-2 + tp_dim])
        spec[other] = self._fs(shape[-2 + other])
        return tuple([None] * (len(shape) - 2) + spec)

    # -- params -----------------------------------------------------------
    def param_spec(self, path: str, shape) -> tuple:
        c = self.cfg
        nd = len(shape)
        if re.search(r"embed$", path):
            return (self._mt(shape[0]), self._fs(shape[1]))
        if re.search(r"lm_head$", path):
            return (self._fs(shape[0]), self._mt(shape[1]))
        if re.search(r"frontend_proj$", path):
            return (None, self._mt(shape[1]))
        if re.search(r"(wq|wk|wv)$", path):
            return self._mat(shape, 1)
        if re.search(r"wo$", path) and "ffn" not in path and nd >= 2 \
                and "rglru" not in path:
            return self._mat(shape, 0)
        if re.search(r"router$", path):
            return tuple([None] * (nd - 1) + [self._mt(shape[-1])])
        if "ffn" in path and nd >= 3 and c.n_experts:       # MoE (E, d, f)
            lead = [None] * (nd - 3)
            e = self._mt(shape[-3])
            if re.search(r"wi$", path):
                return tuple(lead + [e, self._fs(shape[-2]), None])
            return tuple(lead + [e, None, self._fs(shape[-1])])
        if "ffn" in path and re.search(r"wi$", path):
            return self._mat(shape, 1)
        if "ffn" in path and re.search(r"wo$", path):
            return self._mat(shape, 0)
        if "rglru" in path or "ssd" in path:
            if re.search(r"(wx|wgate|in_proj)$", path):
                return self._mat(shape, 1)
            if re.search(r"(wo|out_proj)$", path):
                return self._mat(shape, 0)
            if re.search(r"(wr|wi)$", path):
                return self._mat(shape, 1)
            if re.search(r"conv$", path):
                return tuple([None] * (nd - 1) + [self._mt(shape[-1])])
            if nd >= 1 and re.search(r"lam$", path):
                return tuple([None] * (nd - 1) + [self._mt(shape[-1])])
        return tuple([None] * nd)                           # norms, scalars

    def params(self, params_shape):
        return tree_map_with_path(
            lambda path, leaf: self.param_spec(path, leaf.shape), params_shape)

    def opt_state(self, opt_shape, params_spec):
        """mu/nu follow the params; count is replicated."""
        return {"mu": params_spec, "nu": params_spec, "count": ()}

    # -- batches ----------------------------------------------------------
    def _bs(self, b: int, s: int) -> tuple:
        """(B, S): batch over DP when divisible, else sequence (SP).  One
        data axis is named alone, as a ``PartitionSpec`` normalises it."""
        dp = self.dp[0] if len(self.dp) == 1 else self.dp
        if _div(b, self.mesh, self.dp):
            return (dp, None)
        if _div(s, self.mesh, self.dp):
            return (None, dp)
        return (None, None)

    def batch(self, batch_shape) -> dict:
        out = {}
        for k, v in batch_shape.items():
            if len(v.shape) >= 2:
                spec = self._bs(v.shape[0], v.shape[1])
                out[k] = tuple(list(spec) + [None] * (len(v.shape) - 2))
            else:
                out[k] = (None,)
        return out

    # -- decode cache -----------------------------------------------------
    def cache_leaf(self, path: str, shape) -> tuple:
        """Cache leaves may carry a leading layer-stack dim (scan repeats)."""
        nd = len(shape)
        name = path.rsplit("/", 1)[-1]
        if name in ("k", "v"):                   # (..., B, S, KV, Dh)
            lead = [None] * (nd - 4)
            b, s, kv, dh = shape[-4:]
            bs = self._bs(b, s)
            if self._mt(kv):                     # enough kv heads: TP on heads
                return tuple(lead + [bs[0], bs[1], self._mt(kv), None])
            # few kv heads (GQA/MQA): shard the SEQUENCE over model
            if self.tp:
                if bs[1] is None and s % axis_size(self.mesh, self.tp) == 0:
                    return tuple(lead + [bs[0], self.tp, None, None])
                if bs[1] is not None and bs[0] is None:
                    # batch=1 long-context: sequence over data AND model
                    axes = (bs[1] if isinstance(bs[1], tuple)
                            else (bs[1],)) + (self.tp,)
                    if s % axis_size(self.mesh, axes) == 0:
                        return tuple(lead + [None, axes, None, None])
            return tuple(lead + [bs[0], bs[1], None, self._mt(dh)])
        if name == "conv":                       # (..., B, W, L)
            return tuple([None] * (nd - 1) + [self._mt(shape[-1])])
        if name == "h" and nd >= 4:              # ssd state (..., B, H, N, P)
            return tuple([None] * (nd - 3) + [self._mt(shape[-3]), None, None])
        if name == "h":                          # rglru state (..., B, L)
            return tuple([None] * (nd - 1) + [self._mt(shape[-1])])
        return tuple([None] * nd)

    def cache(self, cache_shape):
        return tree_map_with_path(
            lambda path, leaf: self.cache_leaf(path, leaf.shape), cache_shape)


# ---------------------------------------------------------------------------
# trees: the reference's nested dicts and lists, paths as it spells them
# ---------------------------------------------------------------------------

def tree_map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and tuples
    (``None`` an empty subtree), the path the reference's ``"/"``-joined
    dict keys and list indices."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


# ---------------------------------------------------------------------------
# slices of a spec on a mesh
# ---------------------------------------------------------------------------

def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_slices(spec, shape, mesh, shard: int) -> tuple:
    """The slice (a tuple of ``slice``s, one per dim) of a leaf of ``shape``
    that ``shard`` holds under ``spec``: a dim split over axes ``(a1, a2,
    ...)`` in ``prod(sizes)`` equal chunks, chunk ``i`` the row-major index
    of the shard's coordinates on those axes."""
    coords = mesh.coords(shard)
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = _axes(entry)
        if not axes:
            out.append(slice(None))
            continue
        sizes = [mesh.shape[a] for a in axes]
        parts = int(np.prod(sizes))
        if n % parts:
            raise ValueError(f"dim {n} does not split over {axes} ({parts})")
        i = int(np.ravel_multi_index([coords[a] for a in axes], sizes))
        out.append(slice(i * n // parts, (i + 1) * n // parts))
    return tuple(out)


def owns(spec, mesh, shard: int) -> bool:
    """Whether ``shard`` has index 0 on every axis that ``spec`` does not
    name: the one shard of its slice's replicas that counts it once."""
    named = {a for e in spec for a in _axes(e)}
    coords = mesh.coords(shard)
    return all(coords[a] == 0 for a in mesh.axis_names if a not in named)


def place(full, spec, mesh, shards=None) -> dict:
    """``{shard: its slice of full}`` for ``shards`` (this rank's local
    shards by default), each a contiguous copy."""
    shards = mesh.local_shards if shards is None else shards
    return {s: full[shard_slices(spec, full.shape, mesh, s)].clone(
        memory_format=torch.contiguous_format) for s in shards}
