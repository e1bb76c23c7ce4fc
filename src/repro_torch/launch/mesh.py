"""The port's device meshes: ``repro.launch.mesh`` over virtual shards.

A :class:`Mesh` is a row-major grid of shards with the reference's
``shape`` (axis name -> size) and ``axis_names``.  Its shards run over one
:class:`~repro_torch.launch.dist.ShardGroup`: in one process every shard is
virtual and runs in turn on the process's device; across processes (gloo)
each rank runs its contiguous block.  ``"pod"`` folds into data
parallelism, as :func:`data_axes` folds it, and the model axis comes last:
shard ``d * model + m`` is data row ``d`` and model column ``m``.

The axis sums (:meth:`Mesh.sum_axes`: :meth:`Mesh.sum_model` over the
shards of one data row, :meth:`Mesh.sum_data` over one model column) add
in shard order, from the full all-gather of :meth:`ShardGroup.gather`, so
that they give the same bits in one process or several.  ``make_production_mesh`` (the reference's
256- and 512-chip TPU meshes) has no counterpart.
"""

from __future__ import annotations

import numpy as np

from .dist import ShardGroup


class Mesh:
    """``shape`` (sizes) over ``axis_names``; ``group`` defaults to a
    :class:`ShardGroup` of every shard over the current process group."""

    def __init__(self, shape, axis_names, group: ShardGroup | None = None):
        shape, axis_names = tuple(int(n) for n in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
            raise ValueError(f"mesh shape {shape} does not fit axes "
                             f"{axis_names}")
        if "model" in axis_names and axis_names[-1] != "model":
            raise ValueError(f"the model axis comes last, not in {axis_names}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = int(np.prod(shape))
        self.group = group if group is not None else ShardGroup(self.size)
        if self.group.n_shards != self.size:
            raise ValueError(f"a group of {self.group.n_shards} shards for a "
                             f"mesh of {self.size}")
        self.n_model = self.shape.get("model", 1)
        self.n_data = self.size // self.n_model
        self.model_axes = ("model",) if "model" in axis_names else ()

    def __repr__(self):
        return f"Mesh({self.shape})"

    @property
    def local_shards(self) -> list:
        return self.group.local_shards

    def coords(self, shard: int) -> dict:
        """The shard's index on each axis (row-major)."""
        idx = np.unravel_index(int(shard), tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def data_index(self, shard: int) -> int:
        return int(shard) // self.n_model

    def model_index(self, shard: int) -> int:
        return int(shard) % self.n_model

    def _gather(self, xs: list, key: str, kind: str = "all-gather") -> list:
        """Every shard's tensors (a list per shard, in shard order) from the
        local shards' ``xs`` (one list of tensors per local shard);
        ``kind`` the collective the exchange stands for."""
        local = self.local_shards
        return self.group.gather({s: list(x) for s, x in zip(local, xs)},
                                 [key] * len(xs[0]), kind)

    def axis_group(self, shard: int, axes) -> list:
        """The shards that share ``shard``'s index on every axis not in
        ``axes``, in shard order (the row-major order over ``axes``)."""
        c = self.coords(shard)
        keep = [a for a in self.axis_names if a not in axes]
        return [t for t in range(self.size)
                if all(self.coords(t)[a] == c[a] for a in keep)]

    def gather_axes(self, xs: list, key: str, axes) -> list:
        """For each local shard, the tensors of its group over ``axes``
        (:meth:`axis_group`): a list over the group of lists of
        tensors."""
        if all(self.shape[a] == 1 for a in axes):
            return [[list(x)] for x in xs]
        got = self._gather(xs, key)
        return [[got[t] for t in self.axis_group(s, axes)]
                for s in self.local_shards]

    def sum_axes(self, xs: list, key: str, axes) -> list:
        """For each local shard, position by position, the sum of its
        group's tensors over ``axes`` in shard order; a group's sum is
        computed once and shared by its local shards."""
        if all(self.shape[a] == 1 for a in axes):
            return [list(x) for x in xs]
        got = self._gather(xs, key, "all-reduce")
        done, out = {}, []
        for s in self.local_shards:
            m = tuple(self.axis_group(s, axes))
            if m not in done:
                acc = list(got[m[0]])
                for t in m[1:]:
                    acc = [a + b for a, b in zip(acc, got[t])]
                done[m] = acc
            out.append(done[m])
        return out

    def sum_model(self, xs: list, key: str) -> list:
        """Over the model shards of each local shard's data row, in shard
        order: ``xs`` holds one list of tensors per local shard."""
        return self.sum_axes(xs, key, self.model_axes)

    def sum_data(self, xs: list, key: str) -> list:
        """Over the data shards of each local shard's model column."""
        return self.sum_axes(xs, key, data_axes(self))

    def gather_model(self, xs: list, key: str) -> list:
        """For each local shard, its data row's tensors in model order: a
        list over the row's shards of lists of tensors."""
        return self.gather_axes(xs, key, self.model_axes)

    def gather_data(self, xs: list, key: str) -> list:
        """For each local shard, its model column's tensors in data order."""
        return self.gather_axes(xs, key, data_axes(self))

    def gather_all(self, xs: list, key: str) -> list:
        """Every shard's tensors, in shard order."""
        if self.size == 1:
            return [list(x) for x in xs]
        return self._gather(xs, key)


def make_host_mesh(shape=None, axes=None, group: ShardGroup | None = None):
    """A mesh of virtual shards: ``shape`` over ``axes``, or one data shard
    a process of the current group when ``shape`` is None (the reference
    counts its devices there; one card is one device)."""
    if shape is None:
        from .dist import process_count
        shape, axes = (process_count(),), ("data",)
    return Mesh(shape, axes, group)


def make_production_mesh(multi_pod: bool = False,
                         group: ShardGroup | None = None) -> Mesh:
    """The reference's production mesh: 16 data x 16 model shards, or with
    ``multi_pod`` 2 pods x 16 x 16, the pod folded into data parallelism
    (:func:`data_axes`)."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"), group)
    return Mesh((16, 16), ("data", "model"), group)


def data_axes(mesh) -> tuple:
    """Mesh axes carrying data parallelism (pod folds into DP)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def model_axis(mesh):
    return "model" if "model" in mesh.axis_names else None


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(np.prod([mesh.shape[a] for a in axes]))
