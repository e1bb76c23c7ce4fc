"""The sharding context of activation constraints:
``repro.models.sharding_ctx`` on a port :class:`~repro_torch.launch.mesh.
Mesh`.

The step builders install the active mesh and its logical axes here, and
the sharded model calls :func:`constrain` with logical templates ("dp",
"tp" or None per dim).  In the reference a constraint places a tensor on
the mesh; in the port it fixes which slice each shard keeps and changes no
value: under a mesh, ``x`` is the list of the local shards' tensors, each
already its data row's part (the "dp" dims are local), and every "tp" dim
that the model axis divides is cut to the shard's chunk
(:func:`~repro_torch.models.collectives.keep`, whose backward gathers the
chunks' gradients).  Outside a mesh it does nothing.
"""

from __future__ import annotations

import contextlib

from .collectives import keep

_CTX = {"mesh": None, "dp": (), "tp": None}


@contextlib.contextmanager
def mesh_ctx(mesh, dp, tp):
    prev = dict(_CTX)
    _CTX.update(mesh=mesh, dp=dp, tp=tp)
    try:
        yield
    finally:
        _CTX.update(prev)


def set_ctx(mesh, dp, tp):
    _CTX.update(mesh=mesh, dp=dp, tp=tp)


def clear_ctx():
    _CTX.update(mesh=None, dp=(), tp=None)


def constrain(x, template):
    """template: tuple over dims of "dp" | "tp" | None.  A "tp" dim that the
    model axis does not divide stays whole, as the reference's falls back
    to None."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    for dim, t in enumerate(template):
        if t == "tp" and _CTX["tp"] and x[0].shape[dim] % mesh.n_model == 0:
            x = keep(mesh, x, dim, key="constrain")
    return x
