"""What one step costs, counted without running it: the port's counterpart
of ``repro.launch.hlo_cost``, which reads the compiled HLO of a step.  The
port has no compiled program to read; it runs the step's Python on
``meta`` tensors (shapes and dtypes, no data, no card) and counts the ops
as they dispatch:

  - **FLOPs**: the formulas of ``torch.utils.flop_counter``'s registry,
    which ``FlopCounterMode`` applies (the products: ``mm``, ``addmm``,
    ``bmm``, ..., forward and backward), applied here in the counter's own
    dispatch mode (``FlopCounterMode`` as a second Python mode doubled the
    trace's time), plus each hand-written kernel's operations
    (``kernels/work.py``), which
    ``kernels/ops.py`` hands to the count for every kernel call on ``meta``
    tensors, with its route and one launch;
  - **HBM traffic**: PyTorch runs eagerly, so every aten op is a kernel of
    its own that reads its inputs and writes its outputs: each
    materializing op's inputs and outputs are counted once, views and
    metadata ops count nothing, plus the kernels' bytes and each
    exchange's (its gathered output and the local part it sends);
  - **collective bytes** by kind, from the shard group's ``histogram``
    (``launch.dist``): per device, the bytes every shard hands an exchange
    (what each rank ends up holding), each exchanged tensor one
    collective;
  - **peak bytes**: the most bytes of device storage live at once during
    the call, the call's inputs included (each storage counted once, from
    its first sight to its release; host tensors count nothing).  A
    dispatch mode sees every storage an op creates and a finalizer its
    release; a storage first seen as an input was live before the call,
    and is added to every instant before too;
  - **launches** of each hand-written kernel, by route.

Loops are Python: every trip runs and is counted, so ``dynamic_loops`` is
always 0.  Where the reference counts its causal flash loop at a hinted
trip count, the port counts what runs: the kernel's kept (query, key)
pairs, and the plain chunked path's chunks below the diagonal.
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import work

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# ops that allocate or relabel storage without reading or writing it,
# besides the views (``OpOverload.is_view``)
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default, _aten.lift_fresh.default,
               _aten._unsafe_view.default}


@dataclasses.dataclass
class Costs:
    """One counted call: the reference's ``hlo_cost.Costs`` fields
    (``traffic`` in bytes) and the port's ``peak_bytes``, ``launches``
    (``{kernel: {"count": n, "routes": {route: n}}}``), ``flops_by_op``
    (the products' FLOPs by aten op), ``exchanges`` (the shard group's
    ``(kind, key, shape) -> [tensors, bytes]`` during the call),
    ``seconds`` (the trace's host time) and ``out``, what the call
    returned."""
    flops: float = 0.0
    traffic: int = 0
    dynamic_loops: int = 0
    peak_bytes: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    exchanges: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    out: object = None

    def kernel(self, name: str, routes: dict, ops: int, nbytes: int):
        """One launch of a hand-written kernel (``kernels.work``'s sink)."""
        row = self.launches.setdefault(name, {"count": 0, "routes": {}})
        row["count"] += 1
        for r, n in routes.items():
            row["routes"][r] = row["routes"].get(r, 0) + n
        self.flops += ops
        self.traffic += nbytes

    def as_dict(self) -> dict:
        coll = {k: {"bytes": 0, "count": 0} for k in COLLECTIVES}
        for (kind, _, _), (n, nb) in self.exchanges.items():
            coll[kind]["bytes"] += nb
            coll[kind]["count"] += n
        return {"flops": self.flops, "traffic_bytes": self.traffic,
                "collectives": coll,
                "collective_bytes": sum(c["bytes"] for c in coll.values()),
                "dynamic_loops": self.dynamic_loops,
                "peak_bytes": self.peak_bytes,
                "launches": self.launches}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its elements, at most its storage's (a
    broadcast view reads its storage once)."""
    n = t.numel() * t.element_size()
    return min(n, t.untyped_storage().nbytes()) if n else 0


class _Counter(TorchDispatchMode):
    """Traffic and live storage bytes of the ops dispatched inside it."""

    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs
        self.live = self.peak = 0
        self.storages: dict = {}       # id(storage) -> bytes, while live

    def _free(self, key):
        self.live -= self.storages.pop(key, 0)

    def _see(self, t: torch.Tensor, before: bool) -> None:
        """Track ``t``'s storage from now on: created here, or live from
        before the call (``before``), when every earlier instant held it
        too."""
        if t.device.type == "cpu":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self.storages:
            return
        nb = st.nbytes()
        self.storages[key] = nb
        weakref.finalize(st, self._free, key)
        self.live += nb
        if before:
            self.peak += nb
        self.peak = max(self.peak, self.live)

    def hold(self, obj, seen=None) -> None:
        """Track every tensor reachable from ``obj`` (the call's inputs):
        tensors, modules, mappings, sequences and objects' attributes."""
        seen = set() if seen is None else seen
        if id(obj) in seen or obj is None or isinstance(
                obj, (str, bytes, int, float, bool, type)):
            return
        seen.add(id(obj))
        if isinstance(obj, torch.Tensor):
            self._see(obj, True)
        elif isinstance(obj, torch.nn.Module):
            for t in list(obj.parameters()) + list(obj.buffers()):
                self._see(t, True)
        elif isinstance(obj, dict):
            for v in obj.values():
                self.hold(v, seen)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                self.hold(v, seen)
        elif hasattr(obj, "__dict__") and not callable(obj):
            for v in vars(obj).values():
                self.hold(v, seen)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func._overloadpacket not in flop_registry:
            # a composite op (inference mode skips autograd, where they
            # decompose) is counted as the ops it runs, as FlopCounterMode
            # counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        for t in ins:
            self._see(t, True)
        out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._see(t, False)
        packet = func._overloadpacket
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.costs.flops += n
            name = str(packet)
            self.costs.flops_by_op[name] = self.costs.flops_by_op.get(
                name, 0) + n
        if func not in _NO_TRAFFIC and not func.is_view:
            self.costs.traffic += sum(map(_nbytes, ins)) + sum(
                t.numel() * t.element_size() for t in outs)
        return out


def count(fn, *args, group=None, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` once, on ``meta`` tensors, and count it
    (module docs); ``group`` is the shard group its exchanges go through
    (a ``ShardGroup``, a ``DryGroup``, ``mesh.group``), whose histogram
    gives the collectives.  Returns the :class:`Costs`, with what ``fn``
    returned as ``out``."""
    costs = Costs()
    counter = _Counter(costs)
    counter.hold((args, kwargs))
    before = {k: tuple(v) for k, v in group.histogram.items()} \
        if group is not None else {}
    t0 = time.perf_counter()
    with work.recording(costs), counter:
        costs.out = fn(*args, **kwargs)
    costs.seconds = time.perf_counter() - t0
    costs.peak_bytes = counter.peak
    if group is not None:
        for key, (n, nb) in group.histogram.items():
            n0, nb0 = before.get(key, (0, 0))
            if n > n0:
                costs.exchanges[key] = [n - n0, nb - nb0]
                # the gathered output written, the local part read
                costs.traffic += (nb - nb0) + (nb - nb0) // group.n_shards
    return costs
