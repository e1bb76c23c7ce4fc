"""Processes and the shard group: where the shards of a sharded step meet.

The port of ``repro.compat.distributed_initialize`` and of the collectives
inside the reference's ``shard_map`` (its ``psum``).  The reference runs
one SPMD program over a mesh whose devices may span processes; the port
runs each shard's step body itself, in turn, and hands what the shards
must share to one :class:`ShardGroup`:

- in one process every shard is *virtual*: the group sums the shards'
  tensors in shard order on their device;
- across processes (``torch.distributed`` over gloo) each rank runs its own
  block of shards, and the group **all-gathers** every shard's tensors and
  sums them in shard order with the same ops on the same device type.

Either way every rank computes the same sum from the same bits, in the
same order, so a 2-process run is bitwise the 1-process run with 2 virtual
hosts.  An ``all_reduce`` would not do: its order of summation is the
backend's.  gloo gathers CPU tensors only, so a card's tensors are staged
through pinned host buffers on the way out and copied back to the card on
the way in.  NCCL needs a card per rank (two ranks on one card are
refused), so asking for it raises until the port runs on such a machine.
The LM's mesh (``launch/mesh.py``) meets over the same group.

:class:`DryGroup` is the group as rank 0 of an ``n_shards``-process group
sees it, with nothing to talk to: a dry run (``launch.step_cost``) runs
shard 0's step on ``meta`` tensors and counts what its exchanges would
move.
"""

from __future__ import annotations

import time

import numpy as np
import torch

_ALIGN = 8          # every packed piece starts on an 8-byte boundary


def init_distributed(coordinator: str, world_size: int, rank: int,
                     backend: str = "gloo") -> None:
    """Join a ``torch.distributed`` process group as ``rank`` of
    ``world_size``, rendezvousing at ``coordinator`` (``"host:port"``;
    ``rank`` 0 listens there).  Only gloo is served: every rank may then
    share one card, its tensors staged through host memory."""
    import torch.distributed as dist
    if backend != "gloo":
        raise ValueError(f"the shard group serves the gloo backend only, not "
                         f"{backend!r}: NCCL needs a card per rank")
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(world_size), rank=int(rank))


def process_count() -> int:
    """Ranks of the current process group (1 without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class ShardGroup:
    """``n_shards`` shards over this process group's ranks: rank ``r`` runs
    the contiguous block ``shard_rank == r`` (``local_shards``), all of them
    in one process.

    :meth:`gather` and :meth:`sum` are the only places shard tensors meet.
    Each position of an exchange carries a key (a Dirichlet's name,
    ``"elbo"``, ...), and two counts are kept per key:

    - ``payload`` — the bytes of every shard's tensors handed to the group,
      whether or not they leave the process;
    - ``wire`` — the bytes this rank sent to and received from other ranks
      through the backend: ``2 (world_size - 1)`` times its own block's,
      each piece at its 8-byte-aligned size, so the keys add up to every
      byte of the all-gather; nothing for virtual shards.

    ``calls`` counts the exchanges and ``seconds`` their host time, staging
    included.  ``histogram`` counts them by ``(kind, key, shape)``: how
    many tensors of that shape were exchanged under that key and their
    payload bytes, ``kind`` the collective the exchange stands for
    (``"all-gather"``; ``"all-reduce"`` for :meth:`sum` and the mesh's
    axis sums, a gather and an ordered sum).
    """

    def __init__(self, n_shards: int):
        import torch.distributed as dist
        self.n_shards = int(n_shards)
        self.world_size = process_count()
        self.rank = process_index()
        if self.n_shards < 1 or self.n_shards % self.world_size:
            raise ValueError(f"{n_shards} shards do not split evenly over "
                             f"{self.world_size} processes")
        if self.world_size > 1 and dist.get_backend() != "gloo":
            raise ValueError(f"the shard group serves the gloo backend only, "
                             f"not {dist.get_backend()!r}")
        self._place(np.repeat(np.arange(self.world_size, dtype=np.int32),
                              self.n_shards // self.world_size))

    def _place(self, shard_rank: np.ndarray) -> None:
        """Give each shard its rank (``shard_rank``), take this rank's as
        ``local_shards``, and start every count at zero."""
        self.shard_rank = shard_rank
        self.local_shards = [int(s) for s in
                             np.flatnonzero(shard_rank == self.rank)]
        self.payload: dict = {}
        self.wire: dict = {}
        self.histogram: dict = {}
        self.calls = 0
        self.seconds = 0.0
        self._pinned: dict = {}

    def _host(self, key, nbytes: int, device) -> torch.Tensor:
        """A reusable host buffer, pinned when it stages a card's bytes."""
        buf = self._pinned.get(key)
        if buf is None or buf.numel() != nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8,
                              pin_memory=device.type == "cuda")
            self._pinned[key] = buf
        return buf

    @property
    def payload_bytes(self) -> int:
        return sum(self.payload.values())

    @property
    def wire_bytes(self) -> int:
        return sum(self.wire.values())

    def _count(self, parts: dict, keys: list, kind: str) -> list:
        """Check an exchange's ``parts`` and ``keys`` and count it (payload,
        wire, histogram, calls); returns the first local shard's
        tensors."""
        local = self.local_shards
        if sorted(parts) != local:
            raise ValueError(f"gather takes this rank's shards {local}, got "
                             f"{sorted(parts)}")
        first = parts[local[0]]
        if len(keys) != len(first):
            raise ValueError(f"{len(keys)} keys for {len(first)} tensors")
        hops = 2 * (self.world_size - 1) * len(local)
        for key, t in zip(keys, first):
            nb = t.numel() * t.element_size()
            self.payload[key] = self.payload.get(key, 0) + self.n_shards * nb
            if hops:
                self.wire[key] = (self.wire.get(key, 0)
                                  + hops * (-(-nb // _ALIGN) * _ALIGN))
            row = self.histogram.setdefault((kind, key, tuple(t.shape)),
                                            [0, 0])
            row[0] += 1
            row[1] += self.n_shards * nb
        self.calls += 1
        return first

    def gather(self, parts: dict, keys: list, kind: str = "all-gather"
               ) -> list:
        """Every shard's tensors, in shard order: ``parts`` maps each local
        shard to a list of tensors (the same shapes and types on every
        shard), ``keys`` names each position for the counts, ``kind`` the
        collective it stands for; returns one such list per shard of the
        group, on the local tensors' device.  Virtual shards come back as
        they are; a remote shard's are its bits, copied."""
        t0 = time.perf_counter()
        first = self._count(parts, keys, kind)
        local = self.local_shards
        if self.world_size == 1:
            self.seconds += time.perf_counter() - t0
            return [list(parts[s]) for s in range(self.n_shards)]
        import torch.distributed as dist
        device = first[0].device
        specs, size = [], 0
        for t in first:
            nb = t.numel() * t.element_size()
            specs.append((size, nb, t.dtype, t.shape))
            size += -(-nb // _ALIGN) * _ALIGN
        send = torch.zeros(size * len(local), dtype=torch.uint8, device=device)
        for i, s in enumerate(local):
            for (off, nb, _, _), t in zip(specs, parts[s]):
                o = i * size + off
                send[o:o + nb] = t.contiguous().reshape(-1).view(torch.uint8)
        # gloo moves CPU tensors only: stage through pinned host memory
        out_host = self._host("send", send.numel(), device)
        out_host.copy_(send)
        recv = [self._host(("recv", r), send.numel(), device)
                for r in range(self.world_size)]
        dist.all_gather(recv, out_host)
        got = []
        for r in range(self.world_size):
            buf = recv[r].to(device, copy=True)    # the buffers are reused
            for i in range(len(local)):
                got.append([buf[i * size + off:i * size + off + nb]
                            .view(dtype).reshape(shape)
                            for off, nb, dtype, shape in specs])
        self.seconds += time.perf_counter() - t0
        return got

    def sum(self, parts: dict, keys: list) -> list:
        """Position by position, the sum over every shard of ``parts``'
        tensors (:meth:`gather`), taken in shard order: shard 0's, plus
        shard 1's, and so on."""
        got = self.gather(parts, keys, "all-reduce")
        out = []
        for i in range(len(got[0])):
            acc = got[0][i]
            for g in got[1:]:
                acc = acc + g[i]
            out.append(acc)
        return out


class DryGroup(ShardGroup):
    """``n_shards`` shards as rank 0 of an ``n_shards``-process group sees
    them, one shard a rank: only shard 0 is local.  Nothing is sent and
    ``torch.distributed`` is never called: :meth:`gather` counts payload,
    wire and histogram exactly as :meth:`ShardGroup.gather` does for rank
    0, and returns shard 0's own tensors beside ``meta`` stand-ins of
    their shapes for the other shards, views of one received buffer of
    every remote shard's bytes, as the gloo path's.  ``models.parallel``
    and a VMP plan run over it as over a real rank."""

    def __init__(self, n_shards: int):
        self.n_shards = self.world_size = int(n_shards)
        if self.n_shards < 1:
            raise ValueError(f"a group of {n_shards} shards")
        self.rank = 0
        self._place(np.arange(self.n_shards, dtype=np.int32))

    def gather(self, parts: dict, keys: list, kind: str = "all-gather"
               ) -> list:
        first = self._count(parts, keys, kind)
        if self.n_shards == 1:
            return [list(first)]
        nbytes = [t.numel() * t.element_size() for t in first]
        packed = [-(-nb // _ALIGN) * _ALIGN for nb in nbytes]
        # every rank's block lands in one device buffer, as gloo's copies do
        buf = torch.empty((self.n_shards, sum(packed)), dtype=torch.uint8,
                          device="meta")
        got = [list(first)]
        for row in buf[1:]:
            got.append([p[:nb].view(t.dtype).view(t.shape) for p, nb, t in
                        zip(row.split(packed), nbytes, first)])
        return got
