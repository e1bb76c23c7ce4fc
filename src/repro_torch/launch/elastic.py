"""Elastic scaling: re-plan the mesh (or the shard plan) for a changed
topology and resume from the newest checkpoint or session.

The port of ``repro.launch.elastic``.  On a real cluster the controller
detects lost or added hosts and relaunches the job with a different host
set; everything the job needs to continue is (a) a factorisation of the
new count into a mesh (:func:`factor_counts`, :func:`factor_mesh`), or for
the statistical engines a shard plan with the ownership map re-derived
from the new topology (rendezvous hashing moves only the minimal shards),
(b) the shardings re-derived from it (``shardings.Rules`` is
mesh-parametric), and (c) the newest valid checkpoint or session, held
whole on the host, which every shard slices anew
(:func:`remesh_and_resume`, :func:`remesh_and_resume_svi`).
"""

from __future__ import annotations

from .dist import init_distributed, process_count, process_index


def factor_counts(n_devices: int, want_model: int = 0) -> tuple:
    """The ``(data, model)`` axis sizes :func:`factor_mesh` realizes.
    Greedy: model axis gets the largest power-of-2 divisor of ``n_devices``
    that is ``<= want_model``, which may be *smaller* than ``want_model``
    (n=6, want_model=4 -> model=2, data=3), so validation must run against
    this, not against the request."""
    model = 1
    if want_model > 1:
        m = min(want_model, n_devices)
        while m > 1:
            if n_devices % m == 0:
                model = m
                break
            m //= 2
    return n_devices // model, model


def factor_mesh(n_devices: int, want_model: int = 0):
    """A ``(data, model)`` :class:`~repro_torch.launch.mesh.Mesh` of
    ``n_devices`` shards, factored by :func:`factor_counts`."""
    from .mesh import Mesh
    data, model = factor_counts(n_devices, want_model)
    return Mesh((data, model), ("data", "model"))


def remesh_and_resume(cfg, run, checkpoint_dir: str,
                      n_devices: int | None = None, want_model: int = 0,
                      steps: int = 10, device=None):
    """Rebuild on a new mesh of ``n_devices`` shards (one a process of the
    current group when None) and continue training from the checkpoint.

    Batch divisibility is validated against the factorization
    :func:`factor_mesh` will actually pick, not the requested
    ``want_model``, which it may round down, so an invalid config fails
    here with the real numbers instead of deep inside ``train``."""
    from .train import train
    n = n_devices or process_count()
    data, model = factor_counts(n, want_model)
    if run.global_batch % data:
        raise ValueError(
            f"global batch {run.global_batch} not divisible by the data-"
            f"parallel degree {data} ({n} devices factor as data={data} x "
            f"model={model} for want_model={want_model})")
    return train(cfg, run, steps, device=device,
                 mesh=factor_mesh(n, want_model),
                 checkpoint_dir=checkpoint_dir,
                 checkpoint_every=max(steps // 2, 1))


def svi_plan(n_devices: int | None = None, want_model: int = 0):
    """The inferspark :class:`~repro_torch.core.partition.ShardingPlan`
    that :func:`remesh_and_resume_svi` resumes on: one shard for each
    ``data`` slot of :func:`factor_counts` (``n_devices, want_model``), as
    the reference wraps its mesh's data axis.  ``n_devices=None`` means one
    device a process of the current group."""
    from ..core.partition import ShardingPlan
    data, _ = factor_counts(n_devices or process_count(), want_model)
    return ShardingPlan(data, "inferspark")


def remesh_and_resume_svi(model, engine_cfg, checkpoint_dir: str,
                          n_devices: int | None = None, want_model: int = 0):
    """Continue an SVI fit from ``checkpoint_dir``'s newest valid
    :class:`~repro_torch.checkpoint.TrainSession` on the inferspark plan
    :func:`svi_plan` gives for ``n_devices`` devices (one a process of the
    current group when None) factored with ``want_model``: as many shards
    as the ``data`` axis has, the reference's arguments and plan.

    ``engine_cfg`` is anything :func:`~repro_torch.core.engine.make_engine`
    accepts (its ``steps`` is the *total* budget — only the remainder past
    the session's step runs).  The session fingerprint deliberately
    excludes the plan, so resuming on a *different* shard count is allowed
    — the schedule (sampler, Robbins-Monro position, holdout) continues
    exactly, but the cross-shard sum order changes, so the continuation is
    deterministic going forward rather than bitwise to the old plan.  At an
    unchanged shard count it is bitwise.
    """
    from ..core.engine import make_engine
    eng = make_engine(engine_cfg, sharding=svi_plan(n_devices, want_model),
                      checkpoint_dir=checkpoint_dir, resume=True)
    return eng.fit(model)


def multihost_svi_session(model, engine_cfg, corpus_dir: str,
                          checkpoint_dir: str | None = None, *,
                          n_hosts: int | None = None,
                          host_id: int | None = None,
                          coordinator: str | None = None,
                          ownership_seed: int = 0):
    """One host's entry point into a multi-host SVI fit over a partitioned
    corpus — the distributed analogue of :func:`remesh_and_resume_svi`.

    With ``coordinator`` (``"host:port"``) the process first joins the
    ``torch.distributed`` group (gloo) as rank ``host_id`` of ``n_hosts``
    (:func:`launch.dist.init_distributed`).  In a multi-process run the
    corpus is opened through a :class:`~repro_torch.data.HostAssignment`
    view, so this host maps only the shards it owns; a single process gets
    ``n_hosts`` *virtual* hosts (the same partitioned batching,
    unrestricted I/O).

    The plan has one shard a host (the reference's one ``"data"`` axis
    over the global device set, one device a host).  With ``checkpoint_dir`` the fit resumes from the newest valid session
    (rank 0 is the sole writer; all ranks read — shared-filesystem
    contract), which is how an elastic remesh works here: relaunch every
    surviving or new host with the new ``n_hosts`` and the same
    ``checkpoint_dir``/``ownership_seed``; shard ownership re-derives from
    the new topology and the schedule continues exactly —
    deterministic going forward, bitwise when the shard count is unchanged.
    ``engine_cfg`` names the device (``device``; ``None`` means
    ``"cuda"``): every rank of one card names that card.
    """
    from ..checkpoint import latest_session_step
    from ..core.engine import make_engine
    from ..core.partition import ShardingPlan
    from ..data import HostAssignment, ShardedCorpus

    if coordinator is not None:
        if n_hosts is None or host_id is None:
            raise ValueError("coordinator= needs explicit n_hosts/host_id")
        init_distributed(coordinator, n_hosts, host_id)
    multiproc = process_count() > 1
    if n_hosts is None:
        n_hosts = process_count()
    if host_id is None:
        host_id = process_index() if multiproc else 0
    hosts = HostAssignment(n_hosts, host_id, ownership_seed)
    # real multi-process runs restrict corpus I/O to owned shards; a
    # single process simulating n virtual hosts must keep all shards
    # readable (SVI rejects a restricted view in virtual mode)
    corpus = ShardedCorpus.open(corpus_dir, hosts=hosts if multiproc
                                else None)
    plan = ShardingPlan(n_hosts, "inferspark")
    resume = bool(checkpoint_dir
                  and latest_session_step(checkpoint_dir) is not None)
    eng = make_engine(engine_cfg, sharding=plan, corpus=corpus,
                      hosts=hosts, checkpoint_dir=checkpoint_dir,
                      resume=resume)
    return eng.fit(model)
