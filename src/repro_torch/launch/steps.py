"""Step builders of the port: ``repro.launch.steps.build_infer_step`` and
``build_train_step``, without ``jit``.

:func:`build_infer_step` builds the probabilistic-inference step, full-batch
VMP or SVI (over a resident or a sharded corpus).  :func:`build_train_step`
builds the LM step: the loss and its gradient (``torch.autograd.grad``, so
no ``.grad`` state is kept between steps; with ``run.microbatch > 1``
accumulated over slices of the batch), the clip to the global norm, the
learning rate from the schedule and AdamW in place; on one device, or with
``mesh=`` over a :class:`~repro_torch.launch.mesh.Mesh` of shards, each of
which stores what ``shardings.Rules`` gives it (``models.parallel``).
:func:`build_prefill_step` and :func:`build_decode_step` build the serving
steps.  PyTorch runs them eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig, RunConfig
from ..core.vmp import resolve_device
from ..models import make_model
from ..models.transformer import modality_inputs
from ..optim import adamw_update, clip_by_global_norm, lr_schedule


def batch_to(batch: dict, device) -> dict:
    """A numpy batch (``TokenStream.batch_at``, with an encoder-decoder's
    ``frames`` or a vision model's ``patches``) as tensors on ``device``:
    integer entries as int64, floating ones as f32.  Entries may already be
    tensors (a dry run's ``meta`` stand-ins)."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return v.to(device, torch.float32 if v.is_floating_point()
                        else torch.int64)
        v = np.asarray(v)
        dt = torch.float32 if np.issubdtype(v.dtype, np.floating) \
            else torch.int64
        return torch.from_numpy(v).to(device, dt)
    return {k: one(v) for k, v in batch.items()}


def tokens_only(cfg: ArchConfig, driver: str, builders: str):
    """Raise ``ValueError`` when ``cfg``'s batch needs more than tokens
    (``frames``, ``patches``): ``driver`` builds batches of tokens only,
    as the reference's does, and such a model runs through ``builders``."""
    extra = modality_inputs(cfg)
    if extra:
        raise ValueError(f"{driver} builds batches of tokens only and "
                         f"{cfg.name} also reads {list(extra)}; run it "
                         f"through {builders} (launch/steps.py) with a "
                         f"batch that holds them")


def build_infer_step(program, engine="vmp", corpus=None):
    """``(step_fn, state0)`` for a compiled
    :class:`~repro_torch.core.compiler.VMPProgram`, with the backend picked
    by config (a name or an :class:`~repro_torch.core.engine.EngineConfig`):
    full-batch VMP or streaming SVI, on ``engine.device`` (``None`` means
    ``"cuda"``).  ``step_fn(state) -> (state', elbo)``; the SVI step keeps
    its engine as ``step_fn.svi`` (held-out ELBO, sampler, ``close``).
    Gibbs is not a step machine.

    ``corpus`` (or ``EngineConfig.corpus``) — a
    :class:`repro_torch.data.ShardedCorpus` for out-of-core SVI: ``program``
    may then be an unobserved :class:`~repro_torch.core.dsl.Model` or a
    template from :func:`repro_torch.data.store.sharded_template`.
    ``EngineConfig.sharding`` (a :class:`~repro_torch.core.partition.
    ShardingPlan`) shards either backend: VMP through
    :func:`~repro_torch.core.partition.make_distributed_step` (its state in
    the plan's layout), SVI over the plan's shards (and ``engine.hosts``).
    """
    from ..core.engine import EngineConfig
    from ..core.runtime import make_step
    from ..core.svi import SVI, SVIConfig
    from ..core.vmp import init_state

    if isinstance(engine, str):
        engine = EngineConfig(backend=engine)
    corpus = corpus if corpus is not None else engine.corpus
    device = resolve_device(engine.device)
    if engine.backend == "vmp":
        if corpus is not None:
            raise ValueError("full-batch VMP needs a resident corpus; use "
                             "engine='svi' for out-of-core inference")
        if engine.sharding is not None:
            from ..core.partition import make_distributed_step
            return make_distributed_step(program, engine.sharding,
                                         seed=engine.seed,
                                         elog_dtype=engine.elog_dtype,
                                         device=device)
        return make_step(program, elog_dtype=engine.elog_dtype,
                         device=device), \
            init_state(program, engine.seed, device=device)
    if engine.backend == "svi":
        svi = SVI(program, SVIConfig(
            batch_size=engine.batch_size, kappa=engine.kappa, tau=engine.tau,
            local_iters=engine.local_iters, pad_multiple=engine.pad_multiple,
            holdout_frac=engine.holdout_frac,
            holdout_every=engine.holdout_every, seed=engine.seed,
            elog_dtype=engine.elog_dtype),
            plan=engine.sharding, corpus=corpus, hosts=engine.hosts,
            device=device)

        def step_fn(state):
            return svi.step(int(state.step), state)

        step_fn.svi = svi
        return step_fn, init_state(svi.program, engine.seed, device=device)
    raise ValueError(f"no step builder for backend {engine.backend!r}")


def build_train_step(cfg: ArchConfig, run: RunConfig, device=None,
                     mesh=None) -> dict:
    """``{"fn": train_step, "loss_and_grads": fn, "device": device}``.
    ``train_step(params, opt_state, batch, step)`` takes a
    :class:`~repro_torch.models.transformer.Decoder`, its AdamW state, a
    batch of tensors on ``device`` and the step number; it updates the
    parameters and the state in place and returns ``(params, opt_state,
    {"loss", "gnorm", "lr"})``, the loss and norm as 0-d tensors.
    ``device=None`` means ``"cuda"``.  With ``mesh`` the step is the
    sharded one (:func:`build_mesh_train_step`).

    ``run.microbatch = k > 1`` splits the batch into k slices along dim 0
    and adds each slice's ``loss / k`` and ``grad / k`` to f32 zeros in
    slice order, as the reference's ``lax.scan`` does; a batch that k does
    not divide raises ``ValueError``."""
    device = resolve_device(device)
    k = run.microbatch
    if k > 1 and run.global_batch % k:
        raise ValueError(f"microbatch {k} does not divide the global batch "
                         f"of {run.global_batch}")
    if mesh is not None:
        return build_mesh_train_step(cfg, run, mesh, device)
    model = make_model(cfg)

    def loss_and_grads(params, batch):
        leaves = list(params.parameters())
        if k <= 1:
            loss = model["train_loss"](params, batch, run)
            return loss.detach(), list(torch.autograd.grad(loss, leaves))
        b = len(batch["tokens"])
        if b % k:
            raise ValueError(f"microbatch {k} does not divide a batch of {b}")
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        for i in range(k):
            mb = {key: v[i * b // k:(i + 1) * b // k]
                  for key, v in batch.items()}
            li = model["train_loss"](params, mb, run)
            gi = torch.autograd.grad(li, leaves)
            loss = loss + li.detach() / k
            grads = [a + g / k for a, g in zip(grads, gi)]
        return loss, grads

    def train_step(params, opt_state, batch, step: int):
        leaves = list(params.parameters())
        loss, grads = loss_and_grads(params, batch)
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        lr = lr_schedule(step, run.learning_rate, run.warmup)
        _, opt_state = adamw_update(leaves, grads, opt_state, lr=lr,
                                    weight_decay=run.weight_decay)
        return params, opt_state, {"loss": loss, "gnorm": gnorm,
                                   "lr": lr}

    return {"fn": train_step, "loss_and_grads": loss_and_grads,
            "device": device}


class ShardedBatch(dict):
    """``{shard: {key: its part}}`` for this rank's shards, and ``shapes``,
    each entry's global shape."""

    def __init__(self, parts: dict, shapes: dict):
        super().__init__(parts)
        self.shapes = shapes


def place_batch(batch: dict, mesh, rules, device) -> ShardedBatch:
    """This rank's shards' parts of a numpy batch: each entry cut as
    ``rules.batch`` gives it and moved to ``device`` as :func:`batch_to`
    moves it."""
    from .shardings import shard_slices
    whole = batch_to(batch, device)
    specs = rules.batch(whole)
    return ShardedBatch(
        {s: {k: v[shard_slices(specs[k], v.shape, mesh, s)].contiguous()
             for k, v in whole.items()} for s in mesh.local_shards},
        {k: tuple(v.shape) for k, v in whole.items()})


def _row_batches(parts: dict, mesh, rules, shapes: dict):
    """Each local shard's data row's batch and the positions whose labels
    it counts (``None`` for all): a batch split over the rows is the row's
    own; one split over the sequence is gathered over the rows (exact), each
    counting its own chunk of the positions; one the rows cannot split is
    whole on every row and counted by row 0."""
    from .shardings import shard_slices
    local = mesh.local_shards
    specs = rules.batch({k: torch.empty(v, device="meta")
                         for k, v in shapes.items()})
    seq = [k for k, sp in specs.items() if len(sp) > 1 and sp[1] is not None]
    rows = [dict(parts[s]) for s in local]
    if seq:
        got = mesh.gather_data([[parts[s][k] for k in seq] for s in local],
                               "batch")
        for r, col in zip(rows, got):
            for j, k in enumerate(seq):
                r[k] = torch.cat([c[j] for c in col], dim=1)
    lab = specs["labels"]
    own = []
    for s, r in zip(local, rows):
        if lab[0] is not None:
            own.append(None)
            continue
        mask = torch.zeros(r["labels"].shape, dtype=torch.bool,
                           device=r["labels"].device)
        if lab[1] is not None:
            mask[shard_slices(lab, shapes["labels"], mesh, s)] = True
        elif mesh.data_index(s) == 0:
            mask[...] = True
        own.append(mask)
    return rows, own


def _microbatches(rows: list, own: list, mesh, k: int, rows_split: bool):
    """The k microbatches of the rows' batches: microbatch ``i`` is the
    global batch's rows ``[i B/k, (i+1) B/k)``, as on one device, cut over
    the data rows as ``Rules`` cuts a batch when the rows split it (the
    batch gathered over the rows first; exact), else each row's whole batch
    sliced."""
    if not rows_split:
        b = len(rows[0]["tokens"])
        if b % k:
            raise ValueError(f"microbatch {k} does not divide a batch of {b}")
        cuts = [slice(i * b // k, (i + 1) * b // k) for i in range(k)]
        return [([{key: v[c] for key, v in r.items()} for r in rows],
                 [None if o is None else o[c] for o in own]) for c in cuts]
    keys = list(rows[0])
    cols = mesh.gather_data([[r[key] for key in keys] for r in rows],
                            "batch")
    whole = [{key: torch.cat([c[j] for c in col]) for j, key in
              enumerate(keys)} for col in cols]
    b, nd = len(whole[0]["tokens"]), mesh.n_data
    if b % (k * nd):
        raise ValueError(f"microbatch {k} of a batch of {b} does not split "
                         f"over {nd} data rows")
    per = b // (k * nd)
    out = []
    for i in range(k):
        out.append(([{key: v[(i * nd + d) * per:(i * nd + d + 1) * per]
                      for key, v in w.items()}
                     for w, d in zip(whole, (mesh.data_index(s)
                                             for s in mesh.local_shards))],
                    [None] * len(rows)))
    return out


def build_mesh_train_step(cfg: ArchConfig, run: RunConfig, mesh,
                          device) -> dict:
    """The train step over ``mesh`` (``models.parallel``), with the
    reference's keys: ``fn``, ``params_spec``, ``opt_spec``,
    ``batch_specs``, ``rules``, ``out_specs``; and ``layout``,
    ``loss_and_grads`` and ``device``.

    ``fn(params, opt_state, batch, step)`` takes a
    :class:`~repro_torch.models.parallel.ShardedParams`, AdamW's state of
    its slices (``{"mu": {shard: [...]}, "nu": {shard: [...]},
    "count"}``), the local shards' parts of the batch
    (:func:`place_batch`) and the step number, and updates the slices in
    place.  The loss is the ordered sum over the data rows of their loss
    sums over the ordered sum of their valid counts, ``_ce_loss`` over the
    whole batch; the gradients come back to each shard's slices
    (``Layout.reduce``), are clipped to the global norm of every element
    counted once, and AdamW runs on each shard's slices.  With
    ``run.microbatch = k > 1`` the gradients of k microbatches are
    accumulated as on one device: microbatch ``i`` holds the global batch's
    rows ``[i B/k, (i+1) B/k)``, cut over the data rows
    (:func:`_microbatches`)."""
    from ..models.parallel import Layout, ShardedForward
    from ..models.sharding_ctx import mesh_ctx
    from .mesh import data_axes, model_axis

    _check_mesh(mesh)
    layout = Layout(cfg, run, mesh)
    rules, forward = layout.rules, ShardedForward(layout, run)
    local = mesh.local_shards
    k = max(run.microbatch, 1)

    def batch_loss(views, rows, own):
        trees = [layout.tree(views[s]) for s in local]
        parts = forward(trees, rows, own)
        counts = mesh.sum_data([[c] for _, c in parts], "count")
        sums = mesh.sum_data([[ls.detach()] for ls, _ in parts], "loss")
        contrib = [ls / c[0].clamp_min(1) for (ls, _), c in zip(parts, counts)]
        flat = [t for s in local for t in views[s]]
        got = torch.autograd.grad(contrib, flat, allow_unused=True)
        n = len(layout.leaves)
        grads = {s: [torch.zeros_like(v) if g is None else g for v, g in
                     zip(views[s], got[j * n:(j + 1) * n])]
                 for j, s in enumerate(local)}
        return sums[0][0] / counts[0][0].clamp_min(1), grads

    def loss_and_grads(params, batch: ShardedBatch):
        specs = rules.batch({key: torch.empty(v, device="meta")
                             for key, v in batch.shapes.items()})
        forward.rows_split = specs["tokens"][0] is not None
        with mesh_ctx(mesh, data_axes(mesh), model_axis(mesh)):
            views = layout.views(params)
            rows, own = _row_batches(batch, mesh, rules, batch.shapes)
            if k <= 1:
                return batch_loss(views, rows, own)
            micro = _microbatches(rows, own, mesh, k, forward.rows_split)
            loss = torch.zeros((), dtype=torch.float32,
                               device=rows[0]["tokens"].device)
            grads = {s: [torch.zeros_like(v, dtype=torch.float32)
                         for v in views[s]] for s in local}
            for mrows, mown in micro:
                li, gi = batch_loss(views, mrows, mown)
                loss = loss + li / k
                grads = {s: [a + g / k for a, g in zip(grads[s], gi[s])]
                         for s in local}
            return loss, grads

    def train_step(params, opt_state, batch, step: int):
        loss, grads = loss_and_grads(params, batch)
        stored, gnorm = layout.reduce(grads)
        del grads
        scale = torch.clamp(run.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = lr_schedule(step, run.learning_rate, run.warmup)
        count = opt_state["count"]
        for s in local:
            g = torch._foreach_mul(stored[s], scale)
            state = {"mu": opt_state["mu"][s], "nu": opt_state["nu"][s],
                     "count": count}
            _, state = adamw_update(params.shards[s], g, state, lr=lr,
                                    weight_decay=run.weight_decay)
            opt_state["count"] = state["count"]
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    # the reference's specs, keyed by its leaves' paths (stacked shapes)
    p_spec = {path: rules.param_spec(path, stacked)
              for _, path, _, stacked in layout.leaves}
    o_spec = rules.opt_state(None, p_spec)
    return {"fn": train_step, "loss_and_grads": loss_and_grads,
            "params_spec": p_spec, "opt_spec": o_spec,
            "batch_specs": rules.batch, "rules": rules,
            "out_specs": (p_spec, o_spec, {"loss": (), "gnorm": (),
                                           "lr": ()}),
            "layout": layout, "device": device}


def mesh_adamw_init(params) -> dict:
    """AdamW's zero state of a :class:`~repro_torch.models.parallel.
    ShardedParams`' slices."""
    from ..optim import adamw_init
    states = {s: adamw_init(leaves) for s, leaves in params.shards.items()}
    return {"mu": {s: st["mu"] for s, st in states.items()},
            "nu": {s: st["nu"] for s, st in states.items()}, "count": 0}


def _check_mesh(mesh):
    from .mesh import Mesh
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a launch.mesh.Mesh, not "
                        f"{type(mesh).__name__}")


def _server(cfg, run, mesh, device) -> dict:
    """A mesh's serving steps (``models.parallel_serve``) with the
    reference's keys."""
    from ..models.parallel_serve import ShardedServer
    _check_mesh(mesh)
    server = ShardedServer(cfg, run, mesh)
    rules = server.layout.rules
    return {"server": server, "rules": rules, "device": device,
            "params_spec": {path: rules.param_spec(path, stacked) for
                            _, path, _, stacked in server.layout.leaves}}


def build_prefill_step(cfg: ArchConfig, run: RunConfig, device=None,
                       mesh=None) -> dict:
    """``{"fn": prefill_step, "device": device}``.  ``prefill_step(params,
    batch, cache_len=0)`` gives the prompt's last logits and its decode
    cache for ``cache_len`` positions (``models.transformer.prefill``).
    ``device=None`` means ``"cuda"``.  With ``mesh`` the params are a
    :class:`~repro_torch.models.parallel.ShardedParams`, the cache a
    :class:`~repro_torch.models.parallel_serve.MeshCache` placed by
    ``Rules.cache``, the logits whole (``ShardedServer.prefill``)."""
    device = resolve_device(device)
    if mesh is not None:
        built = _server(cfg, run, mesh, device)
        return dict(built, fn=built["server"].prefill)
    model = make_model(cfg)

    def prefill_step(params, batch, cache_len: int = 0):
        return model["prefill"](params, batch, run, cache_len)

    return {"fn": prefill_step, "device": device}


def build_decode_step(cfg: ArchConfig, run: RunConfig, device=None,
                      mesh=None) -> dict:
    """``{"fn": decode_step, "device": device}``.  ``decode_step(params,
    cache, tokens, pos)`` gives the logits of ``tokens`` (B, 1) at position
    ``pos`` and the cache, updated in place.  ``device=None`` means
    ``"cuda"``.  With ``mesh``, as :func:`build_prefill_step`'s
    (``ShardedServer.decode``)."""
    device = resolve_device(device)
    if mesh is not None:
        built = _server(cfg, run, mesh, device)
        return dict(built, fn=built["server"].decode)
    model = make_model(cfg)

    def decode_step(params, cache, tokens, pos: int):
        return model["decode_step"](params, cache, tokens, pos, run)

    return {"fn": decode_step, "device": device}
