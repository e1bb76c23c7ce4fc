"""Step builders of the port: ``repro.launch.steps.build_infer_step`` and
``build_train_step``, without a mesh, shardings or ``jit``.

:func:`build_infer_step` builds the probabilistic-inference step, full-batch
VMP or SVI (over a resident or a sharded corpus).  :func:`build_train_step`
builds the LM step: the loss and its gradient (``torch.autograd.grad``, so
no ``.grad`` state is kept between steps; with ``run.microbatch > 1``
accumulated over slices of the batch), the clip to the global norm, the
learning rate from the schedule and AdamW in place.
:func:`build_prefill_step` and :func:`build_decode_step` build the serving
steps.  PyTorch runs them eagerly on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig, RunConfig
from ..core.vmp import resolve_device
from ..models import make_model
from ..models.transformer import check_slice, modality_inputs
from ..optim import adamw_update, clip_by_global_norm, lr_schedule


def batch_to(batch: dict, device) -> dict:
    """A numpy batch (``TokenStream.batch_at``, with an encoder-decoder's
    ``frames`` or a vision model's ``patches``) as tensors on ``device``:
    integer entries as int64, floating ones as f32."""
    def one(v):
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


def build_train_step(cfg: ArchConfig, run: RunConfig, device=None) -> dict:
    """``{"fn": train_step, "device": device}``.  ``train_step(params,
    opt_state, batch, step)`` takes a
    :class:`~repro_torch.models.transformer.Decoder`, its AdamW state, a
    batch of tensors on ``device`` and the step number; it updates the
    parameters and the state in place and returns ``(params, opt_state,
    {"loss", "gnorm", "lr"})``, the loss and norm as 0-d tensors.
    ``device=None`` means ``"cuda"``.

    ``run.microbatch = k > 1`` splits the batch into k slices along dim 0
    and adds each slice's ``loss / k`` and ``grad / k`` to f32 zeros in
    slice order, as the reference's ``lax.scan`` does; a batch that k does
    not divide raises ``ValueError``."""
    check_slice(cfg, run)
    device = resolve_device(device)
    model = make_model(cfg)
    k = run.microbatch
    if k > 1 and run.global_batch % k:
        raise ValueError(f"microbatch {k} does not divide the global batch "
                         f"of {run.global_batch}")

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

    return {"fn": train_step, "device": device}


def build_prefill_step(cfg: ArchConfig, run: RunConfig, device=None) -> dict:
    """``{"fn": prefill_step, "device": device}``.  ``prefill_step(params,
    batch, cache_len=0)`` gives the prompt's last logits and its decode
    cache for ``cache_len`` positions (``models.transformer.prefill``).
    ``device=None`` means ``"cuda"``."""
    device = resolve_device(device)
    model = make_model(cfg)

    def prefill_step(params, batch, cache_len: int = 0):
        return model["prefill"](params, batch, run, cache_len)

    return {"fn": prefill_step, "device": device}


def build_decode_step(cfg: ArchConfig, run: RunConfig, device=None) -> dict:
    """``{"fn": decode_step, "device": device}``.  ``decode_step(params,
    cache, tokens, pos)`` gives the logits of ``tokens`` (B, 1) at position
    ``pos`` and the cache, updated in place.  ``device=None`` means
    ``"cuda"``."""
    device = resolve_device(device)
    model = make_model(cfg)

    def decode_step(params, cache, tokens, pos: int):
        return model["decode_step"](params, cache, tokens, pos, run)

    return {"fn": decode_step, "device": device}
