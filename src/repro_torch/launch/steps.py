"""Step builders of the port: ``repro.launch.steps.build_infer_step`` and
``build_train_step``, without a mesh, shardings or ``jit``.

:func:`build_infer_step` builds the probabilistic-inference step, full-batch
VMP or SVI (over a resident or a sharded corpus).  :func:`build_train_step`
builds the LM step: the loss and its gradient (``torch.autograd.grad``, so
no ``.grad`` state is kept between steps), the clip to the global norm, the
learning rate from the schedule and AdamW in place.  PyTorch runs both
eagerly on one device.
"""

from __future__ import annotations

import torch

from ..configs.base import ArchConfig, RunConfig
from ..core.vmp import resolve_device
from ..models import make_model
from ..models.transformer import check_slice
from ..optim import adamw_update, clip_by_global_norm, lr_schedule


def batch_to(batch: dict, device) -> dict:
    """A numpy batch (``TokenStream.batch_at``) as int64 tensors on
    ``device``."""
    return {k: torch.from_numpy(v).to(device, torch.int64)
            for k, v in batch.items()}


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
    template from :func:`repro_torch.data.store.sharded_template`.  A
    sharding plan (``EngineConfig.sharding``) belongs to the distributed
    slice of the port.
    """
    from ..core.engine import EngineConfig
    from ..core.runtime import make_step
    from ..core.svi import SVI, SVIConfig
    from ..core.vmp import init_state

    if isinstance(engine, str):
        engine = EngineConfig(backend=engine)
    if engine.sharding is not None:
        raise NotImplementedError(
            "a sharded step (EngineConfig.sharding) arrives with the "
            "distributed slice of the port")
    corpus = corpus if corpus is not None else engine.corpus
    device = resolve_device(engine.device)
    if engine.backend == "vmp":
        if corpus is not None:
            raise ValueError("full-batch VMP needs a resident corpus; use "
                             "engine='svi' for out-of-core inference")
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
            corpus=corpus, hosts=engine.hosts, device=device)

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
    ``device=None`` means ``"cuda"``."""
    check_slice(cfg, run)
    device = resolve_device(device)
    model = make_model(cfg)

    def train_step(params, opt_state, batch, step: int):
        leaves = list(params.parameters())
        loss = model["train_loss"](params, batch, run)
        grads = list(torch.autograd.grad(loss, leaves))
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        lr = lr_schedule(step, run.learning_rate, run.warmup)
        _, opt_state = adamw_update(leaves, grads, opt_state, lr=lr,
                                    weight_decay=run.weight_decay)
        return params, opt_state, {"loss": loss.detach(), "gnorm": gnorm,
                                   "lr": lr}

    return {"fn": train_step, "device": device}
