"""The LM train step of the port: ``repro.launch.steps.build_train_step``
without a mesh, shardings or ``jit``.

One step runs the loss and its gradient (``torch.autograd.grad``, so no
``.grad`` state is kept between steps), clips the gradients to the global
norm, reads the learning rate from the schedule and applies AdamW in place.
PyTorch runs it eagerly on the parameters' device.
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
