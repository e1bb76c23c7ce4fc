"""The port's LM trainer: ``repro.launch.train.train`` on one device.

``train`` builds the step (``steps.build_train_step``), restores the latest
checkpoint of ``checkpoint_dir`` or initialises the parameters (the port's
own initialisation from ``run.seed``, or ``params=``), and runs ``steps``
steps over ``TokenStream`` batches, recording each step's host time (the
loss's ``float`` ends each step, so the time covers the device's work).
Every ``checkpoint_every`` steps it saves ``{"params", "opt", "step"}``
through ``checkpoint.CheckpointStore`` in the reference's trees and file
format, so that either package reads the other's parameters.  With
``mesh=`` (a :class:`~repro_torch.launch.mesh.Mesh`) each shard stores and
updates what ``shardings.Rules`` gives it (``steps.build_mesh_train_step``)
and a checkpoint holds the tree gathered whole, written by rank 0: it
resumes on any mesh, or on none.

Usage (a reduced olmo on the CPU; on the card drop ``--device``; ``--arch``
names any decoder of the registry, recurrentgemma-2b and mamba2-370m too;
whisper-large-v3 and internvl2-1b also read frames or patches and are
trained through ``steps.build_train_step``):
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 \\
      --d-model 64 --layers 2 --seq 32 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4 \\
      --arch recurrentgemma-2b --d-model 64 --layers 3 --seq 32 --batch 4
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..checkpoint import CheckpointStore
from ..configs import RunConfig, get_arch
from ..data import TokenStream
from ..models import make_model, params_from_numpy, params_to_numpy
from ..models.transformer import Decoder
from ..optim import adamw_init
from .dist import process_index
from .steps import (batch_to, build_train_step, mesh_adamw_init, place_batch,
                    tokens_only)


class StepTelemetry:
    """Step-time tracker; flags outlier steps (the straggler signal that a
    real cluster controller would act on)."""

    def __init__(self, window: int = 50):
        self.times: list[float] = []
        self.window = window
        self.stragglers = 0

    def record(self, dt: float) -> bool:
        self.times.append(dt)
        hist = self.times[-self.window:-1]
        if len(hist) >= 10 and dt > 3.0 * float(np.median(hist)):
            self.stragglers += 1
            return True
        return False

    def summary(self) -> dict:
        arr = np.array(self.times[1:] or [0.0])
        return {"steps": len(self.times),
                "mean_s": float(arr.mean()),
                "p50_s": float(np.percentile(arr, 50)),
                "p95_s": float(np.percentile(arr, 95)),
                "stragglers": self.stragglers}


def state_to_numpy(cfg, params, opt_state, step: int) -> dict:
    """The trainer's checkpoint tree: the parameters and AdamW's moments in
    the reference's parameter tree, its count and the next step as int32
    scalars."""
    return {"params": params_to_numpy(cfg, params),
            "opt": {"mu": params_to_numpy(cfg, params, opt_state["mu"]),
                    "nu": params_to_numpy(cfg, params, opt_state["nu"]),
                    "count": np.int32(opt_state["count"])},
            "step": np.int32(step)}


def mesh_state_to_numpy(layout, params, opt_state, step: int) -> dict:
    """:func:`state_to_numpy` of a mesh run: the parameters and moments
    gathered whole from every shard's slices (every rank takes part)."""
    from ..models.parallel import gather_leaves
    shell = Decoder(layout.cfg, None, "meta")
    mu, nu = (gather_leaves(layout, opt_state[k], "cpu") for k in ("mu", "nu"))
    return {"params": params_to_numpy(
                layout.cfg, shell, gather_leaves(layout, params.shards, "cpu")),
            "opt": {"mu": params_to_numpy(layout.cfg, shell, mu),
                    "nu": params_to_numpy(layout.cfg, shell, nu),
                    "count": np.int32(opt_state["count"])},
            "step": np.int32(step)}


def to_mesh(layout, params, opt_state):
    """A one-device ``(Decoder, AdamW state)`` placed as the mesh's shards
    store it (``opt_state`` None: zero moments)."""
    from ..models.parallel import ShardedParams
    sharded = ShardedParams.from_module(layout, params)
    if opt_state is None:
        return sharded, mesh_adamw_init(sharded)
    moments = {k: ShardedParams.from_leaves(layout, opt_state[k]).shards
               for k in ("mu", "nu")}
    return sharded, dict(moments, count=opt_state["count"])


def restore_state(cfg, store: CheckpointStore, device):
    """``(params, opt_state, step)`` from ``store``'s latest checkpoint,
    on ``device``."""
    shell = Decoder(cfg, None, "meta")
    like = params_to_numpy(cfg, shell, [torch.empty(0)] *
                           len(list(shell.parameters())))
    tree = store.restore({"params": like,
                          "opt": {"mu": like, "nu": like, "count": 0},
                          "step": 0})

    def leaves(t):
        return [p.detach() for p in
                params_from_numpy(cfg, t, device).parameters()]
    opt_state = {"mu": leaves(tree["opt"]["mu"]),
                 "nu": leaves(tree["opt"]["nu"]),
                 "count": int(tree["opt"]["count"])}
    return params_from_numpy(cfg, tree["params"], device), opt_state, \
        int(tree["step"])


def train(cfg, run: RunConfig, steps: int, mesh=None,
          checkpoint_dir: str | None = None, checkpoint_every: int = 0,
          log_every: int = 10, start_step: int | None = None, *,
          device=None, params=None):
    """Returns ``(params, opt_state, losses, telemetry)``.  The positional
    parameters are the reference's, in its order; ``device`` and
    ``params`` are the port's own, by keyword only.  ``device=None``
    means ``"cuda"``; ``params`` (a ``Decoder`` on that device, updated in
    place) replaces the initialisation, so that a caller can start from a
    given state.  With ``checkpoint_dir`` the run resumes from its latest
    checkpoint (``params`` must then be ``None``) and saves one every
    ``checkpoint_every`` steps; ``start_step`` overrides the step it starts
    from, as the reference's does.  The batches are ``TokenStream``'s,
    tokens only: an architecture whose batch needs ``frames`` or
    ``patches`` (whisper, internvl2) raises ``ValueError``.  With ``mesh``
    the parameters returned are the shards'
    (:class:`~repro_torch.models.parallel.ShardedParams`; ``params=`` may
    still be a ``Decoder``, which is placed), the state their moments."""
    tokens_only(cfg, "train", "build_train_step")
    built = build_train_step(cfg, run, device, mesh=mesh)
    device = built["device"]
    stream = TokenStream(vocab=cfg.vocab, seq_len=run.seq_len,
                         batch=run.global_batch, seed=run.seed)

    store, first, opt_state = None, 0, None
    if checkpoint_dir:
        store = CheckpointStore(checkpoint_dir, every=max(checkpoint_every, 1))
        if store.latest() is not None:
            if params is not None:
                raise ValueError(f"params= and the checkpoint in "
                                 f"{checkpoint_dir} both give the start")
            params, opt_state, first = restore_state(cfg, store, device)
    if params is None:
        params = make_model(cfg)["init"](run, device=device)
    if mesh is not None and isinstance(params, Decoder):
        params, opt_state = to_mesh(built["layout"], params, opt_state)
    if opt_state is None:
        opt_state = adamw_init(list(params.parameters()))
    if start_step is not None:
        first = start_step

    telemetry = StepTelemetry()
    losses = []
    for i in range(first, first + steps):
        batch = batch_to(stream.batch_at(i), device) if mesh is None else \
            place_batch(stream.batch_at(i), mesh, built["rules"], device)
        t0 = time.time()
        params, opt_state, metrics = built["fn"](params, opt_state, batch, i)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        straggle = telemetry.record(dt)
        losses.append(loss)
        if store is not None and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            tree = state_to_numpy(cfg, params, opt_state, i + 1) \
                if mesh is None else mesh_state_to_numpy(
                    built["layout"], params, opt_state, i + 1)
            if process_index() == 0:
                store.maybe_save(i + 1, tree)
        if log_every and (i % log_every == 0 or straggle):
            print(f"[train] step {i:5d} loss {loss:8.4f} "
                  f"{dt*1e3:7.1f} ms{'  STRAGGLER' if straggle else ''}")
    if store is not None:
        store.wait()              # the last checkpoint durable on return
    return params, opt_state, losses, telemetry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.layers or args.d_model:
        cfg = dataclasses.replace(
            cfg,
            n_layers=args.layers or cfg.n_layers,
            d_model=args.d_model or cfg.d_model,
            n_heads=max(4, (args.d_model or cfg.d_model) // 64),
            n_kv_heads=max(2, (args.d_model or cfg.d_model) // 128),
            head_dim=64, d_ff=4 * (args.d_model or cfg.d_model),
            vocab=min(cfg.vocab, 32000))
    run = RunConfig(seq_len=args.seq, global_batch=args.batch,
                    dtype="float32")
    _, _, losses, tel = train(cfg, run, args.steps, device=args.device,
                              checkpoint_dir=args.ckpt_dir,
                              checkpoint_every=args.ckpt_every)
    print(f"[train] first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    print(f"[train] telemetry {tel.summary()}")


if __name__ == "__main__":
    main()
