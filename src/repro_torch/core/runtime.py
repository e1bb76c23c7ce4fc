"""Inference execution: the paper's section 4.3 ("Execution") analogue.

The port of ``repro.core.runtime``: runs the VMP step in a loop with
  - the paper's callback API (Figure 12): ``callback(iteration, elbo) ->
    bool`` — return False to stop early;
  - checkpoint-every-k with crash resume (paper section 4.2's lineage
    checkpointing, repurposed for fault tolerance), in the JAX package's
    file format (``checkpoint/store.py``).
PyTorch runs eagerly, so the step is a plain function over device tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .compiler import VMPProgram
from .vmp import (VMPState, _program_arrays, _step_body, init_state,
                  program_plans, resolve_device)


def _resolve_elog_dtype(elog_dtype):
    """``None``, ``"float32"`` or ``"f32"`` -> None (full width); a name such
    as ``"bfloat16"`` -> the torch dtype; a torch dtype passes through."""
    if elog_dtype is None or isinstance(elog_dtype, str) and \
            elog_dtype in ("", "float32", "f32"):
        return None
    return getattr(torch, elog_dtype) if isinstance(elog_dtype, str) \
        else elog_dtype


def make_step(program: VMPProgram, elog_dtype=None, device=None):
    """``step(state) -> (state, elbo)`` on ``device`` (``None`` means
    ``"cuda"``).  ``elog_dtype`` narrows the concentration tables the token
    plate reads — see ``vmp._step_body``."""
    arrays = _program_arrays(program, resolve_device(device))
    plans = program_plans(program, arrays)
    elog_dtype = _resolve_elog_dtype(elog_dtype)

    def step(state: VMPState):
        return _step_body(program, arrays, state, elog_dtype=elog_dtype,
                          plans=plans)

    return step


def run_inference(program: VMPProgram, steps: int = 20,
                  callback: Optional[Callable] = None,
                  checkpoint_every: int = 0,
                  checkpoint_dir: Optional[str] = None,
                  state: Optional[VMPState] = None,
                  seed: int = 0,
                  elog_dtype=None,
                  device=None):
    """Run ``steps`` VMP iterations; returns (state, elbo_trace).

    ``device`` defaults to ``"cuda"``, or to the device of ``state`` when a
    state is given; a state elsewhere than ``device`` is moved there.  With
    ``checkpoint_every`` and ``checkpoint_dir`` both set, the state is saved
    every ``checkpoint_every`` steps (asynchronously; durable on return),
    and a directory that already holds a checkpoint is resumed from its
    newest valid one.
    """
    from ..checkpoint import CheckpointStore
    if device is None and state is not None:
        device = state.device
    device = resolve_device(device)
    if state is None:
        state = init_state(program, seed, device=device)

    store = None
    if checkpoint_every and checkpoint_dir:
        store = CheckpointStore(checkpoint_dir, every=checkpoint_every)
        if store.latest() is not None:
            state = store.restore(state)
    if state.device != device:
        state = VMPState({n: p.to(device) for n, p in state.posteriors.items()},
                         state.step)
    step_fn = make_step(program, elog_dtype=elog_dtype, device=device)

    trace: list[float] = []
    start = int(state.step)
    for i in range(start, start + steps):
        state, elbo = step_fn(state)
        elbo_f = float(elbo)
        trace.append(elbo_f)
        if store is not None:
            store.maybe_save(i + 1, state)
        if callback is not None and callback(i, elbo_f) is False:
            break
    if store is not None:
        store.wait()              # final async checkpoint durable on return
    return state, trace
