"""Inference execution: the paper's section 4.3 ("Execution") analogue.

The port of ``repro.core.runtime``: runs the VMP step in a loop with the
paper's callback API (Figure 12): ``callback(iteration, elbo) -> bool`` —
return False to stop early.  PyTorch runs eagerly, so the step is a plain
function over device tensors.  Checkpointing arrives with the checkpoint
slice of the port and raises until then.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .compiler import VMPProgram
from .vmp import VMPState, _program_arrays, _step_body, init_state, resolve_device


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
    elog_dtype = _resolve_elog_dtype(elog_dtype)

    def step(state: VMPState):
        return _step_body(program, arrays, state, elog_dtype=elog_dtype)

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
    state is given; a state elsewhere than ``device`` is moved there.
    """
    if checkpoint_every or checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpointing arrives with the checkpoint slice of the port")
    if device is None and state is not None:
        device = state.device
    device = resolve_device(device)
    if state is None:
        state = init_state(program, seed, device=device)
    elif state.device != device:
        state = VMPState({n: p.to(device) for n, p in state.posteriors.items()},
                         state.step)
    step_fn = make_step(program, elog_dtype=elog_dtype, device=device)

    trace: list[float] = []
    start = int(state.step)
    for i in range(start, start + steps):
        state, elbo = step_fn(state)
        elbo_f = float(elbo)
        trace.append(elbo_f)
        if callback is not None and callback(i, elbo_f) is False:
            break
    return state, trace
