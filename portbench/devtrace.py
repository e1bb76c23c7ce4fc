"""Reading a few steps under ``torch.profiler``: the device's busy time and
idle share, the device time of kernels launched under PyTorch's own
``aten::`` operators, and the breakdown the result line carries.

The steps run inside one ``record_function`` span (:data:`SPAN`), whose
interval is the traced window.  Device events are the CUDA activities that
kineto reports (kernels, copies, fills), less the device-side echoes of
the benchmark's own spans (every name under ``portbench.``).  While the
steps are profiled, :func:`layer_spans` wraps a few calls of the program's
runtime in named spans, so that an idle gap can say what the host was
doing.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from collections import defaultdict

import torch

SPAN = "portbench.steps"
PREFIX = "portbench."

#: calls of the port's step that get a span of their own while profiled:
#: (module, attribute) -> span name.  The step looks each up at call time.
LAYER_SPANS = {
    ("repro_torch.core.vmp", "_elog_tables"): "portbench.elog_tables",
    ("repro_torch.kernels.ops", "zstats"): "portbench.zstats",
    ("repro_torch.kernels.ops", "dirichlet_elbo_term"): "portbench.elbo_term",
    ("repro_torch.core.vmp", "_updated"): "portbench.update",
}


@contextlib.contextmanager
def layer_spans(spans=LAYER_SPANS):
    """Wrap each named call in a ``record_function`` span for the block."""
    from torch.profiler import record_function
    saved = []

    def wrap(fn, name):
        def call(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return call

    try:
        for (mod_name, attr), name in spans.items():
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, wrap(fn, name))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _self_device_us(ev) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(ev, name):
            return float(getattr(ev, name))
    return 0.0


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_steps(run, n_steps: int, device) -> dict:
    """Run ``run()`` (``n_steps`` steps) under the profiler and read it.

    Returns ``window_s`` (the span's length), ``busy_s`` (the union of
    device intervals inside it), ``aten_device_s`` (device time of kernels
    under ``aten::`` operators), ``n_steps``, ``device_ops`` (device seconds
    by name) and ``idle_gaps`` (idle seconds by what the host was doing),
    each sorted, largest first."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with layer_spans(), record_function(SPAN):
            run()
            if cuda:
                torch.cuda.synchronize()
    t0 = time.perf_counter()
    events = list(prof.events())
    dev_type = torch.autograd.DeviceType.CUDA
    span = next(e for e in events if e.name == SPAN
                and e.device_type != dev_type)
    s0, s1 = span.time_range.start, span.time_range.end
    device_ops = defaultdict(float)
    intervals = []
    for e in events:
        if e.device_type != dev_type or e.name.startswith(PREFIX) or \
                getattr(e, "is_user_annotation", False):
            continue
        a, b = max(e.time_range.start, s0), min(e.time_range.end, s1)
        if b > a:
            intervals.append((a, b))
            device_ops[e.name[:120]] += (b - a) * 1e-6
    busy = _union(intervals)
    busy_us = sum(b - a for a, b in busy)
    aten_us = sum(_self_device_us(ev) for ev in prof.key_averages()
                  if ev.key.startswith("aten::"))
    # idle gaps and the innermost host event running at each gap's middle
    host = [e for e in events if e.device_type != dev_type and
            e.thread == span.thread and e.name != SPAN and
            e.time_range.end > e.time_range.start]
    gaps = defaultdict(float)
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inside = [e for e in host
                  if e.time_range.start <= mid < e.time_range.end]
        name = min(inside, key=lambda e: e.time_range.end -
                   e.time_range.start).name if inside else "python"
        gaps[name[:120]] += (b - a) * 1e-6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]
    return {"window_s": (s1 - s0) * 1e-6, "busy_s": busy_us * 1e-6,
            "aten_device_s": aten_us * 1e-6, "n_steps": n_steps,
            "device_ops": top(device_ops), "idle_gaps": top(gaps),
            "read_s": time.perf_counter() - t0}
