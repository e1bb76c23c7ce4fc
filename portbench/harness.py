"""One run of one cell: the inputs from the seed, the port's set-up, the
checked steps, the timed window, the traced extras and the comparison.

Everything a cell needs is found by name, so a later cell, traffic mix or
metric is a set of new files and entries:

  - ``BENCHMARK.json`` at the root: the cell's configuration and traffic,
    its end-to-end and per-layer metrics;
  - ``portbench/configs/<config>.json``: the model (``model``, ``dsl``),
    its corpus (``corpus``), how the corpus is observed (``observe``),
    and the parent map of each intermediate plate (``bind``: ``{plate:
    corpus key}``, as SLDA's sentences);
  - ``portbench/traffic/<traffic>.json``: the fit (``checked_steps``,
    ``warmup_steps``, ``profiled_steps``);
  - ``portbench/reference/<model>.py``: the plain model (``dirichlets``,
    ``model``, and ``step`` and ``FAULTS`` where the model's latent is not
    flat; else ``reference/flat.py``'s), and the step work
    ``portbench/work/<step_work>.py``;
  - ``portbench/metrics/<metric>.py``: a reader ``read(ctx)`` per
    per-layer metric, which may name a call of the port to time
    (``WRAP = "module:attribute"``, with ``signature(args, kwargs)``);
  - ``portbench/limits/<workload>.json``: the limit of each number the
    comparison holds (``check.py``).

Nothing here imports the port before :func:`run_cell` has made and handed
over the inputs; the port is imported, set up and driven through its own
entry points (``core.models.make``, ``observe``, ``bind``, ``compile``,
``runtime.make_step``, ``runtime.run_inference``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import check  # noqa: E402
import corpus as corpus_mod  # noqa: E402

#: top-level module names that no run may load
BANNED = ("jax", "jaxlib", "flax", "repro")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the cell, by name
# ---------------------------------------------------------------------------

def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root, workload: str) -> dict:
    """The cell's manifest entries and files: ``workload``, ``config``,
    ``traffic``, ``limits``, ``end_to_end``, ``per_layer`` (each metric
    with its reader module as ``reader``), ``reference`` and
    ``step_work`` (modules)."""
    root = Path(root)
    bench = root / "portbench"
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    try:
        w = next(x for x in manifest["workloads"] if x["name"] == workload)
    except StopIteration:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json") from None
    entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    per_layer = []
    for m in manifest["per_layer"]:
        if _applies(m, workload):
            per_layer.append(dict(m, reader=_load(
                bench / "metrics" / f"{m['name']}.py",
                f"portbench_metric_{m['name'].replace('.', '_')}")))
    return {"workload": w, "config": config, "traffic": traffic,
            "limits": limits, "per_layer": per_layer,
            "end_to_end": [m for m in manifest["end_to_end"]
                           if _applies(m, workload)],
            "reference": importlib.import_module(
                f"reference.{config['model']}"),
            "step_work": importlib.import_module(
                f"work.{config['step_work']}")}


# ---------------------------------------------------------------------------
# clocks
# ---------------------------------------------------------------------------

class Marks:
    """Pairs of marks around device work: CUDA events on the card (read
    once the work is done), the host clock after a synchronise elsewhere."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pairs = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, start):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pairs.append((start, ev))
        else:
            self.pairs.append((start, time.perf_counter()))

    def ms(self) -> list:
        """Milliseconds of each pair, in order."""
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.pairs]
        return [(b - a) * 1e3 for a, b in self.pairs]


class PortPeak:
    """The port's peak device memory: ``torch.cuda.max_memory_allocated``
    over the stretches in which only the port and its inputs hold memory.
    The benchmark's own readings run between :meth:`pause` and
    :meth:`resume`, and what they allocate is left out."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.bytes = 0
        self.resume()

    def pause(self):
        if self.cuda:
            self.bytes = max(self.bytes, int(torch.cuda.max_memory_allocated()))

    def resume(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()

    def read(self) -> int:
        self.pause()
        return self.bytes


class Wrapped:
    """A call of the port timed while the window runs: the module
    attribute ``target`` (``"module:attribute"``) replaced by a wrapper
    that marks each call and keeps what ``signature(args, kwargs)`` takes
    of the first call with each distinct signature key."""

    def __init__(self, target: str, signature, device):
        self.mod_name, self.attr = target.split(":")
        self.signature = signature
        self.marks = Marks(device)
        self.keys = []              # signature key of each call
        self.sigs = {}

    def __enter__(self):
        self.mod = importlib.import_module(self.mod_name)
        self.fn = getattr(self.mod, self.attr)

        def call(*a, **kw):
            key, sig = self.signature(a, kw)
            self.keys.append(key)
            self.sigs.setdefault(key, sig)
            t = self.marks.start()
            out = self.fn(*a, **kw)
            self.marks.stop(t)
            return out
        setattr(self.mod, self.attr, call)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.attr, self.fn)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def make_inputs(cell: dict, seed: int, device, trace: bool) -> dict:
    """The corpus on ``device`` from the seed, copied to the host for the
    port; with ``trace``, the step's work counted from it first."""
    cfg = cell["config"]
    corp = corpus_mod.make(cfg["corpus"], seed, device)
    work = None
    if trace:
        work = cell["step_work"].of_model(
            cell["reference"].model(cfg, corp))
    host = {k: v.cpu().numpy() for k, v in corp.items()}
    return {"host": host, "n_tokens": int(len(host["tokens"])),
            "step_work": work}


def posts0(cell: dict, seed: int, device) -> dict:
    """The starting posteriors of the cell's Dirichlets, from the seed."""
    return corpus_mod.initial_posteriors(
        cell["reference"].dirichlets(cell["config"]), seed, device)


def reference_step(cell: dict) -> tuple:
    """``(step, FAULTS)`` of the cell's plain reference: its own where its
    module defines them, else ``reference/flat.py``'s."""
    ref = cell["reference"]
    flat = importlib.import_module("reference.flat")
    return (getattr(ref, "step", flat.step),
            getattr(ref, "FAULTS", flat.FAULTS))


def priors(cell: dict) -> dict:
    return {n: p for n, (_, _, p) in
            cell["reference"].dirichlets(cell["config"]).items()}


def build_program(cell: dict, host: dict, device, spans: dict):
    """The port's front end and set-up: ``(program, step)``."""
    from repro_torch.core import models, runtime
    cfg = cell["config"]
    t = time.perf_counter()
    m = models.make(cfg["model"], **cfg["dsl"])
    for rv, spec in cfg["observe"].items():
        m[rv].observe(host[spec["values"]],
                      segment_ids=host[spec["segment_ids"]])
    for plate, key in cfg.get("bind", {}).items():
        m.bind(plate, host[key])
    prog = m.compile()
    spans["compile"] = time.perf_counter() - t
    t = time.perf_counter()
    step = runtime.make_step(prog, device=device)
    _sync(device)
    spans["make_step"] = time.perf_counter() - t
    return prog, step


def checked_steps(cell: dict, prog, step, seed: int, device,
                  peak: PortPeak) -> tuple:
    """The first steps through ``run_inference`` with the window's own
    step, from the seed's starting posteriors: ``(state, readings, check
    seconds)``, the seconds spent on the readings themselves, whose
    device memory ``peak`` leaves out."""
    from repro_torch.core import runtime, vmp
    n = int(cell["traffic"]["checked_steps"])
    # no name here holds a state that the port has stepped past: each
    # call takes its state from a list, and the list lets go of it
    state, elbos = runtime.run_inference(
        prog, steps=1, state=vmp.VMPState(posts0(cell, seed, device), 0),
        step_fn=step)
    peak.pause()
    t = time.perf_counter()
    pri = priors(cell)
    stats = {k: check.norm(p, pri[k]) for k, p in state.posteriors.items()}
    spent = time.perf_counter() - t
    peak.resume()
    box = [state]
    del state
    state, more = runtime.run_inference(prog, steps=n - 1, state=box.pop(),
                                        step_fn=step)
    peak.pause()
    t = time.perf_counter()
    p0 = posts0(cell, seed, device)
    change = {k: check.norm(p, p0[k]) for k, p in state.posteriors.items()}
    del p0
    spent += time.perf_counter() - t
    peak.resume()
    return state, {"elbos": elbos + more, "stats": stats,
                   "change": change}, spent


def reference_readings(cell: dict, host: dict, seed: int, device,
                       fault=None) -> dict:
    """The plain reference's readings over the checked steps, from the same
    corpus and starting posteriors."""
    ref = cell["reference"]
    step, _ = reference_step(cell)
    corp = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    model = ref.model(cell["config"], corp)
    post = posts0(cell, seed, device)
    pri = priors(cell)
    elbos, stats = [], None
    for i in range(int(cell["traffic"]["checked_steps"])):
        elbo, post = step(model, post, fault=fault)
        elbos.append(elbo)
        if i == 0:
            stats = {k: check.norm(p, pri[k]) for k, p in post.items()}
    p0 = posts0(cell, seed, device)
    change = {k: check.norm(p, p0[k]) for k, p in post.items()}
    return {"elbos": elbos, "stats": stats, "change": change}


def _window(prog, step, box: list, seconds: float, device) -> dict:
    """Steps through ``run_inference`` from the state in ``box`` (taken out
    of it) until ``seconds`` have passed: each step marked on the device,
    the window on the host clock."""
    from repro_torch.core import runtime
    marks = Marks(device)
    done = {"steps": 0, "failed": 0, "end": None}

    def timed(st):
        t = marks.start()
        out = step(st)
        marks.stop(t)
        return out

    def callback(i, elbo):
        done["steps"] += 1
        if not math.isfinite(elbo):
            done["failed"] += 1
        now = time.perf_counter()
        if now >= deadline:
            done["end"] = now
            return False
        return True

    _sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    try:
        state, _ = runtime.run_inference(prog, steps=1 << 40,
                                         state=box.pop(), step_fn=timed,
                                         callback=callback)
    except Exception as exc:         # a step that raised ends the window
        log(f"[window] a step raised: {exc!r}")
        done["failed"] += 1
        state = None
    end = done["end"] or time.perf_counter()
    return {"state": state, "seconds": end - t0, "steps": done["steps"],
            "attempted": len(marks.pairs), "failed": done["failed"],
            "step_ms": marks.ms()}


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", elog_dtype=None) -> dict:
    """One run of ``workload``: the result, with the keys the benchmark
    prints.
    ``elog_dtype`` switches on the port's own narrower tables for the
    checked steps (the control), and for nothing else."""
    cell = load_cell(root, workload)
    cfg, traffic = cell["config"], cell["traffic"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    t = time.perf_counter()
    inputs = make_inputs(cell, seed, device, trace)
    _free(device)
    peak = PortPeak(device)
    data_s = time.perf_counter() - t
    log(f"[data] {workload}: N = {inputs['n_tokens']} tokens, made in "
        f"{data_s:.3f} s (not set-up)")

    # set-up: from the first import of the port to the window's start
    t_setup = time.perf_counter()
    importlib.import_module("repro_torch")
    from repro_torch.core import runtime
    from repro_torch.kernels import ops
    spans = {"import": time.perf_counter() - t_setup}
    prog, step = build_program(cell, inputs["host"], device, spans)
    if elog_dtype is not None:
        step = runtime.make_step(prog, elog_dtype=elog_dtype, device=device)
    ops.reset_launch_counts()
    t = time.perf_counter()
    state, prog_read, check_s = checked_steps(cell, prog, step, seed, device,
                                              peak)
    spans["checked_steps"] = time.perf_counter() - t - check_s
    box = [state]
    del state
    state, _ = runtime.run_inference(
        prog, steps=int(traffic["warmup_steps"]), state=box.pop(),
        step_fn=step)
    _sync(device)
    setup_s = time.perf_counter() - t_setup - check_s
    launches = ops.launch_counts()
    routes = {k: r for k, r in ops.route_counts().items() if launches.get(k)}
    log(f"[setup] {setup_s:.3f} s: import {spans['import']:.3f} s, compile "
        f"{spans['compile']:.3f} s, make_step {spans['make_step']:.3f} s, "
        f"checked steps {spans['checked_steps']:.3f} s (the first builds "
        f"or loads the kernels); routes of the kernels launched "
        f"{json.dumps(routes)}, launches {json.dumps(launches)} in "
        f"{traffic['checked_steps'] + traffic['warmup_steps']} steps")

    # the window (with the metrics' wrapped calls under --trace 1)
    wraps = []
    if trace:
        targets = {}
        for m in cell["per_layer"]:
            w = getattr(m["reader"], "WRAP", None)
            if w and w not in targets:
                targets[w] = Wrapped(w, m["reader"].signature, device)
        wraps = list(targets.values())
    for w in wraps:
        w.__enter__()
    box.append(state)
    del state
    try:
        win = _window(prog, step, box, seconds, device)
    finally:
        for w in reversed(wraps):
            w.__exit__()
    peak_bytes = peak.read()
    times = np.asarray(win["step_ms"][:win["steps"]], np.float64)
    log(f"[window] {win['steps']} steps in {win['seconds']:.6f} s; step ms "
        f"median {np.median(times) if len(times) else float('nan'):.4f}, "
        f"p95 {np.percentile(times, 95) if len(times) else float('nan'):.4f}"
        f" over {len(times)} samples ({len(times) * 0.05:.1f} beyond it)")

    result = {"correct": False, "attempted": win["attempted"],
              "failed": win["failed"]}
    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak_bytes}
    if not trace:
        values = {"tokens_per_s": inputs["n_tokens"] * win["steps"]
                  / win["seconds"],
                  "step_ms_p95": float(np.percentile(times, 95))
                  if len(times) else float("nan"),
                  "peak_mem_gib": peak_bytes / 2 ** 30, "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        from devtrace import profile_steps
        n_prof = int(traffic["profiled_steps"])
        holder = {"state": win["state"]}

        def run():
            holder["state"], _ = runtime.run_inference(
                prog, steps=n_prof, state=holder.pop("state"), step_fn=step)
        prof = profile_steps(run, n_prof, device) \
            if win["state"] is not None else None
        wrapped = {w.mod_name + ":" + w.attr: [
            (w.sigs[k], ms) for k, ms in zip(w.keys, w.marks.ms())]
            for w in wraps}
        # what a per-layer metric reads: set-up spans (seconds), the window
        # (seconds, steps, per-step ms), the wrapped calls by target
        # ((signature, ms) lists), the profile (devtrace.profile_steps), the
        # step's work (operations, bytes)
        ctx = SimpleNamespace(spans=spans, window=win, wrapped=wrapped, profile=prof,
                      step_work=inputs["step_work"],
                      n_tokens=inputs["n_tokens"], device=device)
        for m in cell["per_layer"]:
            v = m["reader"].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if prof is not None:
            device_info["busy_s"] = prof["busy_s"]
            device_info["window_s"] = prof["window_s"]
            result["breakdown"] = {"device_ops": prof["device_ops"][:10],
                                   "idle_gaps": prof["idle_gaps"][:10]}
            holder.clear()
        del ctx, wrapped
    result["metrics"] = metrics
    result["device"] = device_info

    # the comparison, once the program's state is freed
    del step, prog, win, wraps
    _free(device)
    t = time.perf_counter()
    ref_read = reference_readings(cell, inputs["host"], seed, device)
    ref_s = time.perf_counter() - t
    values = check.compare(prog_read, ref_read)
    ok, checks = check.judge(values, cell["limits"])
    result["correct"] = bool(ok and result["failed"] == 0
                             and result["attempted"] > 0)
    log(f"[check] reference {ref_s:.3f} s; program ELBOs "
        f"{prog_read['elbos']}, reference {ref_read['elbos']}")
    result["checks"] = checks
    return result


def banned_modules() -> list:
    """Top-level names of loaded modules that no run may load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def print_result(result: dict) -> None:
    """The compared numbers beside their limits as the last lines on
    standard error; the result as the last line of standard output, its
    ``checks`` last."""
    out = {k: result[k] for k in ("correct", "attempted", "failed",
                                  "metrics", "device")}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = result["checks"]
    for name, c in result["checks"].items():
        log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
