"""The port's tracer (``repro_torch.trace``): spans, their totals and
records, the recording switch, the bounded buffer, the sync count, the
kernels' counters, the spans of a VMP step and of its set-up, and the
benchmark's three readers of them (``portbench/metrics``).

The tests marked ``card`` need a CUDA card and skip without one (on the
chip: ``python -m pytest tests/test_torch_trace.py -m card``): a profiled
step's trace holds the port's spans and ``devtrace`` counts none of them
as device work, a pageable copy and an ``.item()`` each count one sync,
the Dirichlets' event pairs are positive and shorter than the step, and a
segment latent's step holds ``zstats_zmap``'s three phase spans.
"""

from __future__ import annotations

import importlib.util
import sys
import threading
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import models, runtime, vmp
from repro_torch.kernels import ops

ROOT = Path(__file__).resolve().parents[1]
METRICS = ROOT / "portbench" / "metrics"
CPU = torch.device("cpu")

STEP = ["runtime.step", "vmp.step", "vmp.elog_tables", "vmp.token_plate",
        "vmp.statics", "vmp.elbo_terms", "vmp.update", "runtime.sync"]
MAKE_STEP = ["runtime.make_step", "vmp.program_arrays", "vmp.owner_plans",
             "vmp.plans_to_device"]


@pytest.fixture(autouse=True)
def _clean():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lda(seed=0, K=3, V=20, D=10):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(5, 15, size=D)
    m = models.make("lda", alpha=0.1, beta=0.05, K=K, V=V)
    m["x"].observe(rng.integers(0, V, size=int(lengths.sum())),
                   lengths=lengths)
    return m.compile()


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"trace_test_metric_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _names(recs):
    return [r.name for r in recs]


# ---------------------------------------------------------------------------
# spans, totals and records
# ---------------------------------------------------------------------------

def test_spans_nest_with_parent_ids_and_self_time():
    with trace.recording():
        with trace.span("outer"):
            time.sleep(0.002)
            with trace.span("inner"):
                time.sleep(0.01)
            with trace.span("inner"):
                pass
    outer, a, b = trace.records()
    assert _names([outer, a, b]) == ["outer", "inner", "inner"]
    assert outer.parent is None and a.parent == b.parent == outer.id
    assert len({outer.id, a.id, b.id}) == 3
    assert outer.thread == threading.current_thread().name
    assert outer.start_ns <= a.start_ns < a.end_ns <= b.start_ns \
        <= b.end_ns <= outer.end_ns
    t = trace.totals()
    assert t["inner"]["calls"] == 2 and t["outer"]["calls"] == 1
    assert t["outer"]["self_s"] == pytest.approx(
        t["outer"]["host_s"] - t["inner"]["host_s"], abs=1e-9)
    assert t["outer"]["self_s"] >= 0.002 and t["inner"]["host_s"] >= 0.01
    assert t["inner"]["last_s"] < 0.01 <= t["inner"]["host_s"]
    assert outer.host_ms == pytest.approx(t["outer"]["host_s"] * 1e3)
    assert outer.device_ms is None            # no events on the CPU


def test_a_span_decorates_a_function_anew_each_call():
    @trace.span("deco")
    def f(n):
        return f(n - 1) + 1 if n else 0

    with trace.recording():
        assert f(2) == 2
    recs = trace.records()
    assert _names(recs) == ["deco"] * 3
    assert [r.parent for r in recs] == [None, recs[0].id, recs[1].id]
    assert f.__name__ == "f"


def test_each_thread_keeps_its_own_stack():
    start = threading.Barrier(4, timeout=10)

    def work(i):
        with trace.span(f"t{i}"):
            start.wait()
            with trace.span(f"t{i}.child"):
                start.wait()

    with trace.recording():
        threads = [threading.Thread(target=work, args=(i,), name=f"w{i}")
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        assert not any(th.is_alive() for th in threads)
    recs = {r.name: r for r in trace.records()}
    for i in range(4):
        parent, child = recs[f"t{i}"], recs[f"t{i}.child"]
        assert parent.parent is None and child.parent == parent.id
        assert parent.thread == child.thread == f"w{i}"


def test_off_spans_keep_totals_and_make_no_record_or_range(monkeypatch):
    ranges = []
    real = trace._profiler.record_function

    def spy(name, *a, **kw):
        ranges.append(name)
        return real(name, *a, **kw)
    monkeypatch.setattr(trace._profiler, "record_function", spy)
    with trace.recording():
        with trace.span("kept"):
            pass
    kept = trace.records()
    with trace.span("off"):
        with trace.span("off.child"):
            pass
    assert trace.records() == kept           # still the last stretch's
    assert trace.totals()["off"]["calls"] == 1
    assert trace.totals()["off.child"]["calls"] == 1
    # recording() alone opens no profiler range; a profiler session does
    assert ranges == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("profiled"):
            with trace.span("profiled.child"):
                torch.ones(3).sum()
    assert ranges == ["profiled", "profiled.child"]
    names = {e.name for e in prof.events()}
    assert {"profiled", "profiled.child"} <= names
    # the session was a stretch of its own, and it replaced the last one
    assert _names(trace.records()) == ["profiled", "profiled.child"]
    with trace.span("after"):
        pass
    assert ranges == ["profiled", "profiled.child"]


def test_a_new_stretch_replaces_the_records():
    with trace.recording():
        with trace.span("first"):
            pass
    with trace.recording():
        with trace.span("second"):
            pass
        with trace.recording():                 # nested: the same stretch
            with trace.span("third"):
                pass
    assert _names(trace.records()) == ["second", "third"]


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 5)
    with trace.recording():
        for _ in range(8):
            with trace.span("s"):
                pass
    assert len(trace.records()) == 5
    assert trace.counters()["trace.dropped"] == 3
    assert trace.totals()["s"]["calls"] == 8
    assert "trace.dropped = 3" in trace.report()


def test_reset_by_prefix_clears_only_those_counters():
    trace.count("kernels.launches.zstats", 2)
    trace.count("other", 1)
    with trace.span("s"):
        pass
    trace.reset("kernels.")
    assert trace.counters() == {"other": 1}
    assert trace.totals()["s"]["calls"] == 1
    trace.reset()
    assert trace.counters() == {} and trace.totals() == {}


def test_report_tables_records_or_totals():
    with trace.span("only.totals"):
        pass
    text = trace.report()
    assert "only.totals" in text and "device ms" in text
    with trace.recording():
        with trace.span("rec"):
            with trace.span("rec.child"):
                pass
    trace.count("kernels.launches.zstep")
    lines = trace.report().splitlines()
    assert lines[0].split()[0] == "span"
    assert [ln.split()[0] for ln in lines[1:3]] == ["rec", "rec.child"]
    assert lines[-1] == "kernels.launches.zstep = 1"


# ---------------------------------------------------------------------------
# blocking syncs (the card's warnings stood in for on the CPU)
# ---------------------------------------------------------------------------

class _FakeEvent:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda`` as the tracer sees it on a card: initialized, with a
    sync-debug mode and timing events."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: modes.append(m))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    return modes


def _sync():
    warnings.warn(trace._SYNC_WARNING + " (Triggered internally)",
                  UserWarning)


def test_syncs_count_under_the_innermost_span_and_print_nothing(fake_cuda):
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("default")
        before = (warnings.showwarning, list(warnings.filters))
        with trace.recording():
            with trace.span("outer"):
                assert fake_cuda[-1] == "warn"
                _sync()
                with trace.span("inner"):
                    for _ in range(3):
                        _sync()             # the same line: each counts
                warnings.warn("another warning", UserWarning)
            assert fake_cuda[-1] == 0           # restored on exit
            with trace.span("later"):
                _sync()
        assert (warnings.showwarning, warnings.filters) == before
    outer, inner, later = trace.records()
    assert (outer.syncs, inner.syncs, later.syncs) == (1, 3, 1)
    assert [str(w.message) for w in seen] == ["another warning"]
    assert fake_cuda == [0, "warn", 0, "warn", 0]
    assert outer.device_ms is not None and outer.device_ms >= 0


def test_off_spans_set_no_sync_mode_and_make_no_event(fake_cuda,
                                                      monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda **kw: made.append(1) or _FakeEvent())
    with trace.span("off"):
        pass
    assert fake_cuda == [0] and made == []


def test_one_mode_for_spans_open_on_several_threads(fake_cuda):
    inside, done = threading.Event(), threading.Event()

    def work():
        with trace.span("worker"):
            inside.set()
            done.wait(10)

    with trace.recording():
        th = threading.Thread(target=work)
        th.start()
        assert inside.wait(10)
        with trace.span("main"):
            pass
        assert fake_cuda[-1] == "warn"          # the worker's span is open
        done.set()
        th.join(10)
        assert not th.is_alive()
    assert fake_cuda == [0, "warn", 0]


# ---------------------------------------------------------------------------
# the spans of the VMP fit
# ---------------------------------------------------------------------------

def test_make_step_spans_in_order():
    prog = _lda()
    with trace.recording():
        runtime.make_step(prog, device=CPU)
    recs = trace.records()
    assert _names(recs) == MAKE_STEP
    assert [r.parent for r in recs[1:]] == [recs[0].id] * 3
    # the plans are cached on the program: a second set-up builds none
    with trace.recording():
        runtime.make_step(prog, device=CPU)
    assert _names(trace.records()) == ["runtime.make_step",
                                       "vmp.program_arrays"]
    assert trace.totals()["vmp.owner_plans"]["calls"] == 1


def test_one_step_spans_in_order(tmp_path):
    prog = _lda()
    step = runtime.make_step(prog, device=CPU)
    state = vmp.init_state(prog, 0, device=CPU)
    with trace.recording():
        runtime.run_inference(prog, steps=1, state=state, step_fn=step)
    recs = trace.records()
    assert _names(recs) == STEP
    ids = {r.name: r.id for r in recs}
    assert [r.parent for r in recs] == [
        None, ids["runtime.step"]] + [ids["vmp.step"]] * 5 + [
        ids["runtime.step"]]
    # a checkpoint and a callback each get a span after the sync
    with trace.recording():
        runtime.run_inference(prog, steps=2, state=state, step_fn=step,
                              checkpoint_every=1,
                              checkpoint_dir=str(tmp_path),
                              callback=lambda i, e: i < 0)
    assert _names(trace.records()) == STEP + ["runtime.checkpoint",
                                              "runtime.callback"]


def test_the_front_end_spans():
    rng = np.random.default_rng(1)
    m = models.make("lda", alpha=0.1, beta=0.05, K=3, V=20)
    with trace.recording():
        m["x"].observe(rng.integers(0, 20, size=40), lengths=[20, 20])
        m.compile()
    assert _names(trace.records()) == ["model.observe", "model.compile"]


def test_spans_leave_the_step_bitwise():
    prog = _lda(seed=3)
    step = runtime.make_step(prog, device=CPU)
    state = vmp.init_state(prog, 5, device=CPU)
    s_off, e_off = runtime.run_inference(prog, steps=3, state=state,
                                         step_fn=step)
    with trace.recording():
        s_on, e_on = runtime.run_inference(prog, steps=3, state=state,
                                           step_fn=step)
    assert e_on == e_off
    for n in s_off.posteriors:
        assert torch.equal(s_on.posteriors[n], s_off.posteriors[n])


# ---------------------------------------------------------------------------
# zstats_zmap's phase spans
# ---------------------------------------------------------------------------

ZMAP = ["zmap.logits", "zmap.prior", "zmap.stats"]


def _zmap_call(seed=0, docs=6, K=3, V=12):
    """``zstats`` arguments of a tiny DCM-SLDA token plate on the CPU: the
    prior table, the sentences' document rows, phi's strided zmap child."""
    g = torch.Generator().manual_seed(seed)
    sent_doc = torch.sort(torch.randint(0, docs, (20,), generator=g)).values
    sent_ids = torch.repeat_interleave(torch.arange(20),
                                       torch.randint(1, 6, (20,), generator=g))
    words = torch.randint(0, V, (len(sent_ids),), generator=g)
    i32 = lambda t: t.to(torch.int32)  # noqa: E731
    child = ops.ZChild(torch.randn(docs * K, V, generator=g), i32(words),
                       zmap=i32(sent_ids), base=i32(sent_doc[sent_ids] * K))
    return torch.randn(docs, K, generator=g), i32(sent_doc), (child,)


def test_a_cpu_zstats_call_records_no_zmap_span():
    """The plain path never enters the kernel's wrapper: with recording
    off no record at all, and on, no ``zmap.*`` record or total."""
    table, rows, kids = _zmap_call()
    ops.zstats(table, rows, kids)
    assert trace.records() == []
    with trace.recording():
        with trace.span("vmp.token_plate"):
            ops.zstats(table, rows, kids)
    assert _names(trace.records()) == ["vmp.token_plate"]
    assert not {n for n in trace.totals() if n.startswith("zmap.")}


@pytest.fixture
def stand_in_kernels(monkeypatch):
    """``fused_zmap.zstats_zmap`` on CPU tensors with each phase's launches
    stood in for by empty results, and what each phase was handed."""
    from repro_torch.kernels import fused_zmap, fused_zstats
    seen = []

    def logits(lib, zargs, plan, n_latent, k, stream):
        seen.append(("logits", _names(trace.records())))
        return torch.zeros(n_latent, k)

    def flat(eprior, prior_rows, flat_kids, ftabs, zmask, plan, extra,
             r_out):
        seen.append(("prior", _names(trace.records())))
        return torch.zeros(()), torch.zeros_like(eprior), ()

    def stats(lib, zargs, plan, j, c, r, stream):
        seen.append(("stats", _names(trace.records())))
        return torch.zeros(c.elog.shape)

    monkeypatch.setattr(fused_zmap, "_check_device", lambda t: None)
    monkeypatch.setattr(fused_zmap, "_logits", logits)
    monkeypatch.setattr(fused_zmap, "_stats_pass", stats)
    monkeypatch.setattr(fused_zstats, "launch_flat", flat)
    monkeypatch.setattr(fused_zstats, "library", lambda: None)
    monkeypatch.setattr(fused_zstats, "make_args", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=0))
    return fused_zmap, seen


def test_zmap_phase_spans_nest_under_the_token_plate(stand_in_kernels):
    """Each phase runs inside its own span, the three children of the
    caller's span in order; off, they add totals and no record."""
    fused_zmap, seen = stand_in_kernels
    table, rows, kids = _zmap_call()
    with trace.recording():
        with trace.span("vmp.token_plate"):
            fused_zmap.zstats_zmap(table, rows, kids)
    recs = trace.records()
    assert _names(recs) == ["vmp.token_plate"] + ZMAP
    assert [r.parent for r in recs[1:]] == [recs[0].id] * 3
    assert [w for w, _ in seen] == ["logits", "prior", "stats"]
    # each phase sees its own span open, the last record begun
    assert [names[-1] for _, names in seen] == ZMAP
    trace.reset()
    fused_zmap.zstats_zmap(table, rows, kids)
    assert trace.records() == []
    assert {n: t["calls"] for n, t in trace.totals().items()} == \
        dict.fromkeys(ZMAP, 1)
    assert ops.launch_counts()["zstats_zmap"] == 1


# ---------------------------------------------------------------------------
# the kernels' counters
# ---------------------------------------------------------------------------

def test_launch_and_route_counts_keep_their_shape():
    ops.reset_launch_counts()
    assert ops.launch_counts() == {
        "zstats": 0, "zstats_zmap": 0, "zmap_logits": 0,
        "dirichlet_expectation": 0, "dirichlet_elbo_term": 0,
        "dirichlet_update": 0, "zstep": 0, "flash_attention": 0}
    assert ops.route_counts() == {
        "zstats": {"pieces": 0, "runs": 0, "strided": 0},
        "zstats_zmap": {"pieces": 0, "runs": 0, "strided": 0, "group": 0,
                        "warp": 0},
        "zmap_logits": {"group": 0, "warp": 0},
        "flash_attention": {"wgmma": 0, "mma": 0},
        "dirichlet_elbo_term": {"rows": 0, "chunks": 0}}
    trace.count("kernels.launches.zstats", 2)
    trace.count("kernels.routes.zstats.runs")
    assert ops.launch_counts()["zstats"] == 2
    assert ops.route_counts()["zstats"] == {"pieces": 0, "runs": 1,
                                            "strided": 0}


def test_plain_calls_on_the_cpu_launch_nothing():
    ops.reset_launch_counts()
    alpha = torch.rand(4, 6) + 0.5
    ops.dirichlet_expectation(alpha)
    ops.zstep(torch.randn(5, 6))
    prog = _lda()
    runtime.run_inference(prog, steps=1, device=CPU)
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _ctx(device="cuda"):
    return SimpleNamespace(device=torch.device(device), profile={})


def test_readers_read_nothing_on_the_cpu():
    prog = _lda()
    with trace.recording():
        runtime.run_inference(prog, steps=1, device=CPU)
    for name in ("plan_host_s", "dirichlet_ms", "syncs_per_step"):
        assert _reader(name).read(_ctx("cpu")) is None


def test_readers_on_the_port_s_records(fake_cuda):
    runtime.make_step(_lda(), device=CPU)
    with trace.recording():
        with trace.span("runtime.step"):
            with trace.span("vmp.step"):
                with trace.span("vmp.elbo_terms"):
                    _sync()
                    _sync()
                with trace.span("vmp.update"):
                    _sync()
            with trace.span("runtime.sync"):
                _sync()
        with trace.span("runtime.step"):
            with trace.span("vmp.elbo_terms"):
                _sync()
        with trace.span("outside"):
            _sync()
    assert _reader("syncs_per_step").read(_ctx()) == 2.5
    recs = trace.records()
    parts = [r for r in recs if r.name in ("vmp.elbo_terms", "vmp.update")]
    want = sum(r.device_ms for r in parts) / 2
    assert _reader("dirichlet_ms").read(_ctx()) == pytest.approx(want)
    assert _reader("plan_host_s").read(_ctx()) == pytest.approx(
        trace.totals()["vmp.owner_plans"]["last_s"])
    trace.reset()
    assert _reader("plan_host_s").read(_ctx()) is None


def test_readers_read_nothing_without_the_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "trace")
    for name in ("plan_host_s", "dirichlet_ms", "syncs_per_step"):
        assert _reader(name).read(_ctx()) is None


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_fit(device, steps=2):
    prog = _lda(seed=7, K=8, V=300, D=60)
    step = runtime.make_step(prog, device=device)
    box = {"state": runtime.run_inference(
        prog, steps=1, state=vmp.init_state(prog, 0, device=device),
        step_fn=step)[0]}

    def run():
        box["state"], _ = runtime.run_inference(prog, steps=steps,
                                                state=box.pop("state"),
                                                step_fn=step)
    return run


def _devtrace():
    bench = str(ROOT / "portbench")
    if bench not in sys.path:
        sys.path.insert(0, bench)
    import devtrace
    return devtrace


@pytest.mark.card
def test_a_profiled_step_holds_the_port_s_spans(cuda):
    from torch.profiler import ProfilerActivity, profile
    run = _card_fit(cuda)
    # devtrace counts no span's device echo as device work
    p = _devtrace().profile_steps(run, 2, cuda)
    ops_ = {name for name, _ in p["device_ops"]}
    assert not ops_ & set(STEP)
    assert 0 < p["busy_s"] <= p["window_s"]
    assert _names(trace.records()).count("runtime.step") == 2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    host = {e.name for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CUDA}
    assert set(STEP) <= host


@pytest.mark.card
def test_a_pageable_copy_and_an_item_each_count_one_sync(cuda):
    x = torch.ones(16, device=cuda)
    host = torch.from_numpy(np.ones(16, np.float32))
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with trace.recording():
        with trace.span("copy"):
            host.to(cuda)
        with trace.span("item"):
            x.sum().item()
        with trace.span("none"):
            (x * 2).sum()
    copy, item, none = trace.records()
    assert (copy.syncs, item.syncs, none.syncs) == (1, 1, 0)
    assert torch.cuda.get_sync_debug_mode() == mode


@pytest.mark.card
def test_the_dirichlet_event_pairs_are_shorter_than_the_step(cuda):
    run = _card_fit(cuda, steps=3)
    p = _devtrace().profile_steps(run, 3, cuda)
    recs = trace.records()
    steps = [r for r in recs if r.name == "runtime.step"]
    parts = [r for r in recs if r.name in ("vmp.elbo_terms", "vmp.update")]
    assert len(steps) == 3 and len(parts) == 6
    assert all(r.device_ms > 0 for r in parts)
    for s in steps:
        mine = [r for r in parts if r.start_ns >= s.start_ns
                and r.end_ns <= s.end_ns]
        assert sum(r.device_ms for r in mine) < s.device_ms
    ms = _reader("dirichlet_ms").read(SimpleNamespace(device=cuda,
                                                      profile=p))
    assert 0 < ms < min(s.device_ms for s in steps)
    # the step's blocking syncs: its ELBO's float and each Dirichlet's
    # prior copied from the host twice (ELBO term and update)
    syncs = _reader("syncs_per_step").read(SimpleNamespace(device=cuda,
                                                           profile=p))
    assert syncs == 5


@pytest.mark.card
def test_the_launch_counts_of_a_few_kernel_calls(cuda):
    ops.reset_launch_counts()
    alpha = torch.rand(40, 6, device=cuda) + 0.5
    ops.dirichlet_expectation(alpha)
    ops.dirichlet_expectation(alpha, transpose=True)
    ops.zstep(torch.randn(50, 6, device=cuda))
    run = _card_fit(cuda, steps=2)            # 3 steps: 3 zstats, 6 Elogs
    run()                                     # and 6 ELBO terms and updates
    counts = ops.launch_counts()
    assert counts == {"zstats": 3, "zstats_zmap": 0, "zmap_logits": 0,
                      "dirichlet_expectation": 8, "dirichlet_elbo_term": 6,
                      "dirichlet_update": 6, "zstep": 1,
                      "flash_attention": 0}
    routes = ops.route_counts()
    assert routes["zstats"] == {"pieces": 3, "runs": 0, "strided": 0}
    assert routes["dirichlet_elbo_term"] == {"rows": 3, "chunks": 3}


def _segment_fit(device, name):
    """A tiny segment-latent fit on ``device`` after one step: DCM-SLDA or
    SLDA, 40 documents in sentences of 2 to 7 tokens."""
    rng = np.random.default_rng(5)
    K, V, D = 8, 300, 40
    sent_doc = np.repeat(np.arange(D), rng.integers(3, 9, D)).astype(np.int32)
    tok_sent = np.repeat(np.arange(len(sent_doc)),
                         rng.integers(2, 8, len(sent_doc))).astype(np.int32)
    m = models.make(name, alpha=0.1, beta=0.05, K=K, V=V)
    m["x"].observe(rng.integers(0, V, len(tok_sent)).astype(np.int32),
                   segment_ids=tok_sent)
    m.bind("sents", sent_doc)
    prog = m.compile()
    step = runtime.make_step(prog, device=device)
    box = {"state": runtime.run_inference(
        prog, steps=1, state=vmp.init_state(prog, 0, device=device),
        step_fn=step)[0]}

    def run(steps):
        box["state"], _ = runtime.run_inference(prog, steps=steps,
                                                state=box.pop("state"),
                                                step_fn=step)
    return run


@pytest.mark.card
@pytest.mark.parametrize("name", ["dcmslda", "slda"])
def test_a_segment_step_holds_the_three_zmap_spans(cuda, name):
    """Each profiled step's ``vmp.token_plate`` holds ``zmap.logits``,
    ``zmap.prior`` and ``zmap.stats`` once each, in order, each with device
    ms; the step's blocking syncs stay 5."""
    run = _segment_fit(cuda, name)
    p = _devtrace().profile_steps(lambda: run(2), 2, cuda)
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    plates = [r for r in recs if r.name == "vmp.token_plate"]
    assert len(plates) == 2
    for plate in plates:
        kids = [r for r in recs if r.parent == plate.id]
        assert _names(kids) == ZMAP
        assert all(r.device_ms is not None and r.device_ms > 0
                   for r in kids)
    assert all(by_id[r.parent].name == "vmp.token_plate"
               for r in recs if r.name in ZMAP)
    syncs = _reader("syncs_per_step").read(SimpleNamespace(device=cuda,
                                                           profile=p))
    assert syncs == 5
    for reader in ("zmap_logits_ms", "zmap_stats_ms"):
        ms = _reader(reader).read(SimpleNamespace(device=cuda, profile=p))
        assert 0 < ms < min(r.device_ms for r in recs
                            if r.name == "runtime.step")

