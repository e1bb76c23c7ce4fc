"""Whole runs at a tiny size on the CPU (the port's plain path): a
throwaway cell and metric added from files alone, the control and the
faults that ``correct`` must catch, what a run loads, and when the command
refuses to run."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.append(str(ROOT / "src"))
import harness  # noqa: E402

TINY = ["tiny-lda.vmp", "tiny-dcmlda.vmp", "tiny-slda.vmp"]
SEED = 2 ** 31 + 101


def run(root, workload, trace=False, **kw):
    return harness.run_cell(root, workload, SEED, 0.2, trace, device="cpu",
                            **kw)


@pytest.mark.parametrize("workload", TINY)
def test_throwaway_cell_and_metric_run_from_files(tiny_root, workload):
    r = run(tiny_root, workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"tokens_per_s", "step_ms_p95",
                                 "peak_mem_gib", "setup_s"}
    assert list(r["checks"]) == ["elbo_gap", "stats_gap", "change_gap"]
    t = run(tiny_root, workload, trace=True)
    assert t["correct"]
    # the kernel roofline of the real cell: zstats_zmap's for a segment
    # latent, zstats' for a flat one
    (roofline,) = [m["name"] for m in harness.load_cell(
        tiny_root, workload)["per_layer"] if m["name"].endswith("_roofline")]
    assert roofline == ("zmap_roofline" if "slda" in workload
                        else "zstats_roofline")
    assert {"compile_s", "owner_plan_s", "step_mfu", roofline,
            "tiny_steps"} <= set(t["metrics"])
    assert t["metrics"]["tiny_steps"]["value"] >= 1
    # no device on the CPU: the device's readers find nothing to read
    assert "idle_share" not in t["metrics"]
    assert "plain_ops_ms" not in t["metrics"]


@pytest.mark.parametrize("workload", TINY)
def test_control_is_not_correct(tiny_root, workload):
    """The port's own bfloat16 tables, the control, fail the cell's
    limits."""
    r = run(tiny_root, workload, elog_dtype="bfloat16")
    assert not r["correct"], r["checks"]


def _unchanged(monkeypatch):
    from repro_torch.core import runtime, vmp
    body = runtime._step_body

    def stuck(program, arrays, state, *a, **kw):
        _, elbo = body(program, arrays, state, *a, **kw)
        return vmp.VMPState(dict(state.posteriors), state.step + 1), elbo
    monkeypatch.setattr(runtime, "_step_body", stuck)


def _zstats_fault(monkeypatch, kind):
    from repro_torch.kernels import ops
    real = ops.zstats

    def every_other(t):
        return None if t is None else t[::2]

    def broken(table_prior, prior_rows, children, zmask=None, **kw):
        if kind == "half" and children[0].zmap is not None:
            # a segment latent: every other token left out, the instances
            # kept
            kids = tuple(c._replace(values=c.values[::2],
                                    zmap=every_other(c.zmap),
                                    base=every_other(c.base))
                         for c in children)
            lse, ps, cs = real(table_prior, prior_rows, kids, zmask, **kw)
            return 2 * lse, 2 * ps, tuple(2 * c for c in cs)
        if kind == "half":
            kids = tuple(c._replace(values=c.values[::2],
                                    base=every_other(c.base))
                         for c in children)
            lse, ps, cs = real(table_prior, prior_rows[::2], kids, **kw)
            return 2 * lse, 2 * ps, tuple(2 * c for c in cs)
        lse, ps, cs = real(table_prior, prior_rows, children, zmask, **kw)
        k = table_prior.shape[1]
        cs = tuple(c.clone() for c in cs)
        for c in cs:
            c[::k] *= 2
        return lse, ps, cs
    monkeypatch.setattr(ops, "zstats", broken)


@pytest.mark.parametrize("workload", TINY)
@pytest.mark.parametrize("fault", ["unchanged", "half", "topic"])
def test_broken_step_is_not_correct(tiny_root, workload, fault,
                                    monkeypatch):
    """The timed path broken underneath: a step that returns its state
    unchanged; half the tokens left out, the rest doubled; topic 0's
    statistics doubled where they are produced."""
    if fault == "unchanged":
        _unchanged(monkeypatch)
    else:
        _zstats_fault(monkeypatch, fault)
    r = run(tiny_root, workload)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", TINY)
@pytest.mark.parametrize("fault", ["half", "topic"])
def test_reference_fault_is_not_correct(tiny_root, workload, fault):
    """Each fault of the cell's reference step (the calibration's upper
    readings) fails the cell's limits against the clean reference."""
    import check
    cell = harness.load_cell(tiny_root, workload)
    _, faults = harness.reference_step(cell)
    assert fault in faults
    host = harness.make_inputs(cell, SEED, "cpu", False)["host"]
    clean = harness.reference_readings(cell, host, SEED, "cpu")
    bad = harness.reference_readings(cell, host, SEED, "cpu", fault=fault)
    ok, checks = check.judge(check.compare(bad, clean), cell["limits"])
    assert not ok, checks


def test_cell_takes_its_reference_step():
    """A flat model runs ``reference/flat.py``'s step, SLDA its own."""
    from reference import flat, segment
    root = BENCH.parent
    assert harness.reference_step(harness.load_cell(
        root, "lda-nytimes.vmp")) == (flat.step, flat.FAULTS)
    assert harness.reference_step(harness.load_cell(
        root, "slda-nytimes.vmp")) == (segment.step, segment.FAULTS)


def test_a_run_loads_no_jax_and_no_reference_package(tiny_root):
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.append(%r); "
        "import harness; r = harness.run_cell(%r, 'tiny-lda.vmp', 7, 0.1, "
        "True, device='cpu'); print(r['correct'], harness.banned_modules(),"
        " 'repro_torch' in sys.modules)"
        % (str(BENCH), str(ROOT / "src"), str(tiny_root)))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, check=True)
    assert "True [] True" in out.stdout.splitlines(), out.stdout


def test_command_refuses_without_a_card_or_the_port(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    args = ["--workload", "lda-nytimes.vmp", "--seed", "1", "--seconds",
            "1", "--trace", "0"]
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), *args],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    # a checkout that holds only the manifest and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "portbench/run.py", *args],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "not in this checkout" in out.stderr


def test_result_line_prints_checks_last(capsys):
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"setup_s": {"value": 1.5, "unit": "s"}},
              "device": {"platform": "gpu"},
              "checks": {"elbo_gap": {"value": 1e-7, "limit": 1e-5}}}
    harness.print_result(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "[check] elbo_gap 1e-07 limit 1e-05"
