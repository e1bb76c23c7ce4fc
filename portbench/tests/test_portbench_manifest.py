"""``BENCHMARK.json`` and the files each cell resolves to."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
import harness  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_resolves_to_its_files(workload):
    cell = harness.load_cell(ROOT, workload)
    w = cell["workload"]
    assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert (BENCH / "limits" / f"{workload}.json").is_file()
    assert (BENCH / "reference" / f"{cell['config']['model']}.py").is_file()
    assert (BENCH / "work" / f"{cell['config']['step_work']}.py").is_file()
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(m["reader"].read), m["name"]
    for n in ("elbo_gap", "stats_gap", "change_gap"):
        assert cell["limits"][n]["limit"] > 0


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [c["name"] for c in MANIFEST["configs"]]
    assert len(set(names)) == len(names)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and \
            (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs) == len(set(WORKLOADS))
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for n in names + WORKLOADS + [m["name"] for m in MANIFEST["end_to_end"]
                                  + MANIFEST["per_layer"]]:
        assert NAME.match(n), n
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200
