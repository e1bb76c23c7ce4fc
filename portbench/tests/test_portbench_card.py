"""On the card: the throwaway cells through the port's CUDA and Triton
kernels, held to the real cells' limits; the program passes and its
bfloat16 control fails.  Skips without a card; run on the chip with
``python -m pytest portbench/tests -m card``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.append(str(BENCH.parent / "src"))
import harness  # noqa: E402

pytestmark = pytest.mark.card


@pytest.mark.parametrize("workload", ["tiny-lda.vmp", "tiny-dcmlda.vmp",
                                      "tiny-slda.vmp"])
def test_program_passes_and_control_fails_on_the_card(tiny_root, cuda,
                                                      workload):
    r = harness.run_cell(tiny_root, workload, 2 ** 31 + 5, 0.5, True,
                         device=cuda)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    (roofline,) = [m["name"] for m in harness.load_cell(
        tiny_root, workload)["per_layer"] if m["name"].endswith("_roofline")]
    assert {"plain_ops_ms", "idle_share", roofline,
            "step_mfu"} <= set(r["metrics"])
    assert 0 < r["metrics"][roofline]["value"] <= 100
    c = harness.run_cell(tiny_root, workload, 2 ** 31 + 5, 0.2, False,
                         device=cuda, elog_dtype="bfloat16")
    assert not c["correct"], c["checks"]
