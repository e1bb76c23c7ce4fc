"""Fixtures of the benchmark's tests, and the ``card`` marker.

``tiny_root`` is a copy of the benchmark (``BENCHMARK.json`` and
``portbench/``) in a temporary directory with throwaway cells added from
files alone: ``tiny-lda.vmp``, ``tiny-dcmlda.vmp`` and ``tiny-slda.vmp``
(the models at a few hundred tokens, held to the real cells' limits and
read by the real cells' per-layer metrics) and a throwaway per-layer
metric ``tiny_steps``.  Tests that need a card take the
``cuda`` fixture, which skips where there is none.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
if str(ROOT / "src") not in sys.path:
    sys.path.append(str(ROOT / "src"))

#: the throwaway cells: name -> (real cell, tiny sizes)
TINY = {
    "tiny-lda.vmp": ("lda-nytimes.vmp", dict(K=4, V=50, docs=40,
                                             mean_len=30)),
    "tiny-dcmlda.vmp": ("dcmlda-nips.vmp", dict(K=3, V=40, docs=30,
                                                   mean_len=25)),
    "tiny-slda.vmp": ("slda-nytimes.vmp", dict(K=4, V=50, docs=40,
                                               mean_len=30)),
}

TINY_METRIC = '''"""A throwaway metric: steps in the timed window."""


def read(ctx):
    return float(ctx.window["steps"])
'''


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (run them on "
        "the chip: python -m pytest portbench/tests -m card)")


def make_tiny_root(dest: Path) -> Path:
    """The benchmark copied under ``dest`` with the throwaway cells and
    metric added from files and entries alone."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for name, (real, sizes) in TINY.items():
        w = next(x for x in bench["workloads"] if x["name"] == real)
        entry = next(c for c in bench["configs"] if c["name"] == w["config"])
        cfg = json.loads((dest / entry["file"]).read_text())
        cfg["dsl"].update(K=sizes["K"], V=sizes["V"])
        cfg["corpus"].update(topics=sizes["K"], vocab=sizes["V"],
                             docs=sizes["docs"], mean_len=sizes["mean_len"])
        cname = name.rsplit(".", 1)[0]
        (dest / "portbench" / "configs" / f"{cname}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append(dict(entry, name=cname,
                                     file=f"portbench/configs/{cname}.json"))
        bench["workloads"].append(dict(w, name=name, config=cname))
        shutil.copy(dest / "portbench" / "limits" / f"{real}.json",
                    dest / "portbench" / "limits" / f"{name}.json")
        for m in bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(name)
    (dest / "portbench" / "metrics" / "tiny_steps.py").write_text(TINY_METRIC)
    bench["per_layer"].append({
        "name": "tiny_steps", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "runtime", "moves": "tokens_per_s",
        "workloads": list(TINY)})
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
