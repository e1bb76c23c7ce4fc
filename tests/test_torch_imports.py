"""Import fence of the port: no module under ``src/repro_torch/``, and
neither ``chip_smoke.py`` nor ``scripts/torch_numerics.py``, imports ``jax``,
``ml_dtypes`` or the JAX package ``repro``; and importing the port leaves
them unloaded."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "scripts" / "torch_numerics.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_fence_covers_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "torch_numerics.py", "vmp.py", "ops.py",
            "fused_zstats.py", "dirichlet_expectation.py",
            "vmp_zstep.py", "build.py", "flash_attention.py", "base.py",
            "olmo_1b.py", "layers.py", "transformer.py", "registry.py",
            "adamw.py", "steps.py", "train.py", "svi.py", "engine.py",
            "pipeline.py", "compiler.py", "store.py", "faults.py",
            "session.py", "gibbs.py", "baselines.py", "posterior.py",
            "foldin.py", "server.py", "validate.py", "audit.py",
            "explain.py", "ql.py", "plan.py", "admission.py", "compact.py",
            "gateway.py", "partition.py", "dist.py", "elastic.py",
            "serve.py", "work.py", "roofline.py", "step_cost.py",
            "dryrun.py", "collective_histo.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [(line, name) for line, name in _imports(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_fence_catches_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("repro.core")
    assert _forbidden("ml_dtypes")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.core.models\n"
            "import repro_torch.kernels.ops, repro_torch.data\n"
            "import repro_torch.configs, repro_torch.models, repro_torch.optim\n"
            "import repro_torch.launch.steps, repro_torch.launch.train\n"
            "import repro_torch.checkpoint, repro_torch.testing\n"
            "import repro_torch.data.store, repro_torch.query\n"
            "import repro_torch.core.gibbs, repro_torch.core.baselines\n"
            "import repro_torch.gateway, repro_torch.analysis.explain\n"
            "import repro_torch.analysis.audit, repro_torch.analysis.validate\n"
            "import repro_torch.core.partition, repro_torch.launch.dist\n"
            "import repro_torch.launch.elastic, repro_torch.launch.serve\n"
            "import repro_torch.kernels.work, repro_torch.launch.roofline\n"
            "import repro_torch.launch.step_cost, repro_torch.launch.dryrun\n"
            "import repro_torch.launch.collective_histo\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
            "assert not bad, bad\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
