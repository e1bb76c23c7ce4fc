"""Build a CUDA source of the port into a shared library with a plain C
interface.

``nvcc`` compiles one ``csrc/*.cu`` for ``sm_90a`` into
``lib<name>-<hash>.so`` under :func:`build_dir`, keyed by the first 12 hex
digits of the source's sha256, so that a library is rebuilt exactly when its
source changes.  The wrappers load it with ``ctypes``.  Each build writes a
temporary file and renames it into place, so processes building at once do
not see a half-written library.
"""

import hashlib
import os
import subprocess
from pathlib import Path


def build_dir() -> Path:
    """Where the shared libraries are built: ``$REPRO_TORCH_BUILD_DIR`` or
    ``build/`` at the repo root."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parents[3] / "build"


def build_library(src: Path, name: str, verbose: bool = False) -> tuple[Path, str]:
    """Compile ``src`` unless a library built from the same source exists;
    returns (library path, compiler output).  ``verbose`` rebuilds and
    returns what ``-Xptxas -v`` says of each kernel."""
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    out = build_dir() / f"lib{name}-{tag}.so"
    if out.exists() and not verbose:
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    cmd = [str(nvcc) if nvcc.exists() else "nvcc",
           "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src)]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src.name} failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out, res.stdout + res.stderr
