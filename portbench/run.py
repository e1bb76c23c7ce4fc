#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 portbench/run.py --workload lda-nytimes.vmp --seed 12345 \\
        --seconds 10 --trace 0

From the root of a checkout.  Prints the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``) as one JSON line,
the last of standard output, after the numbers the comparison held beside
their limits on standard error.  Exits non-zero, with no result, where the
machine has no CUDA card or fewer than the cell needs, where the port's
package is not in the checkout, or where a module of the JAX package (or
JAX) was loaded.  The port's build and kernel caches go to fixed
directories under ``build/portbench/`` in the checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "portbench"


def fix_caches() -> None:
    """The port's library builds and the kernel caches, inside the
    checkout at fixed paths, whatever the environment says."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "lib")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TRITON_HOME"] = str(CACHE / "triton_home")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc!r})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fix_caches()
    sys.path.insert(0, str(ROOT / "src"))
    if importlib.util.find_spec("repro_torch") is None:
        print("the port's package repro_torch is not in this checkout",
              file=sys.stderr)
        return 2
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in manifest["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"[device] {power_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    import harness
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace))
    banned = harness.banned_modules()
    if banned:
        print(f"modules that no run may load were loaded: {banned}",
              file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
