#!/usr/bin/env python3
"""Read the numbers that the comparison holds, to set their limits.

    python3 portbench/calibrate.py --workload lda-nytimes.vmp \\
        --seeds 11 12 13 --faults 2 [--out calib.jsonl]

For each seed, in one process: the cell's corpus and set-up, the program's
checked steps (the lower readings), the control's, which are the port's
own ``elog_dtype="bfloat16"`` tables switched on from the same starting
posteriors (an upper reading), and, for the first ``--faults`` seeds, the
reference with a fault planted (the ``FAULTS`` of the cell's reference
step, ``reference/flat.py``'s or the model's own: half the tokens or
instances left out with the rest doubled, topic 0's statistics doubled
where they are produced), each against the clean reference.  One JSON line
a seed, and at the end the largest program reading and the smallest
control and fault readings of each number.  No window is timed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run

ROOT = run.ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    run.fix_caches()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    import check
    import harness
    device = "cuda"
    harness.log(f"[device] {run.power_line()}")
    from repro_torch.core import runtime
    cell = harness.load_cell(ROOT, args.workload)
    _, faults = harness.reference_step(cell)
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        inputs = harness.make_inputs(cell, seed, device, False)
        harness._free(device)
        prog, step = harness.build_program(cell, inputs["host"],
                                           device, {})
        setup_s = time.perf_counter() - t0
        peak = harness.PortPeak(device)
        _, prog_read, _ = harness.checked_steps(cell, prog, step, seed,
                                                device, peak)
        control = runtime.make_step(prog, elog_dtype="bfloat16",
                                    device=device)
        _, ctrl_read, _ = harness.checked_steps(cell, prog, control, seed,
                                                device, peak)
        del prog, step, control
        harness._free(device)
        ref = harness.reference_readings(cell, inputs["host"], seed,
                                         device)
        row = {"seed": seed, "n_tokens": inputs["n_tokens"],
               "setup_s": setup_s,
               "program": check.compare(prog_read, ref),
               "control": check.compare(ctrl_read, ref)}
        if i < args.faults:
            for f in faults:
                row[f] = check.compare(harness.reference_readings(
                    cell, inputs["host"], seed, device, fault=f), ref)
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(dict(row, workload=args.workload)) + "\n")
        del inputs
        harness._free(device)
        torch.cuda.synchronize()
    summary = {"workload": args.workload, "seeds": len(rows)}
    for n in check.NUMBERS:
        summary[n] = {
            "program_max": max(r["program"][n] for r in rows),
            "control_min": min(r["control"][n] for r in rows),
            **{f"{f}_min": min(r[f][n] for r in rows if f in r)
               for f in faults if any(f in r for r in rows)}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
