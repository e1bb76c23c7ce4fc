"""Per-key collective histogram of one dry-run cell: which exchanges of the
step move the bytes.  ``repro.launch.collective_histo`` on the port: the
reference reads its compiled HLO; the port traces the step on ``meta``
tensors over a ``DryGroup`` (``launch.dryrun``) and reads the group's
``(kind, key, shape) -> (count, bytes)`` record.

  PYTHONPATH=src python -m repro_torch.launch.collective_histo \\
      --arch gemma3-4b --shape train_4k [--multi] [--remat dots] [--fsdp] \\
      [--top 15]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--moe-groups", type=int, default=0)
    ap.add_argument("--act-shard", default="none")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    from ..configs import SHAPES, RunConfig, get_arch
    from .dryrun import make_mesh, trace_cell

    kind, seq, batch = SHAPES[args.shape]
    run = RunConfig(seq_len=seq, global_batch=batch, remat=args.remat,
                    fsdp=args.fsdp, moe_groups=args.moe_groups,
                    act_shard=args.act_shard, flash_kernel=True)
    mesh, label = make_mesh(args.multi)
    costs, _ = trace_cell(get_arch(args.arch), args.shape, run, mesh)
    rows = sorted(costs.exchanges.items(), key=lambda kv: -kv[1][1])
    total = sum(nb for _, nb in costs.exchanges.values())
    print(f"{args.arch} {args.shape} on {label}: total collective bytes/"
          f"device: {total / 1e9:.2f} GB")
    for (kind_, key, shape), (n, b) in rows[:args.top]:
        print(f"  {b / 1e9:9.3f} GB  x{n:<8d} "
              f"{kind_:12s} {key:14s} {str(shape)[:80]}")


if __name__ == "__main__":
    main()
