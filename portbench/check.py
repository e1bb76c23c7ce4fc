"""The comparison that decides ``correct``: the program's first checked
steps against the plain reference's, from the same inputs and the same
starting posteriors.

A fit is judged as a training run is.  Each side records, over its first
steps: the ELBO of each step (at the step's input posteriors), the norm of
each Dirichlet's statistics after the first step (``post_1 - prior``: the
update as the step hands it over), and the norm of each Dirichlet's change
after the last checked step (``post_n - post_0``).  The numbers compared:

  - ``elbo_gap``: the largest ``|ELBO_p - ELBO_r| / |ELBO_r|`` over the
    steps;
  - ``stats_gap`` and ``change_gap``: over the Dirichlets that count, the
    largest ``|norm_p - norm_r| / max(norm_r, median of norm_r)``.  A
    Dirichlet whose reference statistics have a norm under a thousandth of
    the median one does not count (its change is round-off).

Each is held to its limit in ``limits/<workload>.json``; a number that is
not finite fails.
"""

from __future__ import annotations

import math
import statistics

import torch

NUMBERS = ("elbo_gap", "stats_gap", "change_gap")
#: a Dirichlet counts where its reference statistics' norm is at least this
#: share of the median Dirichlet's
COUNT_SHARE = 1e-3


def norm(t: torch.Tensor, sub=None, block_rows: int = 1 << 14) -> float:
    """The float64 2-norm of ``t - sub`` (``sub`` a scalar or a tensor of
    t's shape), ``block_rows`` rows at a time."""
    total = 0.0
    for s in range(0, t.shape[0], block_rows):
        x = t[s:s + block_rows].double()
        if sub is not None:
            x = x - (sub if not torch.is_tensor(sub)
                     else sub[s:s + block_rows].double())
        total += float((x * x).sum())
    return math.sqrt(total)


def _gap(prog: dict, ref: dict, counted) -> float:
    med = statistics.median(ref.values())
    return max((abs(prog[n] - ref[n]) / max(ref[n], med) for n in counted),
               default=0.0)


def compare(prog: dict, ref: dict) -> dict:
    """``{number: value}`` of the program's readings against the
    reference's."""
    med = statistics.median(ref["stats"].values())
    counted = [n for n, v in ref["stats"].items() if v >= COUNT_SHARE * med]
    elbo = max(abs(p - r) / abs(r) for p, r in zip(prog["elbos"],
                                                   ref["elbos"]))
    return {"elbo_gap": elbo,
            "stats_gap": _gap(prog["stats"], ref["stats"], counted),
            "change_gap": _gap(prog["change"], ref["change"], counted)}


def judge(values: dict, limits: dict) -> tuple:
    """``(correct, {number: {"value", "limit"}})``: every number finite and
    at most its limit."""
    out = {n: {"value": values[n], "limit": float(limits[n]["limit"])}
           for n in NUMBERS}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
