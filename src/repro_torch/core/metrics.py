"""Evaluation metrics (the port's copy of ``repro.core.metrics``)."""

from __future__ import annotations

import numpy as np


def aligned_tv(est: np.ndarray, true: np.ndarray) -> float:
    """Mean total-variation distance between row-distributions after greedy
    permutation matching (label switching: topic k of a mixture fit is
    arbitrary).  0 = planted structure recovered exactly, 1 = disjoint.
    """
    est = np.asarray(est, np.float64)
    true = np.asarray(true, np.float64)
    used, dists = set(), []
    for k in range(len(true)):
        best, best_d = None, 2.0
        for j in range(len(est)):
            if j not in used:
                d = 0.5 * np.abs(est[j] - true[k]).sum()
                if d < best_d:
                    best, best_d = j, d
        if best is not None:
            used.add(best)
        dists.append(best_d)
    return float(np.mean(dists))
