"""Crash-safe training sessions: everything ``SVI.fit`` needs to continue
bitwise-identically after a ``kill -9``.  The port's copy of
``repro.checkpoint.session``: the same tree, manifest ``meta`` and
fingerprint, so either package resumes from the other's session.

A :class:`TrainSession` snapshots, at a step boundary:

  - the variational state (posterior concentrations + step counter) —
    the Robbins-Monro position *is* the step counter, so the learning-rate
    schedule resumes exactly;
  - the accumulated history (per-step ELBO + held-out trace), so the
    resumed run's trace equals the uninterrupted run's;
  - the sampler cursor: the resident sampler is pure in ``(seed, step)``
    and needs nothing, while the growing sampler's epoch snapshots
    (``GrowingMinibatchSampler.epoch_log()`` + the frozen group arrays)
    are stored verbatim so replay does not depend on when docs arrived;
  - the held-out split (in growing mode the split depends on the corpus
    size at *first* build, which a resumed process cannot re-derive);
  - a corpus snapshot ``(n_docs, n_tokens, n_shards)`` sanity floor;
  - a config/program **fingerprint** — resume into a mismatched model or
    schedule is refused with the differing fields named.

Sessions ride the self-validating checkpoint store (``store.py``): the
tree is pure-dict so it reloads without a ``tree_like``, and the scalar
context rides in the checkpoint manifest's ``meta``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Optional

import numpy as np
import torch

from . import store

SESSION_KIND = "svi-train-session"


@dataclasses.dataclass
class TrainSession:
    """One resumable snapshot of an ``SVI.fit`` run at step ``t``."""

    posteriors: dict          # name -> np.ndarray concentrations
    t: int                    # completed steps == VMPState.step == RM position
    history: dict             # {"elbo": [float], "heldout": [(t, float)]}
    epochs: list              # growing sampler: [(start_step, groups array)]
    holdout: np.ndarray       # held-out group ids (int64)
    corpus: Optional[dict]    # {"n_docs", "n_tokens", "n_shards"} or None
    fingerprint: dict         # from session_fingerprint()


def session_fingerprint(program, cfg, batch_size: int) -> dict:
    """JSON-able identity of (model structure, schedule-affecting config).

    Two fits with equal fingerprints walk the same optimization path, so
    resuming across them is bitwise-safe.  Deliberately excludes the
    sharding plan (remesh-and-resume continues the schedule on a new mesh,
    trading bitwise identity for elasticity) and, in growing mode, the
    current corpus size (growth between save and resume is the point).
    """
    meta = getattr(program, "meta", {}) or {}
    fp = {
        "kind": SESSION_KIND,
        "program": getattr(program, "name", ""),
        "dirichlets": {n: [int(d.g), int(d.k)]
                       for n, d in sorted(program.dirichlets.items())},
        "growing": bool(cfg.growing),
        "pstar_size": 0 if cfg.growing else int(meta.get("pstar_size") or 0),
        "capacity_docs": int(meta.get("capacity_docs") or 0),
        "batch_size": int(batch_size),
        "kappa": float(cfg.kappa), "tau": float(cfg.tau),
        "rho": None if cfg.rho is None else float(cfg.rho),
        "local_iters": int(cfg.local_iters),
        "pad_multiple": int(cfg.pad_multiple),
        "holdout_frac": float(cfg.holdout_frac),
        "holdout_every": int(cfg.holdout_every),
        "holdout_local_iters": int(cfg.holdout_local_iters),
        "shuffle": bool(cfg.shuffle),
        "population_size": int(cfg.population_size),
        "elog_dtype": dtype_name(cfg.elog_dtype),
        "seed": int(cfg.seed),
    }
    return fp


def dtype_name(dtype) -> str:
    """The name ``str(np.dtype(dtype))`` gives the JAX package's
    fingerprint, without ``ml_dtypes``: ``""`` for None, ``"bfloat16"`` for
    bf16 by name or as a torch dtype, numpy's name for the rest."""
    if dtype is None:
        return ""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if dtype == "bfloat16":
        return "bfloat16"
    return str(np.dtype(dtype))


def fingerprint_digest(fp: dict) -> str:
    return hashlib.sha256(
        json.dumps(fp, sort_keys=True).encode()).hexdigest()[:16]


def check_fingerprint(saved: dict, current: dict, where: str) -> None:
    """Refuse resume into a mismatched model/config, naming the fields."""
    if saved == current:
        return
    keys = sorted(set(saved) | set(current))
    diffs = [f"{k}: saved={saved.get(k)!r} != current={current.get(k)!r}"
             for k in keys if saved.get(k) != current.get(k)]
    raise ValueError(
        f"refusing to resume from {where}: session was written by a "
        f"mismatched model/config — differing fields: " + "; ".join(diffs))


def _to_tree(sess: TrainSession) -> dict:
    hs = sess.history.get("heldout", [])
    groups = [np.asarray(g, np.int64) for _, g in sess.epochs]
    return {
        "posteriors": {n: np.asarray(v)
                       for n, v in sorted(sess.posteriors.items())},
        "elbo": np.asarray(sess.history.get("elbo", []), np.float64),
        "heldout_t": np.asarray([t for t, _ in hs], np.int64),
        "heldout_v": np.asarray([v for _, v in hs], np.float64),
        "epoch_starts": np.asarray([s for s, _ in sess.epochs], np.int64),
        "epoch_sizes": np.asarray([len(g) for g in groups], np.int64),
        "epoch_groups": (np.concatenate(groups) if groups
                         else np.zeros(0, np.int64)),
        "holdout": np.asarray(sess.holdout, np.int64),
    }


def _meta(sess: TrainSession) -> dict:
    return {"kind": SESSION_KIND, "t": int(sess.t),
            "fingerprint": sess.fingerprint,
            "digest": fingerprint_digest(sess.fingerprint),
            "corpus": sess.corpus}


def save_session(ckpt: store.CheckpointStore, sess: TrainSession,
                 force: bool = False) -> bool:
    """Write ``sess`` through a :class:`CheckpointStore` (step label = t)."""
    return ckpt.maybe_save(sess.t, _to_tree(sess), meta=_meta(sess),
                           force=force)


def load_session(directory: str, step: int | None = None) -> TrainSession:
    """Load the newest valid session (or an exact ``step``).

    Corrupt newer checkpoints are skipped with a warning (the store's
    fallback contract); a checkpoint that is not a session raises.
    """
    tree, manifest = store.load(directory, tree_like=None, step=step)
    meta = manifest.get("meta") or {}
    if meta.get("kind") != SESSION_KIND:
        raise ValueError(
            f"checkpoint in {directory} (step {manifest.get('step')}) is not "
            f"a train session (kind={meta.get('kind')!r})")
    history = {
        "elbo": [float(x) for x in tree["elbo"]],
        "heldout": [(int(t), float(v))
                    for t, v in zip(tree["heldout_t"], tree["heldout_v"])],
    }
    epochs = []
    off = 0
    for start, size in zip(tree["epoch_starts"], tree["epoch_sizes"]):
        epochs.append((int(start),
                       np.asarray(tree["epoch_groups"][off:off + int(size)],
                                  np.int64)))
        off += int(size)
    return TrainSession(
        posteriors={n: np.asarray(v) for n, v in tree["posteriors"].items()},
        t=int(meta["t"]), history=history, epochs=epochs,
        holdout=np.asarray(tree["holdout"], np.int64),
        corpus=meta.get("corpus"), fingerprint=meta.get("fingerprint") or {})


def latest_session_step(directory: str) -> int | None:
    """Step of the newest *valid* session checkpoint (None if none)."""
    try:
        return store.latest_valid_step(directory)
    except FileNotFoundError:              # pragma: no cover
        return None
