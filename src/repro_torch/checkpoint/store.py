"""Fault-tolerant, self-validating checkpointing for trees of arrays: the
port's copy of ``repro.checkpoint.store``, in the same file format, so that
either package loads what the other saved.

Format (v2): one atomic ``step_<n>.npz`` file per step containing every leaf
plus a ``__manifest__`` JSON entry recording step, leaf count, treedef, and a
per-leaf ``{path, shape, dtype, crc32}`` record.  The manifest makes every
checkpoint *self-validating*: :func:`validate` detects truncation, bit rot,
and shape/dtype drift and reports exactly which leaves are damaged.

Guarantees:
  - **atomicity, no loss window** — a checkpoint is serialized to a unique
    temp file, fsync'd, and ``os.replace``'d into place.
  - **validation with fallback** — :func:`restore` checksums the newest
    checkpoint and, on corruption, warns with the exact damage and falls
    back to the newest *valid* step instead of dying.
  - **structure checks** — restoring into a ``tree_like`` whose leaf count
    disagrees with the file raises an error naming the path and mismatch.
  - **async** — host copies are taken on the caller's thread, the
    serialization, fsync and replace on a background thread;
    ``CheckpointStore.wait()`` re-raises failed commits.
  - **keep-k** — older checkpoints are garbage collected.

Trees are nested dicts, lists and tuples of numpy arrays or tensors, and the
port's ``VMPState``.  The leaf order and paths are the JAX package's
(``jax.tree_util``): a dict's keys in sorted order, path components joined
by ``/``; list and tuple entries by index; a ``VMPState`` positionally —
its posteriors in sorted name order, then ``step`` (a 0-d int32 array, as
the JAX package's state holds it) — under the paths ``"0"``, ``"1"``, ….
The manifest's ``treedef`` string is this module's own description; no
loader compares it.  bf16 leaves (torch tensors) are stored as a uint16
bitcast, recorded per leaf as ``stored_as``, and restored as
``torch.bfloat16`` tensors; every other leaf comes back as a numpy array.

Crash-safety of the protocol itself is provable via the injection points
``checkpoint.save.pre_replace`` / ``post_replace`` (``testing/faults.py``).
"""

from __future__ import annotations

import itertools
import json
import os
import re
import threading
import time
import warnings
import zlib

import numpy as np
import torch

from ..core.vmp import VMPState
from ..testing import faults

FORMAT = "repro-checkpoint"
VERSION = 2
_MANIFEST_KEY = "__manifest__"
_FILE_RE = re.compile(r"^step_(\d{10})\.npz$")
_TMP_COUNT = itertools.count()

#: dtypes npz cannot serialize: stored as an integer bitcast of the same
#: width, recorded per leaf as ``stored_as`` in the manifest
_ENCODED_DTYPES = {"bfloat16": "uint16"}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed validation; ``problems`` itemizes the damage."""

    def __init__(self, path: str, problems: list[str]):
        self.path = str(path)
        self.problems = list(problems)
        super().__init__(
            f"corrupt checkpoint {self.path}: " + "; ".join(self.problems))


def _step_file(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{int(step):010d}.npz")


# ---------------------------------------------------------------------------
# the tree walk (jax.tree_util's order and key paths)
# ---------------------------------------------------------------------------

def _children(node):
    """``[(path part, is-plain-dict-key, child)]`` of an inner node, or None
    for a leaf."""
    if isinstance(node, VMPState):
        names = sorted(node.posteriors)
        kids = [node.posteriors[n] for n in names] + \
            [np.asarray(node.step, np.int32)]
        return [(str(i), False, c) for i, c in enumerate(kids)]
    if isinstance(node, dict):
        return [(k if isinstance(k, str) and "/" not in k else str(k),
                 isinstance(k, str) and "/" not in k, node[k])
                for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), False, c) for i, c in enumerate(node)]
    if node is None:
        return []
    return None


def _walk(node, prefix: tuple, plain: bool, out: list):
    kids = _children(node)
    if kids is None:
        out.append(("/".join(prefix) if prefix else "<root>", plain, node))
        return
    for part, is_plain, child in kids:
        _walk(child, prefix + (part,), plain and is_plain, out)


def _treedef(node) -> str:
    kids = _children(node)
    if kids is None:
        return "*"
    inner = ", ".join(_treedef(c) for _, _, c in kids)
    if isinstance(node, VMPState):
        return f"VMPState[{sorted(node.posteriors)}]({inner})"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{p!r}: {_treedef(c)}"
                               for p, _, c in kids) + "}"
    if isinstance(node, tuple):
        return f"({inner})"
    if isinstance(node, list):
        return f"[{inner}]"
    return "None"


def _host(leaf, copy: bool):
    """A leaf as a host array: a numpy array, or a CPU tensor for bf16
    (numpy has none).  ``copy`` takes a copy that owns its bytes even where
    the leaf already lies on the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.array(leaf, copy=True) if copy else np.asarray(leaf)


def _flatten_with_paths(tree, copy: bool = False):
    """``(leaves as host arrays, paths, treedef string, dict_tree)``."""
    flat: list = []
    _walk(tree, (), True, flat)
    return ([_host(leaf, copy) for _, _, leaf in flat],
            [p for p, _, _ in flat], _treedef(tree),
            all(plain for _, plain, _ in flat))


def _rebuild(node, leaves):
    """``node``'s structure with its leaves taken in order from the
    iterator ``leaves``: a ``VMPState`` becomes one with CPU tensors and an
    int step."""
    kids = _children(node)
    if kids is None:
        return next(leaves)
    vals = [_rebuild(c, leaves) for _, _, c in kids]
    if isinstance(node, VMPState):
        names = sorted(node.posteriors)
        return VMPState({n: torch.as_tensor(v) for n, v in zip(names, vals)},
                        int(vals[-1]))
    if isinstance(node, dict):
        return dict(zip(sorted(node), vals))
    if isinstance(node, tuple):
        return tuple(vals)
    if isinstance(node, list):
        return vals
    return None


def _n_leaves(node) -> int:
    flat: list = []
    _walk(node, (), True, flat)
    return len(flat)


# ---------------------------------------------------------------------------
# one checkpoint file
# ---------------------------------------------------------------------------

def _fsync_dir(directory: str) -> None:
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:                        # pragma: no cover - exotic fs
        return
    try:
        os.fsync(fd)
    except OSError:                        # pragma: no cover
        pass
    finally:
        os.close(fd)


def _encode(leaf):
    """``(numpy array to store, logical dtype name, stored_as or None)``."""
    if isinstance(leaf, torch.Tensor):       # bf16: bitcast, not convert
        return (leaf.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16",
                _ENCODED_DTYPES["bfloat16"])
    return leaf, str(leaf.dtype), None


def save(directory: str, step: int, tree, meta: dict | None = None) -> str:
    """Write one checkpoint (blocking); returns its path.

    Serializes to a unique temp file, fsyncs, then atomically
    ``os.replace``s into place — a crash at any point leaves either the old
    complete checkpoint or the new one, never neither.  ``meta`` (JSON-able
    dict) rides in the manifest and comes back from :func:`load`.
    """
    return _save_flat(directory, step, *_flatten_with_paths(tree), meta=meta)


def _save_flat(directory: str, step: int, leaves: list, paths: list,
               treedef: str, dict_tree: bool, meta: dict | None) -> str:
    """:func:`save` of a flattened tree (:func:`_flatten_with_paths`)."""
    os.makedirs(directory, exist_ok=True)
    arrays, records = {}, []
    for i, (leaf, path) in enumerate(zip(leaves, paths)):
        name = f"leaf_{i:05d}"
        leaf, dtype, stored_as = _encode(leaf)
        rec = {"name": name, "path": path,
               "shape": list(leaf.shape), "dtype": dtype}
        if stored_as is not None:
            rec["stored_as"] = stored_as
        rec["crc32"] = zlib.crc32(np.ascontiguousarray(leaf).tobytes())
        arrays[name] = leaf
        records.append(rec)
    manifest = {"format": FORMAT, "version": VERSION, "step": int(step),
                "n_leaves": len(leaves), "treedef": treedef,
                "dict_tree": bool(dict_tree), "leaves": records,
                "meta": meta or {}, "time": time.time()}
    blob = np.frombuffer(json.dumps(manifest).encode(), np.uint8)
    final = _step_file(directory, step)
    tmp = final + f".tmp-{os.getpid()}-{next(_TMP_COUNT)}"
    with open(tmp, "wb") as fh:
        np.savez(fh, **{_MANIFEST_KEY: blob}, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    faults.trip("checkpoint.save.pre_replace")
    os.replace(tmp, final)
    faults.trip("checkpoint.save.post_replace")
    _fsync_dir(directory)
    return final


def read_manifest(path: str) -> dict:
    """Parse a checkpoint's manifest (no leaf validation)."""
    try:
        with np.load(path) as data:
            if _MANIFEST_KEY not in data.files:
                raise CheckpointCorruptError(path, ["missing manifest entry"])
            manifest = json.loads(bytes(data[_MANIFEST_KEY]))
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            path, [f"unreadable ({type(e).__name__}: {e})"])
    if manifest.get("format") != FORMAT:
        raise CheckpointCorruptError(
            path, [f"not a {FORMAT} file (format={manifest.get('format')!r})"])
    return manifest


def validate(path: str) -> dict:
    """Fully validate a checkpoint file; returns its manifest.

    Checks the zip container, manifest presence/format, leaf inventory, and
    per-leaf shape/dtype/crc32.  Raises :class:`CheckpointCorruptError`
    whose ``problems`` name each damaged leaf by its tree path.
    """
    manifest = read_manifest(path)
    problems: list[str] = []
    try:
        with np.load(path) as data:
            names = set(data.files) - {_MANIFEST_KEY}
            if manifest["n_leaves"] != len(manifest["leaves"]):
                problems.append("manifest leaf count inconsistent")
            for rec in manifest["leaves"]:
                if rec["name"] not in names:
                    problems.append(f"leaf {rec['path']!r}: entry missing")
                    continue
                arr = data[rec["name"]]
                expect_dtype = rec.get("stored_as", rec["dtype"])
                if list(arr.shape) != list(rec["shape"]):
                    problems.append(
                        f"leaf {rec['path']!r}: shape {list(arr.shape)} != "
                        f"manifest {rec['shape']}")
                elif str(arr.dtype) != expect_dtype:
                    problems.append(
                        f"leaf {rec['path']!r}: dtype {arr.dtype} != "
                        f"manifest {expect_dtype}")
                elif zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                        != rec["crc32"]:
                    problems.append(f"leaf {rec['path']!r}: checksum mismatch")
    except CheckpointCorruptError:
        raise
    except Exception as e:
        raise CheckpointCorruptError(
            path, [f"unreadable ({type(e).__name__}: {e})"])
    if problems:
        raise CheckpointCorruptError(path, problems)
    return manifest


def complete_steps(directory: str) -> list[int]:
    """Steps with a fully-replaced checkpoint file (tmp files are ignored).
    Completeness is the atomic replace; validity is :func:`validate`."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _FILE_RE.match(name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = complete_steps(directory)
    return steps[-1] if steps else None


def latest_valid_step(directory: str) -> int | None:
    """Newest step that passes full validation (None if none do)."""
    for s in reversed(complete_steps(directory)):
        try:
            validate(_step_file(directory, s))
            return s
        except CheckpointCorruptError:
            continue
    return None


def _decode(rec: dict, arr: np.ndarray):
    if rec.get("stored_as") is None:
        return arr
    if rec["dtype"] != "bfloat16":
        raise ValueError(f"unknown encoded leaf dtype {rec['dtype']!r}")
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
        .view(torch.bfloat16)


def _assemble(path: str, manifest: dict, tree_like):
    with np.load(path) as data:
        leaves = [_decode(rec, data[rec["name"]])
                  for rec in manifest["leaves"]]
    if tree_like is not None:
        n = _n_leaves(tree_like)
        if n != len(leaves):
            sample = ", ".join(r["path"] for r in manifest["leaves"][:6])
            raise ValueError(
                f"checkpoint {path} holds {len(leaves)} leaves but the "
                f"provided tree_like has {n} — stale or "
                f"mismatched model structure?  (checkpoint leaf paths: "
                f"{sample}{', ...' if len(leaves) > 6 else ''})")
        return _rebuild(tree_like, iter(leaves))
    if not manifest.get("dict_tree"):
        raise ValueError(
            f"checkpoint {path} contains non-dict tree nodes; pass "
            f"tree_like= to reconstruct it")
    out: dict = {}
    for rec, leaf in zip(manifest["leaves"], leaves):
        node = out
        parts = rec["path"].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def load(directory: str, tree_like=None, step: int | None = None):
    """Validate and load a checkpoint; returns ``(tree, manifest)``.

    With ``step=None`` picks the newest step, falling back (with a
    ``RuntimeWarning`` naming the damage) past corrupted checkpoints to the
    newest valid one.  An explicit ``step=`` never falls back — corruption
    raises :class:`CheckpointCorruptError` with the itemized damage.
    With ``tree_like=None`` the tree is reconstructed from the manifest's
    leaf paths (pure-dict trees only).
    """
    steps = complete_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no complete checkpoint in {directory}")
    if step is not None:
        if step not in steps:
            raise FileNotFoundError(
                f"no checkpoint for step {step} in {directory} "
                f"(have {steps})")
        path = _step_file(directory, step)
        manifest = validate(path)
        return _assemble(path, manifest, tree_like), manifest
    failures: list[CheckpointCorruptError] = []
    for s in reversed(steps):
        path = _step_file(directory, s)
        try:
            manifest = validate(path)
        except CheckpointCorruptError as e:
            warnings.warn(
                f"skipping corrupt checkpoint {path} "
                f"({'; '.join(e.problems)}); falling back to an older step",
                RuntimeWarning, stacklevel=2)
            failures.append(e)
            continue
        return _assemble(path, manifest, tree_like), manifest
    raise CheckpointCorruptError(
        directory, [f"every checkpoint is corrupt: "
                    f"{'; '.join(str(e) for e in failures)}"])


def restore(directory: str, tree_like=None, step: int | None = None):
    """Restore a checkpoint tree (see :func:`load` for the full contract)."""
    tree, _ = load(directory, tree_like, step)
    return tree


def clean_tmp(directory: str) -> int:
    """Remove leftover ``*.npz.tmp-*`` files from crashed saves.  Only safe
    when no save is in flight against ``directory`` (single-writer rule)."""
    if not os.path.isdir(directory):
        return 0
    n = 0
    for name in os.listdir(directory):
        if ".npz.tmp-" in name:
            try:
                os.remove(os.path.join(directory, name))
                n += 1
            except OSError:                # pragma: no cover - races
                pass
    return n


class CheckpointStore:
    """every-k checkpointing with keep-k GC and async commit.

    One store owns one directory (single-writer).  Construction sweeps tmp
    litter left by a previous crashed process.
    """

    def __init__(self, directory: str, every: int = 10, keep: int = 3,
                 blocking: bool = False):
        self.directory = directory
        self.every = max(1, every)
        self.keep = max(1, keep)
        self.blocking = blocking
        self._pending: list[threading.Thread] = []
        self._errors: list[BaseException] = []
        clean_tmp(directory)

    def maybe_save(self, step: int, tree, meta: dict | None = None,
                   force: bool = False) -> bool:
        if not force and step % self.every != 0:
            return False
        # the leaves' host copies are taken here, on the caller's thread:
        # a CPU tensor's numpy() would alias state the caller goes on to
        # change, and a CUDA tensor's copy must not race the next step
        flat = _flatten_with_paths(tree, copy=True)
        if self.blocking:
            _save_flat(self.directory, step, *flat, meta=meta)
        else:
            # tracked (non-fire-and-forget) async commit: wait() joins them,
            # so a run's final checkpoint is durable before the run returns
            def _commit(s=step, fl=flat, m=meta):
                try:
                    _save_flat(self.directory, s, *fl, meta=m)
                except BaseException as e:          # surfaced by wait()
                    self._errors.append(e)

            t = threading.Thread(target=_commit, daemon=True)
            t.start()
            # keep the list O(in-flight): drop threads that already landed
            self._pending = [p for p in self._pending if p.is_alive()]
            self._pending.append(t)
        self._gc()
        return True

    def wait(self) -> None:
        """Block until every in-flight async commit has landed; re-raise
        the first failure (a silently dropped checkpoint is not durable)."""
        for t in self._pending:
            t.join()
        self._pending = []
        if self._errors:
            err, self._errors = self._errors[0], []
            raise RuntimeError("async checkpoint save failed") from err

    def _gc(self):
        # never removes the newest keep-k complete steps; corrupt files
        # age out the same way so fallback candidates stay bounded
        for s in complete_steps(self.directory)[:-self.keep]:
            try:
                os.remove(_step_file(self.directory, s))
            except OSError:                # pragma: no cover - races
                pass

    def latest(self) -> int | None:
        self.wait()
        return latest_step(self.directory)

    def restore(self, tree_like=None, step: int | None = None):
        self.wait()
        return restore(self.directory, tree_like, step)

