"""Compile a Bayesian network + observations into a vectorized VMP program.

The port's copy of ``repro.core.compiler``: the program IR and
:func:`compile_program`, op for op, so that both packages build the same
index arrays from the same model and data.  It plays the role of the
paper's *metadata collection* and *code generation* stages (sections
3.3-3.4, 4.2):

  - resolve ``?`` plate sizes from the observed data,
  - assign every RV a **consecutive vertex-ID interval** (paper section 4.2),
  - resolve every conditional dependency into static row-index arrays plus at
    most one latent selector (the supported mixture class),
  - emit a :class:`VMPProgram` that ``vmp.py`` runs one update step at a time.

Minibatch slicing (``slice_arrays``, ``sliced_shadow``), the SVI
engine's view of a program, is copied the same way.  Everything here is
numpy; tensors and devices begin in ``vmp.py`` and ``svi.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..analysis.diagnostics import raise_error, raise_unsupported

from .network import UNKNOWN, BayesianNetwork, CategoricalRV, DirichletRV, Plate


# ---------------------------------------------------------------------------
# program IR
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChildFactor:
    """An observed Categorical child of a latent selector."""
    x_name: str
    dir_name: str                    # parent Dirichlet
    values: np.ndarray               # (N,) observed category per instance
    zmap: Optional[np.ndarray]       # (N,) -> selector instance; None = identity
    base: Optional[np.ndarray]       # (N,) static row base; None = all zeros
    stride: int                      # row = base + stride * z
    n_z: int                         # selector instance count

    @property
    def specialized(self) -> bool:
        """LDA fast path: rows are exactly the selector value."""
        return self.base is None and self.stride == 1


@dataclasses.dataclass
class StaticFactor:
    """An observed Categorical whose Dirichlet row is fully static."""
    x_name: str
    dir_name: str
    rows: np.ndarray                 # (N,)
    values: np.ndarray               # (N,)
    group: Optional[np.ndarray] = None   # (N,) partition-group per instance


@dataclasses.dataclass
class LatentSpec:
    name: str
    n: int                           # instances
    k: int                           # categories
    prior_dir: str                   # Dirichlet supplying the prior
    prior_rows: np.ndarray           # (n,) static rows into prior_dir
    children: list[ChildFactor]
    group: Optional[np.ndarray] = None   # (n,) partition-group per instance


@dataclasses.dataclass
class DirichletSpec:
    name: str
    g: int                           # rows (flattened plate size)
    k: int                           # dim
    prior: np.ndarray                # (k,) or scalar, broadcast over rows
    group_rows: Optional[np.ndarray] = None  # (g,) group per row; None = global


@dataclasses.dataclass
class VMPProgram:
    name: str
    net: BayesianNetwork
    dirichlets: dict[str, DirichletSpec]
    latents: list[LatentSpec]
    statics: list[StaticFactor]
    vertex_layout: dict[str, tuple[int, int]]
    plate_sizes: dict[str, int]
    meta: dict

    def init_state(self, seed: int = 0, device=None):
        from .vmp import init_state
        return init_state(self, seed, device=device)


# ---------------------------------------------------------------------------
# plate resolution
# ---------------------------------------------------------------------------

class _PlateInfo:
    """Resolved flat sizes + parent maps for every plate."""

    def __init__(self, net: BayesianNetwork):
        self.net = net
        self.flat: dict[int, int] = {id(net.toplevel): 1}
        self.parent_map: dict[int, np.ndarray] = {id(net.toplevel): None}

    def resolve(self, observations: dict, plate_bindings: dict):
        net = self.net
        # pass 1: data-driven sizes for ? plates carrying observed RVs
        for name, obs in observations.items():
            rv = net.rvs[name]
            self._bind_leaf(rv.plate, len(obs["values"]), obs["segment_ids"])
        for pname, parent_ids in plate_bindings.items():
            plate = self._plate_by_name(pname)
            self._bind_leaf(plate, len(parent_ids), np.asarray(parent_ids, np.int32))
        # pass 2: fixpoint over known-size plates (child = parent * size)
        for _ in range(len(net.plates) + 1):
            progress = False
            for p in net.plates:
                if id(p) in self.flat:
                    continue
                if p.size != UNKNOWN and id(p.parent) in self.flat:
                    pf = self.flat[id(p.parent)]
                    self.flat[id(p)] = pf * p.size
                    self.parent_map[id(p)] = np.repeat(
                        np.arange(pf, dtype=np.int32), p.size)
                    progress = True
            if not progress:
                break
        for p in net.plates:
            if id(p) in self.flat:
                p.flat_size = self.flat[id(p)]

    def _plate_by_name(self, name):
        for p in self.net.plates:
            if p.name == name:
                return p
        raise KeyError(f"no plate named {name!r}")

    def _bind_leaf(self, plate: Plate, n: int, segment_ids):
        pid = id(plate)
        if pid in self.flat and self.flat[pid] != n:
            raise_error("plate-size-conflict", plate.name,
                        f"plate {plate.name}: conflicting sizes "
                        f"{self.flat[pid]} vs {n}",
                        hint="every observation/binding on one plate must "
                             "agree on its flattened size")
        self.flat[pid] = n
        if segment_ids is not None:
            self.parent_map[pid] = np.asarray(segment_ids, np.int32)
            par = plate.parent
            if par is not None and par.size == UNKNOWN and id(par) not in self.flat:
                self.flat[id(par)] = int(segment_ids.max()) + 1 if n else 0
        elif plate.parent is not None and plate.parent.parent is None:
            self.parent_map[pid] = np.zeros(n, dtype=np.int32)

    # -- index algebra ----------------------------------------------------
    def ancestor_index(self, child: Plate, anc: Plate) -> np.ndarray:
        """Flat index of each ``child`` instance's ancestor in ``anc``."""
        if anc.parent is None:                       # TOPLEVEL
            return np.zeros(self.flat[id(child)], dtype=np.int32)
        idx = np.arange(self.flat[id(child)], dtype=np.int32)
        p = child
        while p is not anc:
            pm = self.parent_map.get(id(p))
            if pm is None:
                raise ValueError(f"plate {p.name} has no parent map; "
                                 f"observe/bind data for it first")
            idx = pm[idx]
            p = p.parent
            if p is None:
                raise ValueError(f"{anc.name} is not an ancestor")
        return idx

    def local_index(self, child: Plate, anc: Plate) -> np.ndarray:
        """Index of the ancestor instance *within its own parent's repeat*."""
        flat = self.ancestor_index(child, anc)
        if anc.size == UNKNOWN:
            # only legal as the outermost chain plate (checked by caller)
            return flat
        return flat % np.int32(anc.size)


# ---------------------------------------------------------------------------
# row resolution for Dirichlet parents
# ---------------------------------------------------------------------------

def _dirichlet_rows(pl: _PlateInfo, d: DirichletRV, child: CategoricalRV):
    """Resolve the flattened Dirichlet row for each child instance.

    Returns (base, stride) where ``base`` is the static part ((N,) or None for
    all-zero) and ``stride`` multiplies the latent selector value (0 if no
    plate is selector-resolved).
    """
    chain = d.plate.chain()
    sizes = []
    for i, p in enumerate(chain):
        if p.size == UNKNOWN:
            if i != 0:
                raise_unsupported(
                    "unknown-plate-position", d.name,
                    f"{d.name} (plate {d.plate.path()}): '?' plates are only "
                    f"supported as the outermost plate of a Dirichlet's chain "
                    f"(plate {p.name} is at position {i})",
                    hint="move the unknown-size plate outermost or give it "
                         "a fixed size")
            sizes.append(pl.flat[id(p)])
        else:
            sizes.append(p.size)
    strides = [int(np.prod(sizes[i + 1:], dtype=np.int64)) for i in range(len(chain))]

    n = pl.flat[id(child.plate)]
    base = np.zeros(n, dtype=np.int64)
    sel_stride = 0
    sel_used = False
    for p, s in zip(chain, strides):
        if p.is_ancestor_of(child.plate):
            base = base + pl.local_index(child.plate, p).astype(np.int64) * s
        elif child.selector is not None and not sel_used:
            sel_used = True
            sel_stride = s
        else:  # unreachable after net.validate()
            raise ValueError(f"cannot resolve plate {p.name} for {child.name}")
    if not base.any():
        base_out = None
    else:
        base_out = base.astype(np.int32)
    return base_out, int(sel_stride)


# ---------------------------------------------------------------------------
# compile
# ---------------------------------------------------------------------------

def compile_program(net: BayesianNetwork, observations: dict,
                    plate_bindings: dict | None = None,
                    sharding=None) -> VMPProgram:
    net.validate()
    pl = _PlateInfo(net)
    pl.resolve(observations, plate_bindings or {})

    # partition plate (paper section 4.4): the outermost '?' plate is the
    # "independent trees" dimension along which the MPG decomposes
    pstar = None
    for p in net.plates:
        if p.parent is net.toplevel and p.size == UNKNOWN and id(p) in pl.flat:
            if pstar is None or pl.flat[id(p)] > pl.flat[id(pstar)]:
                pstar = p

    def _group_of(plate: Plate):
        if pstar is not None and pstar.is_ancestor_of(plate):
            return pl.ancestor_index(plate, pstar)
        return None

    dirichlets: dict[str, DirichletSpec] = {}
    for d in net.dirichlets():
        g = pl.flat.get(id(d.plate))
        if g is None:
            raise_error("plate-unresolved", d.name,
                        f"{d.name}: plate {d.plate.name} size unresolved",
                        hint="observe data on the plate or bind it "
                             "(Model.bind) before compiling")
        prior = np.asarray(d.conc, dtype=np.float32)
        if prior.ndim == 0:
            prior = np.full((d.dim,), float(prior), dtype=np.float32)
        if prior.shape != (d.dim,):
            raise_error("prior-shape", d.name,
                        f"{d.name}: prior shape {prior.shape} != ({d.dim},)",
                        hint="pass a scalar or a length-dim concentration "
                             "vector")
        if (prior <= 0).any():
            raise_error("prior-positive", d.name,
                        f"{d.name}: concentrations must be positive")
        chain = d.plate.chain()
        group_rows = None
        if pstar is not None and chain and chain[0] is pstar:
            s0 = g // pl.flat[id(pstar)] if pl.flat[id(pstar)] else 1
            group_rows = (np.arange(g, dtype=np.int64) // max(s0, 1)).astype(np.int32)
        dirichlets[d.name] = DirichletSpec(d.name, g, d.dim, prior,
                                           group_rows=group_rows)

    latents: list[LatentSpec] = []
    statics: list[StaticFactor] = []
    children_of: dict[str, list[ChildFactor]] = {}

    for rv in net.rvs.values():
        if not isinstance(rv, CategoricalRV):
            continue
        if rv.observed:
            obs = observations[rv.name]
            base, stride = _dirichlet_rows(pl, rv.parent, rv)
            if rv.selector is None:
                rows = base if base is not None else np.zeros(
                    len(obs["values"]), np.int32)
                statics.append(StaticFactor(rv.name, rv.parent.name,
                                            rows, obs["values"],
                                            group=_group_of(rv.plate)))
            else:
                if rv.selector.plate is rv.plate:
                    zmap = None
                else:
                    zmap = pl.ancestor_index(rv.plate, rv.selector.plate)
                children_of.setdefault(rv.selector.name, []).append(
                    ChildFactor(rv.name, rv.parent.name, obs["values"], zmap,
                                base, stride if stride else 1,
                                pl.flat[id(rv.selector.plate)]))
        else:
            if rv.selector is not None:
                raise_unsupported(
                    "latent-mixture", f"{rv.name}->{rv.selector.name}",
                    f"latent {rv.name} (plate {rv.plate.path()}) is selected "
                    f"by latent {rv.selector.name} — latent mixtures of "
                    f"latents are outside the supported class",
                    hint=f"observe {rv.name} or remove the selector edge "
                         f"from {rv.selector.name}")

    for rv in net.latent_categoricals():
        n = pl.flat.get(id(rv.plate))
        if n is None:
            raise_error("plate-unresolved", rv.name,
                        f"latent {rv.name}: plate size unresolved; "
                        f"observe its children or bind the plate")
        base, stride = _dirichlet_rows(pl, rv.parent, rv)
        if stride:
            raise_error("latent-strided", rv.name,
                        f"latent {rv.name} (plate {rv.plate.path()}) cannot "
                        f"itself be a mixture: its prior {rv.parent.name} has "
                        f"a selector-resolved plate",
                        hint=f"give {rv.name} a statically-indexed prior")
        prior_rows = base if base is not None else np.zeros(n, np.int32)
        latents.append(LatentSpec(rv.name, n, rv.dim, rv.parent.name,
                                  prior_rows, children_of.pop(rv.name, []),
                                  group=_group_of(rv.plate)))
    if children_of:
        raise_error("orphan-selector", ",".join(children_of),
                    f"selectors without latent spec: {list(children_of)}",
                    hint="every selector must be a latent Categorical in "
                         "the model")

    # consecutive vertex-ID intervals, in definition order (paper section 4.2)
    layout, off = {}, 0
    for rv in net.rvs.values():
        cnt = pl.flat[id(rv.plate)]
        layout[rv.name] = (off, off + cnt)
        off += cnt

    plate_sizes = {p.name: pl.flat[id(p)] for p in net.plates if id(p) in pl.flat}
    n_obs = sum(len(o["values"]) for o in observations.values())
    meta = {"n_observed": n_obs, "n_vertices": off,
            "model_loc": net.loc(), "sharding": sharding,
            "pstar": pstar.name if pstar is not None else None,
            "pstar_size": pl.flat[id(pstar)] if pstar is not None else None}
    return VMPProgram(net.name, net, dirichlets, latents, statics,
                      layout, plate_sizes, meta)


# ---------------------------------------------------------------------------
# minibatch slicing (the SVI engine's view of a program)
# ---------------------------------------------------------------------------
#
# A minibatch is a subset B of the partition-plate groups (documents).  The
# message-passing graph decomposes into independent trees over those groups
# (paper section 4.4), so the batch's slice of the program is closed: the
# latent rows whose group is in B, the child/static factors of those rows
# (zmaps re-indexed to batch-local latent positions), the batch rows of every
# LOCAL Dirichlet (re-indexed likewise), and the full arrays of every GLOBAL
# Dirichlet.  ``caps`` optionally pads each sliced axis to a fixed capacity
# (masked), so a step built at one cap signature serves every batch.

def local_dirichlets(program: VMPProgram) -> frozenset:
    """Dirichlets rooted at the partition plate: sliced per batch; all
    others are global (natural-gradient targets under SVI)."""
    return frozenset(n for n, d in program.dirichlets.items()
                     if d.group_rows is not None)


def _padded(a: np.ndarray, cap: int, fill=0):
    """Pad ``a``'s leading axis to ``cap`` with ``fill`` — shared by the
    resident slicer below and the out-of-core slicer of a later slice
    (whose bitwise-equality contract depends on this exact convention)."""
    out = np.full((cap,) + a.shape[1:], fill, a.dtype)
    out[:len(a)] = a
    return out


def _slice_mask(cap: int, n: int, always_mask: bool):
    """(cap,) float32 validity mask with ``n`` ones, or None for an
    exactly-full axis when no padding policy is active — shared with the
    out-of-core slicer like :func:`_padded`."""
    if cap == n and not always_mask:
        return None
    out = np.zeros(cap, np.float32)
    out[:n] = 1.0
    return out


def check_resident(program: VMPProgram, what: str) -> None:
    """Raise unless ``program`` holds its token arrays: a sharded template
    (``data.store.sharded_template``) keeps them on disk, and a resident
    path reading its ``None`` arrays must fail loudly."""
    if program.meta.get("sharded"):
        raise ValueError(
            f"{what} needs a resident program, and {program.name} is a "
            f"sharded template whose tokens live on disk: slice its batches "
            f"with data.store.slice_sharded (SVI(corpus=))")


def slice_arrays(program: VMPProgram, groups, caps_fn=None):
    """Build one minibatch's device-ready index arrays.

    ``groups`` — partition-plate group ids in the batch (document ids).
    ``caps_fn(name, n) -> cap`` — optional padding policy per sliced axis
    (identity when None: exact shapes, masks omitted).

    Returns ``(arrays, dir_rows, caps, n_tokens)``:
      - ``arrays`` — the ``_step_body`` array dict for the sliced program,
      - ``dir_rows`` — per local Dirichlet: global row index of each sliced
        row (padding rows carry the sentinel ``g`` so scatters drop them)
        plus a row mask,
      - ``caps`` — the realized capacity of every sliced axis (the static
        shape signature a step is built at),
      - ``n_tokens`` — unpadded observed-instance count in the batch.
    """
    check_resident(program, "slice_arrays")
    if program.meta.get("pstar") is None:
        raise ValueError(f"model {program.name} has no '?' partition plate; "
                         f"minibatch slicing needs one")
    n_groups = program.meta["pstar_size"]
    groups = np.asarray(groups, np.int64)
    member = np.zeros(n_groups, bool)
    member[groups] = True
    cap_of = caps_fn if caps_fn is not None else (lambda name, n: n)
    # under a padding policy, emit masks even for exactly-full axes so every
    # batch (and every shard of a stacked batch) has one pytree structure
    always_mask = caps_fn is not None

    def _mask(cap, n):
        return _slice_mask(cap, n, always_mask)

    arrays: dict[str, dict] = {}
    dir_rows: dict[str, dict] = {}
    caps: dict[str, int] = {}
    rowmap: dict[str, np.ndarray] = {}

    for name, d in program.dirichlets.items():
        if d.group_rows is None:
            continue
        sel = np.flatnonzero(member[d.group_rows])
        g_b = len(sel)
        cap = max(int(cap_of(name, g_b)), 1)
        rm = np.full(d.g, -1, np.int64)
        rm[sel] = np.arange(g_b)
        rowmap[name] = rm
        rows = np.full(cap, d.g, np.int32)        # sentinel: out-of-range
        rows[:g_b] = sel
        mask = np.zeros(cap, np.float32)
        mask[:g_b] = 1.0
        dir_rows[name] = {"rows": rows, "mask": mask}
        caps[name] = cap

    n_tokens = 0
    for spec in program.latents:
        if spec.group is None:
            raise ValueError(f"latent {spec.name} is not under the partition "
                             f"plate; minibatch slicing unsupported")
        selz = np.flatnonzero(member[spec.group])
        nz = len(selz)
        capz = max(int(cap_of(spec.name, nz)), 1)
        caps[spec.name] = capz
        zloc = np.full(spec.n, -1, np.int64)
        zloc[selz] = np.arange(nz)
        pr = spec.prior_rows[selz]
        if spec.prior_dir in rowmap:
            pr = rowmap[spec.prior_dir][pr]
        arrays[spec.name] = {"prior_rows": _padded(pr.astype(np.int32), capz),
                             "mask": _mask(capz, nz)}
        for f in spec.children:
            if f.zmap is None:             # token plate == latent plate
                selt, capt = selz, capz
            else:
                selt = np.flatnonzero(member[spec.group[f.zmap]])
                capt = max(int(cap_of(f.x_name, len(selt))), 1)
            nt = len(selt)
            n_tokens += nt
            caps[f.x_name] = capt
            tmask = _mask(capt, nt)
            zm = None
            if f.zmap is not None:
                zm = _padded(zloc[f.zmap[selt]].astype(np.int32), capt)
            base = None
            if f.base is not None:
                b = f.base[selt].astype(np.int64)
                if f.dir_name in rowmap:
                    b = rowmap[f.dir_name][b]
                base = _padded(b.astype(np.int32), capt)
            arrays[f.x_name] = {
                "values": _padded(f.values[selt].astype(np.int32), capt),
                "zmap": zm, "base": base, "mask": tmask}

    for s in program.statics:
        if s.group is None:
            raise ValueError(f"static factor {s.x_name} is not under the "
                             f"partition plate; minibatch slicing unsupported")
        sel = np.flatnonzero(member[s.group])
        ns = len(sel)
        n_tokens += ns
        cap = max(int(cap_of(s.x_name, ns)), 1)
        caps[s.x_name] = cap
        rows = s.rows[sel].astype(np.int64)
        if s.dir_name in rowmap:
            rows = rowmap[s.dir_name][rows]
        arrays[s.x_name] = {"rows": _padded(rows.astype(np.int32), cap),
                            "values": _padded(s.values[sel].astype(np.int32), cap),
                            "mask": _mask(cap, ns)}

    return arrays, dir_rows, caps, n_tokens


def sliced_shadow(program: VMPProgram, caps: dict[str, int]) -> VMPProgram:
    """The program with every sliced axis resized to its cap — the static
    metadata a minibatch step is built against.  Depends only on the cap
    signature, so one shadow serves every batch padded to the same caps."""
    dc = dataclasses
    new_dirs = {name: (dc.replace(d, g=caps[name], group_rows=None)
                       if d.group_rows is not None else d)
                for name, d in program.dirichlets.items()}
    new_lats = []
    for spec in program.latents:
        capz = caps[spec.name]
        children = [dc.replace(f, n_z=capz) for f in spec.children]
        new_lats.append(dc.replace(spec, n=capz,
                                   prior_rows=np.zeros(capz, np.int32),
                                   children=children, group=None))
    meta = dict(program.meta)
    meta["slice_of"] = program.name
    # the full-batch path's owner plans (``vmp.program_plans``) hold the
    # program's own token streams and must not leak into the shadow through
    # the shallow meta copy: a batch brings its own (``svi.host_batch``)
    meta.pop("_zstats_plan", None)
    return dc.replace(program, dirichlets=new_dirs, latents=new_lats,
                      meta=meta)
