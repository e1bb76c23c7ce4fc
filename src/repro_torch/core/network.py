"""Bayesian-network intermediate representation.

Mirrors the paper's internal representation (section 4.1, Figure 14): a tree
whose non-leaf nodes are *plates* (rooted at the predefined TOPLEVEL plate of
size 1) and whose leaves are random variables.  Conditional dependencies are
stored on the RV nodes.

Plate sizes may be unknown at model-definition time (the paper's ``?``
plates); they are resolved at observe time by the compiler.  A nested plate's
*flattened size* is the total number of leaf instances (sum over repetitions),
exactly as in the paper.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from ..analysis.diagnostics import raise_error, raise_unsupported

UNKNOWN = "?"


@dataclasses.dataclass
class Plate:
    """A (possibly nested, possibly unknown-size) plate."""
    name: str
    size: Union[int, str]           # int or UNKNOWN ("?")
    parent: Optional["Plate"]       # None only for TOPLEVEL
    # resolved at compile time:
    flat_size: Optional[int] = None

    def chain(self) -> list["Plate"]:
        """Plates from root (exclusive of TOPLEVEL) to self, outermost first."""
        out, p = [], self
        while p is not None and p.parent is not None:
            out.append(p)
            p = p.parent
        return out[::-1]

    def is_ancestor_of(self, other: "Plate") -> bool:
        p = other
        while p is not None:
            if p is self:
                return True
            p = p.parent
        return False

    def path(self) -> str:
        """Human-readable plate path, outermost first (``docs/sents/tokens``)
        — names *where* an RV lives in diagnostics."""
        return "/".join(p.name for p in self.chain()) or "TOPLEVEL"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Plate({self.name}, size={self.size}, flat={self.flat_size})"


@dataclasses.dataclass
class DirichletRV:
    """A plate of Dirichlet-distributed probability vectors.

    ``conc`` is the (symmetric scalar or length-``dim`` vector) prior
    concentration; Beta(a) is represented as dim=2.
    """
    name: str
    plate: Plate
    dim: int
    conc: object                    # float | list[float] (a paper "DExpr")

    def __repr__(self) -> str:  # pragma: no cover
        return f"Dirichlet({self.name}, plate={self.plate.name}, dim={self.dim})"


@dataclasses.dataclass
class CategoricalRV:
    """A plate of Categorical draws.

    ``parent`` is the Dirichlet supplying the probability vector.  Each plate
    in the parent's chain must be resolvable either statically (it is an
    ancestor of this RV's plate — e.g. theta's ``docs`` plate for LDA's z) or
    through ``selector`` — a latent CategoricalRV whose value indexes that
    plate (e.g. z indexing phi's topic plate).  This is exactly the
    mixture-of-Categoricals class the paper supports.
    """
    name: str
    plate: Plate
    parent: DirichletRV
    selector: Optional["CategoricalRV"] = None   # latent mixture index
    observed: bool = False

    @property
    def dim(self) -> int:
        return self.parent.dim

    def __repr__(self) -> str:  # pragma: no cover
        kind = "obs" if self.observed else "lat"
        return f"Categorical({self.name}[{kind}], plate={self.plate.name})"


RV = Union[DirichletRV, CategoricalRV]


class BayesianNetwork:
    """The model template produced by the DSL (paper section 3.2).

    Holds the plate tree and RV list; validation of the supported class
    happens here so errors surface at definition time, not at inference time.
    """

    def __init__(self, name: str):
        self.name = name
        self.toplevel = Plate("TOPLEVEL", 1, None)
        self.plates: list[Plate] = [self.toplevel]
        self.rvs: dict[str, RV] = {}

    def add_plate(self, name: str, size, parent: Optional[Plate]) -> Plate:
        p = Plate(name, size, parent or self.toplevel)
        self.plates.append(p)
        return p

    def add_rv(self, rv: RV) -> RV:
        if rv.name in self.rvs:
            raise_error("duplicate-rv", rv.name,
                        f"duplicate random variable {rv.name!r}",
                        hint="every RV needs a unique name")
        self.rvs[rv.name] = rv
        return rv

    # -- validation -------------------------------------------------------
    def validate(self) -> None:
        for rv in self.rvs.values():
            if isinstance(rv, CategoricalRV):
                self._validate_categorical(rv)

    def _validate_categorical(self, rv: CategoricalRV) -> None:
        sel_used = False
        for plate in rv.parent.plate.chain():
            if plate.is_ancestor_of(rv.plate):
                continue                      # statically resolvable
            if rv.selector is not None and not sel_used:
                # the latent selector resolves exactly one plate of the parent
                sel_used = True
                if plate.size != UNKNOWN and rv.selector.dim != plate.size:
                    raise_error(
                        "selector-dim-mismatch", f"{rv.name}->{rv.parent.name}",
                        f"{rv.name}: selector {rv.selector.name} has dim "
                        f"{rv.selector.dim} but parent plate {plate.name} has "
                        f"size {plate.size}",
                        hint=f"give {rv.selector.name} dim {plate.size} or "
                             f"resize plate {plate.name}")
                if not rv.selector.plate.is_ancestor_of(rv.plate) \
                        and rv.selector.plate is not rv.plate:
                    raise_error(
                        "selector-plate", f"{rv.name}->{rv.selector.name}",
                        f"{rv.name} (plate {rv.plate.path()}): selector "
                        f"{rv.selector.name} (plate {rv.selector.plate.path()})"
                        f" must live on the same plate or an ancestor plate",
                        hint="move the selector onto the child's plate chain")
                continue
            raise_error(
                "unsupported-edge", f"{rv.name}->{rv.parent.name}",
                f"{rv.name} (plate {rv.plate.path()}): cannot resolve parent "
                f"plate {plate.name}; the supported class is mixtures of "
                f"Categoricals with Dirichlet priors (paper section 8)",
                hint="the plate must be an ancestor of the child or indexed "
                     "by its (single) latent selector")
        if rv.selector is not None:
            if rv.selector.observed:
                raise_error(
                    "selector-observed", f"{rv.name}->{rv.selector.name}",
                    f"{rv.name}: selector must be latent",
                    hint=f"unobserve {rv.selector.name} or use a static "
                         f"row index instead of a selector")
            if rv.selector.selector is not None:
                raise_unsupported(
                    "chained-selector", f"{rv.name}->{rv.selector.name}",
                    f"{rv.name} (plate {rv.plate.path()}): selector "
                    f"{rv.selector.name} itself has selector "
                    f"{rv.selector.selector.name} — chained latent selectors "
                    f"are outside the supported class",
                    hint="collapse the chain into one selector per child")

    def latent_categoricals(self) -> list[CategoricalRV]:
        return [r for r in self.rvs.values()
                if isinstance(r, CategoricalRV) and not r.observed]

    def dirichlets(self) -> list[DirichletRV]:
        return [r for r in self.rvs.values() if isinstance(r, DirichletRV)]

    def loc(self) -> int:
        """Model-definition line count (the paper's 7-LOC claim); counted by
        the DSL builder."""
        return getattr(self, "_loc", 0)
