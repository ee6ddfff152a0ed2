"""Iteration methods (reference: `src/system/iterating.rs`).

Port of `groan_rs_tpu/system/iterating.py`: Python iterators over `Atom`
views, for code written against the reference; hot code uses the index
arrays (`group_indices`, `group_mask`) and the batched ops.  An
`AtomIterator` holds an index array: its shape filters run the shapes'
`inside` on the System's device, its centres are the K1 + K2 kernels
there (`ops.interactive`), and `Atom` views exist only while iterating.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from ..core.atom import Atom
from ..errors import AtomError, GroupError, SelectError
from ..ops import interactive

__all__ = ["AtomIterator", "IteratingMixin", "PairIteratingMixin", "union_iter",
           "intersection_iter"]


def _inside(system, geometry, idx, box=None) -> np.ndarray:
    """Atoms `idx` with a position that lie inside `geometry` (PBC-aware
    in `box`, or without PBC when `box` is None) -> bool numpy over
    `idx`, computed on the System's device."""
    dev = system.device
    pts = interactive.put(system.positions[idx], dev)
    if box is None:
        ok = geometry.inside_naive(pts)
    else:
        ok = geometry.inside(pts, interactive.put(box, dev))
    return system.has_position[idx] & interactive.fetch(ok)


class AtomIterator:
    """Chainable, vectorized atom iterator — the reference's
    `AtomIterable` / `AtomIteratorWithBox` trait surface
    (structures/iterators.rs:842,1053) as one class.

    Holds the parent System and a resolved index array: adaptors
    (`filter_geometry`, `union`, `intersection`) stay vectorized over
    the index set, aggregators (`get_center`, `get_com`, ...) run the
    same device ops the System methods use, and `Atom` views
    materialize only at iteration.  Like the reference's by-value
    adaptors, chaining methods operate on the iterator's FULL atom set
    regardless of any partially-advanced cursor."""

    __slots__ = ("_system", "_idx", "_pos")

    def __init__(self, system, indices):
        self._system = system
        self._idx = np.asarray(indices, dtype=np.int64).ravel()
        self._pos = 0

    # ------------------------------------------------------ iteration
    def __iter__(self) -> "AtomIterator":
        return self

    def __next__(self) -> Atom:
        if self._pos >= self._idx.shape[0]:
            raise StopIteration
        a = Atom(self._system, int(self._idx[self._pos]))
        self._pos += 1
        return a

    @property
    def indices(self) -> np.ndarray:
        """The (remaining-agnostic) full index set, System order."""
        return self._idx.copy()

    def get_simbox(self):
        """reference: iterators.rs HasBox::get_simbox:838."""
        return self._system.simbox

    # ------------------------------------------------------ internals
    def _positions(self) -> np.ndarray:
        s, idx = self._system, self._idx
        if not s.has_position[idx].all():
            bad = int(idx[~s.has_position[idx]][0])
            raise AtomError(f"atom {bad} has no position",
                            code="InvalidPosition")
        return s.positions[idx]

    def _masses(self) -> np.ndarray:
        topo, idx = self._system.topology, self._idx
        if not topo.has_mass[idx].all():
            bad = int(idx[~topo.has_mass[idx]][0])
            raise AtomError(f"atom {bad} has no mass", code="InvalidMass")
        return topo.mass[idx]

    def _box(self) -> np.ndarray:
        from ..core.simbox import simbox_check
        from ..errors import SimBoxError

        try:
            return simbox_check(self._system.simbox).to_lengths_vec()
        except SimBoxError as e:
            raise AtomError(str(e), code="InvalidSimBox") from e

    # ------------------------------------------------------ adaptors
    def filter_geometry(self, geometry) -> "AtomIterator":
        """Atoms (with positions) inside `geometry`, PBC-aware
        (reference: iterators.rs:1094)."""
        return AtomIterator(self._system, self._idx[
            _inside(self._system, geometry, self._idx, self._box())])

    def filter_geometry_naive(self, geometry) -> "AtomIterator":
        """No-PBC variant (reference: iterators.rs:994)."""
        return AtomIterator(self._system, self._idx[
            _inside(self._system, geometry, self._idx)])

    def union(self, other: "AtomIterator") -> "AtomIterator":
        """Atoms in either iterator, System order, each once
        (reference: UnionAtomIterator, iterators.rs:660)."""
        return AtomIterator(self._system,
                            np.union1d(self._idx, other._idx))

    def intersection(self, other: "AtomIterator") -> "AtomIterator":
        """Atoms in both iterators, System order
        (reference: IntersectionAtomIterator, iterators.rs:758)."""
        return AtomIterator(self._system,
                            np.intersect1d(self._idx, other._idx))

    # ------------------------------------------------------ aggregators
    def get_center(self) -> np.ndarray:
        """Refined Bai-Breen center of geometry
        (reference: iterators.rs:1237)."""
        return interactive.center(self._positions(), self._box(),
                                  device=self._system.device)

    def get_com(self) -> np.ndarray:
        """Refined center of mass (reference: iterators.rs get_com)."""
        return interactive.center(self._positions(), self._box(), self._masses(),
                                  device=self._system.device)

    def estimate_center(self) -> np.ndarray:
        """Bai-Breen estimate only (reference: iterators.rs:1152)."""
        return interactive.estimate_center(self._positions(), self._box(),
                                           device=self._system.device)

    def estimate_com(self) -> np.ndarray:
        """reference: iterators.rs:1314."""
        return interactive.estimate_center(self._positions(), self._box(),
                                           self._masses(), device=self._system.device)

    def get_center_naive(self) -> np.ndarray:
        """Plain mean, no PBC (reference: iterators.rs:886)."""
        return interactive.center_naive(self._positions(), device=self._system.device)

    def get_com_naive(self) -> np.ndarray:
        """reference: iterators.rs:946."""
        return interactive.center_naive(self._positions(), self._masses(),
                                        device=self._system.device)

    # ------------------------------------------------------ mutators
    def translate(self, vector) -> "AtomIterator":
        """Translate these atoms and wrap into the box
        (reference: MutableAtomIterable::translate, iterators.rs:1006)."""
        self._system._translate_indices(self._idx, vector,
                                        group_errors=False)
        return self

    def wrap(self) -> "AtomIterator":
        """Wrap these atoms into the box
        (reference: iterator wrap, iterators.rs)."""
        self._system._wrap_indices(self._idx, group_errors=False)
        return self


class IteratingMixin:
    def _adjacency(self):
        """Sorted neighbours of an atom as a list, from the bond CSR."""
        offsets, flat = self.topology.bonds_csr()
        return lambda a: flat[offsets[a]:offsets[a + 1]].tolist()

    def group_iter(self, name: str) -> AtomIterator:
        """Iterate atoms of a group (reference: iterating.rs:43).

        Returns a chainable `AtomIterator`:
        `system.group_iter("Protein").filter_geometry(s).get_center()`."""
        return AtomIterator(self, self.group_indices(name))

    group_iter_mut = group_iter

    def selection_iter(self, query: str) -> AtomIterator:
        """Parse a query and iterate matching atoms (reference: iterating.rs:352)."""
        from ..select import evaluate_mask, parse_query

        try:
            mask = evaluate_mask(parse_query(query), self)
        except SelectError as e:
            raise GroupError(f"invalid query '{query}': {e}", code="InvalidQuery") from e
        return AtomIterator(self, np.nonzero(mask)[0])

    selection_iter_mut = selection_iter

    def bonded_atoms_iter(self, index: int):
        """Iterate atoms bonded to `index` (reference: iterating.rs:170)."""
        if not (0 <= index < self.get_n_atoms()):
            raise AtomError(f"atom index {index} out of range", code="OutOfRange")
        offsets, flat = self.topology.bonds_csr()
        for j in flat[offsets[index]:offsets[index + 1]]:
            yield Atom(self, int(j))

    bonded_atoms_iter_mut = bonded_atoms_iter

    def molecule_iter(self, index: int):
        """Iterate all atoms of the molecule containing `index`, in BFS
        order from `index` (reference: iterating.rs:238, BFS via
        get_molecule_indices at iterating.rs:399)."""
        for i in self.get_molecule_indices(index):
            yield Atom(self, int(i))

    molecule_iter_mut = molecule_iter

    def get_molecule_indices(self, index: int) -> list[int]:
        """BFS order over the bond graph starting at `index`
        (reference: iterating.rs:399)."""
        if not (0 <= index < self.get_n_atoms()):
            raise AtomError(f"atom index {index} out of range", code="OutOfRange")
        bonded = self._adjacency()
        seen = {index}
        order = [index]
        queue = deque([index])
        while queue:
            a = queue.popleft()
            for b in bonded(a):
                if b not in seen:
                    seen.add(b)
                    order.append(b)
                    queue.append(b)
        return order

    def molecule_bonds_iter(self, index: int):
        """Iterate bonds (i, j) of the molecule containing `index`, BFS
        order, each bond once (reference: iterating.rs:301)."""
        if not (0 <= index < self.get_n_atoms()):
            raise AtomError(f"atom index {index} out of range", code="OutOfRange")
        bonded = self._adjacency()
        visited = {index}
        queue = deque([index])
        while queue:
            a = queue.popleft()
            for b in bonded(a):
                if b not in visited:
                    visited.add(b)
                    queue.append(b)
                    yield (Atom(self, a), Atom(self, int(b)))

    # ------------------------------------------------------------- geometry filtering
    molecule_bonds_iter_mut = molecule_bonds_iter

    def atoms_filter_geometry(self, geometry):
        """Indices of atoms (with positions) inside a shape — the vectorized
        analogue of `filter_geometry` (iterators.rs:1094)."""
        return np.nonzero(_inside(self, geometry, slice(None), self.box_lengths()))[0]

    def group_filter_geometry(self, name: str, geometry):
        idx = self.group_indices(name)
        return idx[_inside(self, geometry, idx, self.box_lengths())]


def union_iter(iter1, iter2):
    """Merge two index-ordered atom iterators, yielding each atom at most
    once in System order (reference: UnionAtomIterator, iterators.rs:660)."""
    a = next(iter1, None)
    b = next(iter2, None)
    while a is not None or b is not None:
        if b is None or (a is not None and a.get_index() < b.get_index()):
            yield a
            a = next(iter1, None)
        elif a is None or b.get_index() < a.get_index():
            yield b
            b = next(iter2, None)
        else:  # same atom in both
            yield a
            a = next(iter1, None)
            b = next(iter2, None)


def intersection_iter(iter1, iter2):
    """Yield atoms present in BOTH index-ordered iterators, in System order
    (reference: IntersectionAtomIterator, iterators.rs:758)."""
    a = next(iter1, None)
    b = next(iter2, None)
    while a is not None and b is not None:
        ia, ib = a.get_index(), b.get_index()
        if ia == ib:
            yield a
            a = next(iter1, None)
            b = next(iter2, None)
        elif ia < ib:
            a = next(iter1, None)
        else:
            b = next(iter2, None)


class PairIteratingMixin:
    def atom_pairs_iter(self, pairs):
        """Iterate (Atom, Atom) for explicit index pairs
        (reference: AtomPairIterator, iterators.rs:1612)."""
        n = self.get_n_atoms()
        for i, j in pairs:
            if not (0 <= i < n) or not (0 <= j < n):
                raise AtomError(f"atom pair ({i}, {j}) out of range", code="OutOfRange")
            yield Atom(self, int(i)), Atom(self, int(j))

    atom_pairs_iter_mut = atom_pairs_iter

    def group_union_iter(self, name1: str, name2: str):
        """Union of two groups' atoms in System order."""
        return union_iter(self.group_iter(name1), self.group_iter(name2))

    def group_intersection_iter(self, name1: str, name2: str):
        """Intersection of two groups' atoms in System order."""
        return intersection_iter(self.group_iter(name1), self.group_iter(name2))
