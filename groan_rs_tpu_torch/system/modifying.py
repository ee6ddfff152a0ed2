"""Modification methods: translate, wrap, renumber, bonds, make-whole
(reference: `src/system/modifying.rs`).

Port of `groan_rs_tpu/system/modifying.py`.  Position edits run on the
System's device over the selected rows and are written back into the
host `positions` array in place.  Make-whole follows the reference's
algorithm (modifying.rs:368-390): every atom is placed relative to its
molecule's reference atom by one `vector_to`, so `make_molecules_whole`
is one gather and one vectorised minimum image over all atoms, with no
loop over molecules.  Images come from `vector_to`'s
`floor(d / L + 1/2)` form, as in the JAX package, ties included.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.simbox import simbox_check
from ..errors import AtomError, GroupError, PositionError, SimBoxError
from ..ops import interactive, pbc

__all__ = ["ModifyingMixin"]


def _box_or(system, error):
    try:
        return simbox_check(system.simbox).to_lengths_vec()
    except SimBoxError as e:
        raise error(str(e), code="InvalidSimBox") from e


def _require_positions(system, idx, error=PositionError, **kw):
    """Raise `error` for the first atom of `idx` (an index array) without
    a position."""
    missing = ~system.has_position[idx]
    if missing.any():
        raise error(f"atom {int(idx[np.argmax(missing)])} has no position", **kw)


class ModifyingMixin:
    # ------------------------------------------------------------- translation
    def group_translate(self, name: str, vector):
        """Translate group atoms and wrap into the box (reference: modifying.rs:45)."""
        self._translate_indices(self.group_indices(name), vector, group_errors=True)

    def atoms_translate(self, vector):
        """Translate all atoms and wrap (reference: modifying.rs:73)."""
        self._translate_indices(np.arange(self.get_n_atoms()), vector, group_errors=False)

    def _translate_indices(self, idx, vector, group_errors: bool):
        box = _box_or(self, GroupError if group_errors else AtomError)
        _require_positions(self, idx)
        dev = self.device
        moved = interactive.put(self.positions[idx], dev) + interactive.put(vector, dev)
        self.positions[idx] = interactive.fetch(pbc.wrap(moved, interactive.put(box, dev)))

    def atoms_translate_nopbc(self, vector):
        self.positions[self.has_position] += np.asarray(vector, np.float32)

    # ------------------------------------------------------------- renumbering
    def atoms_renumber(self):
        """atomnum = index + 1 (reference: modifying.rs:114)."""
        self.topology.atomnum = np.arange(1, self.get_n_atoms() + 1, dtype=np.int64)

    def residues_renumber(self):
        """Sequential residue renumbering (reference: modifying.rs:176):
        increments whenever the residue number differs from the previous
        atom's (bug-compatible, including resnum 0 on the first atom)."""
        resnum = self.topology.resnum
        if resnum.shape[0] == 0:
            return
        changes = np.empty(resnum.shape[0], dtype=np.int64)
        changes[0] = 1 if resnum[0] != 0 else 0
        changes[1:] = resnum[1:] != resnum[:-1]
        self.topology.resnum = np.cumsum(changes)

    # ------------------------------------------------------------- wrapping
    def atoms_wrap(self):
        """Wrap all atoms into the box (reference: modifying.rs:201)."""
        self._wrap_indices(np.arange(self.get_n_atoms()), group_errors=False)

    def group_wrap(self, name: str):
        """reference: modifying.rs:215."""
        self._wrap_indices(self.group_indices(name), group_errors=True)

    def _wrap_indices(self, idx, group_errors: bool):
        box = _box_or(self, GroupError if group_errors else AtomError)
        _require_positions(self, idx)
        dev = self.device
        self.positions[idx] = interactive.fetch(pbc.wrap(
            interactive.put(self.positions[idx], dev), interactive.put(box, dev)))

    # ------------------------------------------------------------- bonds
    def add_bond(self, index1: int, index2: int):
        """reference: modifying.rs:235."""
        self.topology.add_bond(index1, index2)

    def clear_bonds(self):
        """reference: modifying.rs:480."""
        self.topology.clear_bonds()

    def has_bonds(self) -> bool:
        return self.topology.has_bonds()

    # ------------------------------------------------------------- make whole
    def make_molecules_whole(self):
        """Fix molecules broken across PBC (reference: modifying.rs:338):
        wrap each molecule's reference atom, then place every atom at
        `ref + vector_to(ref, atom)`."""
        box = _box_or(self, AtomError)
        _require_positions(self, np.arange(self.get_n_atoms()))
        dev = self.device
        mol = torch.from_numpy(self.topology.molecule_ids()).to(dev)
        refs = torch.from_numpy(self.topology.mol_references()).to(dev)
        pos = interactive.put(self.positions, dev)
        box_t = interactive.put(box, dev)
        ref_per_atom = pbc.wrap(pos[refs], box_t)[mol]
        self.positions[:] = interactive.fetch(
            ref_per_atom + pbc.vector_to(ref_per_atom, pos, box_t))

    def make_group_whole(self, group: str):
        """Make a group compact around its estimated centre
        (reference: modifying.rs:447)."""
        center = self.group_estimate_center(group)  # raises for missing group/box
        box = simbox_check(self.simbox).to_lengths_vec()
        idx = self.group_indices(group)
        _require_positions(self, idx, GroupError, code="InvalidPosition")
        dev = self.device
        c = interactive.put(center, dev)
        self.positions[idx] = interactive.fetch(c + pbc.vector_to(
            c, interactive.put(self.positions[idx], dev), interactive.put(box, dev)))
