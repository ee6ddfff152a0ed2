"""Atom: a lightweight per-index view into a System.

Port of `groan_rs_tpu/core/atom.py`: the reference's `Atom` struct
(`src/structures/atom.rs:23-71`) over the System's per-atom columns, with
the same `get_*`/`set_*`/`with_*` method names.  Mutations write through
to the parent System's columns.  It is host code (what the atom
iterators yield); its PBC helpers run the port's `ops.pbc` on CPU
tensors, the float32 arithmetic of the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import PositionError
from .container import AtomContainer


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


class Atom:
    __slots__ = ("_system", "_index")

    def __init__(self, system, index: int):
        self._system = system
        self._index = int(index)

    # ------------------------------------------------------------- identity
    def get_index(self) -> int:
        return self._index

    @property
    def index(self) -> int:
        return self._index

    # ------------------------------------------------------------- metadata
    def get_residue_number(self) -> int:
        return int(self._system.topology.resnum[self._index])

    def set_residue_number(self, v: int):
        self._system.topology.resnum[self._index] = int(v)

    def get_residue_name(self) -> str:
        return self._system.topology.resname.get(self._index)

    def set_residue_name(self, v: str):
        self._system.topology.resname.set(self._index, v)

    def get_atom_number(self) -> int:
        return int(self._system.topology.atomnum[self._index])

    def set_atom_number(self, v: int):
        self._system.topology.atomnum[self._index] = int(v)

    def get_atom_name(self) -> str:
        return self._system.topology.atomname.get(self._index)

    def set_atom_name(self, v: str):
        self._system.topology.atomname.set(self._index, v)

    def get_chain(self):
        c = self._system.topology.chain.get(self._index)
        return c if c else None

    def set_chain(self, v):
        self._system.topology.chain.set(self._index, v or "")

    # ------------------------------------------------------------- optional floats
    def _get_opt(self, field):
        topo = self._system.topology
        if not getattr(topo, "has_" + field)[self._index]:
            return None
        return float(getattr(topo, field)[self._index])

    def _set_opt(self, field, v):
        topo = self._system.topology
        if v is None:
            getattr(topo, "has_" + field)[self._index] = False
            getattr(topo, field)[self._index] = np.nan
        else:
            getattr(topo, "has_" + field)[self._index] = True
            getattr(topo, field)[self._index] = float(v)

    def get_charge(self):
        return self._get_opt("charge")

    def set_charge(self, v):
        self._set_opt("charge", v)

    def get_mass(self):
        return self._get_opt("mass")

    def set_mass(self, v):
        self._set_opt("mass", v)

    def get_vdw(self):
        return self._get_opt("vdw")

    def set_vdw(self, v):
        self._set_opt("vdw", v)

    def get_expected_min_bonds(self):
        topo = self._system.topology
        return int(topo.expected_min_bonds[self._index]) if topo.has_expected_min_bonds[self._index] else None

    def set_expected_min_bonds(self, v):
        topo = self._system.topology
        topo.has_expected_min_bonds[self._index] = v is not None
        topo.expected_min_bonds[self._index] = 0 if v is None else int(v)

    def get_expected_max_bonds(self):
        topo = self._system.topology
        return int(topo.expected_max_bonds[self._index]) if topo.has_expected_max_bonds[self._index] else None

    def set_expected_max_bonds(self, v):
        topo = self._system.topology
        topo.has_expected_max_bonds[self._index] = v is not None
        topo.expected_max_bonds[self._index] = 0 if v is None else int(v)

    def get_element_name(self):
        v = self._system.topology.element_name.get(self._index)
        return v if v else None

    def set_element_name(self, v):
        self._system.topology.element_name.set(self._index, v or "")

    def get_element_symbol(self):
        v = self._system.topology.element_symbol.get(self._index)
        return v if v else None

    def set_element_symbol(self, v):
        self._system.topology.element_symbol.set(self._index, v or "")

    # ------------------------------------------------------------- vectors
    def get_position(self):
        s = self._system
        if not s.has_position[self._index]:
            return None
        return s.positions[self._index].copy()

    def set_position(self, v):
        s = self._system
        if v is None:
            s.has_position[self._index] = False
        else:
            s.has_position[self._index] = True
            s.positions[self._index] = np.asarray(v, dtype=np.float32)

    def has_position(self) -> bool:
        return bool(self._system.has_position[self._index])

    def _set_position_axis(self, axis: int, v: float):
        s = self._system
        if not s.has_position[self._index]:
            raise PositionError(f"atom {self._index} has no position")
        s.positions[self._index, axis] = np.float32(v)

    def set_position_x(self, v: float):
        """reference: atom.rs set_position_x"""
        self._set_position_axis(0, v)

    def set_position_y(self, v: float):
        self._set_position_axis(1, v)

    def set_position_z(self, v: float):
        self._set_position_axis(2, v)

    def reset_position(self):
        """Remove the position (reference: atom.rs reset_position)."""
        self.set_position(None)

    def get_velocity(self):
        s = self._system
        if not s.has_velocity[self._index]:
            return None
        return s.velocities[self._index].copy()

    def set_velocity(self, v):
        s = self._system
        if v is None:
            s.has_velocity[self._index] = False
        else:
            s.has_velocity[self._index] = True
            s.velocities[self._index] = np.asarray(v, dtype=np.float32)

    def has_velocity(self) -> bool:
        return bool(self._system.has_velocity[self._index])

    def reset_velocity(self):
        self.set_velocity(None)

    def get_force(self):
        s = self._system
        if not s.has_force[self._index]:
            return None
        return s.forces[self._index].copy()

    def set_force(self, v):
        s = self._system
        if v is None:
            s.has_force[self._index] = False
        else:
            s.has_force[self._index] = True
            s.forces[self._index] = np.asarray(v, dtype=np.float32)

    def has_force(self) -> bool:
        return bool(self._system.has_force[self._index])

    def reset_force(self):
        self.set_force(None)

    # ------------------------------------------------------------- resets
    # (reference: atom.rs reset_* — clear an optional field)
    def reset_chain(self):
        self.set_chain(None)

    def reset_charge(self):
        self.set_charge(None)

    def reset_mass(self):
        self.set_mass(None)

    def reset_vdw(self):
        self.set_vdw(None)

    def reset_element_name(self):
        self.set_element_name(None)

    def reset_element_symbol(self):
        self.set_element_symbol(None)

    def reset_expected_min_bonds(self):
        self.set_expected_min_bonds(None)

    def reset_expected_max_bonds(self):
        self.set_expected_max_bonds(None)

    # ------------------------------------------------------------- builders
    # (reference: atom.rs with_* — chainable setters; on this view they
    # mutate the parent System and return the view)
    def with_chain(self, v):
        self.set_chain(v)
        return self

    def with_charge(self, v):
        self.set_charge(v)
        return self

    def with_mass(self, v):
        self.set_mass(v)
        return self

    def with_vdw(self, v):
        self.set_vdw(v)
        return self

    def with_element_name(self, v):
        self.set_element_name(v)
        return self

    def with_element_symbol(self, v):
        self.set_element_symbol(v)
        return self

    def with_expected_min_bonds(self, v):
        self.set_expected_min_bonds(v)
        return self

    def with_expected_max_bonds(self, v):
        self.set_expected_max_bonds(v)
        return self

    def with_position(self, v):
        self.set_position(v)
        return self

    def with_velocity(self, v):
        self.set_velocity(v)
        return self

    def with_force(self, v):
        self.set_force(v)
        return self

    # ------------------------------------------------------------- line writers
    # (reference: atom.rs write_gro:556 / write_pdb:633 / write_pqr:693 —
    # format THIS atom's record; the same byte-golden-tested formatters
    # the vectorized file writers use, applied to a one-atom slice)
    def write_gro(self, stream, write_velocities: bool = False):
        from ..io.gro import format_atom_blob

        stream.write(format_atom_blob(
            self._system, np.array([self._index]), write_velocities).decode())

    def write_pdb(self, stream):
        from ..io.pdb import format_pdb_atom_blob

        stream.write(format_pdb_atom_blob(self._system, np.array([self._index])).decode())

    def write_pqr(self, stream, precision=None):
        from ..io.pqr import PqrPrecision, format_pqr_atom_line

        if precision is None:
            precision = PqrPrecision()
        stream.write(
            format_pqr_atom_line(self._system, self._index, precision) + "\n")

    # ------------------------------------------------------------- bonds
    def reset_bonded(self):
        """Remove every bond of this atom — the SAFE form of the
        reference's `unsafe Atom::reset_bonded` (atom.rs:452): bonds are
        removed symmetrically from the neighbours and the molecule
        references are invalidated, so no follow-up calls are needed."""
        self._system.topology.remove_bonds_of(self._index)

    def _bonded(self) -> np.ndarray:
        offsets, flat = self._system.topology.bonds_csr()
        return flat[offsets[self._index]:offsets[self._index + 1]]

    def get_bonded(self) -> AtomContainer:
        return AtomContainer.from_indices(self._bonded())

    def get_n_bonded(self) -> int:
        return int(self._bonded().shape[0])

    # ------------------------------------------------------------- geometry helpers
    def distance(self, other: "Atom", dim, simbox) -> float:
        """reference: atom.rs:780"""
        from ..ops import pbc
        from .dimension import Dimension

        p1, p2 = self.get_position(), other.get_position()
        if p1 is None:
            raise PositionError(f"atom {self._index} has no position")
        if p2 is None:
            raise PositionError(f"atom {other._index} has no position")
        dmask = dim.value if isinstance(dim, Dimension) else dim
        return float(pbc.distance(_t(p1), _t(p2), _t(simbox.to_lengths_vec()), dmask))

    def distance_from_point(self, point, dim, simbox) -> float:
        from ..ops import pbc
        from .dimension import Dimension

        p1 = self.get_position()
        if p1 is None:
            raise PositionError(f"atom {self._index} has no position")
        dmask = dim.value if isinstance(dim, Dimension) else dim
        return float(pbc.distance(_t(p1), _t(point), _t(simbox.to_lengths_vec()), dmask))

    def wrap(self, simbox):
        """reference: atom.rs:535"""
        from ..ops import pbc

        p = self.get_position()
        if p is None:
            raise PositionError(f"atom {self._index} has no position")
        self.set_position(pbc.wrap(_t(p), _t(simbox.to_lengths_vec())).numpy())

    def translate(self, shift, simbox):
        """Translate with PBC wrap."""
        from ..ops import pbc

        p = self.get_position()
        if p is None:
            raise PositionError(f"atom {self._index} has no position")
        self.set_position(pbc.wrap(_t(p + np.asarray(shift, np.float32)),
                                   _t(simbox.to_lengths_vec())).numpy())

    def translate_nopbc(self, shift):
        p = self.get_position()
        if p is None:
            raise PositionError(f"atom {self._index} has no position")
        self.set_position(p + np.asarray(shift, np.float32))

    def distance_naive(self, other: "Atom", dim) -> float:
        """Oriented distance without PBC (reference: atom.rs distance_naive;
        single-axis results keep the sign of self - other)."""
        from .dimension import Dimension

        p1, p2 = self.get_position(), other.get_position()
        if p1 is None:
            raise PositionError(f"atom {self._index} has no position")
        if p2 is None:
            raise PositionError(f"atom {other._index} has no position")
        dmask = dim.value if isinstance(dim, Dimension) else dim
        d = (p1 - p2) * np.asarray(dmask, np.float32)
        n = int(np.sum(np.asarray(dmask) != 0))
        if n == 0:
            return 0.0
        if n == 1:
            return float(d.sum())
        return float(np.sqrt((d * d).sum()))

    def rotate(self, rotation, simbox):
        """Rotate and wrap into the box (reference: atom.rs rotate)."""
        from ..ops import pbc

        self.rotate_nopbc(rotation)
        self.set_position(pbc.wrap(_t(self.get_position()),
                                   _t(simbox.to_lengths_vec())).numpy())

    def rotate_nopbc(self, rotation):
        """Apply a 3x3 rotation matrix (column-vector convention, as nalgebra)."""
        p = self.get_position()
        if p is None:
            raise PositionError(f"atom {self._index} has no position")
        self.set_position(np.asarray(rotation, np.float32) @ p)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"Atom(index={self._index}, {self.get_residue_number()}{self.get_residue_name()}"
            f" {self.get_atom_name()}{self.get_atom_number()})"
        )
