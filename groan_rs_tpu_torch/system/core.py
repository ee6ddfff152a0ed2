"""The molecular System.

The port of `groan_rs_tpu.system.System` for what a user needs to build a
system from files and analyse it: topology, box, the current frame's
positions and velocities (with presence masks), precision, index groups (`system/groups.py`: GSL queries, algebra, NDX files) and
labeled atoms, element, property and bond guessing (`system/guess.py`),
hydrogen bonds (`system/hbonds.py`), the current frame's box, step and
time (set per frame by `TrajReader.__iter__`), `from_file` for GRO, PDB
and PQR files and their writers.
`group_get_com` runs the port's own refined centre on the CPU (the K1 +
K2 twins), as RMSD's reference preparation needs
(`groan_rs_tpu/system/rmsd.py:18-47`).  TPR files and group-by-geometry
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.container import AtomContainer
from ..core.simbox import SimBox, simbox_check
from ..core.topology import Topology
from ..errors import FileTypeError, GroupError, SimBoxError
from ..files import FileType
from .groups import Group, GroupsMixin
from .guess import GuessMixin
from .hbonds import HBondsMixin

__all__ = ["System"]


def _vectors(arr, present, n):
    """(`[N, 3]` float32 array, bool `[N]` presence) of an optional
    per-atom vector (JAX `system/core.py:150-158`)."""
    if arr is None:
        return np.zeros((n, 3), np.float32), np.zeros(n, bool)
    arr = np.ascontiguousarray(np.asarray(arr, np.float32).reshape(n, 3))
    present = (np.ones(n, bool) if present is None
               else np.asarray(present, bool).reshape(n))
    return arr, present


class System(GroupsMixin, GuessMixin, HBondsMixin):
    def __init__(self, name: str, topology: Topology, simbox: SimBox | None = None,
                 positions: np.ndarray | None = None,
                 velocities: np.ndarray | None = None,
                 has_velocity: np.ndarray | None = None):
        n = topology.n_atoms
        self.name = name
        self.topology = topology
        self.simbox = simbox
        self.positions, self.has_position = _vectors(positions, None, n)
        self.velocities, self.has_velocity = _vectors(velocities, has_velocity, n)
        self.precision = 100
        self.step = 0
        self.time = 0.0
        self.labeled_atoms: dict[str, int] = {}
        # reserved groups 'all' / 'All' (reference: system/mod.rs:156)
        self.groups: dict[str, Group] = {
            g: Group(AtomContainer.from_ranges([(0, n - 1)]), print_ndx=False)
            for g in ("all", "All")}

    # ------------------------------------------------------------ files
    @classmethod
    def from_file(cls, filename) -> "System":
        """Construct from a GRO, PDB or PQR file (reference:
        system/mod.rs:197)."""
        return cls.from_file_with_format(filename, FileType.from_name(filename))

    @classmethod
    def from_file_with_format(cls, filename, filetype: FileType) -> "System":
        """reference: system/mod.rs:226."""
        if filetype is FileType.GRO:
            from ..io.gro import read_gro

            return read_gro(filename)
        if filetype is FileType.PDB:
            from ..io.pdb import read_pdb

            return read_pdb(filename)
        if filetype is FileType.PQR:
            from ..io.pqr import read_pqr

            return read_pqr(filename)
        if filetype is FileType.TPR:
            raise FileTypeError(
                f"cannot construct a System from '{filename}': reading TPR "
                "files is not ported to groan_rs_tpu_torch yet (see ROADMAP.md)")
        raise FileTypeError(
            f"cannot construct a System from '{filename}' "
            f"(file type '{filetype.value}')"
        )

    def write_gro(self, filename, write_velocities: bool = False):
        from ..io.gro import write_gro

        write_gro(self, filename, "all", write_velocities)

    def group_write_gro(self, group: str, filename, write_velocities: bool = False):
        from ..io.gro import write_gro

        write_gro(self, filename, group, write_velocities)

    def write_pdb(self, filename, write_conect: bool = False):
        from ..io.pdb import write_pdb

        write_pdb(self, filename, "all", write_conect)

    def group_write_pdb(self, group: str, filename, write_conect: bool = False):
        from ..io.pdb import write_pdb

        write_pdb(self, filename, group, write_conect)

    def write_pqr(self, filename, precision=None):
        from ..io.pqr import write_pqr

        write_pqr(self, filename, precision, "all")

    def group_write_pqr(self, group: str, filename, precision=None):
        from ..io.pqr import write_pqr

        write_pqr(self, filename, precision, group)

    def add_bonds_from_pdb(self, filename):
        from ..io.pdb import add_bonds_from_pdb

        add_bonds_from_pdb(self, filename)

    def read_ndx(self, filename):
        """reference: ndx_io.rs:39."""
        from ..io.ndx import read_ndx

        read_ndx(self, filename)

    def read_ndx_with_default(self, filename, default: str):
        """Read ndx if it exists, else fall back to `default`
        (reference: utility.rs:26)."""
        if filename is not None and os.path.isfile(str(filename)):
            self.read_ndx(filename)
        elif default is not None and os.path.isfile(str(default)):
            self.read_ndx(default)

    def write_ndx(self, filename):
        from ..io.ndx import write_ndx

        write_ndx(self, filename)

    # ------------------------------------------------------------ state
    def get_name(self) -> str:
        return self.name

    def get_n_atoms(self) -> int:
        return self.topology.n_atoms

    def get_box(self) -> SimBox | None:
        return self.simbox

    def set_box(self, simbox: SimBox | None) -> None:
        self.simbox = simbox

    def get_step(self) -> int:
        return self.step

    def set_step(self, v: int) -> None:
        self.step = int(v)

    def get_time(self) -> float:
        return self.time

    def set_time(self, v: float) -> None:
        self.time = float(v)

    def box_lengths(self) -> np.ndarray:
        """`(3,)` float32 orthogonal box lengths (raises SimBoxError for a
        missing, triclinic or invalid box)."""
        return simbox_check(self.simbox).to_lengths_vec()

    def set_precision(self, v: int) -> None:
        self.precision = int(v)

    def has_velocities(self) -> bool:
        return bool(self.has_velocity.all()) and self.get_n_atoms() > 0

    def group_get_com(self, name: str) -> np.ndarray:
        """Refined centre of mass of a group, float32 `(3,)`
        (reference: analysis.rs:258)."""
        from ..ops.center import center

        try:
            box = simbox_check(self.simbox).to_lengths_vec()
        except SimBoxError as e:
            raise GroupError(str(e), code="InvalidSimBox") from e
        idx = self.group_indices(name)
        if not self.topology.has_mass[idx].all():
            bad = int(idx[~self.topology.has_mass[idx]][0])
            raise GroupError(f"atom {bad} has no mass", code="InvalidMass")
        com = center(torch.from_numpy(self.positions[idx]),
                     torch.from_numpy(box),
                     weights=torch.from_numpy(self.topology.mass[idx]))
        return com.numpy()
