"""A minimal molecular System for the ported slice.

The part of `groan_rs_tpu.system.System` the trajectory pass reads:
topology (masses), box, reference positions, precision and index groups
(sorted atom indices; 'all' always exists).  `group_get_com` runs the
port's own refined centre on the CPU (the K1 + K2 twins), as RMSD's
reference preparation needs (`groan_rs_tpu/system/rmsd.py:18-47`).
The GSL selection language and the file readers come with later slices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.simbox import SimBox, simbox_check
from ..core.topology import Topology
from ..errors import GroupError, SimBoxError

__all__ = ["System"]


class System:
    def __init__(self, name: str, topology: Topology, simbox: SimBox | None = None,
                 positions: np.ndarray | None = None):
        n = topology.n_atoms
        self.name = name
        self.topology = topology
        self.simbox = simbox
        self.positions = (np.zeros((n, 3), np.float32) if positions is None
                          else np.ascontiguousarray(
                              np.asarray(positions, np.float32).reshape(n, 3)))
        self.precision = 100
        self.groups: dict[str, np.ndarray] = {
            "all": np.arange(n, dtype=np.int64)}

    def get_n_atoms(self) -> int:
        return self.topology.n_atoms

    def get_box(self) -> SimBox | None:
        return self.simbox

    def box_lengths(self) -> np.ndarray:
        """`(3,)` float32 orthogonal box lengths (raises SimBoxError for a
        missing, triclinic or invalid box)."""
        return simbox_check(self.simbox).to_lengths_vec()

    def set_precision(self, v: int) -> None:
        self.precision = int(v)

    def group_create_from_indices(self, name: str, indices) -> None:
        idx = np.unique(np.asarray(indices, np.int64))
        if len(idx) and (idx[0] < 0 or idx[-1] >= self.get_n_atoms()):
            raise GroupError(f"group '{name}' has atoms out of range",
                             code="InvalidIndex")
        self.groups[name] = idx

    def group_create_from_ranges(self, name: str, ranges) -> None:
        """Inclusive (start, end) ranges, clipped to the system
        (reference: groups.rs:249)."""
        n = self.get_n_atoms()
        parts = [np.arange(max(0, int(s)), min(int(e), n - 1) + 1)
                 for s, e in ranges]
        self.group_create_from_indices(
            name, np.concatenate(parts) if parts else np.zeros(0, np.int64))

    def group_indices(self, name: str) -> np.ndarray:
        try:
            return self.groups[name]
        except KeyError:
            raise GroupError(f"group '{name}' does not exist",
                             code="NotFound") from None

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
