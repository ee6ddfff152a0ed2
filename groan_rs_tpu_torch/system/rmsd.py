"""Single-structure RMSD methods (reference: `src/system/rmsd.rs:75-141`).

Port of `groan_rs_tpu/system/rmsd.py`, on the System's device: the
group's refined COM (K1 + K2 on the card), the shift-and-wrap of
`extract_data_from_system` (rmsd.rs:425), QCP Kabsch and `fit_transform`
are the ops the trajectory RMSD runs (`ops.rmsd`).  The trajectory form,
`RMSDTrajIterator`, lives in `io/traj.py`.
"""

from __future__ import annotations

import numpy as np

from ..core.simbox import simbox_check
from ..errors import GroupError, RMSDError, SimBoxError
from ..ops import interactive, pbc
from ..ops import rmsd as rmsd_ops

__all__ = ["RMSDMixin"]


def _extract(system, group: str):
    """reference: extract_data_from_system (rmsd.rs:425) -> (the group
    shifted so its COM sits at the box centre and wrapped, the box centre,
    the group's indices, its COM), as numpy."""
    try:
        box = simbox_check(system.get_box()).to_lengths_vec()
    except SimBoxError as e:
        raise RMSDError(str(e), code="InvalidSimBox") from e
    try:
        idx = system.group_indices(group)
        if idx.shape[0] == 0:  # before the COM kernel (it rejects empties)
            raise RMSDError(f"group '{group}' is empty", code="EmptyGroup")
        com = system.group_get_com(group)
    except GroupError as e:
        code = {"NotFound": "NonexistentGroup"}.get(e.code, e.code)
        raise RMSDError(str(e), code=code) from e
    box_center = box * np.float32(0.5)
    dev = system.device
    shifted = pbc.wrap(interactive.put(system.positions[idx] + (box_center - com), dev),
                       interactive.put(box, dev))
    return interactive.fetch(shifted), box_center, idx, com


def _masses(system, group: str, idx) -> np.ndarray:
    if not system.topology.has_mass[idx].all():
        bad = int(idx[~system.topology.has_mass[idx]][0])
        raise RMSDError(f"atom {bad} has no mass", code="InvalidMass")
    return system.topology.mass[idx]


class RMSDMixin:
    def calc_rmsd_rot_trans(self, reference, group: str):
        """Rotation, translation and RMSD vs a reference system
        (reference: rmsd.rs:141)."""
        return self._rmsd_fit(reference, group)[:3]

    def _rmsd_fit(self, reference, group: str):
        """-> (rotation, translation, rmsd, the reference group's COM)."""
        ref_coords, ref_center, ref_idx, ref_com = _extract(reference, group)
        tgt_coords, tgt_center, _, _ = _extract(self, group)
        if ref_coords.shape[0] != tgt_coords.shape[0]:
            raise RMSDError(
                f"group '{group}' has {ref_coords.shape[0]} atoms in reference "
                f"but {tgt_coords.shape[0]} in target", code="InconsistentGroup")
        w = _masses(reference, group, ref_idx)
        dev = self.device
        rot, trans, rms = rmsd_ops.kabsch(
            interactive.put(ref_coords, dev), interactive.put(tgt_coords, dev),
            interactive.put(w, dev), interactive.put(ref_center, dev),
            interactive.put(tgt_center, dev))
        return (interactive.fetch(rot), interactive.fetch(trans), float(rms), ref_com)

    def calc_rmsd(self, reference, group: str) -> float:
        """Mass-weighted Kabsch RMSD (reference: rmsd.rs:75)."""
        return self.calc_rmsd_rot_trans(reference, group)[2]

    def calc_rmsd_and_fit(self, reference, group: str) -> float:
        """RMSD, then fit this system onto the reference (reference:
        rmsd.rs:129)."""
        rot, _, rms, ref_com = self._rmsd_fit(reference, group)
        self._apply_fit(group, rot, ref_com)
        return rms

    def _apply_fit(self, group: str, rotation, ref_group_com):
        """reference: fit_structure (rmsd.rs:508); every atom moves."""
        box = simbox_check(self.get_box()).to_lengths_vec()
        group_com = self.group_get_com(group)
        dev = self.device
        self.positions[:] = interactive.fetch(rmsd_ops.fit_transform(
            interactive.put(self.positions, dev), interactive.put(box, dev),
            interactive.put(group_com, dev), interactive.put(rotation, dev),
            interactive.put(ref_group_com, dev)))
