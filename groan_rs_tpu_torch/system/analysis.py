"""Analysis methods: centres, COM, distances (reference: `src/system/analysis.rs`).

Port of `groan_rs_tpu/system/analysis.py`.  Selections become index
arrays on the host, the rows go to the System's device and the math is
`ops.interactive`: the refined centres are the K1 + K2 kernels on the
card (their plain twins with `device="cpu"`).  A per-frame Python loop
over these methods forfeits batching, so after `GROAN_DISPATCH_WARN_AT`
calls (256 by default, 0 = never) a `PerformanceWarning` points at
`models.TrajectoryAnalysis`, once, as in the JAX package.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from ..core.dimension import Dimension
from ..core.simbox import simbox_check
from ..errors import AtomError, GroupError, PerformanceWarning, PositionError, SimBoxError
from ..ops import interactive

__all__ = ["AnalysisMixin", "TriclinicAnalysisMixin"]

_DISPATCH_WARN_AT = int(os.environ.get("GROAN_DISPATCH_WARN_AT", "256"))
_dispatch_state = {"count": 0, "warned": False}


def _tick_dispatch():
    st = _dispatch_state
    st["count"] += 1
    if (not st["warned"] and _DISPATCH_WARN_AT > 0
            and st["count"] >= _DISPATCH_WARN_AT):
        st["warned"] = True
        warnings.warn(
            f"{st['count']} per-call System analysis dispatches so far — "
            "each moves its atoms to the device and back. For per-frame "
            "trajectory analysis use models.TrajectoryAnalysis (one batched "
            "pass), or the batched ops.* functions directly.",
            PerformanceWarning, stacklevel=3)


def _reset_dispatch_guard(warn_at: int | None = None):
    """Testing hook: reset the counter (and optionally the threshold)."""
    global _DISPATCH_WARN_AT
    _dispatch_state["count"] = 0
    _dispatch_state["warned"] = False
    if warn_at is not None:
        _DISPATCH_WARN_AT = warn_at


class AnalysisMixin:
    # ------------------------------------------------------------- helpers
    def _group_positions(self, name: str) -> np.ndarray:
        idx = self.group_indices(name)
        if not self.has_position[idx].all():
            bad = int(idx[~self.has_position[idx]][0])
            raise GroupError(f"atom {bad} has no position", code="InvalidPosition")
        return self.positions[idx]

    def _group_masses(self, name: str) -> np.ndarray:
        idx = self.group_indices(name)
        if not self.topology.has_mass[idx].all():
            bad = int(idx[~self.topology.has_mass[idx]][0])
            raise GroupError(f"atom {bad} has no mass", code="InvalidMass")
        return self.topology.mass[idx]

    def _check_box(self) -> np.ndarray:
        try:
            return simbox_check(self.simbox).to_lengths_vec()
        except SimBoxError as e:
            raise GroupError(str(e), code="InvalidSimBox") from e

    # ------------------------------------------------------------- centres
    def group_estimate_center(self, name: str) -> np.ndarray:
        """Bai-Breen estimate (reference: analysis.rs:52)."""
        _tick_dispatch()
        box = self._check_box()
        return interactive.estimate_center(self._group_positions(name), box,
                                           device=self.device)

    def group_get_center(self, name: str) -> np.ndarray:
        """Refined centre of geometry (reference: analysis.rs:105)."""
        _tick_dispatch()
        box = self._check_box()
        return interactive.center(self._group_positions(name), box, device=self.device)

    def group_get_center_naive(self, name: str) -> np.ndarray:
        """Plain mean, no PBC (reference: analysis.rs:150)."""
        return interactive.center_naive(self._group_positions(name), device=self.device)

    def group_estimate_com(self, name: str) -> np.ndarray:
        """reference: analysis.rs:203."""
        _tick_dispatch()
        box = self._check_box()
        pos = self._group_positions(name)
        return interactive.estimate_center(pos, box, self._group_masses(name),
                                           device=self.device)

    def group_get_com(self, name: str) -> np.ndarray:
        """Refined centre of mass (reference: analysis.rs:258)."""
        _tick_dispatch()
        box = self._check_box()
        pos = self._group_positions(name)
        return interactive.center(pos, box, self._group_masses(name), device=self.device)

    def group_get_com_naive(self, name: str) -> np.ndarray:
        """reference: analysis.rs:305."""
        pos = self._group_positions(name)
        return interactive.center_naive(pos, self._group_masses(name), device=self.device)

    # ------------------------------------------------------------- distances
    def group_distance(self, group1: str, group2: str, dim: Dimension) -> float:
        """Distance between group centres (reference: analysis.rs:348)."""
        _tick_dispatch()
        box = self._check_box()
        c1 = self.group_get_center(group1)
        c2 = self.group_get_center(group2)
        return float(interactive.distance(c1, c2, box, dim.value, device=self.device))

    def group_all_distances(self, group1: str, group2: str, dim: Dimension) -> np.ndarray:
        """N x M pair distance matrix (reference: analysis.rs:401)."""
        _tick_dispatch()
        box = self._check_box()
        return interactive.distance_matrix(self._group_positions(group1),
                                           self._group_positions(group2), box,
                                           dim.value, device=self.device)

    def atoms_distance(self, index1: int, index2: int, dim: Dimension) -> float:
        """Distance between two atoms (reference: analysis.rs:459)."""
        _tick_dispatch()
        n = self.get_n_atoms()
        if not (0 <= index1 < n) or not (0 <= index2 < n):
            raise AtomError(f"atom index out of range ({index1}, {index2})",
                            code="OutOfRange")
        box = simbox_check(self.simbox).to_lengths_vec()
        for i in (index1, index2):
            if not self.has_position[i]:
                raise PositionError(f"atom {i} has no position")
        return float(interactive.distance(self.positions[index1],
                                          self.positions[index2], box, dim.value,
                                          device=self.device))


class TriclinicAnalysisMixin:
    """Exact triclinic analysis (the reference reads triclinic boxes but
    its PBC math is orthogonal-only, src/lib.rs:353-355): plain torch on
    the System's device, no kernel."""

    def _box_matrix(self) -> np.ndarray:
        sb = self.get_box()
        if sb is None:
            raise SimBoxError("system has no simulation box", code="DoesNotExist")
        return np.asarray(sb.to_matrix(), np.float32)

    def group_get_center_triclinic(self, name: str) -> np.ndarray:
        """Refined Bai-Breen centre of geometry under the exact triclinic
        minimum image (fractional-space trig)."""
        _tick_dispatch()
        return interactive.center_triclinic(self._group_positions(name),
                                            self._box_matrix(), device=self.device)

    def group_get_com_triclinic(self, name: str) -> np.ndarray:
        _tick_dispatch()
        return interactive.center_triclinic(self._group_positions(name),
                                            self._box_matrix(),
                                            self._group_masses(name), device=self.device)

    def group_distance_triclinic(self, name1: str, name2: str) -> float:
        """Exact triclinic minimum-image distance between group centres."""
        _tick_dispatch()
        c1 = self.group_get_center_triclinic(name1)
        c2 = self.group_get_center_triclinic(name2)
        return float(interactive.distance_triclinic(c1, c2, self._box_matrix(),
                                                    device=self.device))

    def atoms_distance_triclinic(self, i: int, j: int) -> float:
        """Exact triclinic minimum-image distance between two atoms."""
        _tick_dispatch()
        n = self.get_n_atoms()
        for k in (i, j):
            if not (0 <= k < n):
                raise AtomError(f"atom {k} out of range", code="OutOfRange")
        return float(interactive.distance_triclinic(
            self.positions[i], self.positions[j], self._box_matrix(), device=self.device))
