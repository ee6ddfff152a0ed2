"""Simulation box.

The slice of `groan_rs_tpu.core.simbox.SimBox` the port needs: the 9
Gromacs components (v1x v2y v3z v1y v1z v2x v2z v3x v3y, GRO order), the
orthogonality and validity checks, the `(3,)` length vector the
orthorhombic kernels take, and the row-major `(3, 3)` box matrix of the
triclinic path (`to_matrix` / `from_matrix`, rows are the box vectors).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import SimBoxError


@dataclass
class SimBox:
    v1x: float = 0.0
    v2y: float = 0.0
    v3z: float = 0.0
    v1y: float = 0.0
    v1z: float = 0.0
    v2x: float = 0.0
    v2z: float = 0.0
    v3x: float = 0.0
    v3y: float = 0.0

    @classmethod
    def from_lengths(cls, x: float, y: float, z: float) -> "SimBox":
        return cls(float(x), float(y), float(z))

    def is_orthogonal(self) -> bool:
        return all(v == 0.0 for v in (self.v1y, self.v1z, self.v2x, self.v2z,
                                      self.v3x, self.v3y))

    def is_valid(self) -> bool:
        return self.v1x > 0.0 and self.v2y > 0.0 and self.v3z > 0.0

    def to_matrix(self) -> np.ndarray:
        """Row-major `(3, 3)` float32 matrix; rows are the box vectors."""
        return np.array([[self.v1x, self.v1y, self.v1z],
                         [self.v2x, self.v2y, self.v2z],
                         [self.v3x, self.v3y, self.v3z]], dtype=np.float32)

    @classmethod
    def from_matrix(cls, m) -> "SimBox":
        m = np.asarray(m, dtype=np.float64)
        return cls(float(m[0, 0]), float(m[1, 1]), float(m[2, 2]),
                   float(m[0, 1]), float(m[0, 2]),
                   float(m[1, 0]), float(m[1, 2]),
                   float(m[2, 0]), float(m[2, 1]))

    def to_lengths_vec(self) -> np.ndarray:
        """`(3,)` float32 orthogonal box lengths."""
        return np.array([self.v1x, self.v2y, self.v3z], dtype=np.float32)


def simbox_check(simbox) -> SimBox:
    """Validate a box for orthogonal-PBC math (reference: simbox.rs:230)."""
    if simbox is None:
        raise SimBoxError("system has no simulation box", code="DoesNotExist")
    if not simbox.is_orthogonal():
        raise SimBoxError("simulation box is not orthogonal", code="NotOrthogonal")
    if not simbox.is_valid():
        raise SimBoxError("simulation box is not valid", code="Invalid")
    return simbox
