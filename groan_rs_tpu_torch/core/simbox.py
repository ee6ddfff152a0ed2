"""Simulation box.

The port of `groan_rs_tpu.core.simbox.SimBox`: the 9 Gromacs components
(v1x v2y v3z v1y v1z v2x v2z v3x v3y, GRO order), built from a GRO box
line (3 or 9 values) or from lengths and angles (PDB CRYST1); the
orthogonality and validity checks, the `(3,)` length vector the
orthorhombic kernels take, and the row-major `(3, 3)` box matrix of the
triclinic path (`to_matrix` / `from_matrix`, rows are the box vectors).
"""

from __future__ import annotations

import math
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

    @classmethod
    def from_gro_line(cls, values) -> "SimBox":
        """Build from the 3 or 9 floats of a GRO box line."""
        vals = [float(v) for v in values]
        if len(vals) not in (3, 9):
            raise SimBoxError(f"a box requires 3 or 9 components, got {len(vals)}")
        return cls(*vals)

    @classmethod
    def from_lengths_angles(cls, a: float, b: float, c: float, alpha: float,
                            beta: float, gamma: float) -> "SimBox":
        """From lengths (nm) + angles (degrees), Gromacs convention
        (reference: simbox.rs:96)."""
        ar, br, cr = math.radians(alpha), math.radians(beta), math.radians(gamma)
        v2x, v2y = b * math.cos(cr), b * math.sin(cr)
        v3x = c * math.cos(br)
        v3y = c * (math.cos(ar) - math.cos(br) * math.cos(cr)) / math.sin(cr)
        v3z = math.sqrt(max(c * c - v3x * v3x - v3y * v3y, 0.0))

        def snap(v: float) -> float:  # 90-degree noise to exact zero
            return 0.0 if abs(v) < 1e-6 else v

        return cls(snap(a), snap(v2y), snap(v3z), 0.0, 0.0, snap(v2x), 0.0,
                   snap(v3x), snap(v3y))

    @property
    def x(self) -> float:
        return self.v1x

    @property
    def y(self) -> float:
        return self.v2y

    @property
    def z(self) -> float:
        return self.v3z

    def lengths(self) -> np.ndarray:
        """Box-vector lengths |v1|, |v2|, |v3| (reference: simbox.rs:150)."""
        return np.linalg.norm(self.to_matrix(), axis=1).astype(np.float32)

    def angles(self) -> np.ndarray:
        """Angles alpha (v2,v3), beta (v1,v3), gamma (v1,v2) in degrees."""
        v1, v2, v3 = self.to_matrix().astype(np.float64)

        def ang(u, w):
            c = float(np.dot(u, w) / (np.linalg.norm(u) * np.linalg.norm(w)))
            return math.degrees(math.acos(max(-1.0, min(1.0, c))))

        return np.array([ang(v2, v3), ang(v1, v3), ang(v1, v2)], dtype=np.float32)

    def to_lengths_angles(self):
        """(lengths, angles): the inverse of `from_lengths_angles`
        (reference: simbox.rs to_lengths_angles)."""
        return self.lengths(), self.angles()

    def is_zero(self) -> bool:
        return all(v == 0.0 for v in self)

    def __iter__(self):
        """The 9 components in GRO order."""
        return iter((self.v1x, self.v2y, self.v3z, self.v1y, self.v1z,
                     self.v2x, self.v2z, self.v3x, self.v3y))

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

    def to_gro_line(self) -> list:
        """The GRO box line's values: 3 for an orthogonal box, else 9."""
        vals = list(self)
        return vals[:3] if self.is_orthogonal() else vals


def simbox_check(simbox) -> SimBox:
    """Validate a box for orthogonal-PBC math (reference: simbox.rs:230)."""
    if simbox is None:
        raise SimBoxError("system has no simulation box", code="DoesNotExist")
    if not simbox.is_orthogonal():
        raise SimBoxError("simulation box is not orthogonal", code="NotOrthogonal")
    if not simbox.is_valid():
        raise SimBoxError("simulation box is not valid", code="Invalid")
    return simbox
