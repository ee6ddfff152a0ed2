"""Vector3D: the reference's 3-vector type as a numpy array subclass.

Port of `groan_rs_tpu/core/vector3d.py` (reference:
`src/structures/vector3d.rs`): `.x/.y/.z` fields, `len`, `to_unit`,
`invert`, `angle`, `shift`, `rotate`, `wrap`, `distance`,
`distance_naive`, `vector_to`, `filter`, `is_zero`, `average`.

The class IS a `(3,)` float32 `numpy.ndarray`, so it can be passed
anywhere a position is expected.  It is host code: the PBC methods run the
port's `ops.pbc` on CPU tensors (the float32 arithmetic of the JAX
package's `ops.pbc`), and the angle and shift the float32 formulas of
`ops/vecmath.py` in numpy.  Mutating methods (`shift`, `wrap`, `filter`)
modify in place and return self, as the reference's `&mut self` methods.
"""

from __future__ import annotations

import numpy as np
import torch


def _dmask(dim):
    from .dimension import Dimension

    return dim.value if isinstance(dim, Dimension) else tuple(dim)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _norm(v) -> np.float32:
    v = np.asarray(v, np.float32)
    return np.sqrt((v * v).sum(dtype=np.float32))


class Vector3D(np.ndarray):
    def __new__(cls, x: float = 0.0, y: float = 0.0, z: float = 0.0):
        return np.asarray([x, y, z], dtype=np.float32).view(cls)

    @classmethod
    def from_array(cls, arr) -> "Vector3D":
        """View/convert any length-3 array as a Vector3D."""
        return np.asarray(arr, dtype=np.float32).reshape(3).view(cls)

    # ------------------------------------------------------------ fields
    @property
    def x(self) -> float:
        return float(self[0])

    @x.setter
    def x(self, v):
        self[0] = v

    @property
    def y(self) -> float:
        return float(self[1])

    @y.setter
    def y(self, v):
        self[1] = v

    @property
    def z(self) -> float:
        return float(self[2])

    @z.setter
    def z(self, v):
        self[2] = v

    # ---------------------------------------------------------- queries
    def len(self) -> float:
        """Vector magnitude (reference: vector3d.rs:214)."""
        return float(np.sqrt(np.float32(self @ self)))

    def is_zero(self) -> bool:
        """reference: vector3d.rs:626."""
        return bool((np.asarray(self) == 0.0).all())

    def angle(self, other) -> float:
        """Angle to `other` in radians, acos(a.b / (|a||b|)) (reference:
        vector3d.rs:276); collinear rounding past |cos| = 1 gives NaN, as
        in the reference."""
        a, b = np.asarray(self, np.float32), np.asarray(other, np.float32)
        with np.errstate(invalid="ignore"):
            return float(np.arccos((a * b).sum(dtype=np.float32)
                                   / (_norm(a) * _norm(b))))

    def dot(self, other) -> float:
        return float(np.float32(np.asarray(self) @ np.asarray(other)))

    def cross(self, other) -> "Vector3D":
        return Vector3D.from_array(np.cross(np.asarray(self),
                                            np.asarray(other)))

    # ------------------------------------------------------- derivations
    def to_unit(self) -> "Vector3D":
        """Unit vector; a null vector returns itself
        (reference: vector3d.rs:236)."""
        n = self.len()
        if n == 0.0:
            return Vector3D.from_array(self.copy())
        return Vector3D.from_array(np.asarray(self) / np.float32(n))

    def invert(self) -> "Vector3D":
        """Reversed direction (reference: vector3d.rs:254)."""
        return Vector3D.from_array(-np.asarray(self))

    def rotate(self, rotation_matrix) -> "Vector3D":
        """Rotate by a 3x3 matrix, no PBC (reference: vector3d.rs:359)."""
        return Vector3D.from_array(
            np.asarray(rotation_matrix, np.float32) @ np.asarray(self))

    # ---------------------------------------------------------- mutators
    def shift(self, orientation, distance: float) -> "Vector3D":
        """Shift along `orientation` (need not be unit) by `distance`,
        no PBC (reference: vector3d.rs:305)."""
        o = np.asarray(orientation, np.float32)
        self[:] = np.asarray(self) + (o / _norm(o)) * np.float32(distance)
        return self

    def wrap(self, sbox) -> "Vector3D":
        """Wrap into the (orthogonal) box (reference: vector3d.rs:380)."""
        from ..ops import pbc

        self[:] = pbc.wrap(_t(self), _t(sbox.to_lengths_vec())).numpy()
        return self

    def filter(self, dim) -> "Vector3D":
        """Zero the components outside `dim` (reference: vector3d.rs:610)."""
        m = _dmask(dim)
        for i in range(3):
            if not m[i]:
                self[i] = 0.0
        return self

    # --------------------------------------------------------- distances
    def distance(self, point, dim, sbox) -> float:
        """Minimum-image distance in `dim` (reference: vector3d.rs:458)."""
        from ..ops import pbc

        return float(pbc.distance(_t(self), _t(point), _t(sbox.to_lengths_vec()),
                                  _dmask(dim)))

    def distance_naive(self, point, dim) -> float:
        """No-PBC distance; 1D flavours keep their sign
        (reference: vector3d.rs:522)."""
        from ..ops import pbc

        return float(pbc.distance_naive(_t(self), _t(point), _dmask(dim)))

    def vector_to(self, point, sbox) -> "Vector3D":
        """Shortest PBC vector from self to `point`
        (reference: vector3d.rs:561)."""
        from ..ops import pbc

        return Vector3D.from_array(
            pbc.vector_to(_t(self), _t(point), _t(sbox.to_lengths_vec())).numpy())

    # ------------------------------------------------------------ static
    @staticmethod
    def average(vectors) -> "Vector3D":
        """Component mean of a collection; empty input yields the NaN
        vector like the reference's 0/0 (reference: vector3d.rs:662)."""
        vs = [np.asarray(v, np.float32) for v in vectors]
        if not vs:
            return Vector3D(np.nan, np.nan, np.nan)
        arr = np.asarray(vs, dtype=np.float32)
        return Vector3D.from_array(arr.sum(axis=0) / np.float32(len(arr)))
