"""Geometric shapes for per-frame membership counts.

Port of the shape classes of `groan_rs_tpu/core/shapes.py:28-235` (the
reference's `Shape` trait, `src/structures/shape.rs`): `Sphere`,
`Rectangular`, `Cylinder` and `TriangularPrism` with their attributes and
getters, in numpy.  Membership is evaluated batched on tensors by
`ops.geometry.inside_shape`, with the reference's asymmetries (Sphere
strict `<`, Rectangular and Cylinder inclusive `<=`).  `TriangularPrism`
has no batched membership test; it exists so that `add_in_shape` can
refuse it with `ShapeError`, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from ..errors import ShapeError
from .dimension import Dimension

__all__ = ["Shape", "Sphere", "Rectangular", "Cylinder", "TriangularPrism"]

AXIS = {Dimension.X: 0, Dimension.Y: 1, Dimension.Z: 2}
_PLANE = {Dimension.X: Dimension.YZ, Dimension.Y: Dimension.XZ,
          Dimension.Z: Dimension.XY}


class Shape:
    def get_position(self) -> np.ndarray:
        return self.position.copy()


class Sphere(Shape):
    """reference: shape.rs:14,114"""

    def __init__(self, position, radius: float):
        self.position = np.asarray(position, np.float32)
        self.radius = float(radius)

    def get_radius(self) -> float:
        return self.radius


class Rectangular(Shape):
    """reference: shape.rs:25,169 — spans [position, position + (x,y,z)]."""

    def __init__(self, position, x: float, y: float, z: float):
        self.position = np.asarray(position, np.float32)
        self.x, self.y, self.z = float(x), float(y), float(z)

    def get_x(self) -> float:
        return self.x

    def get_y(self) -> float:
        return self.y

    def get_z(self) -> float:
        return self.z


class Cylinder(Shape):
    """reference: shape.rs:40,256 — anchored at `position`, extending
    `height` along `orientation`, radius in the perpendicular plane."""

    def __init__(self, position, radius: float, height: float,
                 orientation: Dimension):
        if orientation not in AXIS:
            raise ShapeError(f"unsupported cylinder orientation '{orientation}'")
        self.position = np.asarray(position, np.float32)
        self.radius = float(radius)
        self.height = float(height)
        self.orientation = orientation
        self.plane = _PLANE[orientation]

    def get_radius(self) -> float:
        return self.radius

    def get_height(self) -> float:
        return self.height

    def get_orientation(self) -> Dimension:
        return self.orientation

    def get_plane(self) -> Dimension:
        return self.plane


class TriangularPrism(Shape):
    """reference: shape.rs:57,435 — base triangle in an axis-aligned plane."""

    def __init__(self, base1, base2, base3, height: float):
        self.base1 = np.asarray(base1, np.float32)
        self.base2 = np.asarray(base2, np.float32)
        self.base3 = np.asarray(base3, np.float32)
        self.height = float(height)
        orientation = None
        for axis, ori in enumerate((Dimension.X, Dimension.Y, Dimension.Z)):
            if self.base1[axis] == self.base2[axis] == self.base3[axis]:
                if orientation is not None:
                    raise ShapeError("prism base cannot be constructed")
                orientation = ori
        if orientation is None:
            raise ShapeError("prism base does not lie in the xy, xz, or yz plane")
        self.orientation = orientation
        self.plane = _PLANE[orientation]

    def get_base1(self) -> np.ndarray:
        return self.base1.copy()

    def get_base2(self) -> np.ndarray:
        return self.base2.copy()

    def get_base3(self) -> np.ndarray:
        return self.base3.copy()

    def get_height(self) -> float:
        return self.height

    def get_orientation(self) -> Dimension:
        return self.orientation
