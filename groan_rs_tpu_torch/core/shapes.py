"""Geometric shapes: membership tests for selections and per-frame counts.

Port of `groan_rs_tpu/core/shapes.py:28-235` (the reference's `Shape`
trait, `src/structures/shape.rs`): `Sphere`, `Rectangular`, `Cylinder`
and `TriangularPrism` with their attributes and getters.

`inside(points, box)` and `inside_naive(points)` take `[..., 3]` points
(a tensor on any device, or numpy) and return a bool tensor on the
points' device, in the JAX functions' float32 arithmetic: PBC distances
by `ops.pbc.distance` (a square root, compared with the radius), oriented
axis distances folded to [0, L), the reference's asymmetries (Sphere
strict `<`, Rectangular and Cylinder inclusive `<=`, TriangularPrism's
height strict).  `TriangularPrism` has no `inside_naive`, as in the JAX
package.  The batched per-frame count of `TrajectoryAnalysis`
(`ops.geometry.inside_shape`, JAX `ops/geometry.py`) compares squared
distances instead and refuses the prism.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import ShapeError
from ..ops import pbc
from .dimension import Dimension

__all__ = ["Shape", "Sphere", "Rectangular", "Cylinder", "TriangularPrism"]

AXIS = {Dimension.X: 0, Dimension.Y: 1, Dimension.Z: 2}
_PLANE = {Dimension.X: Dimension.YZ, Dimension.Y: Dimension.XZ,
          Dimension.Z: Dimension.XY}


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=like.device)


def _points(points) -> torch.Tensor:
    return torch.as_tensor(points, dtype=torch.float32)


def _box(box, p: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(box, dtype=torch.float32, device=p.device)


def _axis_distance(p, position, axis: int, box):
    """1-D oriented PBC distance point -> shape, folded to [0, L)."""
    L = _box(box, p)[axis]
    d = pbc.min_image(p[..., axis] - _f32(position[axis], p), L)
    return torch.where(d < 0.0, d + L, d)


def _plane_distance(p, position, plane: Dimension, box):
    return pbc.distance(p, _f32(position, p), _box(box, p), plane.value)


class Shape:
    def get_position(self) -> np.ndarray:
        return self.position.copy()

    def inside(self, points, box) -> torch.Tensor:
        raise NotImplementedError

    def inside_naive(self, points) -> torch.Tensor:
        raise NotImplementedError


class Sphere(Shape):
    """reference: shape.rs:14,114"""

    def __init__(self, position, radius: float):
        self.position = np.asarray(position, np.float32)
        self.radius = float(radius)

    def get_radius(self) -> float:
        return self.radius

    def inside(self, points, box) -> torch.Tensor:
        p = _points(points)
        return _plane_distance(p, self.position, Dimension.XYZ, box) < _f32(self.radius, p)

    def inside_naive(self, points) -> torch.Tensor:
        p = _points(points)
        return pbc.distance_naive(p, _f32(self.position, p)) < _f32(self.radius, p)


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

    def inside(self, points, box) -> torch.Tensor:
        p = _points(points)
        return ((_axis_distance(p, self.position, 0, box) <= _f32(self.x, p))
                & (_axis_distance(p, self.position, 1, box) <= _f32(self.y, p))
                & (_axis_distance(p, self.position, 2, box) <= _f32(self.z, p)))

    def inside_naive(self, points) -> torch.Tensor:
        p = _points(points)
        d = p - _f32(self.position, p)
        return (d >= 0).all(-1) & (d <= _f32([self.x, self.y, self.z], p)).all(-1)


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

    def inside(self, points, box) -> torch.Tensor:
        p = _points(points)
        d_axis = _axis_distance(p, self.position, AXIS[self.orientation], box)
        d_plane = _plane_distance(p, self.position, self.plane, box)
        return (d_axis <= _f32(self.height, p)) & (d_plane <= _f32(self.radius, p))

    def inside_naive(self, points) -> torch.Tensor:
        p = _points(points)
        axis = AXIS[self.orientation]
        d_axis = p[..., axis] - _f32(self.position[axis], p)
        d_plane = pbc.distance_naive(p, _f32(self.position, p), self.plane.value)
        return ((d_axis >= 0.0) & (d_axis < _f32(self.height, p))
                & (d_plane < _f32(self.radius, p)))


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

    def _sign(self, p, a, b):
        i, j = {Dimension.XY: (0, 1), Dimension.XZ: (0, 2),
                Dimension.YZ: (1, 2)}[self.plane]
        return ((p[..., i] - _f32(b[i], p)) * _f32(a[j] - b[j], p)
                - _f32(a[i] - b[i], p) * (p[..., j] - _f32(b[j], p)))

    def inside(self, points, box) -> torch.Tensor:
        p = _points(points)
        d_base = _axis_distance(p, self.base1, AXIS[self.orientation], box)
        d1 = self._sign(p, self.base1, self.base2)
        d2 = self._sign(p, self.base2, self.base3)
        d3 = self._sign(p, self.base3, self.base1)
        has_neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
        has_pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
        return (d_base < _f32(self.height, p)) & ~(has_neg & has_pos)


# the reference's `NaiveShape` trait (shape.rs:464) is the no-PBC view of a
# shape; here every Shape carries `inside_naive` directly
NaiveShape = Shape
