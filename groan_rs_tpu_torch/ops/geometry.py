"""Bond angles, dihedrals and shape membership, batched over frames.

Port of `groan_rs_tpu/ops/geometry.py:33-130`.  Points are `[B, K, 3]`
float32 tensors, boxes `[B, 3]` lengths, or `[B, 3, 3]` box matrices for
`angles` and `dihedrals` with `triclinic=True`.

- `angles`: degrees in [0, 180] as atan2(|v x w|, v.w), exact near 0 and
  180 where the acos of a clamped dot is not;
- `dihedrals`: signed degrees in (-180, 180], IUPAC sign (looking along
  b-c, a clockwise rotation of the far bond is positive), trans = 180;
- `inside_shape`: `[B, N]` bool with the shapes' PBC semantics: Sphere
  strict `<`, Rectangular and Cylinder inclusive `<=`, oriented axis
  distances folded to [0, L).

Every displacement is the per-axis minimum image (`ops.pbc.min_image`),
or the exact triclinic one (`ops.pbc.min_image_triclinic_frames`).
`angles_host_f64` and `dihedrals_host_f64` are their float64 oracles on
the host (JAX `:136-166`; `testing.py` re-exports them).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.shapes import AXIS, Cylinder, Rectangular, Sphere
from ..errors import ShapeError
from ..utils import profiling as prof
from .pbc import min_image, min_image_triclinic_frames

__all__ = ["angles", "dihedrals", "inside_shape", "angles_host_f64",
           "dihedrals_host_f64"]


def _disp(a, b, boxes, triclinic):
    """Minimum-image a - b for `[B, K, 3]` points and `[B, 3]` boxes (or
    `[B, 3, 3]` matrices when `triclinic`)."""
    if triclinic:
        return min_image_triclinic_frames(a - b, boxes)
    return min_image(a - b, boxes[:, None, :])


def angles(a, b, c, boxes, *, triclinic: bool = False):
    """Angle a-b-c (b the vertex) per frame and site -> `[B, K]` degrees."""
    va = _disp(a, b, boxes, triclinic)
    vc = _disp(c, b, boxes, triclinic)
    cross = torch.linalg.cross(va, vc, dim=-1)
    sin = torch.sqrt((cross * cross).sum(-1))
    cos = (va * vc).sum(-1)
    return torch.rad2deg(torch.atan2(sin, cos))


def dihedrals(a, b, c, d, boxes, *, triclinic: bool = False):
    """Dihedral over the chain a-b-c-d per frame and site -> `[B, K]`
    signed degrees: with b1 = b-a, b2 = c-b, b3 = d-c, phi =
    atan2((b1 x b2) x (b2 x b3) . b2/|b2|, (b1 x b2).(b2 x b3))."""
    b1 = _disp(b, a, boxes, triclinic)
    b2 = _disp(c, b, boxes, triclinic)
    b3 = _disp(d, c, boxes, triclinic)
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    b2n = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    y = (torch.linalg.cross(n1, n2, dim=-1) * b2n).sum(-1)
    x = (n1 * n2).sum(-1)
    return torch.rad2deg(torch.atan2(y, x))


def inside_shape(shape, pos, boxes):
    """Membership of `[B, N, 3]` points in a `core.shapes` shape with
    `[B, 3]` orthorhombic boxes -> `[B, N]` bool.  Raises ShapeError for
    a shape without a batched test (TriangularPrism)."""
    if not isinstance(shape, (Sphere, Rectangular, Cylinder)):
        raise ShapeError(
            f"shape {type(shape).__name__} has no device formulation "
            "(Sphere/Rectangular/Cylinder supported)")
    pos = torch.as_tensor(pos, dtype=torch.float32)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=pos.device)

    def f32(x):
        if prof.TRACING:   # a copy from pageable host memory
            prof.count("host_sync", "inside_shape.copy")
        return torch.tensor(np.float32(x), device=pos.device)

    def axis_dist(ax, anchor):
        L = boxes[:, None, ax]
        d = min_image(pos[..., ax] - f32(anchor), L)
        return torch.where(d < 0, d + L, d)

    def plane_dist2(center, dims):
        if prof.TRACING:   # two copies from pageable host memory
            prof.count("host_sync", "inside_shape.copy", 2)
        d = min_image(pos - torch.as_tensor(center, device=pos.device),
                      boxes[:, None, :])
        keep = torch.tensor([ax in dims for ax in range(3)], device=pos.device)
        d = torch.where(keep, d, torch.zeros((), device=pos.device))
        return (d * d).sum(-1)

    if isinstance(shape, Sphere):
        return plane_dist2(shape.position, (0, 1, 2)) < f32(shape.radius) ** 2
    if isinstance(shape, Rectangular):
        return ((axis_dist(0, shape.position[0]) <= f32(shape.x))
                & (axis_dist(1, shape.position[1]) <= f32(shape.y))
                & (axis_dist(2, shape.position[2]) <= f32(shape.z)))
    ax = AXIS[shape.orientation]
    dims = tuple(i for i in range(3) if i != ax)
    return ((axis_dist(ax, shape.position[ax]) <= f32(shape.height))
            & (plane_dist2(shape.position, dims) <= f32(shape.radius) ** 2))


def _min_image_host(d, box):
    """Float64 minimum image of `d` [..., 3] in `box`: lengths, or box
    matrices (the exact triclinic image of `testing.py`)."""
    if np.ndim(box) >= 2 and np.shape(box)[-2:] == (3, 3):
        from ..testing import host_min_image_triclinic

        return host_min_image_triclinic(d, box)
    return d - box * np.round(d / box)


def angles_host_f64(a, b, c, boxes):
    """Float64 angles a-b-c in degrees of `[B, K, 3]` points in `[B, 3]`
    box lengths or `[B, 3, 3]` box matrices: the oracle of `angles`."""
    box = np.asarray(boxes, np.float64)[:, None]
    b = np.asarray(b, np.float64)
    va = _min_image_host(np.asarray(a, np.float64) - b, box)
    vc = _min_image_host(np.asarray(c, np.float64) - b, box)
    cross = np.cross(va, vc)
    return np.degrees(np.arctan2(np.sqrt((cross * cross).sum(-1)),
                                 (va * vc).sum(-1)))


def dihedrals_host_f64(a, b, c, d, boxes):
    """Float64 signed dihedrals a-b-c-d in degrees, IUPAC convention: the
    oracle of `dihedrals` (boxes as `angles_host_f64`'s)."""
    box = np.asarray(boxes, np.float64)[:, None]
    a, b, c, d = (np.asarray(x, np.float64) for x in (a, b, c, d))
    b1 = _min_image_host(b - a, box)
    b2 = _min_image_host(c - b, box)
    b3 = _min_image_host(d - c, box)
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    b2n = b2 / np.linalg.norm(b2, axis=-1, keepdims=True)
    y = (np.cross(n1, n2) * b2n).sum(-1)
    return np.degrees(np.arctan2(y, (n1 * n2).sum(-1)))
