"""Periodic-boundary math on tensors.

Port of `groan_rs_tpu/ops/pbc.py:43-107` (itself the reference's
`src/structures/vector3d.rs:380-592`): the closed `floor` forms with the
exact-boundary fixes that reproduce the reference's loop semantics
(`x == k*L`, k >= 1, wraps to L; `dx == L/2 + k*L` keeps +L/2).  Every
orthorhombic function broadcasts: points `[3]`, `[N, 3]` or `[B, N, 3]`;
`box` the `(3,)` lengths or a broadcastable per-frame form such as
`[B, 1, 3]`.

The exact triclinic forms (`groan_rs_tpu/ops/pbc.py:130-230`) take
row-major box matrices (rows are the box vectors, GROMACS's
lower-triangular convention): one `(3, 3)` box, or `[B, 3, 3]` per frame
for the `*_frames` forms.  A displacement is reduced into the primary
cell by rounding its fractional coordinates, then the shortest of its 27
neighbouring images is kept.  The images are visited in `_SHIFTS` order
with a running minimum of |d|^2 under a strict `<`, so the first of equal
images wins, as `argmin` picks it, and no tensor carries a 27 axis (the
JAX forms build `[..., 27, 3]`).

The inverse box is `torch.linalg.inv_ex` (an LU factorisation, as
`jnp.linalg.inv`; no error check, so no host synchronisation on CUDA);
the volume is the determinant written out by the rule of Sarrus
(`box_volume`), elementwise, with no solver call.  The fractional
products are `einsum`s in full float32: `backend` turns TF32 off.
"""

from __future__ import annotations

import torch

from .. import backend as _backend  # noqa: F401  (TF32 off before any product)

__all__ = ["wrap", "min_image", "vector_to", "displacement", "distance",
           "distance_naive", "box_inverse",
           "box_volume", "min_image_triclinic", "distance_triclinic",
           "wrap_triclinic", "min_image_triclinic_frames",
           "min_image_frames_any", "min_image_norm2_frames",
           "min_image_norm2_pairs", "norm2",
           "distance_triclinic_frames", "wrap_triclinic_frames"]


def _box(box, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(box, dtype=like.dtype, device=like.device)


def wrap(points, box):
    """Wrap coordinates into the box (`Vector3D::wrap`, vector3d.rs:380)."""
    points = torch.as_tensor(points)
    box = _box(box, points)
    m = points - box * torch.floor(points / box)
    # loop semantics: x == k*L (k >= 1) stays at L, never 0
    return torch.where((m == 0.0) & (points > 0.0), box, m)


def min_image(dx, box):
    """Per-axis minimum image (`Vector3D::min_image`, vector3d.rs:575)."""
    dx = torch.as_tensor(dx)
    box = _box(box, dx)
    half = box * 0.5
    m = dx - box * torch.floor(dx / box + 0.5)
    # loop semantics: dx in {L/2 + k*L, k >= 0} maps to +L/2, not -L/2
    return torch.where((m == -half) & (dx > -half), half, m)


def vector_to(a, b, box):
    """Shortest vector from `a` to `b` (`Vector3D::vector_to`,
    vector3d.rs:561): `floor_mod(b - a + L/2, L) - L/2`."""
    a = torch.as_tensor(a)
    box = _box(box, a)
    half = box * 0.5
    d = torch.as_tensor(b) - a + half
    return d - box * torch.floor(d / box) - half


def displacement(a, b, box):
    """Minimum-image displacement `a - b` per axis (oriented)."""
    a = torch.as_tensor(a)
    return min_image(a - torch.as_tensor(b), box)


def _masked_norm(d, dim_mask):
    """One active axis: the oriented component; two or three: the
    Euclidean norm over them; none: zeros."""
    n_active = sum(bool(v) for v in dim_mask)
    if n_active == 0:
        return torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)
    mask = torch.tensor([bool(v) for v in dim_mask], device=d.device)
    d = torch.where(mask, d, torch.zeros((), dtype=d.dtype, device=d.device))
    if n_active == 1:
        return d.sum(-1)
    return torch.sqrt((d * d).sum(-1))


def distance(a, b, box, dim_mask=(True, True, True)):
    """PBC distance masked by dimensions (`Vector3D::distance`,
    vector3d.rs:458): one active axis gives the ORIENTED per-axis minimum
    image of `a - b`, two or three the Euclidean norm over them."""
    return _masked_norm(displacement(a, b, box), dim_mask)


def distance_naive(a, b, dim_mask=(True, True, True)):
    """Distance ignoring PBC (`Vector3D::distance_naive`, vector3d.rs:500),
    masked by dimensions as `distance`."""
    a = torch.as_tensor(a)
    return _masked_norm(a - torch.as_tensor(b, dtype=a.dtype, device=a.device),
                        dim_mask)


# ------------------------------------------------------- exact triclinic PBC

# relative image shifts (27 neighbours, self included), in the JAX order
_SHIFTS = torch.tensor([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                        for k in (-1, 0, 1)], dtype=torch.float32)


def box_inverse(boxes):
    """Inverse of `(3, 3)` or `[B, 3, 3]` box matrices (LU, no error check:
    a singular box gives inf or NaN instead of a host synchronisation;
    within rtol 1e-6 of `jnp.linalg.inv`, tests/test_torch_triclinic.py)."""
    return torch.linalg.inv_ex(boxes)[0]


def box_volume(boxes):
    """|det| of `(3, 3)` or `[B, 3, 3]` box matrices, by the rule of
    Sarrus.  For a lower-triangular box every term but the first is an
    exact zero, so the volume is (v1x * v2y) * v3z, as the LU determinant
    of `jnp.linalg.det` gives it."""
    a, b, c = boxes[..., 0, :], boxes[..., 1, :], boxes[..., 2, :]
    det = (a[..., 0] * b[..., 1] * c[..., 2] + a[..., 1] * b[..., 2] * c[..., 0]
           + a[..., 2] * b[..., 0] * c[..., 1] - a[..., 2] * b[..., 1] * c[..., 0]
           - a[..., 0] * b[..., 2] * c[..., 1] - a[..., 1] * b[..., 0] * c[..., 2])
    return torch.abs(det)


def norm2(v):
    """|v|^2 over the last axis, summed in the order x, y, z."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def _frac_reduce(d, h, hinv):
    """`[B, N, 3]` displacements minus the lattice vector of their rounded
    fractional coordinates (`torch.round`: half to even, as `jnp.round`)."""
    s = torch.einsum("bni,bij->bnj", d, hinv)
    return d - torch.einsum("bni,bij->bnj", torch.round(s), h)


def _shift_vectors(h):
    """The 27 image shifts of `[B, 3, 3]` boxes as vectors -> `[B, 27, 3]`.
    The shifts are made on `h`'s device (`_SHIFTS`' order), not copied
    from the host: a copy from pageable memory would synchronise."""
    k = torch.arange(27, device=h.device)
    shifts = torch.stack([k // 9, k // 3 % 3, k % 3], -1).to(h.dtype) - 1
    return torch.einsum("ki,bij->bkj", shifts, h)


def _nearest_image(d, h, hinv):
    """The shortest of the 27 images of each reduced `[B, N, 3]`
    displacement (the first of equals, as `argmin` picks it)."""
    d0 = _frac_reduce(d, h, hinv)
    shifts = _shift_vectors(h)
    best = best_v = None
    for k in range(shifts.shape[1]):
        c = d0 + shifts[:, None, k]
        n2 = norm2(c)
        if best is None:
            best, best_v = n2, c
            continue
        take = n2 < best
        best = torch.where(take, n2, best)
        best_v = torch.where(take[..., None], c, best_v)
    return best_v


def _frames_boxes(boxes, like):
    h = torch.as_tensor(boxes, dtype=like.dtype, device=like.device)
    return h, box_inverse(h)


def min_image_triclinic_frames(d, boxes):
    """Exact triclinic minimum image with one box matrix per frame: d
    `[B, N, 3]` or `[B, 3]`, boxes `[B, 3, 3]`."""
    d = torch.as_tensor(d)
    single = d.dim() == 2
    h, hinv = _frames_boxes(boxes, d)
    out = _nearest_image(d[:, None, :] if single else d, h, hinv)
    return out[:, 0, :] if single else out


def min_image_norm2_frames(d, boxes, hinv=None):
    """|minimum image|^2 of `[B, N, 3]` displacements with `[B, 3, 3]`
    boxes -> `[B, N]`, the pair paths' form; `hinv` the boxes' inverse
    when the caller has it.  No image vector is kept, so the reduced
    displacement is split into x, y and z planes and each image's |d|^2
    is built in place, (x^2 + y^2) + z^2 as `norm2` sums it; the running
    minimum is `torch.minimum`, which for values is the strict-< pick."""
    h = torch.as_tensor(boxes, dtype=d.dtype, device=d.device)
    d0 = _frac_reduce(d, h, box_inverse(h) if hinv is None else hinv)
    shifts = _shift_vectors(h)[..., None]                      # [B, 27, 3, 1]
    x, y, z = (d0[..., i].contiguous() for i in range(3))
    best = torch.full_like(x, torch.inf)
    n2, c = torch.empty_like(x), torch.empty_like(x)
    for k in range(shifts.shape[1]):
        t = shifts[:, k]
        torch.add(x, t[:, 0], out=c)
        torch.mul(c, c, out=n2)
        torch.add(y, t[:, 1], out=c)
        n2.add_(c.mul_(c))
        torch.add(z, t[:, 2], out=c)
        n2.add_(c.mul_(c))
        torch.minimum(best, n2, out=best)
    return best


def min_image_norm2_pairs(a, b, boxes, flip: bool = False):
    """|minimum image of a_i - b_j|^2 `[B, N, M]` for `a` `[B, N, 3]` and
    `b` `[B, M, 3]` (b_j - a_i with `flip`); boxes `[B, 3]` lengths or
    `[B, 3, 3]` matrices.  With lengths the displacement is built axis by
    axis in place, `d - L floor(d / L + 1/2)` as `min_image` rounds it
    (its half-box sign fix leaves d^2 as it is), squares summed x, y, z:
    the bits of `norm2(min_image(a_i - b_j))` with one `[B, N, M]` plane
    per temporary instead of `[B, N, M, 3]`."""
    bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
    if flip:
        a, b = b[:, None, :, :], a[:, :, None, :]
    else:
        a, b = a[:, :, None, :], b[:, None, :, :]
    if boxes.dim() == 3:
        return min_image_norm2_frames((a - b).reshape(bsz, n * m, 3),
                                      boxes).reshape(bsz, n, m)
    d = torch.empty((bsz, n, m), dtype=torch.float32, device=boxes.device)
    q = torch.empty_like(d)
    d2 = None
    for ax in range(3):
        box = boxes[:, ax, None, None]
        torch.sub(a[..., ax], b[..., ax], out=d)
        torch.div(d, box, out=q)
        d.sub_(q.add_(0.5).floor_().mul_(box))
        if d2 is None:
            d2 = d * d
        else:
            d2.add_(torch.mul(d, d, out=q))
    return d2


def min_image_frames_any(d, boxes):
    """Per-frame minimum image dispatching on the box form: d `[F, ..., 3]`;
    boxes `[F, 3]` lengths (the per-axis form) or `[F, 3, 3]` matrices
    (the exact 27-image search).  `ndim` decides: a shape test could not
    tell three frames of lengths from one matrix."""
    d = torch.as_tensor(d)
    boxes = torch.as_tensor(boxes, dtype=d.dtype, device=d.device)
    if boxes.dim() == 2:
        return min_image(d, boxes.reshape((d.shape[0],) + (1,) * (d.dim() - 2)
                                          + (3,)))
    flat = d.reshape(d.shape[0], -1, 3)
    return min_image_triclinic_frames(flat, boxes).reshape(d.shape)


def distance_triclinic_frames(a, b, boxes):
    """Exact triclinic minimum-image distance, per-frame boxes `[B, 3, 3]`."""
    d = min_image_triclinic_frames(torch.as_tensor(a) - torch.as_tensor(b),
                                   boxes)
    return torch.sqrt(norm2(d))


def wrap_triclinic_frames(points, boxes):
    """Wrap `[B, N, 3]` points into their frames' cells: fractional
    coordinates in [0, 1)."""
    p = torch.as_tensor(points)
    h, hinv = _frames_boxes(boxes, p)
    s = torch.einsum("bni,bij->bnj", p, hinv)
    return torch.einsum("bni,bij->bnj", s - torch.floor(s), h)


def min_image_triclinic(d, box_matrix):
    """Exact triclinic minimum image of `[..., 3]` displacements in one
    `(3, 3)` box."""
    d = torch.as_tensor(d)
    h = _box(box_matrix, d)
    return min_image_triclinic_frames(d.reshape(1, -1, 3), h[None]).reshape(
        d.shape)


def distance_triclinic(a, b, box_matrix):
    """Exact triclinic minimum-image distance between points."""
    d = min_image_triclinic(torch.as_tensor(a) - torch.as_tensor(b), box_matrix)
    return torch.sqrt(norm2(d))


def wrap_triclinic(points, box_matrix):
    """Put `[..., 3]` points inside one `(3, 3)` box's primary cell."""
    p = torch.as_tensor(points)
    h = _box(box_matrix, p)
    return wrap_triclinic_frames(p.reshape(1, -1, 3), h[None]).reshape(p.shape)
