"""Pair reductions between two selections: minimum distance, contacts,
and the pair-distance histogram of the RDF.

Port of `groan_rs_tpu/ops/distances.py:29-43`, `:104-195` and
`:198-251` (`center_distance`, `pair_distances` and
`distance_matrix_masked` serve the System's per-call methods).
Large unmasked selections route to the tiled pair kernel (K3,
`ops.kernels.pair_reduce`), which never materialises N x M; small or
masked ones take the dense path (`distance_matrix`, the JAX package's own
XLA path as plain torch).  The routing rule and its threshold are the JAX
package's, so both packages take the same branch on the same input.

`residue_min_matrix` (`:57-101`, the `gmx mdmat` and `gmx clustsize`
tile) is plain torch, as the JAX function is jnp: the smallest
minimum-image atom-atom distance between padded residue blocks per frame.
`self_image_min` (`:254`, `gmx mindist -pi`) is plain torch too.

Triclinic boxes (`[B, 3, 3]` matrices) take a plain-torch pair path in
every case: `min_distance_triclinic`, `contact_count_triclinic` and
`pair_distance_histogram` with matrix boxes.  The JAX package builds the
dense `[B, N, M, 27, 3]` candidate tensor there and leaves it to XLA's
fusion; here the rows of the first group go in chunks of at most
`chunk_pairs` pairs (`_pair_distances`), and each chunk's 27 images are
visited with a running minimum of |d|^2 (`ops.pbc.min_image_norm2_frames`),
so the largest tensor of a chunk is `[B, c, M, 3]`: 192 MB at the
default 2^24 pairs, with five such tensors alive at once (~1.2 GB with
the planes of `min_image_norm2_frames`).  At the 1M-atom smoke's
400 x 300,000 pairs and 12 frames that is four rows a chunk; at 2^22 (one
row) ~100k small kernels per observable and batch left an H100 36-48%
idle (PERF.md).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..utils import profiling as prof
from . import kernels
from .center import center
from .pbc import (_masked_norm, box_inverse, box_volume, distance, min_image,
                  min_image_norm2_frames)

__all__ = ["center_distance", "pair_distances", "distance_matrix",
           "distance_matrix_masked", "min_distance", "contact_count",
           "min_distance_triclinic", "contact_count_triclinic",
           "pair_distance_histogram", "rdf_normalization",
           "residue_min_matrix", "self_image_min"]

# pairs per chunk of the pair paths that build distances in torch
_CHUNK_PAIRS = 1 << 24

# elements of one `residue_min_matrix` displacement tile over its frames
_TILE_ELEMS = 1 << 26

# at or above this many pairs (N*M) unmasked calls route to K3; below it the
# dense path (and masks) apply — GROAN_PAIR_TILE_THRESHOLD as in groan_rs_tpu
_PAIR_TILE_THRESHOLD = int(os.environ.get("GROAN_PAIR_TILE_THRESHOLD",
                                          str(1 << 24)))


def _tiled_route(a, b, mask_a, mask_b) -> bool:
    return (mask_a is None and mask_b is None
            and a.shape[-2] * b.shape[-2] >= _PAIR_TILE_THRESHOLD)


def _box_rows(box, like):
    """Normalise a broadcast-shaped box ([..., 1, 3]) to [..., 3]."""
    box = torch.as_tensor(box, dtype=like.dtype, device=like.device)
    if box.dim() >= 2 and box.shape[-2] == 1:
        box = box.reshape(box.shape[:-2] + (3,))
    return box


def center_distance(pos_a, pos_b, box, dim_mask, mask_a=None, mask_b=None,
                    weights_a=None, weights_b=None):
    """Distance between the refined centres (K1 + K2) of two selections,
    then a PBC distance along `dim_mask` (`System::group_distance`,
    analysis.rs:348)."""
    ca = center(pos_a, box, mask=mask_a, weights=weights_a)
    cb = center(pos_b, box, mask=mask_b, weights=weights_b)
    return distance(ca, cb, box, dim_mask)


def pair_distances(a, b, box, dim_mask=(True, True, True)):
    """Elementwise distances between matched points `[..., K, 3]` ->
    `[..., K]`."""
    return distance(a, b, box, dim_mask)


def distance_matrix(a, b, box, dim_mask=(True, True, True)):
    """`[..., N, M]` PBC distance matrix (`group_all_distances`,
    analysis.rs:401); box `[..., 3]`.  One active axis gives oriented
    differences."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    box = torch.as_tensor(box, dtype=a.dtype, device=a.device)
    d = min_image(a[..., :, None, :] - b[..., None, :, :],
                  box[..., None, None, :])
    return _masked_norm(d, dim_mask)


def distance_matrix_masked(a, b, box, mask_a, mask_b, fill=float("nan"),
                           dim_mask=(True, True, True)):
    """Distance matrix with the pairs of invalid rows or columns set to
    `fill` (padded selections)."""
    m = distance_matrix(a, b, box, dim_mask)
    valid = (torch.as_tensor(mask_a, device=m.device)[..., :, None]
             & torch.as_tensor(mask_b, device=m.device)[..., None, :])
    return torch.where(valid, m, torch.full((), fill, dtype=m.dtype, device=m.device))


def contact_count(a, b, box, cutoff, mask_a=None, mask_b=None):
    """Number of pairs within `cutoff` per frame (int64)."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    box = _box_rows(box, a)
    if _tiled_route(a, b, mask_a, mask_b):
        return kernels.pair_reduce(a, b, box, float(cutoff))[1]
    within = distance_matrix(a, b, box) < cutoff
    if mask_a is not None:
        within = within & torch.as_tensor(mask_a, device=a.device)[..., :, None]
    if mask_b is not None:
        within = within & torch.as_tensor(mask_b, device=a.device)[..., None, :]
    return within.sum(dim=(-2, -1))


def min_distance(a, b, box, mask_a=None, mask_b=None):
    """Minimum PBC distance between two selections per frame."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    box = _box_rows(box, a)
    if _tiled_route(a, b, mask_a, mask_b):
        return kernels.pair_reduce(a, b, box, 0.0)[0]
    d = distance_matrix(a, b, box)
    if mask_a is not None or mask_b is not None:
        ma = (torch.ones(d.shape[:-1], dtype=torch.bool, device=a.device)[..., None]
              if mask_a is None
              else torch.as_tensor(mask_a, device=a.device)[..., :, None])
        mb = (torch.ones(d.shape[:-2] + d.shape[-1:], dtype=torch.bool,
                         device=a.device)[..., None, :]
              if mask_b is None
              else torch.as_tensor(mask_b, device=a.device)[..., None, :])
        d = torch.where(ma & mb, d, torch.full((), torch.inf, device=a.device))
    return d.amin(dim=(-2, -1))


def _pair_distances(a, b, box, chunk_pairs: int):
    """Yield `(i0, d)`: the PBC distances `d` `[B, c, M]` between rows
    i0..i0+c of `a` `[B, N, 3]` and all of `b` `[B, M, 3]`, with c chosen
    so that a chunk holds at most `chunk_pairs` pairs.  `box` `[B, 3]`
    lengths (per-axis minimum image) or `[B, 3, 3]` matrices (the exact
    27-image search); `ndim` decides."""
    nb, n, m = a.shape[0], a.shape[1], b.shape[1]
    box = _box_rows(box, a)
    triclinic = box.dim() == 3
    hinv = box_inverse(box) if triclinic else None
    step = max(1, chunk_pairs // max(1, nb * m))
    for i0 in range(0, n, step):
        rows = a[:, i0:i0 + step]
        if not triclinic:
            yield i0, distance_matrix(rows, b, box)
            continue
        d = (rows[:, :, None, :] - b[:, None, :, :]).reshape(nb, -1, 3)
        n2 = min_image_norm2_frames(d, box, hinv)
        yield i0, torch.sqrt(n2).reshape(nb, rows.shape[1], m)


def min_distance_triclinic(a, b, boxes, chunk_pairs: int = _CHUNK_PAIRS):
    """Minimum exact triclinic minimum-image distance between `[B, N, 3]`
    and `[B, M, 3]` per frame, boxes `[B, 3, 3]` -> `[B]`."""
    best = torch.full((a.shape[0],), torch.inf, dtype=a.dtype, device=a.device)
    for _, d in _pair_distances(a, b, boxes, chunk_pairs):
        best = torch.minimum(best, d.amin(dim=(1, 2)))
    return best


def contact_count_triclinic(a, b, boxes, cutoff: float,
                            chunk_pairs: int = _CHUNK_PAIRS):
    """Pairs within `cutoff` (distance < cutoff) per frame, exact
    triclinic minimum image, boxes `[B, 3, 3]` -> `[B]` int64."""
    cnt = torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
    for _, d in _pair_distances(a, b, boxes, chunk_pairs):
        cnt += (d < cutoff).sum(dim=(1, 2))
    return cnt


def pair_distance_histogram(a, b, box, r_max: float, n_bins: int,
                            exclude_self: bool = False,
                            chunk_pairs: int = _CHUNK_PAIRS, self_offset: int = 0,
                            dist=None):
    """Per-frame histogram of PBC pair distances in (0, r_max] ->
    `[B, n_bins]` int64 counts (the JAX package returns int32).

    a `[B, N, 3]`, b `[B, M, 3]`, box `[B, 3]` lengths or `[B, 3, 3]`
    triclinic matrices.  Bin k counts pairs with distance in
    (k*dr, (k+1)*dr], dr = r_max / n_bins: the bin is `ceil(d / dr) - 1`,
    valid where d > 0 and the bin is in range.  `exclude_self=True` drops
    the diagonal j == i + self_offset (a same-group RDF; the offset places
    an atoms shard's rows in the gathered second group, `ops.sharded`).
    `dist`, a precomputed `[..., N, M]` distance tensor, is binned the
    same way -> `[..., n_bins]`; `a`, `b` and `box` are then ignored
    (JAX `ops/distances.py:198-230`).

    The JAX form builds the `[B, N, M]` matrix and relies on XLA fusing it
    away; here the rows of `a` go in chunks of at most `chunk_pairs`
    pairs, so no `[B, N, M]` tensor exists.  Counts accumulate with an
    integer `scatter_add_` on a flat `frame * n_bins + bin` index (exact
    under atomics); invalid pairs go to a spill region indexed by the `b`
    atom, which keeps them off a single hot address and is dropped."""
    if dist is not None:
        d = torch.as_tensor(dist)
        lead = d.shape[:-2]
        d = d.reshape((-1,) + d.shape[-2:])
        nb, m, dev = d.shape[0], d.shape[-1], d.device
        chunks = [(0, d)]
    else:
        nb, m, dev = a.shape[0], b.shape[1], a.device
        chunks = _pair_distances(a, b, box, chunk_pairs)
    n_bins = int(n_bins)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which rounds bin edges unlike the JAX division (made
    # by a fill on the device: a copy from the host would synchronise)
    dr = torch.full((), r_max / n_bins, dtype=torch.float32, device=dev)
    total = nb * n_bins
    spill = total + torch.arange(m, device=dev) % 4096
    base = (torch.arange(nb, device=dev) * n_bins)[:, None, None]
    counts = torch.zeros(total + min(m, 4096), dtype=torch.int64, device=dev)
    ones = torch.ones((), dtype=torch.int64, device=dev)
    for i0, d in chunks:   # d [B, c, M]
        idx = torch.ceil(d / dr).to(torch.int32) - 1
        valid = (d > 0.0) & (idx >= 0) & (idx < n_bins)
        if exclude_self:
            rows = torch.arange(i0, i0 + d.shape[1], device=dev) + self_offset
            valid &= rows[:, None] != torch.arange(m, device=dev)[None, :]
        flat = torch.where(valid, base + idx, spill)
        counts.scatter_add_(0, flat.reshape(-1), ones.expand(flat.numel()))
    out = counts[:total].reshape(nb, n_bins)
    return out if dist is None else out.reshape(lead + (n_bins,))


def rdf_normalization(box_lengths, n_a: int, n_b: int, r_max: float,
                      n_bins: int, exclude_self: bool = False):
    """Ideal-gas shell counts that turn a pair histogram into g(r):
    `n_pairs * V_shell_k / V_box` per frame, `[B, n_bins]` float32 for
    `[B, 3]` box lengths or `[B, 3, 3]` box matrices (volume |det|).
    `ndim` decides, as in the JAX function: a shape test could not tell
    three frames of lengths from one matrix."""
    dr = r_max / n_bins
    edges = np.arange(n_bins + 1) * dr
    shell = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    b = torch.as_tensor(box_lengths, dtype=torch.float32)
    vol = box_volume(b) if b.dim() >= 3 else torch.prod(b, dim=-1)
    n_pairs = n_a * n_b - (n_a if exclude_self else 0)
    if prof.TRACING:   # a copy from pageable host memory
        prof.count("host_sync", "rdf_normalization.copy")
    shell_t = torch.as_tensor(shell, dtype=torch.float32, device=b.device)
    return n_pairs * shell_t / vol[..., None]


def residue_min_matrix(pos, boxes, block_idx, block_mask, *, chunk: int = 16):
    """Smallest atom-atom PBC distance between residue blocks, per frame.

    pos `[F, K, 3]`; boxes `[F, 3]` lengths or `[F, 3, 3]` matrices (the
    exact 27-image minimum image); block_idx `[R, P]` atom indices into K,
    padded; block_mask `[R, P]` validity -> `[F, R, R]`.  Rows go `chunk`
    residues at a time and columns as many as fit, over as many frames as
    keep the `[frames, rows, cols, P, P, 3]` displacement tile within
    `_TILE_ELEMS` elements: where one row's `[R, P, P, 3]` is larger, the
    columns split too, down to one residue pair (the JAX function maps
    over frames one at a time; the tile of one frame is its
    `[chunk, R, P, P, 3]`).  A minimum does not depend on the split."""
    pos = torch.as_tensor(pos, dtype=torch.float32)
    dev = pos.device
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    bi = torch.as_tensor(np.asarray(block_idx), dtype=torch.int64, device=dev)
    bm = torch.as_tensor(np.asarray(block_mask), dtype=torch.bool, device=dev)
    f = pos.shape[0]
    r, p = bi.shape
    g = pos[:, bi]                                        # [F, R, P, 3]
    out = torch.empty((f, r, r), dtype=torch.float32, device=dev)
    big = torch.tensor(1e30, dtype=torch.float32, device=dev)
    per_pair = p * p * 3
    cols = min(r, max(1, _TILE_ELEMS // per_pair))
    chunk = min(r, max(1, min(chunk, _TILE_ELEMS // (cols * per_pair))))
    fb = max(1, _TILE_ELEMS // (chunk * cols * per_pair))
    triclinic = boxes.dim() == 3
    for f0 in range(0, f, fb):
        gf, bx = g[f0:f0 + fb], boxes[f0:f0 + fb]
        hinv = box_inverse(bx) if triclinic else None
        for r0 in range(0, r, chunk):
            ga = gf[:, r0:r0 + chunk]                     # [b, C, P, 3]
            for c0 in range(0, r, cols):
                gc = gf[:, c0:c0 + cols]                  # [b, Rc, P, 3]
                d = ga[:, :, None, :, None, :] - gc[:, None, :, None, :, :]
                if triclinic:                             # [b, C, Rc, P, P]
                    d2 = min_image_norm2_frames(
                        d.reshape(d.shape[0], -1, 3), bx, hinv
                    ).reshape(d.shape[:-1])
                else:
                    d = min_image(d, bx[:, None, None, None, None, :])
                    d2 = (d * d).sum(-1)
                valid = (bm[r0:r0 + chunk, None, :, None]
                         & bm[None, c0:c0 + cols, None, :])
                d2 = torch.where(valid, d2, big)
                out[f0:f0 + fb, r0:r0 + chunk, c0:c0 + cols] = torch.sqrt(
                    d2.amin((-2, -1)))
    return out


def self_image_min(pos, boxes, *, chunk: int = 128):
    """Shortest distance between a group and its own periodic images, per
    frame (the `gmx mindist -pi` reduction; JAX `ops/distances.py:254`).

    For every non-zero image shift S = n @ B (n in {-1, 0, 1}^3, B the box
    rows; lengths make a diagonal B) and every atom pair (i, j), i == j
    included (an atom against its own image is |S|), min |x_i - x_j + S|:
    the 26 shifts as they are, also in a triclinic box, not an exact
    shortest image.  Beside it the largest internal distance
    max_ij |x_i - x_j| (no image).

    pos `[F, K, 3]`; boxes `[F, 3]` or `[F, 3, 3]`.  The frames of a call
    go at once: `[frames, rows, K]` planes of x_i - x_j, at most `chunk`
    rows and `_TILE_ELEMS` elements a plane (JAX maps over frames and row
    chunks); each shift's |d + S|^2 is built in place, summed x, y, z,
    and folded into a running per-frame minimum.

    Returns `(min_image [F], max_internal [F])` float32 tensors in nm."""
    pos = torch.as_tensor(pos, dtype=torch.float32)
    dev = pos.device
    f, k = int(pos.shape[0]), int(pos.shape[1])
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    rows_b = (torch.eye(3, dtype=torch.float32, device=dev)[None] * boxes[:, None, :]
              if boxes.dim() == 2 else boxes)
    n = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                      for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0)],
                     dtype=torch.float32, device=dev)                 # [26, 3]
    shifts = torch.einsum("si,fij->fsj", n, rows_b)                  # [F, 26, 3]
    rows = max(1, min(int(chunk), k, _TILE_ELEMS // max(1, k)))
    fb = max(1, _TILE_ELEMS // (rows * k))
    mn = torch.full((f,), torch.inf, dtype=torch.float32, device=dev)
    mx = torch.full((f,), -1.0, dtype=torch.float32, device=dev)
    for f0 in range(0, f, fb):
        p = pos[f0:f0 + fb]
        b = p.shape[0]
        sh = shifts[f0:f0 + b, :, :, None, None]                      # [b, 26, 3, 1, 1]
        for r0 in range(0, k, rows):
            pc = p[:, r0:r0 + rows]
            x, y, z = (pc[:, :, None, a] - p[:, None, :, a] for a in range(3))
            n2 = x * x
            n2.add_(y * y).add_(z * z)
            torch.maximum(mx[f0:f0 + b], n2.amax((1, 2)), out=mx[f0:f0 + b])
            c = torch.empty_like(x)
            for s in range(26):
                t = sh[:, s]
                torch.add(x, t[:, 0], out=c)
                torch.mul(c, c, out=n2)
                torch.add(y, t[:, 1], out=c)
                n2.add_(c.mul_(c))
                torch.add(z, t[:, 2], out=c)
                n2.add_(c.mul_(c))
                torch.minimum(mn[f0:f0 + b], n2.amin((1, 2)), out=mn[f0:f0 + b])
    return torch.sqrt(mn), torch.sqrt(mx.clamp_min(0.0))
