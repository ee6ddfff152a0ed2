"""Solvent-accessible surface area: Shrake-Rupley on the device.

Port of `groan_rs_tpu/ops/sasa.py`.  Each atom gets a Fibonacci lattice
of test points on its extended sphere (vdW + probe); a point is buried
when it falls inside a neighbour's extended sphere.  Per atom the
neighbours whose extended spheres intersect its own ("relevant") are
counted; at most `max_neighbors` of them enter the `[rows, points,
neighbours]` occlusion tile, and the caller raises when the largest
count exceeds the cap, so no result is silently truncated.

The JAX function maps over frames and over atom chunks one at a time;
here the frames of a call go through `[frames, rows, K]` distance tiles
at once, rows and frames capped so that no temporary passes
`_CHUNK_ELEMS` elements.  |min image|^2 comes from
`pbc.min_image_norm2_pairs` (axis by axis in place, rounded as
`pbc.min_image` rounds it), and the chosen neighbours' displacements are
recomputed from their positions with the same arithmetic, so an
orthorhombic tile never holds `[.., K, 3]`.  The mean over the test
points is a multiply by the float32 reciprocal of their count, as XLA
compiles the JAX function's `jnp.mean`.  Which relevant neighbours are kept does
not change an area while the cap holds: occlusion is an `any` over them,
so `torch.topk`'s order and tie rule do not matter.
"""

from __future__ import annotations

import numpy as np
import torch

from . import pbc

__all__ = ["fibonacci_sphere", "sasa_frames", "sasa_frames_host_f64"]

# elements of the largest temporary of one tile
_CHUNK_ELEMS = 1 << 26


def fibonacci_sphere(n: int) -> np.ndarray:
    """`[n, 3]` near-uniform unit sphere points (golden-spiral lattice)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.pi * (np.sqrt(5.0) + 1.0) * i
    z = 1.0 - 2.0 * i / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    return np.stack([r * np.cos(phi), r * np.sin(phi), z],
                    axis=1).astype(np.float32)


def sasa_frames(pos, boxes, radii, *, probe: float = 0.14,
                n_points: int = 192, max_neighbors: int = 64,
                chunk: int = 256):
    """Per-atom SASA for a batch of frames.

    pos `[F, K, 3]`; boxes `[F, 3]` lengths or `[F, 3, 3]` matrices (the
    exact 27-image minimum image); radii `[K]` vdW radii (nm).  Returns
    `(areas [F, K] float32 in nm^2, the largest relevant-neighbour count
    over the batch as an int)`; the caller checks the count against
    `max_neighbors`.  At most `chunk` rows a tile."""
    pos = torch.as_tensor(pos, dtype=torch.float32)
    dev = pos.device
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    f, k = int(pos.shape[0]), int(pos.shape[1])
    m = min(int(max_neighbors), k - 1) if k > 1 else 1
    n = int(n_points)
    r_ext = torch.as_tensor(np.asarray(radii, np.float32), device=dev) + \
        torch.tensor(probe, dtype=torch.float32)
    pts = torch.as_tensor(fibonacci_sphere(n), device=dev)          # [N, 3]
    inv_n = torch.tensor(np.float32(1.0) / np.float32(n), device=dev)  # XLA's mean
    triclinic = boxes.dim() == 3
    per_row = max(k * (3 if triclinic else 1), n * m)
    rows = max(1, min(int(chunk), k, _CHUNK_ELEMS // per_row))
    fb = max(1, _CHUNK_ELEMS // (rows * per_row))
    areas = torch.empty((f, k), dtype=torch.float32, device=dev)
    n_max = torch.zeros((), dtype=torch.int64, device=dev)
    for f0 in range(0, f, fb):
        p, bx = pos[f0:f0 + fb], boxes[f0:f0 + fb]
        b = p.shape[0]
        base = (torch.arange(b, device=dev) * k)[:, None, None]
        for r0 in range(0, k, rows):
            pc = p[:, r0:r0 + rows]                                # [b, C, 3]
            c = pc.shape[1]
            rc = r_ext[r0:r0 + c]
            dist = pbc.min_image_norm2_pairs(pc, p, bx, flip=True).sqrt_()                  # [b, C, K]
            relevant = dist < (rc[:, None] + r_ext[None, :])
            own = torch.arange(c, device=dev)
            relevant[:, own, own + r0] = False                     # no self pair
            n_max = torch.maximum(n_max, relevant.sum(-1).amax())
            key = dist.masked_fill_(~relevant, torch.inf)
            del dist
            top = torch.topk(key, m, dim=-1, largest=False, sorted=False)
            valid = top.values < torch.inf                         # [b, C, M]
            del key, relevant
            pj = p.reshape(-1, 3).index_select(0, (top.indices + base).reshape(-1))
            dj = pbc.min_image_frames_any(
                (pj.reshape(b, c * m, 3) - pc.repeat_interleave(m, 1)), bx
            ).reshape(b, c, m, 3)
            rj = r_ext[top.indices]                                # [b, C, M]
            q = rc[:, None, None] * pts[None, :, :]                # [C, N, 3]
            dd2 = None
            for a in range(3):
                t = q[None, :, :, None, a] - dj[:, :, None, :, a]  # [b, C, N, M]
                dd2 = t.mul_(t) if dd2 is None else dd2.add_(t.mul_(t))
            blocked = (dd2 < (rj * rj)[:, :, None, :]) & valid[:, :, None, :]
            del dd2
            acc = 1.0 - blocked.any(-1).to(torch.float32)
            frac = acc.sum(-1) * inv_n                             # [b, C]
            areas[f0:f0 + b, r0:r0 + c] = 4.0 * np.pi * rc * rc * frac
    return areas, int(n_max)


def sasa_frames_host_f64(pos, boxes, radii, *, probe: float = 0.14,
                         n_points: int = 192):
    """Float64 host oracle: the same point set, ALL neighbours (no cap);
    orthorhombic minimum image, or a brute-force 125-image search for
    `[F, 3, 3]` triclinic boxes."""
    pos = np.asarray(pos, np.float64)
    boxes = np.asarray(boxes, np.float64)
    r = np.asarray(radii, np.float64) + probe
    pts = fibonacci_sphere(n_points).astype(np.float64)
    f, k = pos.shape[0], pos.shape[1]
    shifts = None
    if boxes.ndim == 3:
        g = np.array([-2, -1, 0, 1, 2])
        shifts = np.stack(np.meshgrid(g, g, g, indexing="ij"),
                          axis=-1).reshape(-1, 3).astype(np.float64)
    out = np.zeros((f, k))
    for fi in range(f):
        box = boxes[fi]
        for i in range(k):
            d = pos[fi] - pos[fi, i]
            if shifts is not None:
                cands = d[:, None, :] + (shifts @ box)[None, :, :]
                best = np.argmin((cands * cands).sum(-1), axis=1)
                d = cands[np.arange(k), best]
            else:
                d -= box * np.round(d / box)             # [K, 3], j rel. i
            q = r[i] * pts                               # [N, 3]
            blocked = np.zeros(len(pts), bool)
            for j in range(k):
                if j == i:
                    continue
                dd = q - d[j]
                blocked |= (dd * dd).sum(1) < r[j] * r[j]
            out[fi, i] = 4.0 * np.pi * r[i] * r[i] * (1.0 - blocked.mean())
    return out
