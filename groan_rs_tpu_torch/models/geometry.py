"""Geometric and surface analyses: SASA, free volume, spatial distribution
functions, helix and bundle geometry, dye coupling, angles between sites,
pair distances, dynamic selections, salt bridges, solvent ordering and the
periodic-image distance.

Port of `groan_rs_tpu/models/geometry.py`.  Everything runs on the
System's device (the CUDA card unless the System was built or set with
`device="cpu"`); results come back as numpy in the JAX functions' keys,
shapes, dtypes and units.  Every name is importable as
`groan_rs_tpu_torch.models.<name>` and `models.pipeline.<name>`.

The JAX functions map over frames one at a time (`lax.map`); here the
frames of a call go through batched tensors, in frame chunks that keep
each temporary within `_CHUNK_ELEMS` elements.  The dense pair tiles
(`sasa`, `freevolume`, `select_dynamic`, `trjorder`, `pi_mindist`) are
`[frames, rows, M]` planes of |min image|^2 built axis by axis
(`pbc.min_image_norm2_pairs`), rows capped by the same budget.  `sdf`'s
reference centre is one `ops.center.center` call per frame chunk (K1 +
K2, one launch each, on an orthorhombic box; `center_triclinic`, plain
torch, on a triclinic one), plus frame 0's centre when it fits.  The
part and unit centres of `bundle`, `dyecoupl`, `pairdist(mode="com")`,
`saltbr` and `trjorder(mode="com")` are the JAX functions' weighted
means around each unit's first atom, not Bai-Breen centres.  Everything
else is plain torch, as the JAX functions are jnp outside any Pallas
kernel.  `sdf`'s voxel counts are per-frame float32 sums through
`index_put_(accumulate=True)` (`pipeline._histogram`), so a resident
window and a file call give the same bits.

Where the port differs on purpose:
- `freevolume` draws its probes on the host with `utils.threefry`, bit
  for bit `jax.random.uniform(jax.random.PRNGKey(seed), ...)`.
- `polystat`'s bond correlation is one batched product per lag over all
  frames (JAX maps over lags); `sasa` keeps its relevant neighbours by
  `torch.topk`, whose order and tie rule change no area while the cap
  holds.
- `select_dynamic(whole_res=True)` spreads membership over residues with
  one `logical_or.reduceat`, not a loop over residues.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..errors import GroupError, ParallelError
from ..ops import distances as distance_ops
from ..ops import geometry
from ..ops import pbc
from ..ops import rmsd as rmsd_ops
from .membrane import _ctr, _fetch64, _frame_step, _mi, _norm, _union_window
from .pipeline import (
    _AXIS,
    _G1_SITE_WIDTH,
    _f32,
    _histogram,
    _resident_group_pos,
    _residue_blocks,
    _sel_indices,
    _transient_indices,
    _unit_tables,
)

__all__ = ["sasa", "polystat", "freevolume", "sdf", "write_cube",
           "helixorient", "bundle", "dyecoupl", "gangle", "pairdist",
           "select_dynamic", "saltbr", "trjorder", "pi_mindist"]

# elements of the largest temporary of one frame chunk (as `ops.msd`)
_CHUNK_ELEMS = 1 << 26

_TINY = 1e-12


def _unit(v):
    """`v / max(|v|, 1e-12)` over the last axis."""
    return v / _norm(v).clamp_min(_TINY)[..., None]


def _deg(x):
    return x * (180.0 / np.pi)


def _dot(a, b):
    return (a * b).sum(-1)


def _tile_rows(per_row: int, n_rows: int, chunk: int | None = None) -> int:
    """Rows of a `[frames, rows, M]` tile of `per_row` elements a row."""
    rows = max(1, min(n_rows, _CHUNK_ELEMS // max(1, per_row)))
    return rows if chunk is None else max(1, min(rows, int(chunk)))


def _radii(system, gsel, group, radii) -> np.ndarray:
    """Per-atom vdW radii of the group: the topology's, or the override."""
    if radii is None:
        if not np.asarray(system.topology.has_vdw)[gsel].all():
            raise GroupError(
                f"group '{group}' has atoms without a vdW radius; run "
                "guess_elements() / guess_properties() or pass radii=",
                code="InvalidVdW")
        return np.asarray(system.topology.vdw, np.float32)[gsel]
    radii = np.asarray(radii, np.float32)
    if radii.shape != (gsel.shape[0],):
        raise GroupError(
            f"radii must have shape [{gsel.shape[0]}] to match group "
            f"'{group}'", code="InvalidVdW")
    return radii


def _cols(lut, idx, device):
    return torch.as_tensor(lut[np.asarray(idx)], dtype=torch.int64, device=device)


def _rows_product(v, m):
    """`v @ m` per frame, `[b, K, 3]` x `[b, 3, 3]`, the three products
    summed in order (a fractional draw through a box matrix, offsets
    through a rotation)."""
    return (v[..., 0:1] * m[:, None, 0] + v[..., 1:2] * m[:, None, 1]
            + v[..., 2:3] * m[:, None, 2])


def _weighted_units(x, w, boxes):
    """Weighted means of units `x` `[b, U, P, 3]` around each unit's first
    atom (min image), `w` `[U, P]` normalised -> `[b, U, 3]`."""
    rel = _mi(x - x[:, :, :1], boxes)
    return x[:, :, 0] + (w[None, :, :, None] * rel).sum(2)


def sasa(system, trajectory, group: str, *, probe: float = 0.14,
         n_points: int = 192, max_neighbors: int = 64, radii=None,
         batch_size: int = 32):
    """Solvent-accessible surface area per frame and atom (`gmx sasa`,
    Shrake-Rupley; `ops.sasa.sasa_frames`).

    Each atom gets a Fibonacci lattice of `n_points` test points on its
    extended sphere (vdW + `probe`, nm); a point is buried if it falls
    inside any neighbour's extended sphere.  At most `max_neighbors`
    relevant neighbours enter the occlusion test; the relevant count is
    checked and a ParallelError asks for a larger cap if it was ever
    exceeded.  `radii` overrides the topology's vdW radii ([K] nm).

    Returns a dict: 'indices' [K], 'area' [F, K] (nm^2), 'total' [F]."""
    from ..ops import sasa as sasa_ops

    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    radii = _radii(system, gsel, group, radii)
    areas, max_rel = sasa_ops.sasa_frames(pos, boxes, radii, probe=probe,
                                          n_points=n_points,
                                          max_neighbors=max_neighbors)
    if max_rel > min(int(max_neighbors), max(1, gsel.shape[0] - 1)):
        raise ParallelError(
            f"an atom had {max_rel} relevant neighbours but "
            f"max_neighbors={max_neighbors}; raise max_neighbors to keep "
            "the occlusion test exact")
    areas = areas.cpu().numpy()
    return {"indices": gsel, "area": areas, "total": areas.sum(axis=1)}


def polystat(system, trajectory, group: str, *, mass_weighted: bool = False,
             batch_size: int = 32):
    """Polymer chain statistics of a selection (`gmx polystat`).

    Chains are the molecules of `group` from the bond graph, atoms in
    topology order; single-atom molecules are ignored.  Chains are rebuilt
    whole by accumulating minimum-image consecutive-atom vectors.

    Returns a dict: 'ete2' [F], 'ete' [F], 'rg2' [F] (mass-weighted with
    `mass_weighted`), 'bond_corr' [Kb] (<u_i . u_{i+k}>, k = 0..Lmax-2),
    'persistence_length' (-<l_b> / ln C(1), NaN when C(1) is outside
    (0, 1)), 'mean_bond_length', 'n_chains', 'chain_lengths' [M]."""
    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    mol = system.topology.molecule_ids()[gsel]
    order = np.argsort(mol, kind="stable")
    _, starts, counts = np.unique(mol[order], return_index=True, return_counts=True)
    keep = counts >= 2
    if not keep.any():
        raise GroupError(
            f"group '{group}' contains no molecule with >= 2 atoms (does "
            "the topology carry bonds? read a TPR / PDB CONECT or run "
            "guess_bonds)", code="NoBonds")
    lens = counts[keep].astype(np.int64)
    m, lmax = lens.shape[0], int(lens.max())
    rows = np.repeat(np.arange(m), lens)
    within = np.arange(lens.sum()) - np.repeat(np.cumsum(lens) - lens, lens)
    cols = np.zeros((m, lmax), np.int64)
    amask = np.zeros((m, lmax), bool)
    cols[rows, within] = order[np.concatenate(
        [np.arange(s, s + c) for s, c in zip(starts[keep], lens)])]
    amask[rows, within] = True
    if mass_weighted:
        topo = system.topology
        if not topo.has_mass[gsel].all():
            raise GroupError(
                f"group '{group}' has atoms without mass (mass-weighted "
                "polystat needs a TPR)", code="InvalidMass")
        w_np = np.where(amask, topo.mass[gsel][cols], 0.0).astype(np.float32)
    else:
        w_np = amask.astype(np.float32)

    dev = pos.device
    cj = torch.as_tensor(cols, device=dev)
    w = torch.as_tensor(w_np, device=dev)                        # [M, L]
    bmask = torch.as_tensor(amask[:, 1:], device=dev)           # [M, L-1]
    last = torch.as_tensor(lens - 1, device=dev)
    sw = w.sum(1)
    nb = bmask.sum().to(torch.float32)
    lb = lmax - 1
    step = _frame_step(3 * m * lmax)
    ete2_p, rg2_p, blen_p, u_p = [], [], [], []
    for f0 in range(0, int(pos.shape[0]), step):
        g = pos[f0:f0 + step][:, cj]                             # [b, M, L, 3]
        bx = boxes[f0:f0 + step]
        b = _mi(g[:, :, 1:] - g[:, :, :-1], bx) * bmask[None, :, :, None]
        rel = torch.cat([torch.zeros_like(g[:, :, :1]), torch.cumsum(b, 2)], 2)
        ete_v = rel[:, torch.arange(m, device=dev), last]        # [b, M, 3]
        ete2_p.append(pbc.norm2(ete_v).mean(1))
        com = (rel * w[None, :, :, None]).sum(2) / sw[None, :, None]
        dv = rel - com[:, :, None, :]
        rg2_p.append(((dv * w[None, :, :, None] * dv).sum((2, 3)) / sw[None]).mean(1))
        blen = _norm(b)                                          # [b, M, L-1]
        blen_p.append(blen.sum((1, 2)) / nb)
        u_p.append(b / torch.where(blen == 0.0, torch.ones_like(blen), blen)[..., None])
    u = torch.cat(u_p)
    f = u.shape[0]
    corr = []
    for k in range(lb):
        pm = bmask[:, :lb - k] & bmask[:, k:]                    # [M, L-1-k]
        dots = (u[:, :, :lb - k] * u[:, :, k:]).sum(-1)
        corr.append((dots * pm[None]).sum() / (f * pm.sum().clamp_min(1)))
    bond_corr = torch.stack(corr).cpu().numpy().astype(np.float64)
    mean_bl = float(_fetch64(blen_p).mean())
    c1 = bond_corr[1] if lb > 1 else np.nan
    lp = (-mean_bl / np.log(c1)) if 0.0 < c1 < 1.0 else float("nan")
    e2 = _fetch64(ete2_p)
    return {"ete2": e2, "ete": np.sqrt(e2), "rg2": _fetch64(rg2_p),
            "bond_corr": bond_corr, "persistence_length": float(lp),
            "mean_bond_length": mean_bl, "n_chains": m,
            "chain_lengths": lens}


def freevolume(system, trajectory, group: str = "all", *,
               probe: float = 0.0, n_samples: int = 8192, seed: int = 0,
               radii=None, points=None, batch_size: int = 32,
               chunk: int = 1024):
    """Free-volume fraction by Monte Carlo probe insertion (`gmx
    freevolume`).

    Per frame, `n_samples` uniform fractional points (the seeded draw of
    `utils.threefry`, equal to the JAX package's `jax.random` draw) map
    through the box; a point is FREE when its minimum-image distance to
    every atom of `group` exceeds that atom's vdW radius + `probe` (nm).
    `points=` ([F, P, 3] in box units) replaces the draw.  At most `chunk`
    points a tile.

    Returns a dict: 'fraction' [F], 'free_volume' [F] (nm^3), 'box_volume'
    [F] (nm^3), 'mean_fraction', 'stderr_fraction' (binomial MC error of
    the mean), 'n_samples'."""
    from ..utils import threefry

    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    radii = _radii(system, gsel, group, radii)
    dev = pos.device
    r2 = torch.as_tensor((radii + np.float32(probe)) ** 2, device=dev)
    f = int(pos.shape[0])
    if points is None:
        pts = threefry.uniform(seed, (f, int(n_samples), 3))
    else:
        pts = np.asarray(points, np.float32)
        if pts.shape[0] != f or pts.ndim != 3 or pts.shape[2] != 3:
            raise ParallelError(f"points must be [F={f}, P, 3], got {pts.shape}")
    u = torch.as_tensor(pts, device=dev)
    p = int(u.shape[1])
    xyz = _rows_product(u, boxes) if boxes.dim() == 3 else u * boxes[:, None, :]
    per_row = int(pos.shape[1]) * (3 if boxes.dim() == 3 else 1)
    rows = _tile_rows(per_row, p, chunk)
    fb = max(1, _CHUNK_ELEMS // (rows * per_row))
    inv_p = _f32(np.float32(1.0) / np.float32(p), dev)   # XLA's x / p
    parts = []
    for f0 in range(0, f, fb):
        pf, bx, xf = pos[f0:f0 + fb], boxes[f0:f0 + fb], xyz[f0:f0 + fb]
        n_free = torch.zeros(pf.shape[0], dtype=torch.float32, device=dev)
        for r0 in range(0, p, rows):
            d2 = pbc.min_image_norm2_pairs(xf[:, r0:r0 + rows], pf, bx)
            n_free += (d2 > r2).all(-1).sum(-1).to(torch.float32)
        parts.append(n_free * inv_p)
    frac = _fetch64(parts)
    bx = boxes.cpu().numpy().astype(np.float64)
    bvol = np.abs(np.linalg.det(bx)) if bx.ndim == 3 else np.prod(bx, axis=1)
    mean = float(frac.mean())
    stderr = float(np.sqrt(max(mean * (1.0 - mean), 0.0) / (f * p)))
    return {"fraction": frac, "free_volume": frac * bvol,
            "box_volume": bvol, "mean_fraction": mean,
            "stderr_fraction": stderr, "n_samples": p}


def sdf(system, trajectory, group: str, ref_group: str, *,
        side: float = 2.0, bins: int = 32, fit: bool = False,
        weights: str = "number", batch_size: int = 32):
    """3D spatial distribution function around a reference group (`gmx
    spatial`).

    Per frame the reference COM (refined Bai-Breen) recentres a cube of
    `side` nm and `bins`^3 voxels; `group` atoms scatter their weights
    ("number" or "mass") into it min-imaged.  `fit=True` also rotates each
    frame's offsets by the Kabsch fit of the reference group onto its
    frame-0 conformation.

    Returns a dict: 'grid' [bins]^3 time-averaged density (nm^-3),
    'counts' raw weighted counts, 'origin' [3] cube corner relative to the
    COM, 'voxel' (nm), 'occupancy' fraction of group-atom-frames inside
    the cube."""
    gsel = _sel_indices(system, group)
    rsel = _sel_indices(system, ref_group)
    if gsel.size == 0 or rsel.size == 0:
        raise GroupError("sdf needs non-empty group and ref_group", code="EmptyGroup")
    _, pos, boxes, lut = _union_window(system, trajectory, "__sdf_union",
                                np.concatenate([gsel, rsel]), batch_size)
    dev = pos.device
    g_l, r_l = _cols(lut, gsel, dev), _cols(lut, rsel, dev)
    w_ref = torch.as_tensor(np.asarray(system.topology.mass, np.float32)[rsel], device=dev)
    if weights == "number":
        w = np.ones(gsel.size, np.float32)
    elif weights == "mass":
        w = np.asarray(system.topology.mass, np.float32)[gsel]
    else:
        raise ParallelError(f"weights must be 'number' or 'mass', got '{weights}'")
    w = torch.as_tensor(w, device=dev)
    nb = int(bins)
    vox = float(side) / nb
    inv_vox = _f32(np.float32(1.0) / np.float32(vox), dev)   # XLA's x / vox
    f = int(pos.shape[0])
    if fit:
        p0, box0 = pos[:1].index_select(1, r_l), boxes[:1]
        ref0 = _mi(p0 - _ctr(p0, box0, w_ref)[:, None, :], box0)   # [1, R, 3]
    hist, n_in = [], []
    step = _frame_step(3 * max(gsel.size, rsel.size))
    for f0 in range(0, f, step):
        p, bx = pos[f0:f0 + step], boxes[f0:f0 + step]
        pr = p.index_select(1, r_l)
        com = _ctr(pr, bx, w_ref)                                  # [b, 3]
        off = _mi(p.index_select(1, g_l) - com[:, None, :], bx)    # [b, K, 3]
        if fit:
            cur = _mi(pr - com[:, None, :], bx)
            zero = torch.zeros((cur.shape[0], 3), dtype=cur.dtype, device=dev)
            rot, _, _ = rmsd_ops.kabsch(cur, ref0.expand_as(cur), w_ref, zero, zero)
            off = _rows_product(off, rot)
        ijk = torch.floor((off + side / 2.0) * inv_vox).to(torch.int32)
        inside = ((ijk >= 0) & (ijk < nb)).all(-1)
        ijk = ijk.clamp(0, nb - 1)
        flat = (ijk[..., 0] * nb + ijk[..., 1]) * nb + ijk[..., 2]
        hist.append(_histogram(flat, w * inside.to(torch.float32), nb ** 3,
                               torch.float32))
        n_in.append(inside.to(torch.float32).sum(-1))
    counts = _fetch64(hist).sum(axis=0).reshape(nb, nb, nb)
    return {"grid": counts / (f * vox ** 3), "counts": counts,
            "origin": np.full(3, -side / 2.0), "voxel": vox,
            "occupancy": float(_fetch64(n_in).sum()) / (f * gsel.size)}


def write_cube(path, grid, origin, voxel, *, comment="groan_rs_tpu SDF"):
    """Write a 3D grid as a Gaussian cube file (units converted nm ->
    Bohr); one dummy atom marks the cube centre."""
    bohr = 1.0 / 0.052917721092                      # nm -> Bohr
    nx, ny, nz = grid.shape
    with open(path, "w") as fh:
        fh.write(f"{comment}\n")
        fh.write("time-averaged density (nm^-3)\n")
        ox, oy, oz = (o * bohr for o in origin)
        fh.write(f"{1:5d}{ox:12.6f}{oy:12.6f}{oz:12.6f}\n")
        v = voxel * bohr
        fh.write(f"{nx:5d}{v:12.6f}{0.0:12.6f}{0.0:12.6f}\n")
        fh.write(f"{ny:5d}{0.0:12.6f}{v:12.6f}{0.0:12.6f}\n")
        fh.write(f"{nz:5d}{0.0:12.6f}{0.0:12.6f}{v:12.6f}\n")
        fh.write(f"{1:5d}{0.0:12.6f}{0.0:12.6f}{0.0:12.6f}{0.0:12.6f}\n")
        flat = np.asarray(grid, np.float64).reshape(nx * ny, nz)
        for row in flat:
            for i in range(0, nz, 6):
                fh.write("".join(f"{x:13.5e}" for x in row[i:i + 6]))
                fh.write("\n")


def helixorient(system, trajectory, group: str, *, axis: str = "z",
                batch_size: int = 32):
    """Local helix geometry from CA positions (`gmx helixorient` / `gmx
    helix`).

    The group's CA atoms (residue order) are rebuilt whole by min-image
    accumulation; the Sugeta-Miyazawa construction gives per window the
    radial bisector b_i = unit(u_{i-1} - u_i), the local axis a_i =
    unit(b_i x b_{i+1}) (signed along the chain), rise u_i . a_i, twist
    angle(b_i, b_{i+1}) and radius from the axis-perpendicular chord.

    Returns a dict: 'axis_vec' [F, 3], 'tilt' [F] (deg vs +`axis`),
    'rise' [F] / 'twist' [F] / 'radius' [F] (per-frame means; nm, deg,
    nm), 'rise_per_residue' [F, W], 'twist_per_residue' [F, W],
    'local_axes' [F, W, 3] (W = R - 3), 'resids' [R]."""
    if axis not in _AXIS:
        raise ParallelError(f"axis must be one of xyz, got '{axis}'")
    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    ca_cols = np.flatnonzero(system.topology.atomname.mask_equal("CA")[gsel])
    if len(ca_cols) < 5:
        raise GroupError(
            f"group '{group}' has {len(ca_cols)} CA atoms; helixorient "
            "needs at least 5", code="InvalidSelection")
    resids = np.asarray(system.topology.resnum)[gsel[ca_cols]]
    order = np.argsort(resids, kind="stable")
    ca_cols, resids = ca_cols[order], resids[order]
    dev = pos.device
    cac = torch.as_tensor(ca_cols, device=dev)
    ax_ref = torch.zeros(3, dtype=torch.float32, device=dev)
    ax_ref[_AXIS[axis]] = 1.0
    parts = [[] for _ in range(8)]
    step = _frame_step(3 * len(ca_cols))
    for f0 in range(0, int(pos.shape[0]), step):
        ca = pos[f0:f0 + step].index_select(1, cac)              # [b, R, 3]
        d = _mi(ca[:, 1:] - ca[:, :-1], boxes[f0:f0 + step])
        whole = torch.cat([ca[:, :1], ca[:, :1] + torch.cumsum(d, 1)], 1)
        u = whole[:, 1:] - whole[:, :-1]
        b = _unit(u[:, :-1] - u[:, 1:])
        a = _unit(torch.linalg.cross(b[:, :-1], b[:, 1:]))
        sgn = torch.sign(_dot(a, u[:, 1:-1]))
        a = a * torch.where(sgn == 0, torch.ones_like(sgn), sgn)[..., None]
        rise = _dot(u[:, 1:-1], a)
        twist = torch.arccos(_dot(b[:, :-1], b[:, 1:]).clamp(-1.0, 1.0))
        perp = u[:, 1:-1] - rise[..., None] * a
        radius = _norm(perp) / (2.0 * torch.sin(twist / 2.0)).clamp_min(_TINY)
        mean_axis = _unit(a.mean(1))
        tilt = _deg(torch.arccos((mean_axis * ax_ref).sum(-1).clamp(-1.0, 1.0)))
        for acc, v in zip(parts, (mean_axis, tilt, rise.mean(1), _deg(twist.mean(1)),
                                  radius.mean(1), rise, _deg(twist), a)):
            acc.append(v)
    axv, tilt, rise, twist, radius, rise_pr, twist_pr, axes = (
        _fetch64(x) for x in parts)
    return {"axis_vec": axv, "tilt": tilt, "rise": rise, "twist": twist,
            "radius": radius, "rise_per_residue": rise_pr,
            "twist_per_residue": twist_pr, "local_axes": axes,
            "resids": resids}


def _part_tables(system, specs, n_axes, kind):
    """Split `specs` (one group name/query, split into `n_axes` equal
    consecutive parts, or an explicit list of one name/query per axis)
    into per-axis global index arrays."""
    if isinstance(specs, str):
        idx = _transient_indices(system, specs)
        if n_axes is None:
            raise ParallelError("bundle needs n_axes when "
                                f"{kind} is a single group")
        if idx.size % n_axes:
            raise GroupError(
                f"{kind} group has {idx.size} atoms, not divisible into "
                f"{n_axes} axes", code="InvalidSelection")
        return np.split(idx, n_axes)
    parts = [_transient_indices(system, s) for s in specs]
    if n_axes is not None and len(parts) != n_axes:
        raise ParallelError(
            f"{kind} lists {len(parts)} groups but n_axes={n_axes}")
    return parts


def bundle(system, trajectory, tops, bottoms, *, n_axes: int | None = None,
           axis: str = "z", mass_weighted: bool = True,
           batch_size: int = 32):
    """Helix-bundle axis geometry (`gmx bundle`).

    Each axis runs from the centre of a "bottom" part to the centre of a
    "top" part: `tops` / `bottoms` are ONE group name / GSL query split
    into `n_axes` equal consecutive parts, or explicit per-axis lists.
    Centres are mass-weighted by default, each part rebuilt whole around
    its first atom, the top anchor min-imaged to the bottom anchor.

    Per frame and axis (e = unit `axis`, v = unit axis vector, m =
    midpoint, c = bundle centre): 'length' [F, A], 'distance' [F, A] (|(m
    - c) perp e|), 'zshift' [F, A], 'tilt' [F, A] (deg), 'tiltr' / 'tiltl'
    [F, A] (deg, radial and lateral components), 'axes' [F, A, 3],
    'center' [F, 3]."""
    if axis not in _AXIS:
        raise ParallelError(f"axis must be one of xyz, got '{axis}'")
    top_parts = _part_tables(system, tops, n_axes, "tops")
    bot_parts = _part_tables(system, bottoms, n_axes, "bottoms")
    if len(top_parts) != len(bot_parts):
        raise ParallelError(
            f"{len(top_parts)} top parts vs {len(bot_parts)} bottom parts")
    n_ax = len(top_parts)
    if n_ax < 1:
        raise ParallelError("bundle needs at least one axis")
    for p in (*top_parts, *bot_parts):
        if p.size == 0:
            raise GroupError("empty bundle part", code="EmptyGroup")
    gsel, pos, boxes, lut = _union_window(system, trajectory, "__bundle_union",
                                   np.concatenate(top_parts + bot_parts), batch_size)
    dev = pos.device

    def padded(parts):
        from ..system.rmsd import _masses

        width = max(p.size for p in parts)
        cols = np.zeros((n_ax, width), np.int64)
        w = np.zeros((n_ax, width), np.float32)
        for i, p in enumerate(parts):
            cols[i, :p.size] = lut[p]
            w[i, :p.size] = _masses(system, "bundle part", p) if mass_weighted else 1.0
            w[i] /= w[i].sum()
        return (torch.as_tensor(cols, device=dev), torch.as_tensor(w, device=dev))

    (tcols, tw), (bcols, bw) = padded(top_parts), padded(bot_parts)
    e = torch.zeros(3, dtype=torch.float32, device=dev)
    e[_AXIS[axis]] = 1.0
    parts = [[] for _ in range(8)]
    step = _frame_step(3 * tcols.numel() + 3 * bcols.numel())
    for f0 in range(0, int(pos.shape[0]), step):
        p, bx = pos[f0:f0 + step], boxes[f0:f0 + step]
        bxv, tx = p[:, bcols], p[:, tcols]                       # [b, A, P, 3]
        bcom = _weighted_units(bxv, bw, bx)
        t0, b0 = tx[:, :, 0], bxv[:, :, 0]
        trel = _mi(tx - tx[:, :, :1], bx)
        tcom = (b0 + _mi(t0 - b0, bx)) + (tw[None, :, :, None] * trel).sum(2)
        vec = tcom - bcom                                        # [b, A, 3]
        length = _norm(vec)
        v = vec / length.clamp_min(_TINY)[..., None]
        mid = bcom + 0.5 * vec
        center = mid[:, 0] + _mi(mid - mid[:, :1], bx).mean(1)
        off = _mi(mid - center[:, None], bx)
        zshift = (off * e).sum(-1)
        perp = off - zshift[..., None] * e
        dist = _norm(perp)
        r_hat = perp / dist.clamp_min(_TINY)[..., None]
        l_hat = torch.linalg.cross(e.expand_as(r_hat), r_hat)
        tilt = _deg(torch.arccos((v * e).sum(-1).clamp(-1.0, 1.0)))
        safe = (dist > 1e-9)[..., None]
        zero = torch.zeros_like(r_hat)
        tiltr = _deg(torch.arcsin(_dot(v, torch.where(safe, r_hat, zero)).clamp(-1.0, 1.0)))
        tiltl = _deg(torch.arcsin(_dot(v, torch.where(safe, l_hat, zero)).clamp(-1.0, 1.0)))
        for acc, x in zip(parts, (length, dist, zshift, tilt, tiltr, tiltl, v, center)):
            acc.append(x)
    length, dist, zshift, tilt, tiltr, tiltl, axes_v, centers = (
        _fetch64(x) for x in parts)
    return {"length": length, "distance": dist, "zshift": zshift,
            "tilt": tilt, "tiltr": tiltr, "tiltl": tiltl,
            "axes": axes_v, "center": centers}


def dyecoupl(system, trajectory, donor, acceptor, *, r0: float | None = None,
             batch_size: int = 32):
    """FRET dye-pair coupling (`gmx dyecoupl`).

    `donor` and `acceptor` each select EXACTLY two atoms, the ends of the
    dye's transition dipole.  Per frame (all minimum-image): 'r' [F], the
    distance of the dipole midpoints (nm); 'kappa2' [F], (u_D.u_A - 3
    (u_D.r)(u_A.r))^2; with `r0` (the isotropic Forster radius, nm)
    'efficiency' [F] = 1 / (1 + (2 / (3 kappa2)) (R / R0)^6)."""
    d_idx = _transient_indices(system, donor)
    a_idx = _transient_indices(system, acceptor)
    for nm, ix in (("donor", d_idx), ("acceptor", a_idx)):
        if ix.size != 2:
            raise GroupError(
                f"{nm} must select exactly 2 atoms (dipole endpoints), "
                f"got {ix.size}", code="InvalidSelection")
    _, pos, boxes, lut = _union_window(system, trajectory, "__dye_union",
                                np.concatenate([d_idx, a_idx]), batch_size)
    dc, ac = lut[d_idx], lut[a_idx]
    bx = boxes
    dvec = _mi(pos[:, dc[1]] - pos[:, dc[0]], bx)
    avec = _mi(pos[:, ac[1]] - pos[:, ac[0]], bx)
    dmid = pos[:, dc[0]] + 0.5 * dvec
    amid = pos[:, ac[0]] + 0.5 * avec
    rvec = _mi(amid - dmid, bx)
    r = _norm(rvec)
    ud, ua, ur = _unit(dvec), _unit(avec), rvec / r.clamp_min(_TINY)[..., None]
    kappa = _dot(ud, ua) - 3.0 * _dot(ud, ur) * _dot(ua, ur)
    r, k2 = _fetch64([r]), _fetch64([kappa * kappa])
    out = {"r": r, "kappa2": k2}
    if r0 is not None:
        if r0 <= 0:
            raise ParallelError(f"r0 must be positive, got {r0}")
        with np.errstate(divide="ignore"):
            out["efficiency"] = 1.0 / (1.0 + (2.0 / (3.0 * k2)) * (r / float(r0)) ** 6)
    return out


def _site_dirs(p, bx, cols, width):
    """Unit site directions `[b, S, 3]`: the min-image vector atom0 ->
    atom1, or the normal of the plane of three atoms."""
    a = p[:, cols[:, 0]]
    v = _mi(p[:, cols[:, 1]] - a, bx)
    if width == 3:
        v = torch.linalg.cross(v, _mi(p[:, cols[:, 2]] - a, bx))
    return _unit(v)


def gangle(system, trajectory, group1, *, g1: str = "vector",
           g2: str = "z", group2=None, batch_size: int = 32):
    """Angles between selection-defined vectors or planes and a reference
    (`gmx gangle`).

    `group1` supplies sites in index order: consecutive atom PAIRS
    (`g1="vector"`, atom0 -> atom1, minimum image) or TRIPLES
    (`g1="plane"`, their normals).  `g2` is "x"/"y"/"z" (a box axis),
    "t0" (each site's own first-frame orientation) or "vector"/"plane"
    (sites of `group2`, paired 1:1 or one broadcast to all).

    Returns a dict: 'angles' [F, K] (degrees, 0-180), 'mean' [F]."""
    if g1 not in _G1_SITE_WIDTH:
        raise ParallelError(f"g1 must be 'vector' or 'plane', got '{g1}'")
    fixed_axis = g2 in _AXIS
    if not fixed_axis and g2 not in ("t0", "vector", "plane"):
        raise ParallelError(f"g2 must be x/y/z/t0/vector/plane, got '{g2}'")
    if g2 in ("vector", "plane") and group2 is None:
        raise ParallelError(f"g2='{g2}' needs group2")
    idx1 = _transient_indices(system, group1)
    w1 = _G1_SITE_WIDTH[g1]
    if idx1.size == 0 or idx1.size % w1:
        raise GroupError(
            f"group1 has {idx1.size} atoms, not a multiple of {w1} "
            f"({g1} sites)", code="InvalidSelection")
    k = idx1.size // w1
    idx2 = np.empty(0, np.int64)
    w2 = 0
    if g2 in ("vector", "plane"):
        w2 = _G1_SITE_WIDTH[g2]
        idx2 = _transient_indices(system, group2)
        if idx2.size == 0 or idx2.size % w2:
            raise GroupError(
                f"group2 has {idx2.size} atoms, not a multiple of {w2}",
                code="InvalidSelection")
        k2 = idx2.size // w2
        if k2 not in (1, k):
            raise ParallelError(f"group2 defines {k2} sites; need 1 or {k}")
    _, pos, boxes, lut = _union_window(system, trajectory, "__gangle_union",
                                np.concatenate([idx1, idx2]), batch_size)
    dev = pos.device
    s1 = torch.as_tensor(lut[idx1].reshape(k, w1), device=dev)
    s2 = None
    if w2:
        cols2 = lut[idx2].reshape(-1, w2)
        s2 = torch.as_tensor(np.repeat(cols2, k, axis=0) if cols2.shape[0] == 1
                             else cols2, device=dev)
    if fixed_axis:
        ref_const = torch.zeros((1, k, 3), dtype=torch.float32, device=dev)
        ref_const[..., _AXIS[g2]] = 1.0
    elif g2 == "t0":
        ref_const = _site_dirs(pos[:1], boxes[:1], s1, w1)
    else:
        ref_const = None
    parts = []
    step = _frame_step(3 * (w1 + w2) * k)
    for f0 in range(0, int(pos.shape[0]), step):
        p, bx = pos[f0:f0 + step], boxes[f0:f0 + step]
        v1 = _site_dirs(p, bx, s1, w1)
        ref = _site_dirs(p, bx, s2, w2) if ref_const is None else ref_const
        parts.append(_deg(torch.arccos(_dot(v1, ref).clamp(-1.0, 1.0))))
    ang = _fetch64(parts)
    return {"angles": ang, "mean": ang.mean(axis=1)}


def _com_dist(pos, boxes, c1, w1, c2, w2):
    """`[F, K1, K2]` min-image distances between the weighted unit means
    of two `[K, P]` column tables, in frame and row chunks."""
    f, k2 = int(pos.shape[0]), int(c2.shape[0])
    out = torch.empty((f, int(c1.shape[0]), k2), dtype=torch.float32, device=pos.device)
    per_frame = 3 * max(c1.numel(), c2.numel())
    step = _frame_step(per_frame)
    for f0 in range(0, f, step):
        p, bx = pos[f0:f0 + step], boxes[f0:f0 + step]
        a = _weighted_units(p[:, c1], w1, bx)                    # [b, K1, 3]
        b = _weighted_units(p[:, c2], w2, bx)                    # [b, K2, 3]
        rows = _tile_rows(3 * k2 * p.shape[0], a.shape[1])
        for r0 in range(0, a.shape[1], rows):
            d = _mi(a[:, r0:r0 + rows, None, :] - b[:, None, :, :], bx)
            out[f0:f0 + step, r0:r0 + rows] = _norm(d)
    return out


def pairdist(system, trajectory, group1, group2, *, split: str = "res",
             mode: str = "min", batch_size: int = 32, chunk: int = 16):
    """Per-frame distance matrices between two selections' units (`gmx
    pairdist`).

    Units per `split`: "res" = (chain, resnum) blocks in order of
    appearance, "atom" = one per atom, "group" = the whole selection.
    `mode="min"` gives the smallest minimum-image atom-atom distance
    between units (`ops.distances.residue_min_matrix`); `mode="com"` the
    minimum-image distance between mass-weighted unit centres, each unit
    rebuilt whole around its first atom.

    Returns a dict: 'dist' [F, K1, K2] nm, plus 'resids1/2' and
    'resnames1/2' for split="res"."""
    if split not in ("res", "atom", "group"):
        raise ParallelError(f"split must be res/atom/group, got '{split}'")
    if mode not in ("min", "com"):
        raise ParallelError(f"mode must be min/com, got '{mode}'")
    idx1 = _transient_indices(system, group1)
    idx2 = _transient_indices(system, group2)
    for nm, ix in (("group1", idx1), ("group2", idx2)):
        if ix.size == 0:
            raise GroupError(f"{nm} is empty", code="EmptyGroup")
    _, pos, boxes, lut = _union_window(system, trajectory, "__pairdist_union",
                                np.concatenate([idx1, idx2]), batch_size)
    out = {}

    def units(idx, tag):
        """Local-index blocks into `idx`."""
        if split == "res":
            resids, resnames, blocks = _residue_blocks(system, idx)
            out[f"resids{tag}"] = resids
            out[f"resnames{tag}"] = resnames
            return blocks
        if split == "atom":
            return list(np.arange(idx.size)[:, None])
        return [np.arange(idx.size)]

    u1, u2 = units(idx1, 1), units(idx2, 2)
    k1 = len(u1)
    if mode == "min":
        blocks = [lut[idx1][b] for b in u1] + [lut[idx2][b] for b in u2]
        p = max(len(b) for b in blocks)
        sizes = np.fromiter((len(b) for b in blocks), np.int64, len(blocks))
        block_idx = np.zeros((len(blocks), p), np.int64)
        block_mask = np.arange(p)[None, :] < sizes[:, None]
        block_idx[block_mask] = np.concatenate(blocks)
        m = distance_ops.residue_min_matrix(pos, boxes, block_idx, block_mask,
                                            chunk=chunk)
        out["dist"] = m[:, :k1, k1:].cpu().numpy().astype(np.float64)
        return out
    dev = pos.device
    tables = []
    for idx, ulist in ((idx1, u1), (idx2, u2)):
        cols, w, _, _ = _unit_tables(system, idx, ulist, lut[idx])
        tables += [torch.as_tensor(cols, device=dev), torch.as_tensor(w, device=dev)]
    out["dist"] = _com_dist(pos, boxes, *tables).cpu().numpy().astype(np.float64)
    return out


def select_dynamic(system, trajectory, group, *, within: float | None = None,
                   of: str | None = None, shape=None,
                   whole_res: bool = False, batch_size: int = 32,
                   chunk: int = 8192):
    """Per-frame dynamic selection (`gmx select`).

    For every frame, which atoms of `group` satisfy ONE criterion:
    ``within=r, of=ref`` (minimum-image distance to any atom of `ref`
    below `r`; `[frames, rows, M]` tiles of at most `chunk` candidate
    rows) or ``shape=Shape`` (`Shape.inside`'s semantics,
    `ops.geometry.inside_shape`).  ``whole_res=True`` extends membership to
    every group atom of a touched (chain, resnum) unit.

    Returns a dict: 'indices' [K], 'masks' [F, K] bool, 'sizes' [F]
    (int64), 'occupancy' [K] (fraction of frames selected)."""
    if (within is None) == (shape is None):
        raise ParallelError(
            "select_dynamic needs exactly one criterion: within=r, of=ref "
            "OR shape=Shape")
    if within is not None and of is None:
        raise ParallelError("within=r needs of=<reference selection>")
    idx = _transient_indices(system, group)
    if idx.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    if within is not None:
        ref_idx = _transient_indices(system, of)
        if ref_idx.size == 0:
            raise GroupError(f"reference '{of}' is empty", code="EmptyGroup")
        _, pos, boxes, lut = _union_window(system, trajectory, "__select_union",
                                    np.concatenate([idx, ref_idx]), batch_size)
        dev = pos.device
        cand, ref = _cols(lut, idx, dev), _cols(lut, ref_idx, dev)
        cut2 = torch.tensor(within, dtype=torch.float32, device=dev) ** 2
        per_row = int(ref_idx.size) * (3 if boxes.dim() == 3 else 1)
        rows = _tile_rows(per_row, idx.size, chunk)
        fb = max(1, _CHUNK_ELEMS // (rows * per_row))
        parts = []
        for f0 in range(0, int(pos.shape[0]), fb):
            p, bx = pos[f0:f0 + fb], boxes[f0:f0 + fb]
            pc, pr = p.index_select(1, cand), p.index_select(1, ref)
            parts.append(torch.cat([
                pbc.min_image_norm2_pairs(pc[:, r0:r0 + rows], pr, bx).amin(-1) < cut2
                for r0 in range(0, idx.size, rows)], 1))
        masks = torch.cat(parts).cpu().numpy()
    else:
        _, pos, boxes, lut = _union_window(system, trajectory, "__select_grp", idx, batch_size)
        # raise on unsupported shapes before any frame
        geometry.inside_shape(shape, torch.zeros(1, 1, 3), torch.ones(1, 3))
        cols = _cols(lut, idx, pos.device)
        step = _frame_step(3 * idx.size)
        masks = torch.cat([
            geometry.inside_shape(shape, pos[f0:f0 + step].index_select(1, cols),
                                  boxes[f0:f0 + step])
            for f0 in range(0, int(pos.shape[0]), step)]).cpu().numpy()
    if whole_res:
        _, _, blocks = _residue_blocks(system, idx)
        sizes = np.fromiter((len(b) for b in blocks), np.int64, len(blocks))
        flat = np.concatenate(blocks)
        starts = np.cumsum(sizes) - sizes
        hit = np.logical_or.reduceat(masks[:, flat], starts, axis=1)
        masks = np.empty_like(masks)
        masks[:, flat] = np.repeat(hit, sizes, axis=1)
    return {
        "indices": idx,
        "masks": masks,
        "sizes": masks.sum(axis=1).astype(np.int64),
        "occupancy": masks.mean(axis=0).astype(np.float64),
    }


def saltbr(system, trajectory, group: str = "all", *,
           min_charge: float = 0.5, trunc: float | None = None,
           batch_size: int = 32):
    """Salt-bridge distance series (`gmx saltbr`).

    Charged units are the residues of `group` whose net topology charge
    satisfies |q| >= `min_charge`.  Every charged pair's minimum-image
    mass-weighted COM distance per frame (`pairdist`'s COM tiles); `trunc`
    keeps the pairs whose minimum over the pass is below it.

    Returns a dict: 'dist' [F, P] nm, 'pairs' [P, 2] unit indices, 'kinds'
    [P] in {'++', '--', '+-'}, 'labels' [P] "RESNAME-RESID", 'charges'
    [R], 'resids' [R], 'resnames' [R]."""
    idx = _transient_indices(system, group)
    if idx.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    topo = system.topology
    if not topo.has_charge[idx].all():
        raise GroupError(f"group '{group}' has atoms without charge",
                         code="InvalidCharge")
    resids, resnames, blocks = _residue_blocks(system, idx)
    q_all = np.asarray(topo.charge, np.float64)
    q_res = np.asarray([q_all[idx[b]].sum() for b in blocks])
    keep = np.flatnonzero(np.abs(q_res) >= float(min_charge))
    if keep.size < 2:
        raise GroupError(
            f"need at least 2 residues with |net charge| >= {min_charge}, "
            f"found {keep.size}", code="EmptyGroup")
    charged = np.concatenate([idx[blocks[u]] for u in keep])
    name = "__saltbr_units"
    system.group_create_from_indices(name, np.sort(charged))
    try:
        pd = pairdist(system, trajectory, name, name, split="res", mode="com",
                      batch_size=batch_size)
    finally:
        system.group_remove(name)
    dist = pd["dist"]                                  # [F, R, R]
    iu, ju = np.triu_indices(keep.size, k=1)
    series = dist[:, iu, ju]                           # [F, P]
    if trunc is not None:
        sel = series.min(axis=0) < float(trunc)
        iu, ju, series = iu[sel], ju[sel], series[:, sel]
    q = q_res[keep]
    sign = np.sign(q)
    kinds = np.where(sign[iu] * sign[ju] < 0, "+-",
                     np.where(sign[iu] > 0, "++", "--"))
    labels = np.asarray([f"{resnames[u]}-{resids[u]}" for u in keep], object)
    return {"dist": series, "pairs": np.stack([iu, ju], axis=1), "kinds": kinds,
            "labels": labels, "charges": q, "resids": resids[keep],
            "resnames": resnames[keep]}


def trjorder(system, trajectory, ref_group: str, solvent: str, *,
             mode: str = "atom", da: int = 0, shell: float | None = None,
             output: str | None = None, outfmt: str | None = None,
             out_group: str = "all", batch_size: int = 32,
             chunk: int = 512):
    """Order solvent molecules by distance to a reference group (`gmx
    trjorder`).

    Solvent molecules are the residues of `solvent`.  Per frame, each
    molecule's distance to the CLOSEST `ref_group` atom (min image): from
    its `da`-th atom (`mode="atom"`), from its closest own atom
    (`mode="min"`), or from its mass-weighted COM rebuilt whole
    (`mode="com"`); `[frames, rows, R]` tiles of at most `chunk` molecules'
    sites.  `shell` counts the molecules within that radius per frame.
    With `output`, a host pass writes the trajectory with the solvent
    coordinates permuted into sorted order, restricted to `out_group`.

    Returns a dict: 'dist' [F, M] nm, 'order' [F, M] (stable argsort),
    'nshell' [F] (with `shell`), 'molecules' [M] first-atom indices."""
    if mode not in ("atom", "min", "com"):
        raise ParallelError(f"mode must be atom/min/com, got '{mode}'")
    ridx = _transient_indices(system, ref_group)
    sidx = _transient_indices(system, solvent)
    for nm, ix in (("ref_group", ridx), ("solvent", sidx)):
        if ix.size == 0:
            raise GroupError(f"{nm} is empty", code="EmptyGroup")
    _, pos, boxes, lut = _union_window(system, trajectory, "__trjorder_union",
                                np.concatenate([ridx, sidx]), batch_size)
    _, _, blocks = _residue_blocks(system, sidx)
    sizes = np.fromiter((len(b) for b in blocks), np.int64, len(blocks))
    if mode == "atom":
        if (da >= sizes).any():
            raise GroupError(
                f"da={da} out of range for a {int(sizes[da >= sizes][0])}-atom "
                "molecule", code="InvalidSelection")
        sites = [b[da:da + 1] for b in blocks]
    else:
        sites = blocks
    cols, w, _, _ = _unit_tables(system, sidx, sites, lut[sidx])
    dev = pos.device
    ssz = np.fromiter((len(b) for b in sites), np.int64, len(sites))
    mask = torch.as_tensor(np.arange(cols.shape[1])[None, :] < ssz[:, None], device=dev)
    cols_t, w_t = torch.as_tensor(cols, device=dev), torch.as_tensor(w, device=dev)
    ref = _cols(lut, ridx, dev)
    m_units, r = len(blocks), int(ridx.size)
    width = 1 if mode == "com" else cols.shape[1]
    per_row = width * r * (3 if boxes.dim() == 3 else 1)
    rows = _tile_rows(per_row, m_units, chunk)
    fb = max(1, _CHUNK_ELEMS // (rows * per_row))
    parts = []
    for f0 in range(0, int(pos.shape[0]), fb):
        p, bx = pos[f0:f0 + fb], boxes[f0:f0 + fb]
        b = p.shape[0]
        pr = p.index_select(1, ref)
        row_parts = []
        for r0 in range(0, m_units, rows):
            c, mk = cols_t[r0:r0 + rows], mask[r0:r0 + rows]
            x = p[:, c]                                          # [b, C, P, 3]
            if mode == "com":
                x = _weighted_units(x, w_t[r0:r0 + rows], bx)[:, :, None, :]
                mk = mk[:, :1]
            n_c, n_p = x.shape[1], x.shape[2]
            d2 = pbc.min_image_norm2_pairs(x.reshape(b, n_c * n_p, 3), pr, bx)
            d2 = d2.amin(-1).reshape(b, n_c, n_p)
            row_parts.append(d2.masked_fill_(~mk, 1e30).amin(-1))
        parts.append(torch.cat(row_parts, 1))
    d = np.sqrt(_fetch64(parts))
    order = np.argsort(d, axis=1, kind="stable")
    out = {"dist": d, "order": order,
           "molecules": sidx[np.fromiter((b[0] for b in blocks), np.int64, len(blocks))]}
    if shell is not None:
        out["nshell"] = (d < float(shell)).sum(axis=1).astype(np.int64)
    if output is not None:
        if not isinstance(trajectory, (str, os.PathLike, list)):
            raise ParallelError(
                "trjorder output writing needs the trajectory path(s), "
                "not a DeviceTrajectory")
        if (sizes != sizes[0]).any():
            raise GroupError("reordered output requires equal-size solvent molecules",
                             code="InvalidSelection")
        atom_blocks = sidx[np.stack(blocks)]                     # [M, S]
        slots = atom_blocks.reshape(-1)
        g = "__trjorder_out"
        system.group_create_from_indices(
            g, np.arange(system.topology.n_atoms) if out_group == "all"
            else _transient_indices(system, out_group))
        try:
            files = trajectory if isinstance(trajectory, list) else [trajectory]
            reader = system.traj_cat_iter(files)
            system.group_traj_writer_init(g, output, fmt=outfmt)
            try:
                for f, _ in enumerate(reader):
                    src = atom_blocks[order[f]].reshape(-1)
                    system.positions[slots] = system.positions[src].copy()
                    system.traj_write_frame()
            finally:
                system.traj_writers_close()
        finally:
            system.group_remove(g)
        out["written"] = output
    return out


def pi_mindist(system, trajectory, group: str = "all", *,
               chunk: int = 128, batch_size: int = 32,
               start_time=None, end_time=None, step=None):
    """Shortest distance between a group and its own periodic images
    (`gmx mindist -pi`).

    Per frame: the minimum over the 26 non-zero image shifts S = n @ B and
    all atom pairs (an atom against its own image included) of |x_i - x_j
    + S|, and the group's largest internal distance max_ij |x_i - x_j|
    (`ops.distances.self_image_min`).  `group` is a group name or GSL
    query; `trajectory` a filename or DeviceTrajectory.

    Returns a dict: 'indices' [K], 'times' [F] (ps), 'min_image' [F] and
    'max_internal' [F] (nm)."""
    gsel, pos, boxes, dt = _resident_group_pos(
        system, trajectory, group, batch_size,
        start_time=start_time, end_time=end_time, step=step)
    mn, mx = distance_ops.self_image_min(pos, boxes, chunk=int(chunk))
    return {"indices": gsel, "times": np.asarray(dt.times, np.float64),
            "min_image": _fetch64([mn]), "max_internal": _fetch64([mx])}
