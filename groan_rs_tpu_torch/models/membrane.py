"""Membrane and interfacial-water analyses: leaflets, the electrostatic
potential profile, order parameters, 2D density maps, water orientation
(sorient, h2order), solvent polarisation (spol), tetrahedral order
(hydorder) and interface positions (densorder).

Port of `groan_rs_tpu/models/membrane.py`.  Everything runs on the
System's device (the CUDA card unless the System was built or set with
`device="cpu"`); results come back as numpy in the JAX functions' keys,
shapes, dtypes and units.  Every name is importable as
`groan_rs_tpu_torch.models.<name>` and `models.pipeline.<name>`.

The JAX functions map over frames one at a time (`lax.map`); here the
frames of a call go through batched tensors, in frame chunks that keep
each temporary within `_CHUNK_ELEMS` elements.  The reference centre of
`sorient` and `spol` is one `ops.center.center` call per frame chunk: on
an orthorhombic box that is one K1 and one K2 launch (`center_triclinic`,
plain torch, on a triclinic box).  Everything else is plain torch, as the
JAX functions are jnp outside any Pallas kernel.  Histograms are per-frame
float32 sums through `index_put_(accumulate=True)` (`pipeline._histogram`;
`densmap` one float32 grid over all frames, as in the JAX function), which
sums each bin in a fixed order, so a resident window and a file call give
the same bits.

Where the port differs on purpose:
- `_water_sites` matches hydrogens to oxygens with array operations (a
  stable sort by residue number), not a Python loop over atoms; the error
  names the same first oxygen.
- `hydorder` picks each atom's 4 nearest neighbours by the int64 key
  `(bits of d^2) << 32 | column`, so equal distances keep the lower
  index, as `jax.lax.top_k` does (`torch.topk` promises no order on
  ties).  Its tile is `[frames, rows, W]`, rows capped by the element
  budget; no padding rows.
- `potential_profile` reads a file's boxes with `stop_after=0` (no
  coordinate is decoded; the JAX function decodes every frame whole).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.gridmap import GridMap
from ..errors import GroupError, ParallelError
from ..ops import center as center_ops
from ..ops import pbc
from .pipeline import (
    TrajectoryAnalysis,
    _AXIS,
    _E_OVER_EPS0_NM,
    _Idx,
    _f32,
    _histogram,
    _named_group,
    _resident_group_pos,
    _residue_blocks,
    _sel_indices,
    _system_triclinic,
    _transient_indices,
    _unit_tables,
)

__all__ = ["leaflets", "potential_profile", "order_parameters", "densmap",
           "sorient", "h2order", "spol", "hydorder", "densorder"]

# elements of the largest temporary of one frame chunk (as `ops.msd`)
_CHUNK_ELEMS = 1 << 26


def _mi(d, boxes):
    """Per-frame minimum image of `[B, ..., 3]` displacements: `boxes`
    `[B, 3]` lengths or `[B, 3, 3]` matrices (the exact 27-image search)."""
    return pbc.min_image_frames_any(d, boxes)


def _ctr(pos, boxes, w=None):
    """Refined centre of `[B, K, 3]` per frame, dispatching on the box form:
    K1 + K2 (`center`, one launch each on CUDA) or `center_triclinic`."""
    if boxes.dim() == 3:
        return center_ops.center_triclinic(pos, boxes, weights=w)
    return center_ops.center(pos, boxes, weights=w)


def _frame_step(per_frame: int) -> int:
    """Frames per chunk so that a `per_frame`-element temporary stays
    within `_CHUNK_ELEMS`."""
    return max(1, _CHUNK_ELEMS // max(1, per_frame))


def _taker(cols, device) -> _Idx:
    """Columns of the shipped layout as a slice (a view) when contiguous,
    else an `index_select`."""
    idx = _Idx(cols)
    idx.set_resolved(cols, device)
    return idx


def _fetch64(parts) -> np.ndarray:
    """Per-chunk device tensors, concatenated over frames -> float64 numpy."""
    return torch.cat(parts).cpu().numpy().astype(np.float64)


def _norm(v):
    return torch.sqrt(pbc.norm2(v))


def _axis(axis: str) -> int:
    ax = _AXIS.get(axis)
    if ax is None:
        raise GroupError(f"unknown axis '{axis}' (use 'x'|'y'|'z')",
                         code="InvalidAxis")
    return ax


def leaflets(system, trajectory, heads: str, *, axis: str = "z",
             batch_size: int = 32):
    """Per-frame membrane leaflet assignment and thickness.

    `heads` names ONE head atom per lipid (e.g. a group of "name P").  Per
    frame, the membrane centre along `axis` is the Bai-Breen circular mean
    of the head coordinates (a bilayer wrapped across the box face still
    classifies); each head's minimum-image displacement from that centre
    signs its leaflet.  Thickness is the axis distance between the two
    leaflets' mean head positions.  A triclinic box supports axis 'z' only.

    Returns a dict: 'indices' [L] (head atom indices), 'leaflet' [F, L]
    int32 (+1 upper / -1 lower), 'thickness' [F] (nm), 'center' [F] (nm,
    wrapped into [0, box_axis))."""
    ax = _axis(axis)
    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, heads, batch_size)
    if boxes.dim() == 3:
        # GROMACS lower-triangular H: only the c row has a z component, so
        # z-wraps are exact multiples of H[2, 2]; x/y have no scalar period
        if ax != 2:
            raise ParallelError(
                "leaflets on a triclinic box supports axis='z' only "
                "(x/y have no scalar period under a sheared cell)")
        boxes = boxes[:, :, ax]              # [F, 3] rows' z; [:, 2] = c_z
    if gsel.shape[0] < 2:
        raise GroupError(f"group '{heads}' must name at least 2 head atoms",
                         code="EmptyGroup")
    dev = pos.device
    two_pi = _f32(2 * np.pi, dev)
    z = pos[..., ax]                                      # [F, L]
    lz = boxes[:, ax][:, None]                            # [F, 1]
    theta = torch.remainder(z, lz) * (two_pi / lz)
    xi = torch.cos(theta).mean(1)
    zeta = torch.sin(theta).mean(1)
    center = (torch.atan2(-zeta, -xi) + torch.pi) * lz[:, 0] / two_pi
    d = z - center[:, None]
    d = d - lz * torch.round(d / lz)                      # min image
    up = d >= 0
    leaf = torch.where(up, 1, -1).to(torch.int32)
    zero = torch.zeros((), dtype=d.dtype, device=dev)
    n_up = up.sum(1).clamp_min(1)
    n_dn = (~up).sum(1).clamp_min(1)
    mean_up = torch.where(up, d, zero).sum(1) / n_up
    mean_dn = torch.where(up, zero, d).sum(1) / n_dn
    center = torch.remainder(center, lz[:, 0])
    return {"indices": gsel, "leaflet": leaf.cpu().numpy(),
            "thickness": (mean_up - mean_dn).cpu().numpy(),
            "center": center.cpu().numpy()}


def _box_axis_lengths(trajectory, ax: int) -> np.ndarray:
    """Per-frame float64 box length along `ax` of a DeviceTrajectory or a
    trajectory file (its boxes only: no coordinate is decoded)."""
    from ..parallel.engine import DeviceTrajectory

    if isinstance(trajectory, DeviceTrajectory):
        boxes = trajectory.boxes.cpu().numpy().astype(np.float64)
        if boxes.ndim == 3:
            if ax != 2:
                raise ParallelError(
                    "potential_profile on a triclinic box supports axis='z' "
                    "only (only the c vector has a z component in the "
                    "Gromacs convention)")
            return boxes[:, ax, ax]
        return boxes[:, ax]
    from ..io.traj import open_source

    src = open_source(trajectory)
    b = src.read_batch(np.arange(src.n_frames()), stop_after=0).box_matrices()
    return np.asarray(b[:, ax, ax], np.float64)


def potential_profile(system, trajectory, group: str, *, axis: str = "z",
                      n_bins: int = 100, batch_size: int = 32):
    """Electrostatic potential profile along a box axis (`gmx potential`).

    The per-frame charge density rho(z) is `add_density_profile(mode=
    'charge')` on the device (e/nm^3 in fractional slabs); Poisson's
    equation is then integrated twice per frame on the host in float64
    (E(z) = (1/eps0) int rho dz', psi(z) = -int E dz', rectangle rule on
    the slab grid, psi(0) = 0 at the box bottom) and averaged over frames.

    Returns a dict: 'centers' [n_bins] (nm, mean box), 'rho' [n_bins]
    (e/nm^3, frame mean), 'field' [n_bins] (V/nm), 'psi' [n_bins] (V)."""
    ax = _axis(axis)
    pipe = TrajectoryAnalysis(
        system, device=system.device, triclinic=_system_triclinic(system)
    ).add_density_profile(group, axis=axis, n_bins=n_bins, mode="charge",
                          name="rho")
    out = pipe.runner(group=None, ship="all").run(trajectory, batch_size=batch_size)
    rho = np.asarray(out["rho"], np.float64)              # [F, n_bins]
    lz = _box_axis_lengths(trajectory, ax)
    if rho.shape[0] != lz.shape[0]:
        raise ParallelError("frame count mismatch between profile and box")
    dz = lz / n_bins                                      # [F]
    # E_k = (e/eps0) * sum_{i<=k} rho_i * dz   (V/nm)
    field = _E_OVER_EPS0_NM * np.cumsum(rho, axis=1) * dz[:, None]
    # psi_k = -sum_{i<=k} E_i * dz   (V)
    psi = -np.cumsum(field, axis=1) * dz[:, None]
    centers = (np.arange(n_bins) + 0.5) / n_bins * lz.mean()
    return {"centers": centers, "rho": rho.mean(0),
            "field": field.mean(0), "psi": psi.mean(0)}


def order_parameters(system, trajectory, group: str, *, axis="z",
                     batch_size: int = 32):
    """Trajectory-averaged bond orientational order parameters of a
    selection (`gmx order` / gorder; see `TrajectoryAnalysis.add_order`
    for the per-frame form and the hydrogen rules): one pass, S = (3
    cos^2 theta - 1)/2 averaged over frames, then over each heavy atom's
    bonds.  Returns a dict:

    - 'heavy' [M]: global indices of heavy atoms with >= 1 hydrogen bond
    - 's' [M]: per-heavy-atom mean S (lipid conventions report -s)
    - 'pairs' ([P], [P]): (heavy, hydrogen) global indices per bond
    - 's_pairs' [P]: per-bond trajectory mean S"""
    pipe = TrajectoryAnalysis(
        system, device=system.device, triclinic=_system_triclinic(system)
    ).add_order(group, axis=axis, name="order")
    out = pipe.run(trajectory, batch_size=batch_size)
    c_idx, h_idx = pipe.order_pairs["order"]
    s_pairs = np.asarray(out["order"], np.float64).mean(axis=0)
    heavy, inv = np.unique(c_idx, return_inverse=True)
    sums = np.zeros(heavy.shape[0], np.float64)
    counts = np.zeros(heavy.shape[0], np.int64)
    np.add.at(sums, inv, s_pairs)
    np.add.at(counts, inv, 1)
    return {"heavy": heavy, "s": sums / counts,
            "pairs": (c_idx, h_idx), "s_pairs": s_pairs}


def densmap(system, trajectory, group: str = "all", *, axes: str = "xy",
            bins=(100, 100), weights: str = "number", batch_size: int = 32):
    """2D partial-density map averaged over a trajectory (`gmx densmap`).

    The box is divided into `bins` fractional tiles along the two `axes`
    ("xy"/"xz"/"yz"; along the box vectors of a triclinic cell); each frame
    scatter-adds its atoms' weights ("number", "mass" or "charge") into the
    grid, scaled by that frame's bin volume (box volume / nx / ny).

    Returns a dict: 'map' — a `GridMap` (tile centres in nm of the MEAN
    box) of the time-averaged density (weight units per nm^3), 'density'
    [nx, ny], 'counts' [nx, ny] raw weighted counts (float32 sums, as in
    the JAX function: a tile stops counting ones at 2^24), 'x'/'y' bin
    centres, 'mean_box' [3]."""
    if len(axes) != 2 or axes[0] not in _AXIS or axes[1] not in _AXIS \
            or axes[0] == axes[1]:
        raise ParallelError(f"axes must be two distinct of 'xyz', got '{axes}'")
    i1, i2 = _AXIS[axes[0]], _AXIS[axes[1]]
    nx, ny = int(bins[0]), int(bins[1])
    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    if weights == "number":
        w = np.ones(gsel.shape[0], np.float32)
    elif weights == "mass":
        w = np.asarray(system.topology.mass, np.float32)[gsel]
    elif weights == "charge":
        w = np.asarray(system.topology.charge, np.float32)[gsel]
    else:
        raise ParallelError(
            f"weights must be 'number', 'mass', or 'charge', got '{weights}'")
    dev = pos.device
    f, k = int(pos.shape[0]), int(pos.shape[1])
    wt = torch.as_tensor(w, device=dev)
    tiles = _f32(nx * ny, dev)
    counts = torch.zeros(nx * ny, dtype=torch.float32, device=dev)
    dens = torch.zeros(nx * ny, dtype=torch.float32, device=dev)
    step = _frame_step(3 * k)
    for f0 in range(0, f, step):
        p, bx = pos[f0:f0 + step], boxes[f0:f0 + step]
        if bx.dim() == 3:
            # fractional coordinates along the box VECTORS; volume |det|
            frac = torch.einsum("fki,fij->fkj", p, pbc.box_inverse(bx))
            vol = pbc.box_volume(bx)
        else:
            frac = p / bx[:, None, :]
            vol = torch.prod(bx, 1)
        frac = frac - torch.floor(frac)
        ix = torch.clamp((frac[..., i1] * nx).to(torch.int32), 0, nx - 1)
        iy = torch.clamp((frac[..., i2] * ny).to(torch.int32), 0, ny - 1)
        flat = (ix * ny + iy).reshape(-1).to(torch.int64)
        ww = wt.expand(p.shape[0], k)
        counts.index_put_((flat,), ww.reshape(-1), accumulate=True)
        dens.index_put_((flat,), (ww * (tiles / vol)[:, None]).reshape(-1),
                        accumulate=True)
    counts = counts.reshape(nx, ny).cpu().numpy().astype(np.float64)
    dens = (dens.reshape(nx, ny) / _f32(f, dev)).cpu().numpy().astype(np.float64)
    bx = boxes.cpu().numpy().astype(np.float64)
    # bin centres in nm of the MEAN box: along the box-vector NORMS for
    # triclinic cells (the tiles are fractional along a/b/c)
    mean_box = (np.linalg.norm(bx, axis=-1).mean(axis=0) if bx.ndim == 3
                else bx.mean(axis=0))
    bwx = mean_box[i1] / nx
    bwy = mean_box[i2] / ny
    xs = (np.arange(nx) + 0.5) * bwx
    ys = (np.arange(ny) + 0.5) * bwy
    gm = GridMap.from_vec((xs[0], xs[-1]), (ys[0], ys[-1]), (bwx, bwy),
                          dens.reshape(-1), data_order="row")
    return {"map": gm, "density": dens, "counts": counts, "x": xs, "y": ys,
            "mean_box": mean_box}


def _water_sites(system, oxygen: str, hydrogens: str):
    """Water-like sites: each oxygen matched to exactly two hydrogen atoms
    of the same residue number -> (o_idx [W], h_idx [W, 2]) global
    indices, the hydrogens of a residue in selection order."""
    o = _sel_indices(system, oxygen)
    h = _sel_indices(system, hydrogens)
    if o.size == 0:
        raise GroupError(f"oxygen selection '{oxygen}' is empty",
                         code="EmptyGroup")
    res = np.asarray(system.topology.resnum, np.int64)
    order = np.argsort(res[h], kind="stable")
    h_sorted = h[order].astype(np.int64)
    keys, first, count = np.unique(res[h][order], return_index=True,
                                   return_counts=True)
    ro = res[o]
    if len(keys):
        at = np.minimum(np.searchsorted(keys, ro), len(keys) - 1)
        n_h = np.where(keys[at] == ro, count[at], 0)
    else:
        n_h = np.zeros(o.size, np.int64)
    bad = np.flatnonzero(n_h != 2)
    if bad.size:
        i = int(bad[0])
        raise GroupError(
            f"oxygen atom {int(o[i])} (residue {int(ro[i])}) has "
            f"{int(n_h[i])} matching hydrogens, need exactly 2",
            code="InvalidWater")
    return o, h_sorted[first[at][:, None] + np.arange(2)]


def _union_window(system, trajectory, name, idx, batch_size):
    """The window of the atoms `idx` (through a transient group) and the
    layout column of every atom of the system (-1 where absent)."""
    system.group_create_from_indices(name, idx)
    try:
        gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, name,
                                                  batch_size)
    finally:
        system.group_remove(name)
    lut = np.full(system.topology.n_atoms, -1, np.int64)
    lut[gsel] = np.arange(gsel.size)
    return gsel, pos, boxes, lut


def _bisectors(p, o, h0, h1, bx):
    """Oxygen positions and the two min-image O-H bonds of each water."""
    po = o.take(p)
    return po, _mi(h0.take(p) - po, bx), _mi(h1.take(p) - po, bx)


def sorient(system, trajectory, ref_group: str, *,
            oxygen: str = "name OW", hydrogens: str = "name HW1 HW2",
            rmin: float = 0.0, rmax: float = 0.5, bins: int = 40,
            batch_size: int = 32):
    """Solvent orientation around a reference group (`gmx sorient`).

    For every water whose oxygen lies within (rmin, rmax] of the reference
    COM (refined Bai-Breen, min-image): theta1 is the angle between the
    water dipole bisector and the OUTWARD vector (COM -> oxygen); theta2
    the angle between each O-H bond and the same outward vector.

    Returns a dict: 'cos1_hist'/'cos2_hist' [bins] over cos in [-1, 1]
    (probability densities), 'cos1_edges', 'mean_cos1'/'mean_cos2',
    'n_selected' (total water-frames in the shell), 'r_bins' [bins],
    'mean_cos1_r' [bins] (shell-resolved mean cos theta1 over (0, rmax],
    NaN where empty)."""
    o_idx, h_idx = _water_sites(system, oxygen, hydrogens)
    ridx = np.asarray(system.group_indices(ref_group))
    gsel, pos, boxes, lut = _union_window(
        system, trajectory, "__sorient_union",
        np.union1d(np.union1d(o_idx, h_idx.ravel()), ridx), batch_size)
    dev = pos.device
    o, h0, h1, ref = (_taker(lut[i], dev) for i in
                      (o_idx, h_idx[:, 0], h_idx[:, 1], ridx))
    w_ref = torch.as_tensor(np.asarray(system.topology.mass, np.float32)[ridx],
                            device=dev)
    nb = int(bins)
    tiny = 1e-12

    def hist(c, w):
        i = torch.clamp(((c + 1.0) * (nb / 2.0)).to(torch.int32), 0, nb - 1)
        return _histogram(i, w, nb, torch.float32)

    parts = [[] for _ in range(7)]
    step = _frame_step(3 * max(o_idx.size, ridx.size))
    for f0 in range(0, int(pos.shape[0]), step):
        p, bx = pos[f0:f0 + step], boxes[f0:f0 + step]
        com = _ctr(ref.take(p), bx, w_ref)                # [b, 3]
        po, b1, b2 = _bisectors(p, o, h0, h1, bx)
        out_v = _mi(po - com[:, None, :], bx)
        r = _norm(out_v)
        ou = out_v / r.clamp_min(tiny)[..., None]
        dip = b1 + b2
        dip = dip / _norm(dip).clamp_min(tiny)[..., None]
        c1 = (dip * ou).sum(-1)                           # [b, W]
        c2a = (b1 * ou).sum(-1) / _norm(b1).clamp_min(tiny)
        c2b = (b2 * ou).sum(-1) / _norm(b2).clamp_min(tiny)
        sel = ((r > rmin) & (r <= rmax)).to(torch.float32)
        ri = torch.clamp((r * (nb / rmax)).to(torch.int32), 0, nb - 1)
        inr = (r <= rmax).to(torch.float32)
        for acc, v in zip(parts, (
                hist(c1, sel), hist(c2a, sel) + hist(c2b, sel),
                (c1 * sel).sum(1), ((c2a + c2b) * sel).sum(1), sel.sum(1),
                _histogram(ri, c1 * inr, nb, torch.float32),
                _histogram(ri, inr, nb, torch.float32))):
            acc.append(v)
    h1s, h2s, s1, s2, n, rs, rn = (_fetch64(x).sum(axis=0) for x in parts)
    n = float(n)
    dc = 2.0 / nb
    with np.errstate(invalid="ignore", divide="ignore"):
        return {
            "cos1_hist": h1s / max(n, 1.0) / dc,
            "cos2_hist": h2s / max(2.0 * n, 1.0) / dc,
            "cos1_edges": np.linspace(-1.0, 1.0, nb + 1),
            "mean_cos1": s1 / n if n else np.nan,
            "mean_cos2": s2 / (2 * n) if n else np.nan,
            "n_selected": n,
            "r_bins": (np.arange(nb) + 0.5) * (rmax / nb),
            "mean_cos1_r": np.where(rn > 0, rs / np.maximum(rn, 1), np.nan),
        }


def h2order(system, trajectory, *, oxygen: str = "name OW",
            hydrogens: str = "name HW1 HW2", axis: str = "z",
            bins: int = 50, batch_size: int = 32):
    """Water dipole orientation per slab along a box axis (`gmx h2order`).

    Slabs are fractional along `axis`; per water the cosine between its
    dipole bisector and the +axis direction accumulates into its oxygen's
    slab.  A triclinic box supports axis 'z' only.

    Returns a dict: 'z' [bins] slab centres (nm, mean box), 'cos' [bins]
    mean cos(dipole, axis) (NaN where empty), 'count' [bins] water-frames
    per slab."""
    if axis not in _AXIS:
        raise ParallelError(f"axis must be one of xyz, got '{axis}'")
    ax = _AXIS[axis]
    o_idx, h_idx = _water_sites(system, oxygen, hydrogens)
    gsel, pos, boxes, lut = _union_window(
        system, trajectory, "__h2order_union",
        np.union1d(o_idx, h_idx.ravel()), batch_size)
    nb = int(bins)
    if boxes.dim() == 3 and ax != 2:
        # only the c row has a z component: no other axis has a scalar period
        raise ParallelError("h2order on a triclinic box supports axis='z' only")
    dev = pos.device
    o, h0, h1 = (_taker(lut[i], dev) for i in (o_idx, h_idx[:, 0], h_idx[:, 1]))
    period = boxes[:, ax, ax] if boxes.dim() == 3 else boxes[:, ax]
    one = torch.ones((), dtype=torch.float32, device=dev)
    cs, cn = [], []
    step = _frame_step(3 * o_idx.size)
    for f0 in range(0, int(pos.shape[0]), step):
        p, bx = pos[f0:f0 + step], boxes[f0:f0 + step]
        po, b1, b2 = _bisectors(p, o, h0, h1, bx)
        dip = b1 + b2
        c = dip[..., ax] / _norm(dip).clamp_min(1e-12)
        zf = po[..., ax] / period[f0:f0 + step, None]
        zf = zf - torch.floor(zf)
        i = torch.clamp((zf * nb).to(torch.int32), 0, nb - 1)
        cs.append(_histogram(i, c, nb, torch.float32))
        cn.append(_histogram(i, one, nb, torch.float32))
    cs, cn = _fetch64(cs).sum(axis=0), _fetch64(cn).sum(axis=0)
    period = period.cpu().numpy().astype(np.float64).mean()
    z = (np.arange(nb) + 0.5) * (period / nb)
    with np.errstate(invalid="ignore", divide="ignore"):
        cosm = np.where(cn > 0, cs / np.maximum(cn, 1), np.nan)
    return {"z": z, "cos": cosm, "count": cn}


def spol(system, trajectory, ref_group: str, solvent: str, *,
         rmax: float = 1.0, bins: int = 50, batch_size: int = 32):
    """Solvent dipole orientation against the distance to a solute
    (`gmx spol`).

    Solvent molecules are the residues of `solvent` (charges and masses
    required).  Per frame and molecule, made whole by minimum image around
    its first atom: the molecular dipole about the molecule's own COM and
    the min-image vector from the `ref_group` mass-weighted centre to that
    COM; cos(theta) between them is averaged into `bins` shells of the
    COM-COM distance over (0, rmax].

    Returns a dict: 'r_bins' [bins] shell centres, 'mean_cos_r' [bins]
    (NaN where empty), 'counts' [bins], 'mean_cos', 'n_selected'."""
    from ..system.rmsd import _masses

    ridx = _transient_indices(system, ref_group)
    sidx = _transient_indices(system, solvent)
    for nm, ix in (("ref_group", ridx), ("solvent", sidx)):
        if ix.size == 0:
            raise GroupError(f"{nm} is empty", code="EmptyGroup")
    if not system.topology.has_charge[sidx].all():
        raise GroupError("solvent has atoms without charge", code="InvalidCharge")
    gsel, pos, boxes, _ = _union_window(
        system, trajectory, "__spol_union",
        np.unique(np.concatenate([ridx, sidx])), batch_size)
    dev = pos.device
    _, _, blocks = _residue_blocks(system, sidx)
    cols, w, qt, _ = _unit_tables(system, sidx, blocks,
                                  np.searchsorted(gsel, sidx), charges=True)
    u, pp = cols.shape
    cols_t = torch.as_tensor(cols.reshape(-1), device=dev)
    w_t = torch.as_tensor(w, device=dev)[..., None]
    q_t = torch.as_tensor(qt, device=dev)[..., None]
    ref = _taker(np.searchsorted(gsel, ridx), dev)
    w_ref = torch.as_tensor(np.asarray(_masses(system, "spol ref", ridx),
                                       np.float32), device=dev)
    nb = int(bins)
    cs, cn = [], []
    step = _frame_step(3 * max(u * pp, ridx.size))
    for f0 in range(0, int(pos.shape[0]), step):
        p, bx = pos[f0:f0 + step], boxes[f0:f0 + step]
        ref_com = _ctr(ref.take(p), bx, w_ref)            # [b, 3]
        x = p.index_select(1, cols_t).reshape(p.shape[0], u, pp, 3)
        rel = _mi(x - x[:, :, :1], bx)                    # whole units
        com_rel = (w_t * rel).sum(2)                      # [b, U, 3]
        com = x[:, :, 0] + com_rel
        # dipole about the unit COM: exact for any net charge
        dip = (q_t * (rel - com_rel[:, :, None, :])).sum(2)
        rv = _mi(com - ref_com[:, None, :], bx)
        r = _norm(rv)
        c = (dip * rv).sum(-1) / (r * _norm(dip)).clamp_min(1e-12)
        sel = ((r > 0) & (r <= rmax)).to(torch.float32)
        ri = torch.clamp((r * (nb / rmax)).to(torch.int32), 0, nb - 1)
        cs.append(_histogram(ri, c * sel, nb, torch.float32))
        cn.append(_histogram(ri, sel, nb, torch.float32))
    cs, cn = _fetch64(cs).sum(axis=0), _fetch64(cn).sum(axis=0)
    n = float(cn.sum())
    with np.errstate(invalid="ignore", divide="ignore"):
        return {
            "r_bins": (np.arange(nb) + 0.5) * (rmax / nb),
            "mean_cos_r": np.where(cn > 0, cs / np.maximum(cn, 1), np.nan),
            "counts": cn,
            "mean_cos": cs.sum() / n if n else np.nan,
            "n_selected": n,
        }


def _nearest4(p, pc, r0, bx):
    """The 4 nearest min-image neighbours of the rows `pc` `[b, C, 3]`
    (rows r0.. of `p` `[b, W, 3]`) -> their displacements `[b, C, 4, 3]`
    and distances `[b, C, 4]`, nearest first, equal distances by the lower
    column (`jax.lax.top_k`'s order).  |min image|^2 is
    `pbc.min_image_norm2_pairs`: axis by axis in place, rounded as
    `pbc.min_image` rounds it."""
    b, c, wn = pc.shape[0], pc.shape[1], p.shape[1]
    dev = p.device
    d2 = pbc.min_image_norm2_pairs(pc, p, bx)
    rows = torch.arange(c, device=dev)
    d2[:, rows, rows + r0] = 1e30                         # no self pair
    key = d2.view(torch.int32).to(torch.int64)
    del d2
    key <<= 32
    key |= torch.arange(wn, device=dev)
    top = torch.topk(key, 4, dim=-1, largest=False, sorted=True).values
    del key
    ni = top & 0xFFFFFFFF                                 # [b, C, 4]
    nd2 = (top >> 32).to(torch.int32).view(torch.float32)
    base = (torch.arange(b, device=dev) * wn)[:, None, None]
    pn = p.reshape(-1, 3).index_select(0, (ni + base).reshape(-1))
    v = _mi((pc[:, :, None, :] - pn.reshape(b, c, 4, 3)).reshape(b, c * 4, 3),
            bx).reshape(b, c, 4, 3)
    return v, torch.sqrt(nd2.clamp_min(0.0))


def hydorder(system, trajectory, oxygen: str = "name OW", *,
             axis: str = "z", slabs: int = 0, batch_size: int = 32,
             chunk: int = 256):
    """Tetrahedrality order parameters per water oxygen (`gmx hydorder`).

    For each atom of `oxygen` and frame, its 4 nearest minimum-image
    neighbours within the selection define (Errington & Debenedetti,
    Nature 409:318):
      angle order  S_g = 1 - 3/8 * sum_{j<k} (cos psi_jk + 1/3)^2
      distance order S_k = 1 - 1/3 * sum_k (r_k - rbar)^2 / (4 rbar^2)
    from dense `[frames, rows, W]` distance tiles on the device, at most
    `chunk` rows and `_CHUNK_ELEMS` elements a tile.  With `slabs` > 0,
    atoms bin into fractional slabs along `axis` and per-slab means are
    returned (host numpy, as in the JAX function).

    Returns a dict: 'sg'/'sk' [F, W], 'mean_sg'/'mean_sk' [F], and with
    slabs: 'slab_sg'/'slab_sk' [slabs] pass means (NaN where empty),
    'slab_counts' [slabs]."""
    oidx = _transient_indices(system, oxygen)
    if oidx.size < 5:
        raise GroupError(
            f"need at least 5 atoms for 4-neighbour order parameters, "
            f"selection '{oxygen}' has {oidx.size}", code="EmptyGroup")
    name = "__hydorder_sel"
    system.group_create_from_indices(name, oidx)
    try:
        gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, name,
                                                  batch_size)
    finally:
        system.group_remove(name)
    wn = int(gsel.size)
    ax = _AXIS[axis]
    triclinic = boxes.dim() == 3
    per_row = wn * (3 if triclinic else 1)
    rows = max(1, min(int(chunk), _CHUNK_ELEMS // per_row))
    fb = max(1, _CHUNK_ELEMS // (rows * per_row))
    iu, ju = torch.triu_indices(4, 4, 1, device=pos.device)
    sg_parts, sk_parts = [], []
    for f0 in range(0, int(pos.shape[0]), fb):
        p, bx = pos[f0:f0 + fb], boxes[f0:f0 + fb]
        sg_f, sk_f = [], []
        for r0 in range(0, wn, rows):
            v, r = _nearest4(p, p[:, r0:r0 + rows], r0, bx)
            uv = v / r.clamp_min(1e-12)[..., None]
            cs = (uv[:, :, iu] * uv[:, :, ju]).sum(-1)    # [b, C, 6]
            sg_f.append(1.0 - (3.0 / 8.0) * ((cs + 1.0 / 3.0) ** 2).sum(-1))
            rbar = r.mean(-1)
            sk_f.append(1.0 - ((r - rbar[..., None]) ** 2).sum(-1) / (
                12.0 * rbar.clamp_min(1e-12) ** 2))
        sg_parts.append(torch.cat(sg_f, 1))
        sk_parts.append(torch.cat(sk_f, 1))
    sg, sk = _fetch64(sg_parts), _fetch64(sk_parts)
    out = {"sg": sg, "sk": sk,
           "mean_sg": sg.mean(axis=1), "mean_sk": sk.mean(axis=1)}
    if slabs:
        bx = boxes.cpu().numpy()
        if bx.ndim == 3 and ax != 2:
            raise ParallelError(
                "hydorder slabs on a triclinic box support axis='z' only")
        period = bx[:, ax, ax] if bx.ndim == 3 else bx[:, ax]
        frac = pos[..., ax].cpu().numpy() / period[:, None]
        si = np.clip((np.mod(frac, 1.0) * slabs).astype(np.int64), 0, slabs - 1)
        cnt = np.zeros(slabs)
        ssg = np.zeros(slabs)
        ssk = np.zeros(slabs)
        np.add.at(cnt, si.ravel(), 1.0)
        np.add.at(ssg, si.ravel(), sg.ravel())
        np.add.at(ssk, si.ravel(), sk.ravel())
        with np.errstate(invalid="ignore", divide="ignore"):
            out["slab_sg"] = np.where(cnt > 0, ssg / np.maximum(cnt, 1), np.nan)
            out["slab_sk"] = np.where(cnt > 0, ssk / np.maximum(cnt, 1), np.nan)
        out["slab_counts"] = cnt.astype(np.int64)
    return out


def densorder(system, trajectory, group: str = "all", *, axis: str = "z",
              bins: int = 100, mode: str = "mass", threshold: float = 0.5,
              batch_size: int = 32):
    """Liquid-slab interface positions from per-frame density profiles
    (`gmx densorder`).

    Per frame: the `group` density profile along `axis`
    (`add_density_profile`, fractional slabs), then the two positions where
    it crosses `threshold` x its own maximum — linear interpolation between
    adjacent slab centres, scanning inward from each box edge.  Positions
    are in nm of the per-frame box length (`add_box_lengths` rides the
    same device pass).

    Returns a dict: 'lower'/'upper' [F] nm interface positions,
    'thickness' [F] nm, 'lower_sigma'/'upper_sigma' (std of each
    interface over the pass), 'profiles' [F, bins], 'box_len' [F]."""
    ax = _axis(axis)
    with _named_group(system, group, "__densorder_sel") as g:
        pipe = (TrajectoryAnalysis(system, device=system.device,
                                   triclinic=_system_triclinic(system))
                .add_density_profile(g, axis=axis, n_bins=bins, mode=mode,
                                     name="prof")
                .add_box_lengths(name="blen"))
        out = pipe.runner(group=None, ship="all").run(trajectory,
                                                      batch_size=batch_size)
    prof = np.asarray(out["prof"], np.float64)            # [F, bins]
    box_len = np.asarray(out["blen"], np.float64)[:, ax]
    f = prof.shape[0]
    centers = (np.arange(bins) + 0.5) / bins
    lower = np.full(f, np.nan)
    upper = np.full(f, np.nan)
    for i in range(f):
        p = prof[i]
        lvl = float(threshold) * p.max()
        if p.max() <= 0:
            continue
        above = p >= lvl
        if not above.any():
            continue
        j0 = int(np.argmax(above))                         # first slab >= lvl
        j1 = bins - 1 - int(np.argmax(above[::-1]))        # last slab >= lvl
        if j0 > 0:
            a, b = p[j0 - 1], p[j0]
            frac = centers[j0 - 1] + (lvl - a) / (b - a) / bins
        else:
            frac = centers[0]
        lower[i] = frac * box_len[i]
        if j1 < bins - 1:
            a, b = p[j1], p[j1 + 1]
            frac = centers[j1] + (a - lvl) / (a - b) / bins
        else:
            frac = centers[-1]
        upper[i] = frac * box_len[i]
    return {"lower": lower, "upper": upper,
            "thickness": upper - lower,
            "lower_sigma": float(np.nanstd(lower)),
            "upper_sigma": float(np.nanstd(upper)),
            "profiles": prof, "box_len": box_len}
