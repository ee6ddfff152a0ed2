"""Conformational analyses: fits, RMSF, PCA, entropy, clustering, distance
matrices, secondary structure, dihedral statistics, morphing and modes.

Port of `groan_rs_tpu/models/structure.py`.  Every device step is torch on
the System's device (the CUDA card unless the System was built or set with
`device="cpu"`).  The orthorhombic fits take each frame's refined COM from
`ops.center.center`, i.e. the K1 + K2 kernels on the card, once per
`[F, K, 3]` window; the covariance, `eigh` and distance tiles are plain
torch, as they are XLA outside any Pallas kernel in the JAX package.
What the JAX functions compute on the host (clustering, overlaps, cosine
content, mode trajectories, cluster labelling) stays host numpy here.
Shared loaders live in `models.pipeline`; every name is importable as
`groan_rs_tpu_torch.models.<name>` and `models.pipeline.<name>`.

`dssp` evaluates the `[F, R, R]` energy tensor and the Kabsch-Sander
pattern algebra frame chunk by frame chunk on the device
(`ops.dssp.codes`), where the JAX function ships the whole tensor to the
host.  `pca(mesh=...)` raises: multi-device is not ported.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..errors import GroupError, ParallelError, RMSDError
from ..ops import center as center_ops
from ..ops import distances as distance_ops
from ..ops import pbc
from ..ops import rmsd as rmsd_ops
from .pipeline import (
    TrajectoryAnalysis,
    _CHI_SITES,
    _blocks_by_key,
    _group_frames,
    _named_group,
    _resident_group_pos,
    _residue_blocks,
    _transient_indices,
    _window_pos,
)

__all__ = ["rmsf", "pca", "entropy", "rmsd_matrix", "cluster", "mdmat",
           "dssp", "ramachandran", "chi", "rotmat", "dccm", "rmsdist",
           "clustsize", "morph", "subspace_overlap", "cosine_content",
           "mode_traj"]


def _group_window(system, trajectory, group, batch_size):
    """The group's indices and its window (DeviceTrajectory, columns)."""
    gsel = np.asarray(system.group_indices(group))
    if gsel.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    dt, cols = _group_frames(system, trajectory, group, gsel, batch_size)
    return gsel, dt, cols


def _reference_masses(system, group, gsel, reference):
    """(reference System, its group indices, float32 masses); the group
    must have as many atoms in the reference as in the target."""
    from ..system.rmsd import _masses

    ref_sys = system if reference is None else reference
    ref_idx = np.asarray(ref_sys.group_indices(group))
    if ref_idx.shape[0] != gsel.shape[0]:
        raise RMSDError(
            f"group '{group}' has {ref_idx.shape[0]} atoms in reference "
            f"but {gsel.shape[0]} in target", code="InconsistentGroup")
    return ref_sys, ref_idx, np.asarray(_masses(ref_sys, group, ref_idx), np.float32)


def _fit_inputs(system, dt, cols, group, gsel, reference):
    """Shared rmsf/pca/dccm setup: the group's float32 positions and
    per-frame boxes on the System's device, the fit masses, and a
    `fit_frames(pos, boxes, fit)` closure applying the batched
    mass-weighted least-squares fit onto the reference structure
    (rmsd.rs:508-533 semantics)."""
    from ..system.rmsd import _extract

    dev = system.device
    ref_sys, ref_idx, w = _reference_masses(system, group, gsel, reference)
    pos, boxes = _window_pos(dt, cols, dev)
    wj = torch.as_tensor(w, device=dev)

    if boxes.dim() == 3:
        # triclinic fit (calc_rmsd itself is orthogonal-only): unwrap the
        # group around its exact triclinic refined COM, rotate about the
        # group centroid, translate onto the reference group COM
        ref_com = torch.as_tensor(
            np.asarray(ref_sys.group_get_com_triclinic(group), np.float32), device=dev)
        ref_prep, ref_ctr = rmsd_ops.prepare_coords_triclinic(
            torch.as_tensor(np.asarray(ref_sys.positions[ref_idx], np.float32), device=dev),
            torch.as_tensor(np.asarray(ref_sys.get_box().to_matrix(), np.float32),
                            device=dev), weights=wj)

        def fit_frames(pos, boxes, fit):
            com = center_ops.center_triclinic(pos, boxes, weights=wj)
            if fit:
                rot, _ = rmsd_ops.rmsd_frames_triclinic(ref_prep, ref_ctr, pos,
                                                        boxes, wj)
                unwrapped = com[:, None, :] + pbc.min_image_triclinic_frames(
                    pos - com[:, None, :], boxes)
                cq = (wj[None, :, None] * unwrapped).sum(1) / wj.sum()
                centered = unwrapped - cq[:, None, :]
                return torch.einsum("fni,fji->fnj", centered, rot) + ref_com
            return pos + (ref_com - com)[:, None, :]

        return pos, boxes, w, fit_frames

    ref_coords, ref_center, _, ref_com = _extract(ref_sys, group)
    ref_coords = torch.as_tensor(ref_coords, device=dev)
    ref_center = torch.as_tensor(np.asarray(ref_center, np.float32), device=dev)
    ref_com = torch.as_tensor(np.asarray(ref_com, np.float32), device=dev)

    def fit_frames(pos, boxes, fit):
        com = center_ops.center(pos, boxes[:, None, :], weights=wj)   # K1 + K2
        if fit:
            rot, _ = rmsd_ops.rmsd_frames(ref_coords, ref_center, pos, boxes,
                                          wj, com=com)
            # translate the group COM to the box centre (wrapping), rotate
            # about it by R^T (row vectors), translate to the reference COM
            bc = boxes * 0.5
            moved = pbc.wrap(pos + (bc - com)[:, None, :], boxes[:, None, :])
            centered = moved - bc[:, None, :]
            return torch.einsum("fni,fji->fnj", centered, rot) + ref_com
        return pos + (ref_com - com)[:, None, :]

    return pos, boxes, w, fit_frames


def rmsf(system, trajectory, group: str, *, reference=None, fit: bool = True,
         batch_size: int = 32):
    """Per-atom root-mean-square fluctuation of a selection (`gmx rmsf`):
    every frame least-squares fitted onto the reference structure (default
    `system` itself) with the group's masses as weights, then
    RMSF_i = sqrt(<|x_i(t) - <x_i>_t|^2>_t).  With `fit=False` frames are
    only translated (group COM to the reference COM).

    `trajectory` is a filename (loaded through `runner(group=group)`) or a
    `DeviceTrajectory` whose layout contains the group.  Returns
    `(indices [n], rmsf [n] nm)`."""
    gsel, dt, cols = _group_window(system, trajectory, group, batch_size)
    pos, boxes, _, fit_frames = _fit_inputs(system, dt, cols, group, gsel,
                                            reference)
    fitted = fit_frames(pos, boxes, fit)
    d = fitted - fitted.mean(0)[None]
    return gsel, torch.sqrt((d * d).sum(-1).mean(0)).cpu().numpy()


def _pca_math(fitted, sw, k):
    """Deviations -> covariance -> eigh -> projections: (mean [K, 3],
    eigenvalues descending [3K], eigenvectors [3K, 3K] as columns, each
    with its largest-magnitude entry positive, projections [F, 3K], trace)."""
    f = fitted.shape[0]
    mean = fitted.sum(0) / f
    x = ((fitted - mean[None]) * sw[None, :, None]).reshape(f, 3 * k)
    cov = (x.T @ x) / f
    evals, evecs = torch.linalg.eigh(cov)          # ascending
    evals, evecs = evals.flip(0), evecs.flip(1)
    amax = evecs.abs().argmax(0)
    sign = torch.sign(evecs[amax, torch.arange(3 * k, device=evecs.device)])
    evecs = evecs * torch.where(sign == 0, 1.0, sign)[None]
    return mean, evals, evecs, x @ evecs, torch.trace(cov)


def pca(system, trajectory, group: str, *, n_components: int | None = None,
        reference=None, fit: bool = True, mass_weighted: bool = True,
        batch_size: int = 32, mesh=None):
    """Principal component analysis of positional fluctuations (`gmx
    covar` + `gmx anaeig`): every frame fitted as in `rmsf`, the 3K x 3K
    covariance of the (optionally sqrt-mass-weighted) deviations in one
    `[F, 3K]^T @ [F, 3K]` product, its `eigh`, and the frames' projections
    onto the eigenvectors, on the System's device.  Eigenvector signs are
    fixed (largest-magnitude component positive).

    Returns a dict: 'indices' [K], 'mean' [K, 3] nm, 'eigenvalues' [n]
    descending, 'eigenvectors' [n, K, 3], 'projections' [F, n], 'trace'
    (sum of all eigenvalues), 'mass_weighted', 'sqrt_weights' [K]."""
    if mesh is not None:
        from ..parallel.engine import _LATER_MESH

        raise ParallelError(f"pca(mesh=...) is {_LATER_MESH}")
    gsel, dt, cols = _group_window(system, trajectory, group, batch_size)
    pos, boxes, w, fit_frames = _fit_inputs(system, dt, cols, group, gsel,
                                            reference)
    k = int(gsel.shape[0])
    f = int(pos.shape[0])
    if f < 2:
        raise ParallelError(f"pca needs at least 2 frames (trajectory has {f})")
    sw_np = (np.sqrt(np.asarray(w, np.float32)) if mass_weighted
             else np.ones((k,), np.float32))
    mean, evals, evecs, proj, trace = (
        t.cpu().numpy() for t in _pca_math(
            fit_frames(pos, boxes, fit), torch.as_tensor(sw_np, device=pos.device), k))
    n = 3 * k if n_components is None else min(int(n_components), 3 * k)
    return {
        "indices": gsel,
        "mean": mean,
        "eigenvalues": evals[:n],
        "eigenvectors": evecs[:, :n].T.reshape(n, k, 3),
        "projections": proj[:, :n],
        "trace": float(trace),
        "mass_weighted": bool(mass_weighted),
        "sqrt_weights": sw_np.astype(np.float64),
    }


def rmsd_matrix(system, trajectory, group: str, *, batch_size: int = 32,
                chunk: int = 8):
    """All-pairs fitted RMSD matrix of a trajectory (`gmx rms -m`), every
    pair scored with the `calc_rmsd` convention (`ops.rmsd.rmsd_matrix`;
    triclinic boxes unwrap around the triclinic refined COM first).
    Returns `(indices [K], matrix [F, F])` in nm."""
    from ..system.rmsd import _masses

    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    w = _masses(system, group, gsel)
    return gsel, rmsd_ops.rmsd_matrix(pos, boxes, w, chunk=chunk).cpu().numpy()


def cluster(system, trajectory=None, group: str | None = None, *,
            cutoff: float = 0.1, method: str = "gromos",
            jp_m: int = 10, jp_p: int = 3, matrix=None,
            batch_size: int = 32, chunk: int = 8):
    """Conformational clustering (the `gmx cluster` methods) of the
    all-pairs RMSD matrix (`rmsd_matrix`, or a precomputed `matrix`):

    - 'gromos': take the frame with the most neighbours within `cutoff`
      as a centre, assign it and its neighbours, remove, repeat (ties to
      the lowest index);
    - 'linkage': connected components of the d < cutoff graph;
    - 'jarvis-patrick': frames in each other's `jp_m` nearest neighbours
      sharing at least `jp_p` of them (`cutoff` ignored).

    Returns a dict: 'labels' [F] (0 = largest cluster), 'centers' [C]
    (gromos: the centre; else the medoid), 'sizes' [C], 'matrix' [F, F].
    Host numpy, as in the JAX package."""
    if matrix is None:
        if trajectory is None or group is None:
            raise ParallelError(
                "cluster needs (trajectory, group) or a precomputed matrix")
        _, matrix = rmsd_matrix(system, trajectory, group,
                                batch_size=batch_size, chunk=chunk)
    matrix = np.asarray(matrix)
    f = matrix.shape[0]
    if matrix.shape != (f, f):
        raise ParallelError(f"matrix must be square, got {matrix.shape}")

    if method == "gromos":
        neigh = matrix < float(cutoff)
        np.fill_diagonal(neigh, True)      # a frame is its own neighbour
        alive = np.ones(f, bool)
        labels = np.full(f, -1, np.int64)
        centers, sizes = [], []
        while alive.any():
            counts = (neigh & alive[None, :]).sum(axis=1)
            counts[~alive] = -1
            c = int(np.argmax(counts))     # ties -> lowest index
            members = neigh[c] & alive
            labels[members] = len(centers)
            centers.append(c)
            sizes.append(int(members.sum()))
            alive &= ~members
        return {"labels": labels, "centers": np.asarray(centers, np.int64),
                "sizes": np.asarray(sizes, np.int64), "matrix": matrix}

    if method == "linkage":
        adj = matrix < float(cutoff)
        np.fill_diagonal(adj, False)
    elif method == "jarvis-patrick":
        if jp_m < 1 or jp_m >= f:
            raise ParallelError(f"jp_m must be in [1, {f - 1}], got {jp_m}")
        # nearest-neighbour lists exclude self
        order = np.argsort(matrix + np.diag(np.full(f, np.inf)),
                           axis=1, kind="stable")[:, :jp_m]
        nn = np.zeros((f, f), bool)
        nn[np.repeat(np.arange(f), jp_m), order.reshape(-1)] = True
        mutual = nn & nn.T
        shared = (nn.astype(np.int32) @ nn.T.astype(np.int32)) >= jp_p
        adj = mutual & shared
        np.fill_diagonal(adj, False)
    else:
        raise ParallelError(
            f"method must be 'gromos', 'linkage', or 'jarvis-patrick', "
            f"got '{method}'")

    # connected components of adj, clusters ordered largest-first
    comp = _connected_components(adj)
    uniq, counts = np.unique(comp, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    labels = np.full(f, -1, np.int64)
    centers, sizes = [], []
    for new_id, ci in enumerate(order):
        members = np.flatnonzero(comp == uniq[ci])
        labels[members] = new_id
        sub = matrix[np.ix_(members, members)]
        centers.append(int(members[np.argmin(sub.sum(axis=1))]))
        sizes.append(len(members))
    return {"labels": labels, "centers": np.asarray(centers, np.int64),
            "sizes": np.asarray(sizes, np.int64), "matrix": matrix}


def _blocks_table(blocks):
    """Padded `[R, P]` index table and validity mask of index blocks."""
    p = max(len(b) for b in blocks)
    block_idx = np.zeros((len(blocks), p), np.int64)
    block_mask = np.zeros((len(blocks), p), bool)
    for i, b in enumerate(blocks):
        block_idx[i, :len(b)] = b
        block_mask[i, :len(b)] = True
    return block_idx, block_mask


def mdmat(system, trajectory, group: str, *, per_frame: bool = False,
          batch_size: int = 32, chunk: int = 16):
    """Residue-residue smallest-distance matrix (`gmx mdmat`): for every
    frame and residue pair of `group`, the smallest minimum-image atom-atom
    distance (`ops.distances.residue_min_matrix`; triclinic boxes take the
    exact 27-image minimum image).  Residues are (chain, resnum) blocks in
    order of appearance.

    Returns a dict: 'resids' [R], 'resnames' [R], 'mean' [R, R] nm, and
    with `per_frame=True` 'frames' [F, R, R]."""
    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    resids, resnames, blocks = _residue_blocks(system, gsel)
    m = distance_ops.residue_min_matrix(pos, boxes, *_blocks_table(blocks),
                                        chunk=chunk).cpu().numpy()
    out = {"resids": resids, "resnames": resnames, "mean": m.mean(axis=0)}
    if per_frame:
        out["frames"] = m
    return out


def dssp(system, trajectory, group: str, *, states: int = 3,
         batch_size: int = 32):
    """Secondary structure per residue per frame (Kabsch-Sander): `states=3`
    gives H/E/-, `states=8` the DSSP codes H/G/I/E/B/T/S/-.

    Backbone N/CA/C/O atoms are collected per residue of `group` (the
    amide H estimated from the backbone); the energies and the pattern
    algebra run frame chunk by frame chunk on the System's device
    (`ops.dssp.codes`; triclinic boxes use the exact minimum image).
    Prolines and chain starts or gaps are never donors; patterns never span
    chain breaks.

    Returns a dict: 'resids' [R], 'resnames' [R], 'ss' [F, R] (state
    codes), 'frac' {code: float}."""
    from ..ops import dssp as dssp_ops

    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    resids, resnames, blocks = _residue_blocks(system, gsel)

    topo = system.topology
    names = np.asarray(topo.atomname.categories, object)[topo.atomname.codes[gsel]]
    bb, keep = {}, []
    for i, b in enumerate(blocks):
        slot = {}
        for local in b:
            nm = names[local]
            if nm in ("N", "CA", "C", "O") and nm not in slot:
                slot[nm] = int(local)
        # terminal oxygens are sometimes named OC1/O1/OT1
        if "O" not in slot:
            for local in b:
                if names[local] in ("OC1", "O1", "OT1"):
                    slot["O"] = int(local)
                    break
        if len(slot) == 4:
            bb[i] = slot
            keep.append(i)
    if len(keep) < 5:
        raise GroupError(
            f"group '{group}' has {len(keep)} residues with a complete "
            "N/CA/C/O backbone; dssp needs at least 5", code="InvalidSelection")

    resids = resids[keep]
    resnames = resnames[keep]
    chain_of = np.asarray(topo.chain.codes)[gsel[[bb[i]["CA"] for i in keep]]]
    # consec[i]: residue i+1 directly follows residue i
    consec = np.zeros(len(keep), bool)
    consec[:-1] = (resids[1:] == resids[:-1] + 1) & (chain_of[1:] == chain_of[:-1])
    donor_ok = np.ones(len(keep), bool)
    donor_ok[0] = False
    donor_ok[1:] = consec[:-1]          # needs C/O of the previous residue
    donor_ok &= np.asarray([rn != "PRO" for rn in resnames])

    if states not in (3, 8):
        raise ParallelError(f"states must be 3 or 8, got {states}")
    j = {nm: torch.as_tensor([bb[i][nm] for i in keep], device=pos.device)
         for nm in ("N", "CA", "C", "O")}
    ss = dssp_ops.codes(pos[:, j["N"]], pos[:, j["CA"]], pos[:, j["C"]],
                        pos[:, j["O"]], boxes, donor_ok, consec, states=states)
    table = dssp_ops.CODES3 if states == 3 else dssp_ops.CODES8
    flat = ss.ravel()
    return {"resids": resids, "resnames": resnames, "ss": ss,
            "frac": {c: float((flat == c).mean()) for c in table}}


def _residue_atoms(system, idx, wanted=None):
    """Residues of atoms `idx` by (chain, resnum) in order of appearance ->
    (order [(chain, resnum)], {key: {name: first atom of that name}}),
    keeping only `wanted` names when given."""
    topo = system.topology
    _, _, blocks = _residue_blocks(system, idx)
    names = np.asarray(topo.atomname.categories, object)[topo.atomname.codes[idx]]
    order, residues = [], {}
    for b in blocks:
        key = (topo.chain.get(int(idx[b[0]])), int(topo.resnum[idx[b[0]]]))
        slot = residues[key] = {}
        order.append(key)
        for local in b:
            if (wanted is None or names[local] in wanted) and names[local] not in slot:
                slot[names[local]] = int(idx[local])
    return order, residues


def ramachandran(system, trajectory, group: str, *, batch_size: int = 32,
                 triclinic: bool = False):
    """Backbone phi/psi dihedrals per residue per frame (`gmx rama`):
    phi_i = C(i-1)-N(i)-CA(i)-C(i), psi_i = N(i)-CA(i)-C(i)-N(i+1) from
    atom names within `group`; residues pair only when adjacent (same
    chain, resnum difference 1); only residues with both angles are
    reported.  One `add_dihedrals` pass on the System's device.

    Returns a dict: 'resids' [R], 'resnames' [R], 'phi' [F, R], 'psi'
    [F, R] (signed degrees)."""
    idx = np.asarray(system.group_indices(group))
    if idx.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    order, residues = _residue_atoms(system, idx, ("N", "CA", "C"))

    phi_sites, psi_sites, out_keys = [], [], []
    for i, key in enumerate(order):
        r = residues[key]
        if not all(n in r for n in ("N", "CA", "C")):
            continue
        prev = order[i - 1] if i > 0 else None
        nxt = order[i + 1] if i + 1 < len(order) else None
        has_phi = (prev is not None and prev[0] == key[0]
                   and prev[1] == key[1] - 1 and "C" in residues[prev])
        has_psi = (nxt is not None and nxt[0] == key[0]
                   and nxt[1] == key[1] + 1 and "N" in residues[nxt])
        if has_phi and has_psi:
            phi_sites.append([residues[prev]["C"], r["N"], r["CA"], r["C"]])
            psi_sites.append([r["N"], r["CA"], r["C"], residues[nxt]["N"]])
            out_keys.append(key)
    if not out_keys:
        raise GroupError(
            f"group '{group}' has no residue with both phi and psi "
            "(needs N/CA/C names and adjacent residues)", code="InvalidSelection")

    out = (TrajectoryAnalysis(system, device=system.device, triclinic=triclinic)
           .add_dihedrals(np.asarray(phi_sites), name="phi")
           .add_dihedrals(np.asarray(psi_sites), name="psi")
           .run(trajectory, batch_size=batch_size))
    topo = system.topology
    return {"resids": np.asarray([k[1] for k in out_keys], np.int64),
            "resnames": np.asarray([topo.resname.get(residues[k]["CA"])
                                    for k in out_keys], object),
            "phi": np.asarray(out["phi"]), "psi": np.asarray(out["psi"])}


def entropy(system, trajectory, group: str, *, temperature: float = 300.0,
            reference=None, fit: bool = True, batch_size: int = 32):
    """Configurational entropy from the mass-weighted positional PCA
    (`gmx anaeig -entropy`): Schlitter's upper bound
    S = (kB/2) sum ln(1 + kB T e^2 lambda_i / hbar^2) and the
    quasi-harmonic estimate (Andricioaei & Karplus), per mode
    alpha_i = hbar omega_i / kB T with omega_i = sqrt(kB T / lambda_i),
    S = kB sum [alpha/(e^alpha - 1) - ln(1 - e^-alpha)]; near-zero modes
    clamp at 0.  Float64 on the host over the eigenvalues.

    Returns a dict: 'schlitter' and 'quasiharmonic' kJ/(mol K),
    'eigenvalues' [3K] amu nm^2 descending, 'alphas' [3K] (inf for
    clamped modes)."""
    if not temperature > 0:
        raise ParallelError("temperature must be positive")
    res = pca(system, trajectory, group, reference=reference, fit=fit,
              mass_weighted=True, batch_size=batch_size)
    lam = np.asarray(res["eigenvalues"], np.float64)

    kb_j = 1.380649e-23            # J/K, per molecule
    hbar = 1.0545718176e-34        # J s
    amu_nm2 = 1.66053906660e-27 * 1e-18   # amu nm^2 -> kg m^2
    kb_kj = 8.31446261815324e-3    # kJ/(mol K)

    lam_si = np.clip(lam, 0.0, None) * amu_nm2
    kbt = kb_j * float(temperature)
    arg = kbt * lam_si * np.e ** 2 / hbar ** 2
    s_schlitter = 0.5 * kb_kj * float(np.log1p(arg).sum())

    with np.errstate(divide="ignore"):
        alpha = hbar / np.sqrt(kbt * lam_si)   # = hbar omega / kB T
    a = alpha[lam_si > 0]
    with np.errstate(over="ignore"):
        s_qh = kb_kj * float((a / np.expm1(a) - np.log1p(-np.exp(-a))).sum())
    return {"schlitter": s_schlitter, "quasiharmonic": s_qh,
            "eigenvalues": lam, "alphas": alpha}


def rotmat(system, trajectory, group: str, *, reference=None,
           batch_size: int = 32):
    """Per-frame least-squares rotation matrices onto a reference
    structure (`gmx rotmat`), with the `calc_rmsd` convention:
    `matrices[f]` is the proper rotation R with
    `x_ref ~ R @ (x_frame - com_frame) + com_ref`.

    Returns a dict: 'indices' [K], 'matrices' [F, 3, 3], 'rmsd' [F] nm
    (the fitted RMSD of each frame, as `add_rmsd`)."""
    from ..system.rmsd import _extract

    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    ref_sys, ref_idx, w = _reference_masses(system, group, gsel, reference)
    dev = pos.device
    wj = torch.as_tensor(w, device=dev)
    if boxes.dim() == 3:
        ref_prep, ref_ctr = rmsd_ops.prepare_coords_triclinic(
            torch.as_tensor(np.asarray(ref_sys.positions[ref_idx], np.float32), device=dev),
            torch.as_tensor(np.asarray(ref_sys.get_box().to_matrix(), np.float32),
                            device=dev), weights=wj)
        rot, r = rmsd_ops.rmsd_frames_triclinic(ref_prep, ref_ctr, pos, boxes, wj)
    else:
        ref_coords, ref_center, _, _ = _extract(ref_sys, group)
        rot, r = rmsd_ops.rmsd_frames(
            torch.as_tensor(ref_coords, device=dev),
            torch.as_tensor(np.asarray(ref_center, np.float32), device=dev),
            pos, boxes, wj)
    return {"indices": gsel, "matrices": rot.cpu().numpy(), "rmsd": r.cpu().numpy()}


def dccm(system, trajectory, group: str, *, reference=None, fit: bool = True,
         batch_size: int = 32):
    """Dynamic cross-correlation matrix of atomic fluctuations (Ichiye &
    Karplus 1991): frames fitted as in `rmsf`, then with dr_i(f) = x_i(f)
    - <x_i> the covariance C_ij = <dr_i . dr_j> (one `[F, K, 3] x [F, K, 3]`
    einsum) and DCCM_ij = C_ij / sqrt(C_ii C_jj) with an exact unit
    diagonal.

    Returns a dict: 'indices' [K], 'dccm' [K, K], 'covariance' [K, K] nm^2."""
    gsel, dt, cols = _group_window(system, trajectory, group, batch_size)
    pos, boxes, _, fit_frames = _fit_inputs(system, dt, cols, group, gsel,
                                            reference)
    f = int(pos.shape[0])
    if f < 2:
        raise ParallelError(f"dccm needs at least 2 frames (trajectory has {f})")
    fitted = fit_frames(pos, boxes, fit)
    d = fitted - fitted.mean(0)[None]
    c = torch.einsum("fid,fjd->ij", d, d) / f
    var = torch.diagonal(c)
    m = c / torch.sqrt(torch.clamp(var[:, None] * var[None, :], min=1e-30))
    m.fill_diagonal_(1.0)               # exact unit diagonal
    return {"indices": gsel, "dccm": m.cpu().numpy(), "covariance": c.cpu().numpy()}


def _connected_components(adj):
    """Connected components of a boolean [M, M] adjacency -> labels [M]
    (0-based, numbered by first appearance)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    m = adj.shape[0]
    if m == 0:
        return np.zeros(0, np.int64)
    i, j = np.nonzero(np.triu(adj, 1))
    _, comp = connected_components(
        coo_matrix((np.ones(i.shape[0], np.int8), (i, j)), shape=(m, m)),
        directed=False)
    _, first = np.unique(comp, return_index=True)
    rank = np.empty(first.shape[0], np.int64)
    rank[np.argsort(first)] = np.arange(first.shape[0])
    return rank[comp]


def clustsize(system, trajectory, group: str = "all", *,
              cutoff: float = 0.35, mode: str = "molecule",
              batch_size: int = 32, chunk: int = 16):
    """Aggregate / cluster-size analysis (`gmx clustsize`): entities (the
    molecules of `group` by the bond graph, or single atoms with
    `mode="atom"`) connect when their smallest minimum-image atom-atom
    distance is below `cutoff` nm; the connected components per frame are
    the clusters.  The contact matrix is the mdmat tile on the device
    (`ops.distances.residue_min_matrix`), the labelling host numpy.

    Returns a dict: 'mode', 'n_entities' M, 'times' [F], 'labels' [F, M]
    (numbered by first member), 'n_clusters' [F], 'max_size' [F],
    'mean_size' [F], 'mean_size_w' [F] (sum(s^2)/sum(s)), 'size_hist'
    [M + 1]."""
    if mode not in ("molecule", "atom"):
        raise ParallelError(
            f"clustsize mode must be 'molecule' or 'atom', got {mode!r}")
    gsel, pos, boxes, dt = _resident_group_pos(system, trajectory, group, batch_size)
    if mode == "molecule":
        _, blocks = _blocks_by_key(np.asarray(system.topology.molecule_ids())[gsel])
    else:
        blocks = [np.asarray([i]) for i in range(len(gsel))]
    m = len(blocks)
    dmin = distance_ops.residue_min_matrix(pos, boxes, *_blocks_table(blocks),
                                           chunk=chunk)
    adj_all = (dmin < cutoff).cpu().numpy()                  # [F, M, M]
    f = adj_all.shape[0]
    labels = np.empty((f, m), np.int64)
    n_clusters = np.empty(f, np.int64)
    max_size = np.empty(f, np.int64)
    mean_w = np.empty(f, np.float64)
    hist = np.zeros(m + 1, np.int64)
    for fi in range(f):
        lab = _connected_components(adj_all[fi])
        labels[fi] = lab
        sizes = np.bincount(lab)
        n_clusters[fi] = len(sizes)
        max_size[fi] = sizes.max()
        mean_w[fi] = (sizes.astype(np.float64) ** 2).sum() / sizes.sum()
        hist[: sizes.max() + 1] += np.bincount(sizes)[: sizes.max() + 1]
    return {"mode": mode, "n_entities": m,
            "times": np.asarray(dt.times, np.float64),
            "labels": labels, "n_clusters": n_clusters, "max_size": max_size,
            "mean_size": m / n_clusters.astype(np.float64),
            "mean_size_w": mean_w, "size_hist": hist}


def rmsdist(system, trajectory, group: str, *, reference=None,
            pbc_aware: bool = False, batch_size: int = 32, chunk: int = 256):
    """RMS deviation of intra-group atom-pair distances per frame against a
    reference structure (`gmx rmsdist`):
    RMSdist(t) = sqrt(mean over i != j of (d_ij(t) - d_ij(ref))^2).
    Distances are plain Euclidean unless `pbc_aware=True` (minimum image
    with each frame's box; exact 27-image for triclinic cells).  Rows go
    `chunk` at a time over all frames on the System's device.

    Returns a dict: 'rmsdist' [F] nm, 'ref_distances' [K, K],
    'mean_deviation' [K, K] (mean |d_ij(t) - d_ij(ref)| over frames)."""
    gsel, pos, boxes, _ = _resident_group_pos(system, trajectory, group, batch_size)
    ref = system if reference is None else reference
    rp = np.asarray(ref.positions, np.float32)
    if rp.shape[0] != system.topology.n_atoms:
        raise RMSDError("reference system has a different atom count",
                        code="InconsistentGroup")
    dev = pos.device
    rp = torch.as_tensor(rp[gsel], device=dev)
    k = int(gsel.shape[0])
    rbox = None
    if pbc_aware:
        if ref.simbox is None:
            raise RMSDError("pbc_aware rmsdist needs a reference box",
                            code="InvalidSimBox")
        rbox = torch.as_tensor(
            np.asarray(ref.simbox.to_matrix(), np.float32)
            if not ref.simbox.is_orthogonal()
            else np.asarray([ref.simbox.x, ref.simbox.y, ref.simbox.z], np.float32),
            device=dev)
    f = int(pos.shape[0])
    sse = torch.zeros(f, dtype=torch.float32, device=dev)
    sad = torch.empty((k, k), dtype=torch.float32, device=dev)
    dref = torch.empty((k, k), dtype=torch.float32, device=dev)
    cols = torch.arange(k, device=dev)
    for start in range(0, k, chunk):
        rows = cols[start:start + chunk]
        d = rp[start:start + chunk, None, :] - rp[None]
        if rbox is not None:
            d = (pbc.min_image_triclinic(d, rbox) if rbox.dim() == 2
                 else pbc.min_image(d, rbox))
        dr = torch.sqrt((d * d).sum(-1))                    # [C, K]
        dref[start:start + chunk] = dr
        keep = (rows[:, None] != cols[None, :]).to(torch.float32)
        d = pos[:, start:start + chunk, None, :] - pos[:, None, :, :]
        if pbc_aware:
            d = pbc.min_image_frames_any(d, boxes)
        dev_ = (torch.sqrt((d * d).sum(-1)) - dr[None]) * keep[None]   # [F, C, K]
        sad[start:start + chunk] = dev_.abs().sum(0)
        sse += (dev_ * dev_).sum((1, 2))
    return {"rmsdist": np.sqrt(sse.cpu().numpy().astype(np.float64) / (k * (k - 1))),
            "ref_distances": dref.cpu().numpy().astype(np.float64),
            "mean_deviation": sad.cpu().numpy().astype(np.float64) / f}


def chi(system, trajectory, group: str = "@protein", *, max_chi: int = 2,
        batch_size: int = 32, triclinic: bool = False):
    """Side-chain chi dihedrals and chi1 rotamer occupancies (`gmx chi`):
    chi_1 .. chi_max_chi (<= 4) site tables per residue from standard atom
    names (first present alternative wins; residues lacking an atom skip
    that chi), one `add_dihedrals` pass on the System's device.  chi1
    wells: g+ = (0, 120), t = |chi| >= 120, g- = (-120, 0) degrees.

    Returns per chi order k present 'chi{k}' [F, R_k] (signed degrees),
    'chi{k}_resids', 'chi{k}_resnames', and 'rotamers' {'g+', 't', 'g-'}
    -> occupancy [R_1] from chi1."""
    if not 1 <= max_chi <= 4:
        raise ParallelError(f"max_chi must be 1..4, got {max_chi}")
    idx = _transient_indices(system, group)
    if idx.size == 0:
        raise GroupError(f"group '{group}' is empty", code="EmptyGroup")
    order, residues = _residue_atoms(system, idx)
    topo = system.topology

    pipe = TrajectoryAnalysis(system, device=system.device, triclinic=triclinic)
    meta = {}
    for k in range(max_chi):
        sites, keys = [], []
        for key in order:
            r = residues[key]
            picked = []
            for alts in _CHI_SITES[k]:
                hit = next((r[nm] for nm in alts if nm in r), None)
                if hit is None:
                    break
                picked.append(hit)
            if len(picked) == 4:
                sites.append(picked)
                keys.append(key)
        if sites:
            nm = f"chi{k + 1}"
            pipe.add_dihedrals(np.asarray(sites), name=nm)
            meta[nm] = keys
    if not meta:
        raise GroupError(f"group '{group}' has no residue with χ-angle atoms",
                         code="InvalidSelection")

    res = pipe.run(trajectory, batch_size=batch_size)
    out = {}
    for nm, keys in meta.items():
        out[nm] = np.asarray(res[nm])
        out[f"{nm}_resids"] = np.asarray([k[1] for k in keys], np.int64)
        out[f"{nm}_resnames"] = np.asarray(
            [topo.resname.get(next(residues[k][n] for n in ("CA", "CB")
                                   if n in residues[k])) for k in keys], object)
    if "chi1" in out:
        c1 = out["chi1"]
        out["rotamers"] = {"g+": np.mean((c1 > 0) & (c1 < 120), axis=0),
                           "t": np.mean(np.abs(c1) >= 120, axis=0),
                           "g-": np.mean((c1 > -120) & (c1 < 0), axis=0)}
    return out


def morph(system_a, system_b, *, n: int = 30, first: float = 0.0,
          last: float = 1.0, fit: bool = True, group: str = "all",
          output: str | None = None, outfmt: str | None = None):
    """Linear interpolation between two conformations (`gmx morph`):
    `system_b` (a System or a structure filename) is optionally fitted
    onto `system_a` over `group` (`calc_rmsd_and_fit`), then `n` frames
    x(lambda) = (1 - lambda) x_A + lambda x_B for lambda in [first, last]
    (outside [0, 1] extrapolates).  The RMSD of every frame to each
    endpoint is one batched QCP pass each on `system_a`'s device.  With
    `output`, the frames are written for `group`.

    Returns a dict: 'lambdas' [n], 'frames' [n, K, 3], 'rmsd_a' / 'rmsd_b'
    [n] nm."""
    from ..core.simbox import simbox_check
    from ..system import System as _System
    from ..system.rmsd import _extract, _masses

    if isinstance(system_b, (str, os.PathLike)):
        system_b = _System.from_file(str(system_b), device=system_a.device)
    if system_b.get_n_atoms() != system_a.get_n_atoms():
        raise RMSDError(
            f"morph endpoints have {system_a.get_n_atoms()} vs "
            f"{system_b.get_n_atoms()} atoms", code="InconsistentGroup")
    if n < 2:
        raise ParallelError(f"morph needs n >= 2 frames, got {n}")

    idx = _transient_indices(system_a, group)
    b = system_b.copy()
    idx_b = _transient_indices(b, group)
    if idx_b.size != idx.size:
        raise RMSDError(f"group '{group}' selects {idx.size} atoms in A but "
                        f"{idx_b.size} in B", code="InconsistentGroup")
    # the fit group must exist under one name in both systems
    gf = "__morph_fit"
    system_a.group_create_from_indices(gf, idx)
    b.group_create_from_indices(gf, idx_b)
    try:
        if fit:
            b.calc_rmsd_and_fit(system_a, gf)
        xb = b.positions[idx_b].astype(np.float64)
        xa = system_a.positions[idx].astype(np.float64)
        lambdas = np.linspace(float(first), float(last), int(n))
        frames = ((1.0 - lambdas)[:, None, None] * xa[None]
                  + lambdas[:, None, None] * xb[None]).astype(np.float32)

        # batched QCP RMSD to each endpoint (centred over system_a's box)
        dev = system_a.device
        w = torch.as_tensor(np.asarray(_masses(system_a, group, idx), np.float32),
                            device=dev)
        blen = simbox_check(system_a.get_box()).to_lengths_vec()
        boxes = torch.as_tensor(np.asarray(blen, np.float32), device=dev).expand(int(n), 3)
        frames_t = torch.as_tensor(frames, device=dev)

        def series(ref_sys, g):
            ref_coords, ref_center, _, _ = _extract(ref_sys, g)
            return rmsd_ops.rmsd_frames(
                torch.as_tensor(ref_coords, device=dev),
                torch.as_tensor(np.asarray(ref_center, np.float32), device=dev),
                frames_t, boxes, w)[1].cpu().numpy().astype(np.float64)

        out = {"lambdas": lambdas, "frames": frames,
               "rmsd_a": series(system_a, gf), "rmsd_b": series(b, gf)}
    finally:
        system_a.group_remove(gf)

    if output is not None:
        wsys = system_a.copy()
        with _named_group(wsys, group, "__morph_w") as gw:
            wsys.group_traj_writer_init(gw, output, fmt=outfmt)
            try:
                for k in range(int(n)):
                    wsys.positions[idx] = frames[k]
                    wsys.traj_write_frame()
            finally:
                wsys.traj_writers_close()
        out["written"] = output
    return out


def subspace_overlap(pca_a, pca_b, *, n: int | None = None):
    """Subspace and covariance overlap of two PCA analyses over the same
    group and weighting (`gmx anaeig -over`), over the first `n` modes of
    each: inner products d_ij = v_i . w_j [n, n], subspace overlap
    (1/n) sum d_ij^2 (RMSIP^2), RMSIP, and Hess's covariance overlap
    1 - sqrt[(sum la + sum lb - 2 sum sqrt(la_i lb_j) d_ij^2) /
    (sum la + sum lb)].  Float64 on the host.

    Returns a dict: 'n', 'inner', 'subspace_overlap', 'rmsip',
    'covariance_overlap'."""
    va = np.asarray(pca_a["eigenvectors"], np.float64)
    vb = np.asarray(pca_b["eigenvectors"], np.float64)
    if va.ndim != 3 or vb.ndim != 3 or va.shape[1:] != vb.shape[1:]:
        raise ParallelError(
            f"eigenvector shapes do not match: {va.shape} vs {vb.shape} "
            "(both analyses must cover the same atom group)")
    la = np.asarray(pca_a["eigenvalues"], np.float64)
    lb = np.asarray(pca_b["eigenvalues"], np.float64)
    n_max = min(va.shape[0], vb.shape[0], la.shape[0], lb.shape[0])
    n = n_max if n is None else int(n)
    if not 0 < n <= n_max:
        raise ParallelError(
            f"n must be in [1, {n_max}] (modes carried by both analyses), got {n}")
    d = va[:n].reshape(n, -1) @ vb[:n].reshape(n, -1).T
    ss = d * d
    overlap = float(ss.sum() / n)
    la_n = np.clip(la[:n], 0.0, None)
    lb_n = np.clip(lb[:n], 0.0, None)
    denom = float(la_n.sum() + lb_n.sum())
    if denom > 0:
        cross = float((np.sqrt(np.outer(la_n, lb_n)) * ss).sum())
        cov_overlap = 1.0 - np.sqrt(max(denom - 2.0 * cross, 0.0) / denom)
    else:
        cov_overlap = float("nan")
    return {"n": n, "inner": d, "subspace_overlap": overlap,
            "rmsip": float(np.sqrt(overlap)),
            "covariance_overlap": float(cov_overlap)}


def cosine_content(projections, *, n_modes: int | None = None):
    """Cosine content of principal-component projections (`gmx analyze
    -cc`): c_i = (2/F) (sum_j cos(i pi j / (F-1)) p_j)^2 / sum_j p_j^2 for
    mode i (1-based) of `projections` [F] or [F, n]; float64 on the host.
    Returns c [n_modes] (a scalar for a 1-D input)."""
    p = np.asarray(projections, np.float64)
    scalar = p.ndim == 1
    if scalar:
        p = p[:, None]
    if p.ndim != 2 or p.shape[0] < 2:
        raise ParallelError(
            f"projections must be [F>=2] or [F>=2, n], got {p.shape}")
    f, n_all = p.shape
    n = n_all if n_modes is None else min(int(n_modes), n_all)
    if n < 1:
        raise ParallelError(f"n_modes must be >= 1, got {n_modes}")
    t = np.arange(f, dtype=np.float64) / (f - 1)
    cc = np.empty(n, np.float64)
    for i in range(n):
        y = p[:, i]
        denom = float(y @ y)
        if denom == 0.0:
            cc[i] = 0.0
            continue
        num = float(np.cos((i + 1) * np.pi * t) @ y)
        cc[i] = 2.0 / f * num * num / denom
    return float(cc[0]) if scalar else cc


def mode_traj(system, pca_result, group: str, *, mode: int = 1,
              amplitude: float | None = None, n: int = 30,
              phases: int = 1, output: str | None = None,
              outfmt: str | None = None):
    """Oscillation trajectory along a principal mode (`gmx nmtraj`):
    `n` frames x(t) = mean + A cos(2 pi phases t / n) v_mode / sw from a
    `pca` result over `group` (`sw` undoes its sqrt-mass weighting; `mode`
    is 1-based).  The default amplitude is sqrt(2 lambda_mode).  With
    `output`, the frames are written as a `group` trajectory.

    Returns a dict: 'frames' [n, K, 3] nm, 'displacement' [n],
    'amplitude'."""
    if not 1 <= int(mode) <= pca_result["eigenvectors"].shape[0]:
        raise ParallelError(
            f"mode must be in [1, {pca_result['eigenvectors'].shape[0]}], "
            f"got {mode}")
    if n < 2:
        raise ParallelError(f"mode_traj needs n >= 2 frames, got {n}")
    idx = _transient_indices(system, group)
    mean = np.asarray(pca_result["mean"], np.float64)
    if mean.shape[0] != idx.size:
        raise ParallelError(
            f"pca_result covers {mean.shape[0]} atoms but group "
            f"'{group}' selects {idx.size}")
    ev = np.asarray(pca_result["eigenvectors"][int(mode) - 1], np.float64)
    if "sqrt_weights" in pca_result:
        sw = np.asarray(pca_result["sqrt_weights"], np.float64)
    elif pca_result.get("mass_weighted", True):
        sw = np.sqrt(np.asarray(system.topology.mass, np.float64)[idx])
    else:
        sw = np.ones(idx.size)
    if amplitude is None:
        lam = float(pca_result["eigenvalues"][int(mode) - 1])
        amplitude = float(np.sqrt(max(2.0 * lam, 0.0)))
    disp = float(amplitude) * np.cos(
        2.0 * np.pi * float(phases) * np.arange(int(n)) / int(n))
    frames = (mean[None] + disp[:, None, None]
              * (ev / sw[:, None])[None]).astype(np.float32)

    out = {"frames": frames, "displacement": disp, "amplitude": float(amplitude)}
    if output is not None:
        wsys = system.copy()
        with _named_group(wsys, group, "__modetraj_w") as gw:
            wsys.group_traj_writer_init(gw, output, fmt=outfmt)
            try:
                for k in range(int(n)):
                    wsys.positions[idx] = frames[k]
                    wsys.set_time(float(k))
                    wsys.traj_write_frame()
            finally:
                wsys.traj_writers_close()
        out["written"] = output
    return out
