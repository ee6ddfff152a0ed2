"""Float64 oracles and a synthetic-system factory, shared by the tests and
`chip_smoke.py`.

The oracles are independent of the code under test (none calls the
port's functions).  The first three are the JAX package's bench
references (`bench.py:122-157`):

- `host_refined_center` — the refined Bai-Breen centre
  (iterators.rs:1237-1266) in float64 numpy.
- `host_kabsch_rmsd` — mass-weighted Kabsch RMSD by SVD with the
  determinant fix (rmsd.rs:547-604) in float64 numpy.
- `host_min_distance` — minimum-image min distance, chunked in float64.

`center_jump_bound` says how far a refined centre may move between two
estimates through atoms that the unwrap puts into another image.

Triclinic oracles (`(3, 3)` row-major box matrices, rows the box
vectors), float64: `host_min_image_triclinic` (fractional round, then the
shortest of the 27 neighbouring images; the tests hold it against a
125-image search), `host_refined_center_triclinic` (the circular mean and
unwrap in fractional coordinates), `host_kabsch_rmsd_triclinic`,
`host_pairs_triclinic` (min distance and contact-count bounds).  The
observable oracles below take a box matrix wherever they take a box
(`_mi`, `_to_center`), and `observable_errors` switches to them for
`[F, 3, 3]` boxes.

The rest are written from the formulas of the observables' docstrings in
`groan_rs_tpu/models/pipeline.py` and `ops/geometry.py`, one frame at a
time: `host_gyration`, `host_principal`, `host_dipole`,
`host_total_dipole`, `host_order`, `angles_host_f64`,
`dihedrals_host_f64`, `host_density_profile`, and for the counting
observables `host_density_map`, `host_in_shape` and
`host_pair_histogram`, which return `(lo, hi)` bounds: an item within
`tol` nm of a bin edge or a shape boundary is counted in `hi` for every
bin it may fall in and in no `lo`, so a float32 result is right when
`lo <= got <= hi`.

The factory (`bench.py:53-119`, `:160-179`) lays out a solvated
membrane-protein system at any atom count: a compact protein blob at the
box centre, a lipid-like membrane slab, water triplets; contiguous
molecules sorted spatially as real GROMACS output is; a drifting
multi-frame XTC written with this package's native codec.  Everything is
made from fixed seeds.  `synthetic_state(..., topology="full")` adds
charges, bonds, element symbols, atom names, a Water group and site
tables (`synthetic_layout` describes the layout it follows).
`build_trajectory_triclinic` writes the same layout in an xy-square
rhombic dodecahedron, the protein split by the cell's faces.
`named_layout` gives the layout residue and atom names that GSL's macros
and element guessing recognise, for a structure file built from it.

For the reader options and velocities: `expected_frames` restates the
JAX reader's concatenation dedup, time range and stride in plain numpy,
and `host_kinetic` sums kinetic energies in float64.
`dihedral_worst_site` locates the largest dihedral error of a pass and
what float32 rounding there can explain.

For the conformational analyses (`models/structure.py`): ideal backbones
built by NeRF (`ideal_backbone`, the JAX package's test geometry; an
alpha helix at `HELIX_PHI_PSI`; `ideal_hairpin`, two antiparallel strands
at `STRAND_PHI_PSI` whose turn is left out) laid out as a System state by
`backbone_state`; float64 oracles of the RMSD fit (`host_prepared`,
`host_kabsch`; the preparation reports how close each atom sits to the
wrap boundary), of the covariance eigenvalues and the entropies
(`host_covariance_eigh`, `host_entropy`), of the residue minimum-distance
matrix (`host_residue_min`), of the Kabsch-Sander energies and codes
(`host_dssp_energy`, `host_dssp_codes`) and of the `gmx cluster` labels
(`host_clusters`).

For the time-correlation and transport analyses (`models/dynamics.py`):
seeded AR(1) velocities (`ar1_velocities`) written with positions as a
TRR (`write_trr`); float64 paths (`host_unwrap`, `host_com_paths`), lag
sweeps (`host_msd`, `host_lag_corr`, `host_vanhove` with the norms at a
shell edge), fits (`host_fit`), and `host_dos`, `host_tcaf`,
`host_filtered`, `host_unit_vectors`, `host_dipole_paths`,
`host_molecular_dipoles`; `current_bound` states what float32 rounding
may move the conductivity's mean-squared dipole by.

For the membrane and interfacial-water analyses (`models/membrane.py`):
`host_leaflets`, `host_densmap`, `host_potential`, `host_interfaces`,
`host_sorient`, `host_h2order`, `host_spol` and `host_hydorder` (a
periodic `cKDTree` query).  Where a float32 value may land in another bin
than its float64 value, they return the sure sums and a slack: a result
is right where |got - sure| <= slack.  `potential_gap_bound` states what
a charge-density gap moves the field and the potential by.

For the geometric and surface analyses (`models/geometry.py`): neighbour
queries through a periodic `cKDTree` (a box matrix's 27 images in a plain
tree; `host_nearest`), `host_sasa` (every neighbour within reach, with
the slack of test points at a sphere's surface), `host_free_points`,
`host_self_image`, `host_unit_means` and `mi_f32_image` (the image
float32 arithmetic picks, for directions), `host_polystat`,
`host_helixorient`, `host_bundle`, `host_site_dirs`, `host_dyecoupl` and
`host_sdf` (sure voxel counts and the weight near a face); `chi_state`
builds ideal residues with full side chains at known chi angles.
"""

from __future__ import annotations

import os

import numpy as np

from .io import native

__all__ = ["host_refined_center", "center_jump_bound", "host_kabsch_rmsd", "host_min_distance",
           "host_gyration", "host_principal", "host_dipole",
           "host_total_dipole", "host_order", "angles_host_f64",
           "dihedrals_host_f64", "host_density_profile", "host_density_map",
           "host_in_shape", "host_pair_histogram", "cylinder_args",
           "add_observables", "observable_errors", "undefined_sites",
           "synthetic_sizes",
           "synthetic_layout", "build_trajectory", "synthetic_state",
           "host_min_image_triclinic", "host_refined_center_triclinic",
           "host_kabsch_rmsd_triclinic", "host_pairs_triclinic",
           "dodecahedron", "put_atoms_in_box", "build_trajectory_triclinic",
           "REFINE_TIE_LENGTHS", "REFINE_TIE_KS", "refine_tie_sets",
           "refine_tie_atoms", "dihedral_worst_site", "named_layout",
           "expected_frames", "host_kinetic", "KB",
           "place_atom", "ideal_backbone", "ideal_hairpin", "backbone_state",
           "HELIX_PHI_PSI", "STRAND_PHI_PSI", "SHEET_SPACING",
           "host_prepared", "host_kabsch",
           "host_residue_min", "host_entropy", "host_clusters",
           "host_covariance_eigh", "host_dssp_energy", "host_dssp_codes",
           "AMU_NM_PS_TO_PAS", "ar1_velocities", "write_trr", "host_unwrap",
           "host_msd", "host_msd_axes", "host_lag_corr", "host_lag_corrs", "host_fit", "host_com_paths",
           "host_unit_vectors", "host_dipole_paths", "current_bound",
           "host_vanhove", "host_filtered", "host_dos", "host_tcaf",
           "host_molecular_dipoles", "host_leaflets", "host_densmap",
           "host_potential", "host_interfaces", "host_sorient",
           "potential_gap_bound",
           "host_h2order", "host_spol", "host_hydorder",
           "host_nearest", "host_sasa", "host_free_points", "host_self_image",
           "mi_f32_image",
           "host_unit_means", "host_polystat", "host_helixorient", "host_bundle",
           "host_site_dirs", "host_dyecoupl", "host_sdf", "CHI_RESIDUES",
           "chi_state"]


def host_refined_center(p, box, w=None):
    """Float64 refined Bai-Breen centre of `p` [N, 3] in an orthorhombic
    `box` (3,), optionally mass-weighted."""
    p = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)
    theta = np.mod(p, box) * (2 * np.pi / box)
    xi = np.cos(theta).sum(0)
    zeta = np.sin(theta).sum(0)
    est = (np.arctan2(-zeta, -xi) + np.pi) * box / (2 * np.pi)
    half = box / 2
    d = p - est + half
    unwrapped = est + (d - box * np.floor(d / box) - half)
    if w is None:
        return unwrapped.mean(0)
    w = np.asarray(w, np.float64)
    return (unwrapped * w[:, None]).sum(0) / w.sum()


def center_jump_bound(pos, est_a, est_b, boxes):
    """How far the geometric refined centre of `pos` [B, N, 3] may move
    between the estimates `est_a` and `est_b` [B, 3] through atoms that
    change image.  K2 and its twin unwrap an atom into the image
    floor((x - e + L/2) / L), computed here in float32 as they compute it;
    an atom whose image differs between the two estimates moves the centre
    by L / N on that axis.  A slab that fills the box holds planes of atoms
    with one quantised coordinate, so an estimate that moves by an ulp
    across such a plane moves the centre by n L / N.
    -> (atoms that change image [B, 3] int64, bound [B, 3] float64)."""
    pos = np.asarray(pos, np.float32)
    box = np.asarray(boxes, np.float32)[:, None, :]
    half = box * np.float32(0.5)

    def image(e):
        return np.floor((pos - np.asarray(e, np.float32)[:, None, :] + half) / box)

    counts = (image(est_a) != image(est_b)).sum(1)
    return counts, counts * box[:, 0, :].astype(np.float64) / pos.shape[1]


def host_kabsch_rmsd(ref, ref_com, p, box, w):
    """Float64 Kabsch RMSD of frame coords `p` against prepared reference
    coords `ref` (centred on `ref_com`): centre the frame on the box centre
    via its refined COM, SVD with the determinant sign fix, mass-weighted
    RMSD."""
    p = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)
    w = np.asarray(w, np.float64)
    com = host_refined_center(p, box, w)
    center = box / 2
    qc = np.mod(p + (center - com), box) - center
    pc = np.asarray(ref, np.float64) - np.asarray(ref_com, np.float64)
    h = (w[:, None] * pc).T @ qc
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    p_rot = pc @ rot.T
    return float(np.sqrt((w * ((p_rot - qc) ** 2).sum(-1)).sum() / w.sum()))


def host_min_distance(a, b, box, chunk: int = 16):
    """Float64 minimum-image minimum distance between [N, 3] and [M, 3]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    box = np.asarray(box, np.float64)
    best = np.inf
    for i in range(0, a.shape[0], chunk):
        d = a[i:i + chunk, None, :] - b[None, :, :]
        d -= box * np.round(d / box)
        best = min(best, float(np.sqrt((d * d).sum(-1).min())))
    return best


# ------------------------------------------------------- triclinic oracles

_SHIFTS27 = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], np.float64)


def _vec_mat(v, h):
    """Row vectors `v` [..., 3] times box matrices `h` ((3, 3) or
    broadcastable [..., 3, 3])."""
    if h.ndim == 2:
        return v @ h
    return np.einsum("...i,...ij->...j", v, h)


def host_min_image_triclinic(d, h):
    """Float64 exact minimum image of displacements `d` [..., 3] in the box
    matrix `h` ((3, 3) or broadcastable [..., 3, 3]): round the fractional
    coordinates, then keep the shortest of the 27 neighbouring images (the
    first of equals)."""
    d = np.asarray(d, np.float64)
    h = np.asarray(h, np.float64)
    s = _vec_mat(d, np.linalg.inv(h))
    d0 = d - _vec_mat(np.round(s), h)
    best = best_v = None
    for k in _SHIFTS27:
        c = d0 + _vec_mat(k, h)
        n2 = (c * c).sum(-1)
        if best is None:
            best, best_v = n2, c
            continue
        take = n2 < best
        best = np.where(take, n2, best)
        best_v = np.where(take[..., None], c, best_v)
    return best_v


def host_refined_center_triclinic(p, h, w=None):
    """Float64 refined centre of `p` [N, 3] in the box matrix `h`: the
    (weighted) circular mean of the fractional coordinates, every atom
    unwrapped around it as d - round(d), the weighted mean mapped back."""
    p = np.asarray(p, np.float64)
    h = np.asarray(h, np.float64)
    w = np.ones(p.shape[0]) if w is None else np.asarray(w, np.float64)
    s = p @ np.linalg.inv(h)
    theta = (s - np.floor(s)) * 2 * np.pi
    est = (np.arctan2(-(w[:, None] * np.sin(theta)).sum(0),
                      -(w[:, None] * np.cos(theta)).sum(0)) + np.pi) / (2 * np.pi)
    d = s - est
    d -= np.round(d)
    return ((w[:, None] * (est + d)).sum(0) / w.sum()) @ h


def host_kabsch_rmsd_triclinic(ref, p, h_ref, h, w):
    """Float64 Kabsch RMSD in triclinic boxes: the reference `ref` [n, 3]
    and the frame `p` [n, 3] each unwrapped around its refined centre of
    mass (`h_ref`, `h` their box matrices), centred on their weighted
    centroids; the rotation by SVD of the unweighted covariance with the
    determinant sign fix (as `ops.rmsd.kabsch` and rmsd.rs take it), the
    RMSD mass-weighted."""
    w = np.asarray(w, np.float64)

    def prepared(x, box):
        com = host_refined_center_triclinic(x, box, w)
        u = com + host_min_image_triclinic(np.asarray(x, np.float64) - com, box)
        return u - (w[:, None] * u).sum(0) / w.sum()

    pc, qc = prepared(ref, h_ref), prepared(p, h)
    u, _, vt = np.linalg.svd(pc.T @ qc)
    sign = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, sign]) @ u.T
    return float(np.sqrt((w * ((pc @ rot.T - qc) ** 2).sum(-1)).sum() / w.sum()))


def _min_norm2_triclinic(d, h):
    """Float64 |exact minimum image|^2 of displacements `d` [..., 3] in one
    box matrix `h`: as `host_min_image_triclinic`, keeping only the
    squared length, built on x, y, z planes (the pair oracles' form)."""
    h = np.asarray(h, np.float64)
    d0 = d - np.round(d @ np.linalg.inv(h)) @ h
    x, y, z = (np.ascontiguousarray(d0[..., i]) for i in range(3))
    best = np.full(x.shape, np.inf)
    n2, c = np.empty_like(x), np.empty_like(x)
    for t in _SHIFTS27 @ h:
        np.add(x, t[0], out=c)
        np.multiply(c, c, out=n2)
        np.add(y, t[1], out=c)
        c *= c
        n2 += c
        np.add(z, t[2], out=c)
        c *= c
        n2 += c
        np.minimum(best, n2, out=best)
    return best


def host_pairs_triclinic(a, b, h, cutoff: float, tol: float = 1e-5,
                         chunk: int = 4):
    """Float64 exact triclinic minimum distance between `a` [N, 3] and `b`
    [M, 3], and bounds `(lo, hi)` of the pairs closer than `cutoff`: a pair
    within `tol` of the cutoff counts in `hi` only."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    best, lo, hi = np.inf, 0, 0
    for i0 in range(0, a.shape[0], chunk):
        r = np.sqrt(_min_norm2_triclinic(a[i0:i0 + chunk, None, :] - b[None], h))
        best = min(best, float(r.min()))
        lo += int((r < cutoff - tol).sum())
        hi += int((r < cutoff + tol).sum())
    return best, lo, hi


def dodecahedron(d: float = 23.57) -> np.ndarray:
    """Float32 box matrix of the xy-square rhombic dodecahedron of image
    distance `d`: a = (d, 0, 0), b = (0, d, 0), c = (d/2, d/2, d sqrt2/2);
    volume sqrt2/2 d^3 (GROMACS `editconf -bt dodecahedron`)."""
    return np.array([[d, 0.0, 0.0], [0.0, d, 0.0],
                     [d / 2, d / 2, d * np.sqrt(2.0) / 2]], np.float32)


def put_atoms_in_box(pos, h):
    """Wrap float32 `pos` [N, 3] into the diagonal brick of the
    lower-triangular box `h`, as GROMACS's `put_atoms_in_box` does: shift
    by c to bring z into [0, c_z), then by b for y, then by a for x.  Every
    coordinate then lies in [0, h_ii), which keeps XTC integers small."""
    pos = np.asarray(pos, np.float32).copy()
    h = np.asarray(h, np.float32)
    for ax in (2, 1, 0):
        k = np.floor(pos[:, ax] / h[ax, ax])
        pos -= k[:, None].astype(np.float32) * h[ax]
        # rounding may leave a coordinate at h_ii or a hair below 0
        pos[pos[:, ax] >= h[ax, ax]] -= h[ax]
        pos[pos[:, ax] < 0] += h[ax]
    return pos


def build_trajectory_triclinic(path, n_atoms: int, n_frames: int,
                               d: float = 23.57, precision: float = 1000.0):
    """Write the synthetic layout in `dodecahedron(d)` to `path`
    (atomically) -> (frame-0 positions float32 [N, 3], box matrix float32
    (3, 3)).  The protein blob sits on a cell corner and the membrane slab
    on the plane z = 0 through it, so the cell's faces split both; the
    water fills the cell; every frame
    drifts as `build_trajectory`'s and is wrapped by `put_atoms_in_box`.
    At d = 23.57 the cell holds the 21 nm cube's volume."""
    n_prot, n_mem = synthetic_sizes(n_atoms)
    rng = np.random.default_rng(43)
    h = dodecahedron(d)
    brick = np.diag(h).astype(np.float32)
    pos = np.empty((n_atoms, 3), np.float32)
    sigma = max(1.0, (n_prot / 100.0) ** (1.0 / 3.0) / 2.0)
    prot = rng.normal(size=(n_prot, 3)).astype(np.float32) * sigma
    pos[:n_prot] = prot[_cell_order(prot)]
    lip_sz = LIPID_SIZE
    n_lip = (n_mem + lip_sz - 1) // lip_sz
    heads = rng.uniform(0, 1, size=(n_lip, 3)).astype(np.float32) * brick
    heads[:, 2] = (heads[:, 2] / brick[2] - 0.5) * 5.0   # z in [-2.5, 2.5)
    heads = heads[_cell_order(heads, cell=1.0)]
    walk = np.cumsum(rng.normal(size=(n_lip, lip_sz, 3)).astype(np.float32) * 0.08,
                     axis=1)
    pos[n_prot:n_prot + n_mem] = (heads[:, None, :] + walk).reshape(-1, 3)[:n_mem]
    n_wat = n_atoms - n_prot - n_mem
    n_mol = (n_wat + 2) // 3
    centers = rng.uniform(0, 1, size=(n_mol, 3)).astype(np.float32) * brick
    centers = centers[_cell_order(centers)]
    offsets = rng.normal(size=(n_mol, 2, 3)).astype(np.float32) * 0.06
    trip = np.stack([centers, centers + offsets[:, 0], centers + offsets[:, 1]],
                    axis=1)
    pos[n_prot + n_mem:] = trip.reshape(-1, 3)[:n_wat]
    pos = put_atoms_in_box(pos, h)

    drift = np.random.default_rng(8)
    tmp = f"{path}.tmp{os.getpid()}"
    if os.path.exists(tmp):
        os.unlink(tmp)
    cur = pos.copy()
    for f in range(n_frames):
        if f:
            cur = put_atoms_in_box(
                cur + drift.normal(size=(1, 3)).astype(np.float32) * 0.05
                + drift.normal(size=cur.shape).astype(np.float32) * 0.01, h)
        native.xtc_write_frame(tmp, n_atoms, f * 1000, f * 10.0, h.reshape(9),
                               cur, precision)
    os.replace(tmp, path)
    return pos, h


def _cell_order(points, cell=0.5):
    """Cell-major spatial sort, as solvate/insert tools lay molecules out
    (real XTC files are spatially coherent; the delta coder relies on it)."""
    key = np.floor(points / cell).astype(np.int64)
    return np.lexsort((key[:, 2], key[:, 1], key[:, 0]))


def synthetic_sizes(n_atoms: int) -> tuple[int, int]:
    """(protein, membrane) atom counts of the synthetic layout: 99k and
    300k at 1M atoms (the JAX bench's system)."""
    return min(99_000, n_atoms // 10), min(300_000, n_atoms // 3)


def build_trajectory(path, n_atoms: int, n_frames: int, box_len: float = 21.0,
                     precision: float = 1000.0):
    """Write the synthetic trajectory to `path` (atomically: tmp + rename)
    and return (frame-0 positions float32 [N, 3], box float32 (3,))."""
    n_prot, n_mem = synthetic_sizes(n_atoms)
    rng = np.random.default_rng(42)
    box = np.full(3, box_len, np.float32)
    pos = np.empty((n_atoms, 3), np.float32)

    # protein: Gaussian blob at the box centre at ~100 atoms/nm^3
    sigma = max(1.0, (n_prot / 100.0) ** (1.0 / 3.0) / 2.0)
    prot = box / 2 + rng.normal(size=(n_prot, 3)).astype(np.float32) * sigma
    pos[:n_prot] = prot[_cell_order(prot)]

    # membrane: 50-atom lipids, heads uniform in a slab, tails a short walk
    lip_sz = 50
    n_lip = (n_mem + lip_sz - 1) // lip_sz
    heads = rng.uniform(0, 1, size=(n_lip, 3)).astype(np.float32)
    heads[:, :2] *= box[:2]
    heads[:, 2] = 8.0 + heads[:, 2] * 5.0
    heads = heads[_cell_order(heads, cell=1.0)]
    walk = np.cumsum(rng.normal(size=(n_lip, lip_sz, 3)).astype(np.float32) * 0.08,
                     axis=1)
    pos[n_prot:n_prot + n_mem] = (heads[:, None, :] + walk).reshape(-1, 3)[:n_mem]

    # water: spatially sorted triplets
    n_wat = n_atoms - n_prot - n_mem
    n_mol = (n_wat + 2) // 3
    centers = rng.uniform(0, 1, size=(n_mol, 3)).astype(np.float32) * box
    centers = centers[_cell_order(centers)]
    offsets = rng.normal(size=(n_mol, 2, 3)).astype(np.float32) * 0.06
    trip = np.stack([centers, centers + offsets[:, 0], centers + offsets[:, 1]],
                    axis=1)
    pos[n_prot + n_mem:] = trip.reshape(-1, 3)[:n_wat]
    pos %= box

    box33 = np.diag(box).astype(np.float32).reshape(9)
    drift = np.random.default_rng(7)
    tmp = f"{path}.tmp{os.getpid()}"
    if os.path.exists(tmp):
        os.unlink(tmp)
    cur = pos.copy()
    for f in range(n_frames):
        if f:
            cur = (cur + drift.normal(size=(1, 3)).astype(np.float32) * 0.05
                   + drift.normal(size=cur.shape).astype(np.float32) * 0.01) % box
        native.xtc_write_frame(tmp, n_atoms, f * 1000, f * 10.0, box33, cur,
                               precision)
    os.replace(tmp, path)
    return pos, box


LIPID_SIZE = 50  # atoms per synthetic lipid (build_trajectory's membrane)


def synthetic_layout(n_atoms: int) -> dict:
    """Index ranges and molecule tables of the synthetic layout.

    Protein `[0, n_prot)`, membrane `[n_prot, w0)` as 50-atom lipids,
    water `[w0, n)` as O-H-H triplets (the last one may be cut short).
    In every lipid, local atoms k with k % 3 == 2 are hydrogens bonded
    to atom k - 1; the other atoms form the lipid's heavy chain."""
    n_prot, n_mem = synthetic_sizes(n_atoms)
    w0 = n_prot + n_mem
    mem = np.arange(n_mem)
    is_h = (mem % LIPID_SIZE) % 3 == 2
    heavy = mem[~is_h]
    same = heavy[:-1] // LIPID_SIZE == heavy[1:] // LIPID_SIZE
    chain = np.stack([heavy[:-1][same], heavy[1:][same]], 1) + n_prot
    hyd = mem[is_h] + n_prot
    # four consecutive heavy atoms of one lipid
    quad = np.stack([heavy[:-3], heavy[1:-2], heavy[2:-1], heavy[3:]], 1)
    quad = quad[quad[:, 0] // LIPID_SIZE == quad[:, 3] // LIPID_SIZE] + n_prot
    oxy = np.arange(w0, n_atoms, 3)
    whole = oxy[oxy + 2 < n_atoms]
    return {
        "n_prot": n_prot, "n_mem": n_mem, "w0": w0,
        "lipid_hydrogens": hyd,
        "lipid_bonds": np.concatenate([chain, np.stack([hyd - 1, hyd], 1)]),
        "water_oxygens": oxy,
        "water_bonds": np.concatenate(
            [np.stack([oxy, oxy + k], 1)[oxy + k < n_atoms] for k in (1, 2)]),
        "water_angles": np.stack([whole + 1, whole, whole + 2], 1),
        "lipid_dihedrals": quad,
    }


def synthetic_state(frame0, box, precision: int = 1000,
                    topology: str | None = None) -> dict:
    """The System state (see `convert.system_from_state`) of the synthetic
    layout: random masses in [1, 16) from a fixed seed, groups Protein,
    Membrane and Peptide (the first 400 protein atoms, fewer when the
    protein is smaller, so that Peptide never overlaps Membrane).

    `topology="full"` adds, leaving the masses and groups above as they
    are: TIP3P-like water charges (O -0.834, H +0.417) with O-H bonds, a
    net-neutral seeded charge pattern on the protein, neutral lipids
    with a bonded heavy chain and a bonded hydrogen on every third atom,
    element symbols and atom names, the group Water, and under `sites`
    the water H-O-H triplets (`water_angles`) and four-atom windows
    along each lipid chain (`lipid_dihedrals`)."""
    n = frame0.shape[0]
    n_prot, n_mem = synthetic_sizes(n)
    masses = np.random.default_rng(3).uniform(1.0, 16.0, size=n).astype(np.float32)
    state = {
        "name": "synthetic",
        "positions": np.asarray(frame0, np.float32),
        "box": np.asarray(box, np.float32),
        "mass": masses,
        "has_mass": np.ones(n, bool),
        "precision": int(precision),
        "groups": {
            "Protein": np.arange(n_prot),
            "Membrane": np.arange(n_prot, n_prot + n_mem),
            "Peptide": np.arange(min(400, n_prot)),
        },
    }
    if topology is None:
        return state
    if topology != "full":
        raise ValueError(f"unknown topology '{topology}' (None or 'full')")
    lay = synthetic_layout(n)
    w0, oxy, hyd = lay["w0"], lay["water_oxygens"], lay["lipid_hydrogens"]
    q = np.zeros(n, np.float64)
    qp = np.random.default_rng(5).uniform(-0.5, 0.5, n_prot)
    q[:n_prot] = qp - qp.mean()
    q[w0:] = 0.417
    q[oxy] = -0.834
    element = np.full(n, "C", "<U2")
    name = np.full(n, "CA", "<U3")
    name[n_prot:w0] = "C"
    element[hyd] = name[hyd] = "H"
    element[w0:] = "H"
    element[oxy] = "O"
    name[w0:] = np.asarray(["OW", "HW1", "HW2"])[(np.arange(w0, n) - w0) % 3]
    state.update({
        "charge": q.astype(np.float32),
        "has_charge": np.ones(n, bool),
        "bonds": np.concatenate([lay["lipid_bonds"], lay["water_bonds"]]),
        "element": element,
        "atomname": name,
        "sites": {"water_angles": lay["water_angles"],
                  "lipid_dihedrals": lay["lipid_dihedrals"]},
    })
    state["groups"]["Water"] = np.arange(w0, n)
    return state


# ------------------------------------------------- oracles of the observables


def _is_matrix(box) -> bool:
    """A box matrix ((3, 3), or [..., 1, 3, 3] per frame) rather than
    lengths ((3,), or [..., 1, 3] per frame)."""
    return np.ndim(box) >= 2 and np.shape(box)[-2:] == (3, 3)


def _mi(d, box):
    """Float64 minimum image of displacements `d` [..., 3] in `box`
    (lengths, or a box matrix: the exact triclinic image)."""
    if _is_matrix(box):
        return host_min_image_triclinic(d, box)
    return d - box * np.round(d / box)


def _to_center(p, box, w):
    p = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)
    centre = (host_refined_center_triclinic if _is_matrix(box)
              else host_refined_center)
    return _mi(p - centre(p, box, w), box)


def host_gyration(p, box, w=None, components: bool = False):
    """Radius of gyration of one frame: sqrt(sum w |d|^2 / sum w) with d
    the minimum image from the refined centre (mass-weighted when `w`);
    with `components`, also the radii about x, y, z:
    sqrt(sum w (|d|^2 - d_a^2) / sum w)."""
    d = _to_center(p, box, w)
    ww = np.ones(d.shape[0]) if w is None else np.asarray(w, np.float64)
    r2 = (d * d).sum(-1)
    rg = np.sqrt((ww * r2).sum() / ww.sum())
    if not components:
        return rg
    about = [np.sqrt((ww * (r2 - d[:, a] ** 2)).sum() / ww.sum()) for a in range(3)]
    return np.asarray([rg] + about)


def host_principal(p, box, w):
    """Principal moments of inertia of one frame, ascending:
    eigenvalues of sum w (|d|^2 I - d d^T), d from the refined centre."""
    d = _to_center(p, box, w)
    w = np.asarray(w, np.float64)
    inertia = np.eye(3) * (w * (d * d).sum(-1)).sum() - (w[:, None] * d).T @ d
    return np.linalg.eigvalsh(inertia)


def host_dipole(p, box, q, w):
    """Dipole sum q d of one frame, d the minimum image from the refined
    centre of mass."""
    return (np.asarray(q, np.float64)[:, None] * _to_center(p, box, w)).sum(0)


def host_total_dipole(p, box, q, mol):
    """Total dipole of one frame: sum over molecules of sum q_i d_i, d_i
    the minimum image of atom i from the first atom of its molecule
    (`mol`: any molecule label per atom)."""
    p = np.asarray(p, np.float64)
    _, inv = np.unique(mol, return_inverse=True)
    first = np.full(inv.max() + 1, p.shape[0])
    np.minimum.at(first, inv, np.arange(p.shape[0]))
    d = _mi(p - p[first[inv]], np.asarray(box, np.float64))
    return (np.asarray(q, np.float64)[:, None] * d).sum(0)


def host_order(p_heavy, p_hydrogen, box, axis):
    """Bond order parameters of one frame: S = (3 cos^2 - 1) / 2 of the
    minimum-image heavy -> hydrogen vectors against the unit `axis`."""
    d = _mi(np.asarray(p_hydrogen, np.float64) - np.asarray(p_heavy, np.float64),
            np.asarray(box, np.float64))
    n = np.asarray(axis, np.float64)
    n = n / np.linalg.norm(n)
    cos2 = (d @ n) ** 2 / (d * d).sum(-1)
    return 1.5 * cos2 - 0.5


def angles_host_f64(a, b, c, boxes):
    """Float64 angles a-b-c in degrees, `[B, K, 3]` points and `[B, 3]`
    boxes (moved here from `groan_rs_tpu/ops/geometry.py:140`)."""
    box = np.asarray(boxes, np.float64)[:, None, :]
    b = np.asarray(b, np.float64)
    va = _mi(np.asarray(a, np.float64) - b, box)
    vc = _mi(np.asarray(c, np.float64) - b, box)
    cross = np.cross(va, vc)
    return np.degrees(np.arctan2(np.sqrt((cross * cross).sum(-1)),
                                 (va * vc).sum(-1)))


def dihedrals_host_f64(a, b, c, d, boxes):
    """Float64 signed dihedrals a-b-c-d in degrees, IUPAC convention
    (moved here from `groan_rs_tpu/ops/geometry.py:154`)."""
    box = np.asarray(boxes, np.float64)[:, None, :]
    a, b, c, d = (np.asarray(x, np.float64) for x in (a, b, c, d))
    b1 = _mi(b - a, box)
    b2 = _mi(c - b, box)
    b3 = _mi(d - c, box)
    n1 = np.cross(b1, b2)
    n2 = np.cross(b2, b3)
    b2n = b2 / np.linalg.norm(b2, axis=-1, keepdims=True)
    y = (np.cross(n1, n2) * b2n).sum(-1)
    return np.degrees(np.arctan2(y, (n1 * n2).sum(-1)))


def host_density_profile(p, box, axis: int, n_bins: int, w, scale: float = 1.0):
    """Density profile of one frame along `axis`: each atom's weight
    goes to slab int(frac * n_bins), frac = x / L - floor(x / L); sums
    times n_bins * scale / volume.  The slab index follows the
    observable's float32 rule, so no atom sits on the other side of an
    edge; the sums are float64."""
    x = np.asarray(p, np.float32)[:, axis]
    box32 = np.asarray(box, np.float32)
    frac = x / box32[axis]
    frac = frac - np.floor(frac)
    bins = np.clip((frac * np.float32(n_bins)).astype(np.int32), 0, n_bins - 1)
    hist = np.bincount(bins, weights=np.asarray(w, np.float64), minlength=n_bins)
    return hist * (n_bins * scale) / np.prod(np.asarray(box, np.float64))


def host_density_profile_triclinic(p, h, axis: int, n_bins: int, w,
                                   scale: float = 1.0, tol: float = 1e-4):
    """Density profile of one frame in the box matrix `h`, float64: slab
    floor(frac * n_bins) of the fractional coordinate along `axis`, sums
    times n_bins * scale / |det h| -> (profile, slack).  An atom within
    `tol` of a slab edge (in slab widths) may fall on either side in
    float32: its weight goes to neither slab's profile and to both slabs'
    slack, so a float32 result is right where |got - profile| <= slack."""
    h = np.asarray(h, np.float64)
    w = np.asarray(w, np.float64)
    u = (np.asarray(p, np.float64) @ np.linalg.inv(h))[:, axis]
    u = (u - np.floor(u)) * n_bins
    k = np.round(u)
    near = np.abs(u - k) < tol
    sure = np.clip(np.floor(u).astype(np.int64), 0, n_bins - 1)
    norm = n_bins * scale / abs(np.linalg.det(h))
    prof = np.bincount(sure[~near], weights=w[~near], minlength=n_bins) * norm
    slack = np.zeros(n_bins)
    for c in (k[near] - 1, k[near]):
        np.add.at(slack, c.astype(np.int64) % n_bins, np.abs(w[near]) * norm)
    return prof, slack


def _edge_bins(x, lo, width, n, tol):
    """Bins of coordinates `x` on edges lo + k * width: (sure bin or -1
    when within `tol` of an edge, [two candidate bins] per item)."""
    u = (np.asarray(x, np.float64) - lo) / width
    k = np.round(u)
    near = np.abs(u - k) * width < tol
    sure = np.where(near, -1, np.floor(u)).astype(np.int64)
    sure[(sure < 0) | (sure >= n)] = -1
    cand = np.stack([k - 1, k], -1).astype(np.int64)
    cand[~near] = np.stack([sure, sure], -1)[~near]
    return sure, near, cand


def host_density_map(p, axes, span, nx: int, ny: int, tol: float = 1e-5):
    """Count bounds `(lo, hi)` `[nx, ny]` of one frame's 2-D density map:
    bin = floor((x - x0) / (x1 - x0) * nx) on the two plane axes, atoms
    outside the span dropped."""
    p = np.asarray(p, np.float64)
    (x0, x1), (y0, y1) = span
    su, nu, cu = _edge_bins(p[:, axes[0]], x0, (x1 - x0) / nx, nx, tol)
    sv, nv, cv = _edge_bins(p[:, axes[1]], y0, (y1 - y0) / ny, ny, tol)
    ok = (su >= 0) & (sv >= 0)
    lo = np.zeros((nx, ny), np.int64)
    np.add.at(lo, (su[ok], sv[ok]), 1)
    hi = lo.copy()
    amb = np.nonzero((nu | nv) & ~ok)[0]
    for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)):
        u, v = cu[amb, i], cv[amb, j]
        keep = (u >= 0) & (u < nx) & (v >= 0) & (v < ny)
        # a sure axis repeats its bin: count each cell once per atom
        keep &= (i == 0) | nu[amb]
        keep &= (j == 0) | nv[amb]
        np.add.at(hi, (u[keep], v[keep]), 1)
    return lo, hi


def host_in_shape(p, box, shape, tol: float = 1e-5):
    """Count bounds `(lo, hi)` of one frame's atoms inside a shape with
    the shapes' PBC semantics (Sphere, Rectangular or Cylinder, any
    object with their attributes).  Along an oriented axis the distance
    from the anchor folds into [0, L), so an atom within `tol` of the
    anchor plane is also undecided."""
    p = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)
    d = _mi(p - np.asarray(shape.position, np.float64), box)
    fold = np.where(d < 0, d + box, d)
    kind = type(shape).__name__
    if kind == "Sphere":
        margin = shape.radius - np.sqrt((d * d).sum(-1))
        folded = []
    elif kind == "Rectangular":
        margin = np.min(np.asarray([shape.x, shape.y, shape.z]) - fold, axis=-1)
        folded = [0, 1, 2]
    else:
        ax = {"X": 0, "Y": 1, "Z": 2}[shape.orientation.name]
        plane = [a for a in range(3) if a != ax]
        radial = shape.radius - np.sqrt((d[:, plane] ** 2).sum(-1))
        margin = np.minimum(shape.height - fold[:, ax], radial)
        folded = [ax]
    undecided = (np.abs(d[:, folded]) < tol).any(-1)
    return (int(((margin >= tol) & ~undecided).sum()),
            int(((margin > -tol) | undecided).sum()))


def host_pair_histogram(a, b, box, r_max: float, n_bins: int,
                        exclude_self: bool = False, tol: float = 1e-5,
                        chunk: int = 4):
    """Count bounds `(lo, hi)` `[n_bins]` of one frame's pair-distance
    histogram: bin k holds the minimum-image distances in
    (k dr, (k+1) dr], dr = r_max / n_bins; `exclude_self` drops i == j.
    `box` lengths or a box matrix (the exact triclinic image)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    box = np.asarray(box, np.float64)
    dr = r_max / n_bins
    lo = np.zeros(n_bins + 1, np.int64)
    hi = np.zeros(n_bins + 1, np.int64)
    for i0 in range(0, a.shape[0], chunk):
        d = a[i0:i0 + chunk, None, :] - b[None, :, :]
        if _is_matrix(box):
            d = np.sqrt(_min_norm2_triclinic(d, box))
        else:
            d = _mi(d, box)
            d = np.sqrt((d * d).sum(-1))
        if exclude_self:
            r = np.arange(i0, i0 + d.shape[0])
            d[r - i0, r] = np.inf
        d = d[d <= r_max + tol]
        sure, near, cand = _edge_bins(d, 0.0, dr, n_bins, tol)
        np.add.at(lo, np.where(sure >= 0, sure, n_bins), 1)
        for k in (0, 1):
            c = cand[near, k]
            np.add.at(hi, np.where((c >= 0) & (c < n_bins), c, n_bins), 1)
    return lo[:n_bins], lo[:n_bins] + hi[:n_bins]


# ------------------------------------- the observables pass and its checks


def cylinder_args(box):
    """(position, radius, height) of the in-shape cylinder: z-oriented
    through the box centre, from 10% to 80% of the box height."""
    box = np.asarray(box, np.float64)
    return ([box[0] / 2, box[1] / 2, 0.1 * box[2]], 0.2 * min(box[0], box[1]),
            0.7 * box[2])


def add_observables(pipe, state, cylinder, span=None):
    """Configure the full-width observables pass on a `TrajectoryAnalysis`
    of either package (they share the API) over a `synthetic_state(...,
    topology="full")` system; `cylinder` is that package's Cylinder made
    from `cylinder_args`, or None for no in-shape count (a triclinic pass
    refuses one); `span` the density map's, by default the system box."""
    sites = state["sites"]
    pipe = (pipe.add_gyration("Protein", components=True, name="gyration")
            .add_density_map("Membrane", "xy", tile=0.1, span=span,
                             name="density_map")
            .add_density_profile("Water", "z", 200, mode="mass",
                                 name="profile_mass")
            .add_density_profile("Water", "z", 200, mode="charge",
                                 name="profile_charge")
            .add_rdf("Peptide", "Membrane", r_max=2.0, n_bins=200, name="rdf")
            .add_dipole("Protein", name="dipole")
            .add_box_volume()
            .add_box_lengths()
            .add_total_dipole("Water", name="total_dipole")
            .add_order("Membrane", axis="z", name="order")
            .add_angles(sites["water_angles"], name="angles")
            .add_dihedrals(sites["lipid_dihedrals"], name="dihedrals")
            .add_principal("Protein", name="principal"))
    if cylinder is not None:
        pipe = pipe.add_in_shape("Water", cylinder, name="in_shape")
    return pipe


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def undefined_sites(coords, n_atoms: int) -> dict:
    """Per-frame masks of the `add_observables` items whose value is
    undefined (NaN by the formula) in decoded `coords` [F, N, 3]:
    dihedrals whose central bond has zero length, order parameters of a
    hydrogen on top of its heavy atom.  Quantized coordinates make such
    coincidences rare but real at 1M atoms."""
    lay = synthetic_layout(n_atoms)
    quad, hyd = lay["lipid_dihedrals"], lay["lipid_hydrogens"]
    return {"dihedrals": (coords[:, quad[:, 1]] == coords[:, quad[:, 2]]).all(-1),
            "order": (coords[:, hyd - 1] == coords[:, hyd]).all(-1)}


def _nan_gap(got, want) -> float:
    """Max |got - want| over the oracle's defined entries; inf when the
    undefined (NaN) entries are not the same in both."""
    undefined = ~np.isfinite(want)
    if not np.array_equal(~np.isfinite(got), undefined):
        return np.inf
    gap = np.asarray(got, np.float64)[~undefined] - want[~undefined]
    return float(np.abs(gap).max()) if gap.size else 0.0


def observable_errors(out, coords, boxes, state, cylinder,
                      rdf_frames: int | None = None) -> dict:
    """Hold the first `len(coords)` frames of an `add_observables` pass
    against the float64 oracles -> {check: (error, bound)}; a check
    passes when error <= bound.  Relative errors are to the largest
    |value| of the oracle's frame; counts are the number of items
    outside the oracle's (lo, hi) bounds; dihedrals and order must be
    NaN exactly where the oracle is (`undefined_sites`).

    `boxes` `[F, 3]` lengths, or `[F, 3, 3]` box matrices for a triclinic
    pass: then the oracles take the exact triclinic minimum image, the
    density profiles allow the weight of atoms within 1e-4 slab widths of
    an edge (`host_density_profile_triclinic`), the box volume and
    lengths are relative errors against |det| and the row norms in
    float64 (bound 3e-7: float32 rounding), the density map spans the
    box's diagonal, and there is no in-shape check (`cylinder` None).
    `rdf_frames` limits the RDF check to the first frames."""
    n = coords.shape[1]
    lay = synthetic_layout(n)
    n_prot, w0 = lay["n_prot"], lay["w0"]
    prot, wat = slice(0, n_prot), slice(w0, n)
    mem = slice(n_prot, w0)
    pep = slice(0, min(400, n_prot))
    mass = np.asarray(state["mass"], np.float64)
    q = np.asarray(state["charge"], np.float64)
    hyd = lay["lipid_hydrogens"]
    tri, quad = lay["water_angles"], lay["lipid_dihedrals"]
    triclinic = np.ndim(boxes) == 3
    keys = ["gyration", "dipole", "total_dipole", "principal", "profile_mass",
            "profile_charge", "box_volume", "box_lengths", "angles",
            "dihedrals", "order", "density_map", "rdf"]
    if cylinder is not None:
        keys.append("in_shape")
    err = {k: 0.0 for k in keys}
    rdf_frames = coords.shape[0] if rdf_frames is None else rdf_frames

    def worst(key, e):
        err[key] = max(err[key], e)

    for f in range(coords.shape[0]):
        p = np.asarray(coords[f], np.float32)
        box = np.asarray(boxes[f], np.float32)
        box64 = box.astype(np.float64)
        lengths = np.diag(box64) if triclinic else box64
        worst("gyration", _rel(out["gyration"][f],
                               host_gyration(p[prot], box, mass[prot], True)))
        worst("dipole", _rel(out["dipole"][f],
                             host_dipole(p[prot], box, q[prot], mass[prot])))
        worst("total_dipole", _rel(out["total_dipole"][f], host_total_dipole(
            p[wat], box, q[wat], (np.arange(w0, n) - w0) // 3)))
        worst("principal", _rel(out["principal"][f],
                                host_principal(p[prot], box, mass[prot])))
        for key, wt, scale in (("profile_mass", mass[wat], 1.66053906660),
                               ("profile_charge", q[wat], 1.0)):
            got = out[key][f]
            if triclinic:
                want, slack = host_density_profile_triclinic(p[wat], box64, 2,
                                                             200, wt, scale)
                gap = np.maximum(np.abs(got - want) - slack, 0.0)
                worst(key, float(gap.max() / max(np.abs(want).max(), 1e-30)))
            else:
                worst(key, _rel(got, host_density_profile(p[wat], box, 2, 200,
                                                          wt, scale)))
        if triclinic:
            worst("box_volume", _rel(out["box_volume"][f],
                                     abs(np.linalg.det(box64))))
            worst("box_lengths", _rel(out["box_lengths"][f],
                                      np.sqrt((box64 * box64).sum(-1))))
        else:
            worst("box_volume", float(out["box_volume"][f] != np.float32(
                np.prod(box64))))
            worst("box_lengths", float(np.abs(out["box_lengths"][f] - box).max()))
        pb = p[None]
        want = angles_host_f64(pb[:, tri[:, 0]], pb[:, tri[:, 1]],
                               pb[:, tri[:, 2]], box64[None])[0]
        worst("angles", float(np.abs(out["angles"][f] - want).max()))
        want = dihedrals_host_f64(*(pb[:, quad[:, k]] for k in range(4)),
                                  box64[None])[0]
        got = out["dihedrals"][f]
        wrap = np.round((got - want) / 360.0) * 360.0
        worst("dihedrals", _nan_gap(got - np.nan_to_num(wrap), want))
        with np.errstate(invalid="ignore"):
            want = host_order(p[hyd - 1], p[hyd], box, [0.0, 0.0, 1.0])
        worst("order", _nan_gap(out["order"][f], want))
        lo, hi = host_density_map(p[mem], (0, 1), ((0.0, lengths[0]),
                                                  (0.0, lengths[1])),
                                  int(round(lengths[0] / 0.1)),
                                  int(round(lengths[1] / 0.1)))
        got = out["density_map"][f]
        worst("density_map", float(((got < lo) | (got > hi)).sum()))
        if cylinder is not None:
            lo, hi = host_in_shape(p[wat], box, cylinder)
            worst("in_shape", float(not lo <= out["in_shape"][f] <= hi))
        if f >= rdf_frames:
            continue
        lo, hi = host_pair_histogram(p[pep], p[mem], box, 2.0, 200)
        edges = np.arange(201) * (2.0 / 200)
        n_pairs = (pep.stop - pep.start) * (w0 - n_prot)
        vol = abs(np.linalg.det(box64)) if triclinic else np.prod(box64)
        ideal = n_pairs * 4.0 / 3.0 * np.pi * np.diff(edges ** 3) / vol
        counts = np.rint(out["rdf"][f].astype(np.float64) * ideal)
        worst("rdf", float(((counts < lo) | (counts > hi)).sum()))
    bounds = {"gyration": 1e-4, "dipole": 1e-4, "total_dipole": 1e-4,
              "principal": 1e-3, "profile_mass": 1e-4, "profile_charge": 1e-4,
              "box_volume": 3e-7 if triclinic else 0.0,
              "box_lengths": 3e-7 if triclinic else 0.0, "angles": 2e-2,
              "dihedrals": 2e-2, "order": 3e-4, "density_map": 0.0,
              "in_shape": 0.0, "rdf": 0.0}
    return {k: (err[k], bounds[k]) for k in err}


def dihedral_worst_site(got, coords, boxes) -> dict:
    """Locate the largest dihedral error of an `add_observables` pass:
    `got` [F, K] degrees against `dihedrals_host_f64` on `coords` [F, N, 3]
    with `boxes` [F, 3] lengths or [F, 3, 3] matrices (the exact triclinic
    image; a bond crosses the box when its fractional displacement rounds
    to a non-zero lattice vector).  Besides the frame, site, atoms and error it
    gives the central bond's length, the two bend angles a-b-c and b-c-d,
    the lever arm (the smaller distance of a or d from the b-c axis),
    whether a bond of the site crosses the box (its minimum image shifts
    by a box length, so its float32 displacement is the difference of two
    coordinates ~L apart), and `f32_scale`: one float32 ulp of the
    largest coordinate over the lever arm, in degrees, the order of the
    angle by which rounding a displacement to float32 can move the
    dihedral."""
    quad = synthetic_layout(coords.shape[1])["lipid_dihedrals"]
    worst = (-1.0, 0, 0)
    for f in range(coords.shape[0]):
        pb = np.asarray(coords[f], np.float32)[None]
        want = dihedrals_host_f64(*(pb[:, quad[:, k]] for k in range(4)),
                                  np.asarray(boxes[f], np.float64)[None])[0]
        gap = np.asarray(got[f], np.float64) - want
        gap = np.abs(gap - np.round(gap / 360.0) * 360.0)
        gap[~np.isfinite(gap)] = -1.0
        k = int(np.argmax(gap))
        if gap[k] > worst[0]:
            worst = (float(gap[k]), f, k)
    err, f, k = worst
    box = np.asarray(boxes[f], np.float64)
    p = np.asarray(coords[f], np.float64)[quad[k]]
    raw = [p[i + 1] - p[i] for i in range(3)]
    b1, b2, b3 = (_mi(d, box) for d in raw)
    axis = b2 / np.linalg.norm(b2)

    def bend(u, v):  # the angle at the shared atom between -u and v
        c = float(np.dot(-u, v) / (np.linalg.norm(u) * np.linalg.norm(v)))
        return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))

    lever = min(float(np.linalg.norm(np.cross(b1, axis))),
                float(np.linalg.norm(np.cross(b3, axis))))
    ulp = float(np.spacing(np.float32(np.abs(np.asarray(coords[f])).max())))
    return {"frame": f, "site": k, "atoms": quad[k].tolist(), "error": err,
            "central_bond": float(np.linalg.norm(b2)),
            "bends": (bend(b1, b2), bend(b2, b3)), "lever": lever,
            "crosses_box": bool(any((np.round(
                d @ np.linalg.inv(box) if _is_matrix(box) else d / box) != 0).any()
                for d in raw)),
            "f32_scale": float(np.degrees(ulp / max(lever, 1e-30)))}


# ------------------------------------------------- systems built from files

AMINO_ACIDS = ("ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS",
               "ILE", "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP",
               "TYR", "VAL")
RESIDUE_SIZE = 10  # atoms per synthetic protein residue
_PROTEIN_NAMES = ("N", "H", "CA", "HA", "CB", "HB1", "HB2", "C", "O", "HB3")


def named_layout(n_atoms: int) -> dict:
    """Residue and atom names of the synthetic layout, for a structure file
    whose groups GSL finds and whose elements guessing assigns:

    - the protein as 10-atom residues cycling through `AMINO_ACIDS`
      (which `@protein` lists), atoms N H CA HA CB HB1 HB2 C O HB3;
    - the membrane as 50-atom `POPC` residues (`@membrane`): the local
      hydrogens of `synthetic_layout` (k % 3 == 2) named H{k}, the heavy
      atoms N, C12, P, O11 and then C{k};
    - the water as `SOL` triplets OW HW1 HW2 (`@water`).

    Residues are numbered from 1 over the whole system -> {"resnum",
    "resname", "atomname" (str arrays), "element" (the symbol each atom's
    name guesses to)}."""
    lay = synthetic_layout(n_atoms)
    n_prot, w0 = lay["n_prot"], lay["w0"]
    n_mem = w0 - n_prot
    k = np.arange(n_mem) % LIPID_SIZE
    mem_names = np.char.add("C", k.astype(str))
    mem_names[k % 3 == 2] = np.char.add("H", k[k % 3 == 2].astype(str))
    for j, nm in enumerate(("N", "C12", "P", "O11")):
        mem_names[k == [0, 1, 3, 4][j]] = nm
    n_res_prot = -(-n_prot // RESIDUE_SIZE)
    n_res_mem = -(-n_mem // LIPID_SIZE)
    wat = np.arange(n_atoms - w0)
    resnum = np.concatenate([
        np.arange(n_prot) // RESIDUE_SIZE,
        n_res_prot + np.arange(n_mem) // LIPID_SIZE,
        n_res_prot + n_res_mem + wat // 3]) + 1
    resname = np.concatenate([
        np.asarray(AMINO_ACIDS)[(np.arange(n_prot) // RESIDUE_SIZE) % len(AMINO_ACIDS)],
        np.full(n_mem, "POPC"), np.full(wat.shape[0], "SOL")])
    atomname = np.concatenate([
        np.asarray(_PROTEIN_NAMES)[np.arange(n_prot) % RESIDUE_SIZE], mem_names,
        np.asarray(["OW", "HW1", "HW2"])[wat % 3]])
    first = np.char.lstrip(atomname.astype(str), "0123456789")
    element = np.asarray([c[:1] for c in first])
    return {"resnum": resnum.astype(np.int64), "resname": resname.astype(str),
            "atomname": atomname.astype(str), "element": element}


def expected_frames(file_times, start_time=None, end_time=None, step=None):
    """The frames a concatenated, range-restricted, strided read selects,
    restated from the JAX reader (`groan_rs_tpu/io/traj.py:476-567`) in
    plain numpy: equal times are dropped at a file boundary only, the
    range keeps times within 0.001 ps of [start, end], the stride keeps
    every `step`-th frame of that -> (file index, frame in the file) int
    arrays."""
    files, frames, times, last = [], [], [], None
    for i, t in enumerate(file_times):
        t = np.asarray(t, np.float32)
        j = 0
        while i and last is not None and j < t.shape[0] and t[j] == last:
            j += 1
        files += [i] * (t.shape[0] - j)
        frames += list(range(j, t.shape[0]))
        times += t[j:].tolist()
        if j < t.shape[0]:
            last = t[-1]
    files, frames = np.asarray(files, np.int64), np.asarray(frames, np.int64)
    times = np.asarray(times, np.float32)
    keep = np.ones(times.shape[0], bool)
    if start_time is not None or end_time is not None:
        lo = 0.0 if start_time is None else start_time
        hi = np.inf if end_time is None else end_time
        keep = (times >= lo - 0.001) & (times <= hi + 0.001)
    sel = np.flatnonzero(keep)[::step or 1]
    return files[sel], frames[sel]


def host_kinetic(v, w) -> np.ndarray:
    """Float64 kinetic energy per frame of velocities `v` [F, n, 3] with
    masses `w` [n]: 1/2 sum m |v|^2 (kJ/mol for nm/ps and amu)."""
    v = np.asarray(v, np.float64)
    return 0.5 * (np.asarray(w, np.float64)[None, :] * (v * v).sum(-1)).sum(-1)


KB = 0.008314462618  # kJ / (mol K)


# ---------------------------------------------------------------- K3 tie sets
# Inputs at and near half-box separations, where floor(d / L + 0.5) and a
# k taken from the reciprocal 1/L can differ by one.  Shared by the CPU
# tests and the card's checks (chip_smoke.py phase 3).

TIE_LENGTHS = (1.0, 3.0, 7.3, 20.5, 21.0, 97.3)


def tie_quotients():
    """(d, L) float32: d = +-(k + 1/2) L and +-1..+-16 ulps around it for
    k in -4..4, plus quotients near and past 2^17..2^23, per L in
    TIE_LENGTHS."""
    f32 = np.float32
    ds, lens = [], []
    steps = np.arange(-16, 17, dtype=np.int32)
    quotients = [k + 0.5 for k in range(-4, 5)] + [
        2.0 ** 17 + 0.5, 2.0 ** 18 - 0.5, 2.0 ** 18 + 0.5, 2.0 ** 21 + 0.5,
        2.0 ** 22 + 0.5, 2.0 ** 23, 1e9]
    for L in TIE_LENGTHS:
        for q in quotients:
            for sign in (1.0, -1.0):
                d0 = f32(sign * q * f32(L))
                bits = np.full(steps.shape, d0, f32).view(np.int32) + steps
                ds.append(bits.view(f32))
                lens.append(np.full(steps.shape, L, f32))
    return np.concatenate(ds), np.concatenate(lens)


def half_box_sets(n_axes: int, L: float):
    """(a [128, 3], b [64, 3], box [3], L/2) float32: a[:64] sit exactly
    (k + 1/2) L from b on the first `n_axes` axes (0 on the others; exact
    for dyadic L), coordinates span -2L..3L; a[64:] are free atoms."""
    rng = np.random.default_rng(n_axes)
    box = np.full(3, L, np.float32)
    half = np.float32(L) / np.float32(2)
    # a 1/16 grid keeps b + L/2 + k L exact for dyadic box lengths
    b = (np.round(rng.uniform(-2 * L, 2.5 * L, (64, 3)) * 16) / 16).astype(np.float32)
    shift = np.zeros((64, 3), np.float32)
    shift[:, :n_axes] = half + np.float32(L) * rng.integers(-1, 1, (64, n_axes))
    free = rng.random((64, 3)) * 5 * L - 2 * L
    return np.concatenate([b + shift, free]).astype(np.float32), b, box, half


def half_box_lattice(L: float):
    """(a, b, box, L/2) float32: atoms on a lattice of half-box steps in
    -2L..3L, b a subset of a plus copies three boxes away, so that many
    pairs sit exactly (k + 1/2) L apart on one, two or three axes."""
    f32 = np.float32
    box = np.full(3, L, f32)
    h = f32(L) / f32(2)
    grid = np.arange(-4, 6, dtype=f32) * h
    a = np.stack(np.meshgrid(grid, grid[:3], grid[:2]), -1).reshape(-1, 3)
    b = np.concatenate([a[::7], a[::5] + f32(L) * 3])
    return a, b, box, h


# ---------------------------------------------------------------- K2 tie sets
# Frames whose atoms sit where K2's image floor(d / L), d = (p - e) + L/2,
# turns over: d exactly k L and a few steps either side.  A floor taken
# from the reciprocal 1/L differs there from the true division's.  Few
# atoms per frame, so that one atom in another image moves the centre by
# L / n or more.  Shared by the CPU tests and the card's checks.

REFINE_TIE_LENGTHS = (21.0, 20.5, 7.3, 3.0)
REFINE_TIE_KS = (-1, 0, 1, 2)


def _tie_coordinates(e, L, k, steps):
    """Float32 coordinates p whose d = (p - e) + L/2 lies at fl(k L): the
    p that gives d == fl(k L) exactly (or, where none does, the nearest d),
    and `steps` distinct p on either side of it."""
    f32 = np.float32
    half = L * f32(0.5)
    target = f32(k) * L
    p0 = f32(np.float64(target) - np.float64(half) + np.float64(e))
    cand = np.unique(np.concatenate([
        (np.float64(p0) + np.arange(-64, 65) * np.float64(np.spacing(p0))).astype(f32),
        [p0]]))
    d = (cand - f32(e)) + half
    exact = np.flatnonzero(d == target)
    i = (exact[np.argmin(np.abs(exact - np.searchsorted(cand, p0)))] if len(exact)
         else int(np.argmin(np.abs(d.astype(np.float64) - np.float64(target)))))
    return cand[i - steps:i + steps + 1]


def refine_tie_sets(steps: int = 3):
    """(pos [F, n, 3], est [F, 3], box [F, 3]) float32: per box length of
    REFINE_TIE_LENGTHS three frames (three estimates per axis: L/2, 0 and
    a seeded value in [0, L/2), so that every unwrapped coordinate lies
    within L of 0 and a float32 sum of a frame in any order stays well
    within 1e-5 of its exact mean), each of n = len(REFINE_TIE_KS) x
    (2 steps + 1) atoms.  On every axis the atoms take, for each k of
    REFINE_TIE_KS, the coordinates of `_tie_coordinates` (d = fl(k L) and
    `steps` neighbours either side); the k of an atom rotates with the
    axis, so every atom is at a tie on all three axes."""
    f32 = np.float32
    rng = np.random.default_rng(4)
    nk, width = len(REFINE_TIE_KS), 2 * steps + 1
    pos, ests, boxes = [], [], []
    for length in REFINE_TIE_LENGTHS:
        L = f32(length)
        free = rng.uniform(0.0, length / 2, 3).astype(f32)
        for v in range(3):
            est = np.array([(L * f32(0.5), f32(0.0), free[ax])[(v + ax) % 3]
                            for ax in range(3)], f32)
            frame = np.empty((nk * width, 3), f32)
            for ax in range(3):
                for ki in range(nk):
                    k = REFINE_TIE_KS[(ki + ax) % nk]
                    frame[ki * width:(ki + 1) * width, ax] = _tie_coordinates(
                        est[ax], L, k, steps)
            pos.append(frame)
            ests.append(est)
            boxes.append(np.full(3, L, f32))
    return np.stack(pos), np.stack(ests), np.stack(boxes)


def refine_tie_atoms():
    """(pos [M, 4, 3], est [M, 3], box [M, 3], w [4]) float32: one frame per
    coordinate of `refine_tie_sets` (M = F x n x 3).  Atom 0 carries that
    coordinate on its axis and sits at the estimate on the other two (d =
    L/2, far from any image boundary); atoms 1..3 sit at the estimate and
    weigh 0.  The frame's weighted centre is atom 0's unwrapped position,
    exactly, in any sum order.  K2 gives one thread four consecutive atoms,
    so this frame is one thread, and only the coordinate under test can
    send it to the true division."""
    pos, est, box = refine_tie_sets()
    nf, na, _ = pos.shape
    f, a, ax = (g.ravel() for g in np.meshgrid(np.arange(nf), np.arange(na),
                                               np.arange(3), indexing="ij"))
    frames = np.repeat(est[f][:, None, :], 4, 1)
    frames[np.arange(len(f)), 0, ax] = pos[f, a, ax]
    return frames, est[f], box[f], np.array([1, 0, 0, 0], np.float32)


# ------------------------------------------------- ideal backbones (DSSP)

_BACKBONE_MASS = {"N": 14.007, "CA": 12.011, "C": 12.011, "O": 15.999}


def place_atom(a, b, c, bond, angle, torsion):
    """NeRF: atom d with |cd| = bond (nm), angle(b, c, d) and
    torsion(a, b, c, d) in degrees."""
    u = c - b
    u = u / np.linalg.norm(u)
    n = np.cross(b - a, u)
    n = n / np.linalg.norm(n)
    m = np.cross(n, u)
    ang, tor = np.radians(angle), np.radians(torsion)
    return c + bond * (-np.cos(ang) * u
                       + np.sin(ang) * (np.cos(tor) * m + np.sin(tor) * n))


def ideal_backbone(nres: int, phi: float, psi: float):
    """Ideal backbone (nm) of `nres` residues with uniform phi/psi and
    omega = 180 degrees (bond lengths N-CA 0.1458, CA-C 0.1525, C-N 0.1329,
    C=O 0.1231) -> float64 (N, CA, C, O), each [nres, 3]."""
    bn, bca, bc, bo = 0.1458, 0.1525, 0.1329, 0.1231
    n = [np.array([0.0, 0.0, 0.0])]
    ca = [np.array([bn, 0.0, 0.0])]
    c = [place_atom(np.array([0.0, 0.1, 0.0]), n[0], ca[0], bca, 111.2, phi)]
    for i in range(1, nres):
        n.append(place_atom(n[i - 1], ca[i - 1], c[i - 1], bc, 116.2, psi))
        ca.append(place_atom(ca[i - 1], c[i - 1], n[i], bn, 121.7, 180.0))
        c.append(place_atom(c[i - 1], n[i], ca[i], bca, 111.2, phi))
    o = []
    for i in range(nres):
        nxt = n[i + 1] if i + 1 < nres else place_atom(n[i], ca[i], c[i], bc,
                                                       116.2, psi)
        d1 = (ca[i] - c[i]) / np.linalg.norm(ca[i] - c[i])
        d2 = (nxt - c[i]) / np.linalg.norm(nxt - c[i])
        u = -(d1 + d2)
        o.append(c[i] + bo * u / np.linalg.norm(u))
    return tuple(np.asarray(x) for x in (n, ca, c, o))


HELIX_PHI_PSI = (-57.0, -47.0)
STRAND_PHI_PSI = (-139.0, 135.0)
SHEET_SPACING = 0.48  # nm between the two strands' axes


def ideal_hairpin(n_strand: int):
    """A two-stranded antiparallel beta hairpin (nm) whose turn is left out:
    strand A (`n_strand` residues, odd, at STRAND_PHI_PSI) and strand B,
    A turned by 180 degrees about the sheet normal through a line
    SHEET_SPACING / 2 off A's axis, so that A's residue k faces B's residue
    n_strand - 1 - k, the even k as hydrogen-bonded pairs.  In sequence B
    follows A (B's first residue faces A's last) -> float64 (N, CA, C, O),
    each [2 n_strand, 3]."""
    if n_strand % 2 == 0:
        raise ValueError("n_strand must be odd (the pairs facing each other "
                         "then share their parity)")
    bb = ideal_backbone(n_strand, *STRAND_PHI_PSI)
    ca = bb[1]
    mid = ca.mean(0)
    axis = np.linalg.svd(ca - mid)[2][0]
    co = bb[3] - bb[2]                          # C=O, alternating across the axis
    side = (co * ((-1.0) ** np.arange(n_strand))[:, None]).sum(0)
    side -= axis * (side @ axis)
    side /= np.linalg.norm(side)
    normal = np.cross(axis, side)
    rot = 2.0 * np.outer(normal, normal) - np.eye(3)   # 180 degrees about normal
    pivot = mid + side * (SHEET_SPACING / 2)
    return tuple(np.concatenate([x, (x - pivot) @ rot.T + pivot]) for x in bb)


def backbone_state(pieces, box: float | None = None, gap: int = 2) -> dict:
    """The state (`convert.system_from_state`) of backbone pieces: each a
    (N, CA, C, O) tuple, a chain id and, for a hairpin, its strand length
    (its second strand's residue numbers then skip `gap` for the left-out
    turn).  Atoms go N CA C O per residue, residues ALA numbered from 1 in
    each piece; the pieces sit on a square grid in the xy-plane, cells 2 nm
    wider than the largest piece, centred in a cubic box of side `box`
    (default: the grid plus 2 nm); groups 'Backbone' (all) and 'chain<id>'
    per chain id."""
    xyz = [np.stack(bb, 1) for bb, _, _ in pieces]            # [R, 4, 3] each
    cell = max(float(np.ptp(x.reshape(-1, 3), 0).max()) for x in xyz) + 2.0
    cols = int(np.ceil(np.sqrt(len(xyz))))
    pos, names, resnum, chain = [], [], [], []
    for k, (x, (_, ch, strand)) in enumerate(zip(xyz, pieces)):
        flat = x.reshape(-1, 3)
        at = np.array([k % cols, k // cols, 0.0]) * cell + cell / 2
        pos.append(flat - (flat.max(0) + flat.min(0)) / 2 + at)
        r = x.shape[0]
        num = np.arange(1, r + 1)
        if strand:
            num[strand:] += gap
        names += ["N", "CA", "C", "O"] * r
        resnum.append(np.repeat(num, 4))
        chain += [ch] * (4 * r)
    pos = np.concatenate(pos)
    box = float(np.ceil(np.ptp(pos, 0).max() + 2.0)) if box is None else float(box)
    pos += box / 2 - (pos.max(0) + pos.min(0)) / 2
    if pos.min() <= 0 or pos.max() >= box:
        raise ValueError(f"the backbones do not fit a {box} nm box")
    names = np.asarray(names)
    chain = np.asarray(chain)
    groups = {"Backbone": np.arange(len(names))}
    for ch in dict.fromkeys(chain.tolist()):
        groups[f"chain{ch}"] = np.flatnonzero(chain == ch)
    return {"name": "ideal backbones", "positions": pos.astype(np.float32),
            "box": np.full(3, box, np.float32),
            "mass": np.asarray([_BACKBONE_MASS[a] for a in names], np.float32),
            "has_mass": np.ones(len(names), bool), "precision": 10000,
            "atomname": names, "resname": np.full(len(names), "ALA"),
            "resnum": np.concatenate(resnum), "chain": chain, "groups": groups}


# ------------------------------------------------- float64 oracles (models)

def host_prepared(p, box, w):
    """`calc_rmsd`'s preparation of one frame in float64: the group shifted
    so its refined COM sits at the box centre, wrapped, and taken relative
    to the box centre -> (coords [K, 3], refined COM [3], distance of each
    atom's shifted coordinates from the wrap boundary [K]: an atom within
    float32 reach of it may land a box length away in a float32 run)."""
    box = np.asarray(box, np.float64)
    p = np.asarray(p, np.float64)
    com = host_refined_center(p, box, w)
    shifted = p + (box / 2 - com)
    edge = np.abs(shifted - box * np.round(shifted / box)).min(1)
    return np.mod(shifted, box) - box / 2, com, edge


def host_kabsch(pc, qc, w):
    """Float64 Kabsch of prepared coords (`host_prepared`): SVD of the
    unweighted covariance with the determinant fix, mass-weighted RMSD ->
    (rmsd, rotation R with pc @ R.T ~ qc)."""
    w = np.asarray(w, np.float64)
    u, _, vt = np.linalg.svd(pc.T @ qc)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    rot = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    dev = pc @ rot.T - qc
    return float(np.sqrt((w * (dev * dev).sum(1)).sum() / w.sum())), rot


def host_residue_min(p, box, blocks, rows=None, chunk: int = 64):
    """Float64 smallest minimum-image distance between atom blocks of one
    frame (`p` [K, 3]; `blocks` index arrays, of any lengths) -> [R, R],
    or [len(rows), R] for the row blocks `rows` (default `blocks`)."""
    p = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)

    def table(bl):   # padded with each block's first atom, which adds nothing
        width = max(len(b) for b in bl)
        return p[np.asarray([np.concatenate([b, np.repeat(b[:1], width - len(b))])
                             for b in map(np.asarray, bl)])]

    g = table(blocks)                                         # [R, P, 3]
    gr = g if rows is None else table(rows)
    out = np.empty((gr.shape[0], g.shape[0]))
    for i in range(0, gr.shape[0], chunk):
        d = gr[i:i + chunk, None, :, None, :] - g[None, :, None, :, :]
        d -= box * np.round(d / box)
        out[i:i + chunk] = np.sqrt(np.einsum("...k,...k->...", d, d).min((-2, -1)))
    return out


def host_entropy(lam, temperature: float):
    """Schlitter and quasi-harmonic entropies, kJ/(mol K), of mass-weighted
    covariance eigenvalues `lam` (amu nm^2), float64, the formulas of
    `models.entropy`'s docstring -> (schlitter, quasiharmonic)."""
    kb, hbar, r_gas = 1.380649e-23, 1.0545718176e-34, 8.31446261815324e-3
    lam = np.clip(np.asarray(lam, np.float64), 0.0, None) * 1.66053906660e-45
    kbt = kb * temperature
    schlitter = 0.5 * r_gas * np.log1p(kbt * lam * np.e ** 2 / hbar ** 2).sum()
    a = hbar / np.sqrt(kbt * lam[lam > 0])
    with np.errstate(over="ignore"):
        qh = r_gas * (a / np.expm1(a) - np.log1p(-np.exp(-a))).sum()
    return float(schlitter), float(qh)


def host_clusters(matrix, method: str, cutoff: float, jp_m: int = 10, jp_p: int = 3):
    """Cluster labels of an RMSD matrix by the `gmx cluster` rules, written
    out frame by frame: 'gromos' (repeatedly the frame with the most
    unassigned neighbours within `cutoff`, itself included, lowest index on
    ties, takes them), 'linkage' (connected components of d < cutoff) and
    'jarvis-patrick' (mutual members of each other's `jp_m` nearest lists
    sharing at least `jp_p`); clusters numbered largest first, then by
    their first frame -> labels [F]."""
    m = np.asarray(matrix)
    f = m.shape[0]
    labels = np.full(f, -1, np.int64)
    if method == "gromos":
        near = [set(np.flatnonzero(m[i] < cutoff)) | {i} for i in range(f)]
        left, k = set(range(f)), 0
        while left:
            best = max(sorted(left), key=lambda i: (len(near[i] & left), -i))
            for j in near[best] & left:
                labels[j] = k
            left -= near[best]
            k += 1
        return labels
    if method == "linkage":
        edge = lambda i, j: i != j and m[i, j] < cutoff  # noqa: E731
    else:
        nn = [set(sorted(set(range(f)) - {i}, key=lambda j: (m[i, j], j))[:jp_m])
              for i in range(f)]
        edge = lambda i, j: (i != j and j in nn[i] and i in nn[j]  # noqa: E731
                             and len(nn[i] & nn[j]) >= jp_p)
    comps = []
    for i in range(f):
        if labels[i] >= 0:
            continue
        labels[i] = len(comps)
        stack, members = [i], [i]
        while stack:
            a = stack.pop()
            for b in range(f):
                if labels[b] < 0 and (edge(a, b) or edge(b, a)):
                    labels[b] = len(comps)
                    stack.append(b)
                    members.append(b)
        comps.append(members)
    order = sorted(range(len(comps)), key=lambda c: (-len(comps[c]), min(comps[c])))
    rank = np.empty(len(comps), np.int64)
    rank[order] = np.arange(len(comps))
    return rank[labels]


def host_covariance_eigh(x, sw=None):
    """Float64 eigenvalues (descending) of the covariance of fitted frames
    `x` [F, K, 3], deviations scaled by `sw` [K] (sqrt masses)."""
    x = np.asarray(x, np.float64)
    d = x - x.mean(0)
    if sw is not None:
        d = d * np.asarray(sw, np.float64)[None, :, None]
    d = d.reshape(x.shape[0], -1)
    return np.linalg.eigvalsh(d.T @ d / x.shape[0])[::-1]


def host_dssp_energy(n, ca, c, o, box, donor_ok, rows=None, cols=None):
    """Float64 Kabsch-Sander energies of one frame ([R, 3] nm per atom
    kind, orthorhombic `box`): `e[j, i]` donor NH(j) -> acceptor CO(i)
    kcal/mol for donors `rows` and acceptors `cols` (default all), with
    the amide H estimated from the previous residue's C and O; +inf for
    |i - j| < 2 and donors that are not `donor_ok`."""
    n, c, o = (np.asarray(x, np.float64) for x in (n, c, o))
    box = np.asarray(box, np.float64)
    r = n.shape[0]
    rows = np.arange(r) if rows is None else np.asarray(rows)
    cols = np.arange(r) if cols is None else np.asarray(cols)

    def mi(d):
        return d - box * np.round(d / box)

    def unit(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    h = n.copy()
    h[1:] = n[1:] + 0.101 * unit(unit(mi(n[1:] - c[:-1])) + unit(mi(n[1:] - o[:-1])))

    e = np.zeros((rows.shape[0], cols.shape[0]))
    pairs = ((n, o, 1.0), (h, c, 1.0), (h, o, -1.0), (n, c, -1.0))
    planes = [np.ascontiguousarray(b[cols].T) for _, b, _ in pairs]   # [3, cols]
    for k in range(0, rows.shape[0], 256):
        rk = rows[k:k + 256]
        for (a, _, sign), bt in zip(pairs, planes):
            d2 = np.zeros((rk.shape[0], cols.shape[0]))
            for ax in range(3):                   # minimum image axis by axis
                d = a[rk, ax][:, None] - bt[ax][None]
                q = d / box[ax]
                np.rint(q, out=q)
                q *= box[ax]
                d -= q
                d *= d
                d2 += d
            e[k:k + 256] += sign / (10.0 * np.sqrt(d2))
    e *= 0.084 * 332.0
    bad = (np.abs(rows[:, None] - cols[None]) < 2) | ~np.asarray(donor_ok)[rows][:, None]
    return np.where(bad, np.inf, e)


def host_dssp_codes(hb, consec, states: int = 3, ca=None, box=None, residues=None):
    """Kabsch-Sander codes of one frame from its hydrogen-bond matrix
    `hb[j, i]` (donor NH(j) -> acceptor CO(i) below the cutoff) in numpy:
    3-state H/E/- or 8-state H/G/I/E/B/T/S/- (bends from `ca` [R, 3] in an
    orthorhombic `box`, float64), the rules of the JAX package's
    `ops/dssp.py` written out per residue pair -> [R] str, or the codes of
    `residues` (lo, hi) alone, which read `hb` only in rows and columns
    lo - 8 .. hi + 8 (bridges with any residue, turns up to 5 apart)."""
    hb = np.asarray(hb, bool)
    r = hb.shape[0]
    lo, hi = (0, r) if residues is None else residues
    kp = np.zeros((r + 2, r + 2), bool)
    kp[1:-1, 1:-1] = hb.T                             # kp[i+1, j+1] = Hbond(i, j)
    consec = np.asarray(consec, bool)
    bad = np.concatenate([[0], np.cumsum(~consec)])
    rows = np.arange(max(0, lo - 2), min(r, hi + 2))  # bridges of these residues

    def hbond(di, dj):                                # [i in rows, j] -> Hbond(i+di, j+dj)
        return kp[rows + 1 + di][:, 1 + dj:1 + dj + r]

    def hbond_t(di, dj):                              # [i in rows, j] -> Hbond(j+di, i+dj)
        return kp[1 + di:1 + di + r][:, rows + 1 + dj].T

    def helix(k):                                     # (minimal k-helices, k-turns) [R]
        m = max(0, r - k)
        turn = np.zeros(r, bool)
        turn[:m] = np.diagonal(kp[1:-1, 1:-1], k)[:m] & (bad[k:k + m] == bad[:m])
        span = np.zeros(r, bool)
        for i in np.flatnonzero(turn[:-1] & turn[1:]):
            span[i + 2:i + 2 + k] = True
        return span, turn

    far = np.abs(rows[:, None] - np.arange(r)[None]) >= 3
    par = ((hbond(-1, 0) & hbond_t(0, 1)) | (hbond_t(-1, 0) & hbond(0, 1))) & far
    anti = ((hbond(0, 0) & hbond_t(0, 0)) | (hbond(-1, 1) & hbond_t(-1, 1))) & far
    ss = np.full(r, "-", "U1")
    out = slice(lo, hi)
    if states == 3:
        for k in (3, 4, 5):
            ss[helix(k)[0]] = "H"
        ss[rows[(par | anti).any(1)]] = "E"
        return ss[out] if residues is not None else ss

    def continued(b, anti_):                          # bridge with an adjacent one
        bp = np.zeros((b.shape[0] + 2, r + 2), bool)  # rows are consecutive residues
        bp[1:-1, 1:-1] = b
        m = b.shape[0]
        if anti_:                                     # (i-1, j+1) or (i+1, j-1)
            adj = bp[0:m, 2:r + 2] | bp[2:m + 2, 0:r]
        else:                                         # (i-1, j-1) or (i+1, j+1)
            adj = bp[0:m, 0:r] | bp[2:m + 2, 2:r + 2]
        return b & adj

    strand = np.zeros(r, bool)
    strand[rows] = (continued(par, False) | continued(anti, True)).any(1)
    bridged = np.zeros(r, bool)
    bridged[rows] = (par | anti).any(1)
    isolated = bridged & ~strand
    spans = {k: helix(k) for k in (3, 4, 5)}
    inside = np.zeros(r, bool)
    for k, (_, turn) in spans.items():
        for i in np.flatnonzero(turn):
            inside[i + 1:i + k] = True
    bend = np.zeros(r, bool)
    if ca is not None and r >= 5:
        x = np.asarray(ca, np.float64)
        bx = np.asarray(box, np.float64)
        u = x[2:] - x[:-2]
        u -= bx * np.round(u / bx)
        v1, v2 = u[:-2], u[2:]                        # at residue i: i-2 -> i -> i+2
        cosk = (v1 * v2).sum(1) / np.maximum(
            np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1), 1e-12)
        ok = bad[4:r] == bad[:r - 4]                  # residues i-2 .. i+2 consecutive
        bend[2:r - 2] = (np.degrees(np.arccos(np.clip(cosk, -1, 1))) > 70.0) & ok
    for mask, code in ((bend, "S"), (inside, "T"), (spans[5][0], "I"),
                       (spans[3][0], "G"), (isolated, "B"), (strand, "E"),
                       (spans[4][0], "H")):
        ss[mask] = code
    return ss[out] if residues is not None else ss


# ------------------------------------------------- oracles of the dynamics family
# Float64 restatements of the formulas of `groan_rs_tpu/models/dynamics.py`'s
# docstrings (`gmx msd`, `velacc`, `dos`, `rotacf`, `current`, `vanhove`,
# `filter`, `tcaf`, `dipoles -corr`), over all time origins; none calls
# the port.

AMU_NM_PS_TO_PAS = 1.66053906660e-6   # amu/(nm ps) -> Pa s


def ar1_velocities(n_frames: int, n_atoms: int, seed: int = 23, phi: float = 0.9,
                   sigma: float = 0.3) -> np.ndarray:
    """`[F, N, 3]` float32 velocities (nm/ps): a seeded AR(1) per atom and
    axis, v[t + 1] = phi v[t] + sqrt(1 - phi^2) sigma xi, stationary with
    standard deviation sigma, so that C(tau) ~ phi^tau."""
    rng = np.random.default_rng(seed)
    v = np.empty((n_frames, n_atoms, 3), np.float32)
    v[0] = rng.normal(size=(n_atoms, 3)) * sigma
    c = np.sqrt(1.0 - phi * phi) * sigma
    for f in range(1, n_frames):
        v[f] = phi * v[f - 1] + c * rng.normal(size=(n_atoms, 3))
    return v


def write_trr(path, coords, boxes9, times, steps, velocities) -> None:
    """Write (replacing) a TRR of positions and velocities, frame by frame
    (`boxes9` the `[F, 9]` box matrices as the XTC reader gives them)."""
    if os.path.exists(path):
        os.unlink(path)
    for f in range(len(coords)):
        native.trr_write_frame(path, coords.shape[1], int(steps[f]), float(times[f]), 0.0,
                               np.asarray(boxes9[f], np.float32), x=coords[f],
                               v=velocities[f])


def host_unwrap(pos, boxes) -> np.ndarray:
    """Float64 continuous paths of wrapped `[F, K, 3]` positions: each
    consecutive displacement through the minimum image of the later
    frame's box (`[F, 3]` lengths or `[F, 3, 3]` matrices), summed."""
    p = np.asarray(pos, np.float64)
    b = np.asarray(boxes, np.float64)
    d = p[1:] - p[:-1]
    if b.ndim == 3:
        d = np.stack([host_min_image_triclinic(d[i], b[i + 1]) for i in range(len(d))])
    else:
        d -= b[1:, None, :] * np.round(d / b[1:, None, :])
    return np.concatenate([p[:1], p[:1] + np.cumsum(d, axis=0)])


def host_msd(u, lags, axes=(0, 1, 2), per_entity: bool = False) -> np.ndarray:
    """Mean over the F - lag origins (and the K entities, unless
    `per_entity`) of the squared displacement over `axes` -> [L] or [L, K]."""
    u = np.asarray(u, np.float64)[..., list(axes)]
    f = u.shape[0]
    out = []
    for lag in np.asarray(lags, np.int64):
        d = u[lag:] - u[:f - lag]
        sq = (d * d).sum(-1).mean(0)
        out.append(sq if per_entity else sq.mean())
    return np.asarray(out)


def host_msd_axes(u, lags) -> np.ndarray:
    """`[L, 3]`: per axis, the mean over the F - lag origins and the K
    atoms of the squared displacement (`host_msd` of any axes is a sum of
    its columns)."""
    u = np.asarray(u, np.float64)
    f = u.shape[0]
    return np.asarray([((u[lag:] - u[:f - lag]) ** 2).mean((0, 1))
                       for lag in np.asarray(lags, np.int64)])


def host_lag_corr(s, lags, w=None, order: int | None = None) -> np.ndarray:
    """Mean over the F - lag origins of the (w-weighted) mean over K of
    s(t) . s(t + lag), or of its Legendre polynomial P_order."""
    return host_lag_corrs(s, lags, [(w, order)])[0]


def host_lag_corrs(s, lags, forms) -> list:
    """`host_lag_corr` for each (w, order) of `forms`, from one dot
    product per lag."""
    s = np.asarray(s, np.float64)
    f, k = s.shape[:2]
    out = [[] for _ in forms]
    for lag in np.asarray(lags, np.int64):
        dot = (s[lag:] * s[:f - lag]).sum(-1)
        for i, (w, order) in enumerate(forms):
            x = 1.5 * dot * dot - 0.5 if order == 2 else dot
            w = np.ones(k) if w is None else np.asarray(w, np.float64)
            out[i].append(float((x @ w).sum() / (w.sum() * (f - lag))))
    return [np.asarray(o) for o in out]


def host_fit(t, y, lo: float, hi: float, positive: bool = False):
    """Float64 least-squares line over the lag times in [lo, hi] x the
    largest (and t > 0 with `positive`) -> (slope(s), intercept(s), mask)."""
    t = np.asarray(t, np.float64)
    mask = (t >= lo * t[-1]) & (t <= hi * t[-1])
    if positive:
        mask &= t > 0
    a = np.stack([t[mask], np.ones(int(mask.sum()))], 1)
    coef = np.linalg.lstsq(a, np.asarray(y, np.float64)[mask], rcond=None)[0]
    return coef[0], coef[1], mask


def host_com_paths(u, mol, w) -> np.ndarray:
    """`[F, M, 3]` w-weighted centres of the continuous paths `u` [F, K, 3]
    per molecule label `mol` [K] (molecules in label order)."""
    u = np.asarray(u, np.float64)
    _, inv = np.unique(mol, return_inverse=True)
    inv = inv.reshape(-1)
    m = int(inv.max()) + 1
    w = np.asarray(w, np.float64)
    wsum = np.bincount(inv, w, m)
    out = np.empty((u.shape[0], m, 3))
    for f in range(u.shape[0]):
        for a in range(3):
            out[f, :, a] = np.bincount(inv, w * u[f, :, a], m) / wsum
    return out


def host_unit_vectors(head, tail, boxes) -> np.ndarray:
    """`[F, K, 3]` unit minimum-image vectors from `tail` to `head`."""
    b = np.asarray(boxes, np.float64)
    d = np.stack([_mi(np.asarray(head[f], np.float64) - np.asarray(tail[f], np.float64), b[f])
                  for f in range(len(b))])
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def host_dipole_paths(u, q) -> np.ndarray:
    """`[F, 3]` translational dipoles sum_i q_i u_i(t) in float64."""
    return np.einsum("fka,k->fa", np.asarray(u, np.float64), np.asarray(q, np.float64))


def current_bound(q, u_max: float, mj2) -> np.ndarray:
    """Per-lag bound on |mj2_float32 - mj2_float64| of `current`, from the
    float32 error of each frame's M_J = sum_i q_i u_i, per axis:

    - the paths: each u_i(t) = pos_i(0) + cumsum(d) rounds once at
      ulp(u_max) / 2 (the cumsum of small steps adds far less), so a
      displacement carries about one ulp; over N atoms of random sign
      that is sqrt(N) max|q| ulp(u_max);
    - the sum over N terms |q_i u_i| <= max|q| u_max, reduced as a tree
      (or in blocks no longer than log2 N): 2^-24 sqrt(N log2 N) max|q|
      u_max per frame, sqrt(2) of it for a difference of two frames.

    With B the sum of the two, |d(ΔM . ΔM)| <= 2 |ΔM| sqrt(3) B + 3 B^2,
    |ΔM| = sqrt(mj2).  At the 1M-atom smoke (max|q| 0.834, u_max ~ 21 nm,
    |ΔM| ~ 8 e nm at one lag) this is ~3e-3 relative at lag 1 and ~5e-4
    at lag 47; the error it models is statistical, not a worst case."""
    q = np.asarray(q, np.float64)
    n = q.shape[0]
    qmax = np.abs(q).max()
    ulp = float(np.spacing(np.float32(u_max)))
    b = (np.sqrt(n) * qmax * ulp
         + np.sqrt(2.0) * 2.0 ** -24 * np.sqrt(n * max(1.0, np.log2(n))) * qmax * u_max)
    return 2.0 * np.sqrt(np.asarray(mj2, np.float64)) * np.sqrt(3.0) * b + 3.0 * b * b


def host_vanhove(u, lags, r_max: float, bins: int, tol: float = 1e-6):
    """`[L, bins + 1]` int64 counts of the displacement norms over every
    origin and atom in shells of r_max / bins (the last column: at or past
    r_max), and per lag the number of norms within `tol` nm of a shell
    edge (where a float32 norm may fall on the other side)."""
    u = np.asarray(u, np.float64)
    f = u.shape[0]
    dr = r_max / bins
    counts, edge = [], []
    for lag in np.asarray(lags, np.int64):
        d = u[lag:] - u[:f - lag]
        r = np.sqrt((d * d).sum(-1)).reshape(-1)
        idx = np.where(r >= r_max, bins, np.minimum((r / dr).astype(np.int64), bins))
        counts.append(np.bincount(idx, minlength=bins + 1))
        near = np.abs(r / dr - np.round(r / dr)) * dr < tol
        edge.append(int((near & (r > tol)).sum()))
    return np.asarray(counts, np.int64), np.asarray(edge)


def host_filtered(u, window: int) -> np.ndarray:
    """The cosine low-pass filter of `gmx filter` in float64: weights
    1 + cos(pi i / (n + 1)) over the `window` frames around each frame,
    renormalised over the frames present."""
    u = np.asarray(u, np.float64)
    f = u.shape[0]
    half = window // 2
    band = np.zeros((f, f))
    for i in range(f):
        for o in range(-half, half + 1):
            if 0 <= i + o < f:
                band[i, i + o] = 1.0 + np.cos(np.pi * o / (half + 1))
    band /= band.sum(1, keepdims=True)
    return np.einsum("ij,jka->ika", band, u)


def host_dos(c_w, c_u, t, m_total: float, n_atoms: int) -> dict:
    """`gmx dos` in float64 from the mass-weighted (per unit mass) and
    plain atom-mean VACFs: T from C(0) = 3 N kB T, S(nu) = 2 / (kB T) times
    the real FT of the even extension (a rectangle rule, via the FFT), the
    integral of S (dof, 3N by Parseval) and the Green-Kubo D (cm^2/s)."""
    kb = 8.3144626e-3
    c = np.asarray(c_w, np.float64) * m_total
    t = np.asarray(t, np.float64)
    dt = t[1] - t[0]
    temp = c[0] / (3.0 * n_atoms * kb)
    ext = np.concatenate([c, c[-2:0:-1]])
    s = 2.0 / (kb * temp) * np.fft.rfft(ext).real * dt
    dof = (s.sum() - 0.5 * (s[0] + s[-1])) / (len(ext) * dt)
    c_u = np.asarray(c_u, np.float64)
    d = (np.diff(t) * (c_u[1:] + c_u[:-1]) / 2.0).sum() / 3.0
    return {"T": temp, "dos": s, "dof": dof, "D": d * 1e-2, "vacf": c}


def host_tcaf(pos, vel, mass, box, n_k: int, fit_floor: float, dt: float,
              prefix=None) -> dict:
    """`gmx tcaf` in float64: per axis a, mode m (k = 2 pi m / L_a) and
    transverse axis b the current sum m_i v_ib exp(i k x_ia), its
    all-origin ACF (real part), averaged over the 6 (a, b) pairs;
    normalised; nu from a line through ln C over the leading points above
    `fit_floor` (at least 3; or `prefix[m]` points when given); eta(k) =
    rho nu(k), eta0 from eta(k) = eta0 (1 - a k^2) over the mean k^2."""
    p = np.asarray(pos, np.float64)
    v = np.asarray(vel, np.float64)
    mass = np.asarray(mass, np.float64)
    box = np.asarray(box, np.float64)
    f = p.shape[0]
    curves = np.zeros((n_k, f))
    for a in range(3):
        # exp(i m k1 x) as powers of exp(i k1 x): one cos and sin per axis
        e1 = np.exp(1j * (2.0 * np.pi / box[a]) * p[:, :, a])
        em = mass * e1
        for m in range(n_k):
            for b in (b for b in range(3) if b != a):
                j = (em * v[:, :, b]).sum(1)
                curves[m] += [(j[lag:] * np.conj(j[:f - lag])).real.sum() / (f - lag)
                              for lag in range(f)]
            em = em * e1
    curves /= 6.0
    cn = curves / curves[:, :1]
    t = np.arange(f) * dt
    k2 = (2.0 * np.pi * np.arange(1, n_k + 1) * np.mean(1.0 / box)) ** 2
    nu, stops = np.empty(n_k), []
    for m in range(n_k):
        good = cn[m] > fit_floor
        stop = f if good.all() else int(np.argmin(good))
        stop = max(stop, 3) if prefix is None else int(prefix[m])
        stops.append(stop)
        a = np.stack([t[:stop], np.ones(stop)], 1)
        slope = np.linalg.lstsq(a, np.log(np.maximum(cn[m, :stop], 1e-12)), rcond=None)[0][0]
        nu[m] = -slope / k2[m]
    rho = mass.sum() / np.prod(box)
    eta_k = rho * nu * AMU_NM_PS_TO_PAS
    eta0 = np.linalg.lstsq(np.stack([np.ones(n_k), k2], 1), eta_k, rcond=None)[0][0]
    return {"tcaf": cn, "nu": nu, "eta_k": eta_k, "eta0": eta0, "stops": stops}


def host_molecular_dipoles(p, boxes, mol, w, q):
    """Per frame the total dipole `[F, 3]` (sum q_i r_i, r_i the minimum
    image from the first atom of i's molecule; `host_total_dipole`) and
    the molecular dipoles `[F, M, 3]` about each molecule's w-weighted
    mean of the r_i (molecules by label `mol` [K], in label order)."""
    _, inv = np.unique(mol, return_inverse=True)
    inv = inv.reshape(-1)
    m = int(inv.max()) + 1
    first = np.full(m, inv.shape[0])
    np.minimum.at(first, inv, np.arange(inv.shape[0]))
    w = np.asarray(w, np.float64)
    q = np.asarray(q, np.float64)
    wsum = np.bincount(inv, w, m)
    b = np.asarray(boxes, np.float64)
    total, out = np.empty((len(b), 3)), np.empty((len(b), m, 3))
    for f in range(len(b)):
        x = np.asarray(p[f], np.float64)
        rel = _mi(x - x[first[inv]], b[f])
        total[f] = (q[:, None] * rel).sum(0)
        com = np.stack([np.bincount(inv, w * rel[:, a], m) for a in range(3)], 1) / wsum[:, None]
        d = rel - com[inv]
        out[f] = np.stack([np.bincount(inv, q * d[:, a], m) for a in range(3)], 1)
    return total, out


# ------------------------------------------ membrane and interfacial water
# (`models/membrane.py`), float64, written from the JAX docstrings


def host_leaflets(z, lz, tol: float = 1e-5):
    """Leaflets of head coordinates `z` [F, L] along a box axis of lengths
    `lz` [F]: the circular-mean centre, each head's minimum-image
    displacement from it signs its leaflet (+1 at or above) -> (leaflet
    [F, L], thickness [F], centre [F] in [0, lz), near [F, L]: heads within
    `tol` nm of the centre or of the half-box point, whose float32 sign may
    differ)."""
    z = np.asarray(z, np.float64)
    lz = np.asarray(lz, np.float64)[:, None]
    theta = np.mod(z, lz) * (2 * np.pi / lz)
    c = (np.arctan2(-np.sin(theta).mean(1), -np.cos(theta).mean(1)) + np.pi) \
        * lz[:, 0] / (2 * np.pi)
    d = z - c[:, None]
    d -= lz * np.round(d / lz)
    up = d >= 0
    thick = (np.where(up, d, 0.0).sum(1) / np.maximum(up.sum(1), 1)
             - np.where(up, 0.0, d).sum(1) / np.maximum((~up).sum(1), 1))
    near = (np.abs(d) < tol) | (np.abs(np.abs(d) - lz / 2) < tol)
    return np.where(up, 1, -1), thick, np.mod(c, lz[:, 0]), near


def _hist_slack(x, w, lo: float, width: float, n: int, tol):
    """Histogram of values `x` with weights `w` into `n` bins of `width`
    from `lo`, the index clipped to [0, n) -> (sure [n]: the values away
    from every edge, slack [n]: |w| of each value within `tol` (absolute,
    scalar or per value) of an edge, added to both bins it may fall in)."""
    x = np.asarray(x, np.float64).reshape(-1)
    w = np.broadcast_to(np.asarray(w, np.float64), x.shape).reshape(-1)
    tol = np.broadcast_to(np.asarray(tol, np.float64), x.shape).reshape(-1)
    u = (x - lo) / width
    k = np.round(u)
    near = np.abs(u - k) * width < tol
    b = np.clip(np.floor(u), 0, n - 1).astype(np.int64)
    sure = np.bincount(b[~near], w[~near], n)
    slack = np.zeros(n)
    for c in (k[near] - 1, k[near]):
        np.add.at(slack, np.clip(c, 0, n - 1).astype(np.int64), np.abs(w[near]))
    return sure, slack


def host_densmap(frames, boxes, i1: int, i2: int, nx: int, ny: int, w,
                 tol: float = 1e-5):
    """2-D density map of `frames` [F, K, 3] over the fractional tiles of
    their boxes ([F, 3] lengths or [F, 3, 3] matrices) on axes `i1`, `i2`
    -> (counts, density, counts_slack, density_slack) [nx, ny]: weights
    summed per tile, and weight * nx * ny / volume averaged over frames.
    With lengths the tile index follows the device's float32 rule (x / L,
    minus its floor, times n, truncated), so the slack is zero; with
    matrices the fractional coordinates are float64 and an atom within
    `tol` nm of a tile edge goes to the slack of every tile it may fall in."""
    frames = np.asarray(frames)
    b = np.asarray(boxes, np.float64)
    w = np.asarray(w, np.float64)
    f = frames.shape[0]
    out = [np.zeros((nx, ny)) for _ in range(4)]
    for i in range(f):
        if b.ndim == 2:
            p32 = np.asarray(frames[i], np.float32)
            fr = p32 / b[i].astype(np.float32)
            fr = fr - np.floor(fr)
            ix = np.clip((fr[:, i1] * np.float32(nx)).astype(np.int32), 0, nx - 1)
            iy = np.clip((fr[:, i2] * np.float32(ny)).astype(np.int32), 0, ny - 1)
            near = np.zeros(ix.shape, bool)
            vol = np.prod(b[i])
            lens = None
        else:
            s = np.asarray(frames[i], np.float64) @ np.linalg.inv(b[i])
            s -= np.floor(s)
            lens = np.linalg.norm(b[i], axis=1)
            u, v = s[:, i1] * nx, s[:, i2] * ny
            nu = np.abs(u - np.round(u)) * lens[i1] / nx < tol
            nv = np.abs(v - np.round(v)) * lens[i2] / ny < tol
            near = nu | nv
            ix = np.clip(np.floor(u), 0, nx - 1).astype(np.int64)
            iy = np.clip(np.floor(v), 0, ny - 1).astype(np.int64)
            vol = abs(np.linalg.det(b[i]))
        scale = nx * ny / vol
        flat = (ix * ny + iy)[~near]
        out[0] += np.bincount(flat, w[~near], nx * ny).reshape(nx, ny)
        out[1] += np.bincount(flat, w[~near] * (scale / f), nx * ny).reshape(nx, ny)
        if near.any():
            # a near axis has the two tiles about its edge (modulo the
            # periodic wrap), a sure one its own tile once
            cu = [np.where(nu, np.round(u) - k, ix)[near] for k in (1, 0)]
            cv = [np.where(nv, np.round(v) - k, iy)[near] for k in (1, 0)]
            aw = np.abs(w[near])
            for a in (0, 1):
                for c in (0, 1):
                    keep = ((a == 0) | nu[near]) & ((c == 0) | nv[near])
                    ci = np.mod(cu[a][keep], nx).astype(np.int64)
                    cj = np.mod(cv[c][keep], ny).astype(np.int64)
                    np.add.at(out[2], (ci, cj), aw[keep])
                    np.add.at(out[3], (ci, cj), aw[keep] * scale / f)
    return tuple(out)


def potential_gap_bound(rho_gap, box_len: float, n_bins: int):
    """What a gap `rho_gap` [n_bins] of the mean charge density moves the
    potential profile's field and psi by, through their cumulative sums
    (a constant box: the frame mean commutes with them) -> (field bound,
    psi bound), each plus 1e-9 for the float64 sums."""
    dz = box_len / n_bins
    field = 18.0951262 * np.cumsum(np.abs(rho_gap)) * dz + 1e-9
    return field, np.cumsum(field) * dz + 1e-9


def host_potential(frames, boxes, q, axis: int, n_bins: int) -> dict:
    """Electrostatic potential profile of `frames` [F, N, 3] in box lengths
    [F, 3] with charges `q`: the charge density per slab
    (`host_density_profile`), E = (e / eps0) cumsum(rho) dz and
    psi = -cumsum(E) dz per frame, averaged -> {'rho', 'field', 'psi'}."""
    e_over_eps0 = 18.0951262  # V nm per (e / nm^3) nm^2: e / (eps0 nm)
    b = np.asarray(boxes, np.float64)
    rho = np.stack([host_density_profile(frames[i], b[i], axis, n_bins, q)
                    for i in range(b.shape[0])])
    dz = b[:, axis] / n_bins
    field = e_over_eps0 * np.cumsum(rho, 1) * dz[:, None]
    psi = -np.cumsum(field, 1) * dz[:, None]
    return {"rho": rho.mean(0), "field": field.mean(0), "psi": psi.mean(0)}


def host_interfaces(prof, box_len, threshold: float):
    """The two positions (nm) where each frame's profile `prof` [F, bins]
    crosses `threshold` times its maximum, scanning inward from each box
    edge with linear interpolation between slab centres (the edge slab's
    centre when the profile is above the level there) -> (lower, upper)."""
    prof = np.asarray(prof, np.float64)
    f, n = prof.shape
    centers = (np.arange(n) + 0.5) / n
    lower, upper = np.full(f, np.nan), np.full(f, np.nan)
    for i in range(f):
        p = prof[i]
        lvl = threshold * p.max()
        above = np.flatnonzero(p >= lvl)
        if p.max() <= 0 or not above.size:
            continue
        j0, j1 = above[0], above[-1]
        lo = (centers[j0 - 1] + (lvl - p[j0 - 1]) / (p[j0] - p[j0 - 1]) / n
              if j0 > 0 else centers[0])
        hi = (centers[j1] + (p[j1] - lvl) / (p[j1] - p[j1 + 1]) / n
              if j1 < n - 1 else centers[-1])
        lower[i], upper[i] = lo * box_len[i], hi * box_len[i]
    return lower, upper


def _water_bonds(po, ph1, ph2, box):
    b = np.asarray(box, np.float64)
    po = np.asarray(po, np.float64)
    return (po, _mi(np.asarray(ph1, np.float64) - po, b),
            _mi(np.asarray(ph2, np.float64) - po, b))


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-300)


def host_sorient(po, ph1, ph2, pref, w_ref, boxes, rmin: float, rmax: float,
                 nb: int, delta=0.0, tol: float = 1e-5) -> dict:
    """`gmx sorient` sums over frames: oxygens `po` and hydrogens `ph1`,
    `ph2` [F, W, 3], the reference group `pref` [F, K, 3] with weights
    `w_ref`, boxes [F, 3] or [F, 3, 3].  The reference centre is
    `host_refined_center` (or its triclinic form).  Returns the sums 'h1',
    'h2', 'rs', 'rn' [nb] (sure parts) with their '*_slack', and 's1',
    's2', 'n' with 's1_slack', 's2_slack', 'n_slack': a water within `tol`
    nm (plus `delta`, the float32 centre's distance from this one) of rmin
    or rmax may be in or out of the shell, and a cosine, uncertain by `tol`
    plus delta / r (the outward vector turns by that much), may be in
    either bin about an edge; the sums' slacks add that uncertainty."""
    b = np.asarray(boxes, np.float64)
    tri = b.ndim == 3
    acc = {k: np.zeros(nb) for k in ("h1", "h2", "rs", "rn", "h1_slack",
                                      "h2_slack", "rs_slack", "rn_slack")}
    acc.update({k: 0.0 for k in ("s1", "s2", "n", "s1_slack", "s2_slack", "n_slack")})
    delta = np.broadcast_to(np.asarray(delta, np.float64), (b.shape[0],))
    for f in range(b.shape[0]):
        ctr = host_refined_center_triclinic if tri else host_refined_center
        com = ctr(pref[f], b[f], w_ref)
        o, b1, b2 = _water_bonds(po[f], ph1[f], ph2[f], b[f])
        out_v = _mi(o - com, b[f])
        r = np.linalg.norm(out_v, axis=-1)
        ou = _unit(out_v)
        c1 = (_unit(b1 + b2) * ou).sum(-1)
        c2 = np.stack([(_unit(b1) * ou).sum(-1), (_unit(b2) * ou).sum(-1)])
        rt = tol + delta[f]
        ct = tol + delta[f] / np.maximum(r, 1e-3)
        shell_near = (np.abs(r - rmin) < rt) | (np.abs(r - rmax) < rt)
        sel = (r > rmin) & (r <= rmax) & ~shell_near
        for key, vals in (("h1", c1[None]), ("h2", c2)):
            for v in vals:
                sure, slack = _hist_slack(v, sel, -1.0, 2.0 / nb, nb, ct)
                acc[key] += sure
                acc[key + "_slack"] += slack + _hist_slack(
                    v, shell_near, -1.0, 2.0 / nb, nb, np.inf)[1]
        acc["s1"] += (c1 * sel).sum()
        acc["s2"] += (c2.sum(0) * sel).sum()
        acc["n"] += sel.sum()
        acc["s1_slack"] += np.abs(c1[shell_near]).sum() + ct[sel].sum()
        acc["s2_slack"] += np.abs(c2[:, shell_near]).sum() + 2 * ct[sel].sum()
        acc["n_slack"] += shell_near.sum()
        inr_near = np.abs(r - rmax) < rt
        inr = (r <= rmax) & ~inr_near
        for key, wv in (("rs", c1), ("rn", np.ones_like(c1))):
            sure, slack = _hist_slack(r, wv * inr, 0.0, rmax / nb, nb, rt)
            acc[key] += sure
            acc[key + "_slack"] += slack + _hist_slack(
                r, wv * inr_near, 0.0, rmax / nb, nb, np.inf)[1]
        acc["rs_slack"] += _hist_slack(r, ct * inr, 0.0, rmax / nb, nb, 0.0)[0]
    return acc


def host_h2order(po, ph1, ph2, boxes, axis: int, nb: int) -> dict:
    """`gmx h2order` sums over frames: per slab of the oxygens' fractional
    coordinate along `axis` (the device's float32 rule, so no water sits
    on the other side of an edge), the count and the sum of the cosine
    between the dipole bisector and +axis -> {'cs', 'cn'} [nb]."""
    b = np.asarray(boxes, np.float64)
    cs, cn = np.zeros(nb), np.zeros(nb)
    for f in range(b.shape[0]):
        o, b1, b2 = _water_bonds(po[f], ph1[f], ph2[f], b[f])
        c = _unit(b1 + b2)[:, axis]
        period = np.float32(b[f][axis, axis] if b.ndim == 3 else b[f][axis])
        zf = np.asarray(po[f], np.float32)[:, axis] / period
        zf = zf - np.floor(zf)
        i = np.clip((zf * np.float32(nb)).astype(np.int32), 0, nb - 1)
        cs += np.bincount(i, c, nb)
        cn += np.bincount(i, minlength=nb)
    return {"cs": cs, "cn": cn}


def host_spol(units, w_units, q_units, pref, w_ref, boxes, rmax: float,
              nb: int, delta=0.0, tol: float = 1e-5) -> dict:
    """`gmx spol` sums over frames: solvent molecules `units` [F, U, P, 3]
    with mass weights `w_units` [U, P] (normalised per molecule) and
    charges `q_units` [U, P], made whole around their first atom; the
    dipole about each molecule's COM against the min-image vector from the
    reference group's refined centre (`host_refined_center` of `pref`
    [F, K, 3] weighted by `w_ref`).  Returns 'cs', 'cn' [nb] (sure parts,
    shells of r over (0, rmax]) and 'cs_slack', 'cn_slack': a molecule
    within `tol` nm (plus `delta`) of a shell edge counts in both shells,
    and each cosine is uncertain by `tol` plus delta / r."""
    b = np.asarray(boxes, np.float64)
    tri = b.ndim == 3
    w_u = np.asarray(w_units, np.float64)[..., None]
    q_u = np.asarray(q_units, np.float64)[..., None]
    delta = np.broadcast_to(np.asarray(delta, np.float64), (b.shape[0],))
    out = {k: np.zeros(nb) for k in ("cs", "cn", "cs_slack", "cn_slack")}
    for f in range(b.shape[0]):
        ctr = host_refined_center_triclinic if tri else host_refined_center
        ref = ctr(pref[f], b[f], w_ref)
        x = np.asarray(units[f], np.float64)
        rel = _mi(x - x[:, :1], b[f])
        com_rel = (w_u * rel).sum(1)
        dip = (q_u * (rel - com_rel[:, None])).sum(1)
        rv = _mi(x[:, 0] + com_rel - ref, b[f])
        r = np.linalg.norm(rv, axis=-1)
        c = (dip * rv).sum(-1) / np.maximum(r * np.linalg.norm(dip, axis=-1), 1e-300)
        rt = tol + delta[f]
        edge = (np.abs(r - rmax) < rt) | (r < rt)
        sel = (r > 0) & (r <= rmax) & ~edge
        for key, wv in (("cs", c), ("cn", np.ones_like(c))):
            sure, slack = _hist_slack(r, wv * sel, 0.0, rmax / nb, nb, rt)
            out[key] += sure
            out[key + "_slack"] += slack + _hist_slack(
                r, wv * edge, 0.0, rmax / nb, nb, np.inf)[1]
        ct = tol + delta[f] / np.maximum(r, 1e-3)
        out["cs_slack"] += _hist_slack(r, ct * sel, 0.0, rmax / nb, nb, 0.0)[0]
    return out


def host_hydorder(p, box, tie_tol: float = 1e-5, workers: int = 1):
    """Tetrahedral order of one frame's points `p` [W, 3] in the
    orthorhombic `box` (3,): each point's 4 nearest periodic neighbours by
    a `scipy.spatial.cKDTree(boxsize=box)` 5-nearest query, S_g = 1 - 3/8
    sum_{j<k} (cos psi_jk + 1/3)^2 and S_k = 1 - sum (r_k - rbar)^2 /
    (12 rbar^2) -> (sg [W], sk [W], tied [W]: points whose 4th and 5th
    neighbour distances differ by less than `tie_tol` nm, where the
    choice of the 4th is a tie)."""
    from scipy.spatial import cKDTree

    box = np.asarray(box, np.float64)
    x = np.mod(np.asarray(p, np.float64), box)
    x[x >= box] = 0.0
    dist, idx = cKDTree(x, boxsize=box).query(x, k=6, workers=workers)
    # column 0 is the point itself (distance 0)
    nb = idx[:, 1:5]
    v = _mi(x[nb] - x[:, None, :], box)
    r = np.linalg.norm(v, axis=-1)
    u = v / r[..., None]
    iu, ju = np.triu_indices(4, 1)
    cs = (u[:, iu] * u[:, ju]).sum(-1)
    sg = 1.0 - 3.0 / 8.0 * ((cs + 1.0 / 3.0) ** 2).sum(-1)
    rbar = r.mean(-1)
    sk = 1.0 - ((r - rbar[:, None]) ** 2).sum(-1) / (12.0 * rbar ** 2)
    return sg, sk, dist[:, 5] - dist[:, 4] < tie_tol


# ------------------------------------------- geometric and surface analyses

def _image_points(x, box):
    """Points `x` [N, 3] wrapped into the primary cell and a `cKDTree` that
    finds their minimum images: the orthorhombic box's periodic tree, or
    for a box matrix a plain tree of the 27 images of the wrapped points
    (a query index i maps to atom i % N) -> (tree, wrapped, images,
    disp(j, q): the displacements of the tree's points j from a query
    point q in the primary cell)."""
    from scipy.spatial import cKDTree

    x = np.asarray(x, np.float64)
    box = np.asarray(box, np.float64)
    if not _is_matrix(box):
        w = np.mod(x, box)
        w[w >= box] = 0.0
        return cKDTree(w, boxsize=box), w, w, lambda j, q: _mi(w[j] - q, box)
    s = x @ np.linalg.inv(box)
    w = (s - np.floor(s)) @ box
    k = np.arange(27)
    shifts = (np.stack([k // 9, k // 3 % 3, k % 3], -1) - 1.0) @ box
    img = (w[None, :, :] + shifts[:, None, :]).reshape(-1, 3)
    return cKDTree(img), w, img, lambda j, q: img[j] - q


def host_nearest(a, b, box, workers: int = 4) -> np.ndarray:
    """Float64 minimum-image distance from each point of `a` [M, 3] to its
    nearest point of `b` [K, 3] -> [M] (orthorhombic lengths or a box
    matrix)."""
    tree = _image_points(b, box)[0]
    q = np.asarray(a, np.float64)
    if _is_matrix(box):
        s = q @ np.linalg.inv(box)
        q = (s - np.floor(s)) @ np.asarray(box, np.float64)
    else:
        q = np.mod(q, box)
        q[q >= box] = 0.0
    return tree.query(q, k=1, workers=workers)[0]


def host_sasa(p, box, r_ext, rows, n_points: int = 192, tol: float = 2e-5):
    """Float64 SASA of the atoms `rows` of one frame (`p` [K, 3], extended
    radii `r_ext` [K], every neighbour within reach: a tree query of
    radius r_i + max r) -> (area [R], relevant-neighbour count [R], slack
    [R]: the area of the test points within `tol` nm of a neighbour's
    sphere, which float32 may count either way)."""
    from .ops.sasa import fibonacci_sphere

    p = np.asarray(p, np.float64)
    r = np.asarray(r_ext, np.float64)
    box = np.asarray(box, np.float64)
    pts = fibonacci_sphere(n_points).astype(np.float64)
    tree, w, _, disp = _image_points(p, box)
    n = p.shape[0]
    area, count, slack = (np.zeros(len(rows)) for _ in range(3))
    for t, i in enumerate(rows):
        nb = np.asarray(tree.query_ball_point(w[i], r[i] + r.max()), np.int64)
        j = nb % n
        d = disp(nb, w[i])
        dist = np.linalg.norm(d, axis=1)
        keep = (j != i) & (dist < r[i] + r[j])
        d, j = d[keep], j[keep]
        count[t] = keep.sum()
        gap = np.linalg.norm(r[i] * pts[:, None, :] - d[None], axis=-1) - r[j][None]
        blocked = (gap < 0).any(1)
        near = (np.abs(gap) < tol).any(1)
        unit = 4.0 * np.pi * r[i] ** 2 / n_points
        area[t] = unit * (~blocked).sum()
        slack[t] = unit * near.sum()
    return area, count, slack


def host_free_points(xyz, p, box, r_ext, tol: float = 2e-5):
    """Float64 free-probe test of one frame: probes `xyz` [P, 3] against
    atoms `p` [K, 3] with extended radii `r_ext` -> (free [P] bool, near
    [P] bool: a probe within `tol` nm of a sphere's surface)."""
    r = np.asarray(r_ext, np.float64)
    tree, w, _, disp = _image_points(p, box)
    x = np.asarray(xyz, np.float64)
    free, near = np.ones(len(x), bool), np.zeros(len(x), bool)
    for t, nb in enumerate(tree.query_ball_point(x, r.max() + tol, workers=4)):
        if not nb:
            continue
        nb = np.asarray(nb, np.int64)
        gap = np.linalg.norm(disp(nb, x[t]), axis=1) - r[nb % len(w)]
        free[t] = (gap > 0).all()
        near[t] = (np.abs(gap) < tol).any()
    return free, near


def host_self_image(p, rows) -> tuple[float, float]:
    """Float64 `gmx mindist -pi` of one frame: the least |x_i - x_j + S|
    over the 26 shifts S = n @ rows and all pairs (nearest-neighbour
    queries of the shifted points), and the largest internal distance
    (over the convex hull's vertices)."""
    from scipy.spatial import ConvexHull, cKDTree

    p = np.asarray(p, np.float64)
    rows = np.asarray(rows, np.float64)
    tree = cKDTree(p)
    mn = np.inf
    for n in np.array([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                       for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0)], np.float64):
        mn = min(mn, float(tree.query(p + n @ rows, k=1, workers=4)[0].min()))
    v = p[ConvexHull(p).vertices] if p.shape[0] > 4 else p
    mx = float(np.sqrt(((v[:, None] - v[None]) ** 2).sum(-1).max()))
    return mn, mx


def mi_f32_image(d, box) -> np.ndarray:
    """Float64 minimum image of displacements `d` [..., 3] (differences of
    float32 coordinates) in the orthorhombic `box`, taking the image that
    the port's float32 `pbc.min_image` picks: k = floor(fl(d / L) + 1/2)
    in float32, and +L/2 kept at an exact tie.  The float32 and float64
    images differ where a component lies within float32 rounding of half a
    box, and on the 0.001 nm grid of an XTC in a 21 nm box such
    components (10.5 nm apart) turn up every frame; a direction (a bond,
    a unit's offsets from its first atom) must take the same image.  A box
    matrix takes the exact float64 image (`_mi`)."""
    d = np.asarray(d, np.float64)
    box = np.asarray(box, np.float64)
    if _is_matrix(box):
        return _mi(d, box)
    d32, l32 = d.astype(np.float32), box.astype(np.float32)
    k = np.floor((d32 / l32).astype(np.float32) + np.float32(0.5))
    m32 = d32 - l32 * k
    k = k - ((m32 == -l32 * np.float32(0.5)) & (d32 > -l32 * np.float32(0.5)))
    return d - box * k


def host_unit_means(p, cols, w, box) -> np.ndarray:
    """Float64 weighted means of units around each unit's first atom (the
    float32 image, `mi_f32_image`): `cols` [U, P] atom indices (padding
    weighs 0), `w` [U, P]."""
    x = np.asarray(p, np.float64)[cols]
    return x[:, 0] + (np.asarray(w, np.float64)[..., None]
                      * mi_f32_image(x - x[:, :1], box)).sum(1)


def host_polystat(frames, cols, lens, w, boxes) -> dict:
    """Float64 `polystat` over frames [F, N, 3]: chains `cols` [M, L]
    (padded), `lens` [M], weights `w` [M, L]."""
    m, lmax = cols.shape
    bmask = np.arange(lmax - 1)[None, :] < (lens - 1)[:, None]
    w = np.asarray(w, np.float64)
    ete2, rg2, blen, us = [], [], [], []
    for f in range(frames.shape[0]):
        g = np.asarray(frames[f], np.float64)[cols]
        b = _mi(g[:, 1:] - g[:, :-1], np.asarray(boxes[f], np.float64)) * bmask[..., None]
        rel = np.concatenate([np.zeros((m, 1, 3)), np.cumsum(b, 1)], 1)
        ete2.append((rel[np.arange(m), lens - 1] ** 2).sum(-1).mean())
        com = (rel * w[..., None]).sum(1) / w.sum(1)[:, None]
        rg2.append(((((rel - com[:, None]) ** 2).sum(-1) * w).sum(1) / w.sum(1)).mean())
        bl = np.linalg.norm(b, axis=-1)
        blen.append(bl.sum() / bmask.sum())
        us.append(b / np.where(bl == 0, 1.0, bl)[..., None])
    u = np.stack(us)
    lb = lmax - 1
    corr = np.array([(((u[:, :, :lb - k] * u[:, :, k:]).sum(-1))
                      * (bmask[:, :lb - k] & bmask[:, k:])).sum()
                     / (u.shape[0] * max((bmask[:, :lb - k] & bmask[:, k:]).sum(), 1))
                     for k in range(lb)])
    return {"ete2": np.asarray(ete2), "rg2": np.asarray(rg2), "bond_corr": corr,
            "mean_bond_length": float(np.mean(blen))}


def _unit64(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def host_helixorient(ca, box, axis: int, like=None, tol: float = 1e-4) -> dict:
    """Float64 Sugeta-Miyazawa helix geometry of one frame's C-alphas
    `ca` [R, 3] (residue order; bonds in the float32 image,
    `mi_f32_image`).  A local axis whose sign rule (along the chord) is
    within `tol` of undecided takes the sign of `like` [W, 3] (the
    result under test) where given; 'undecided' counts those windows.

    'bound_*' state how far float32 arithmetic may move each result: the
    chain is rebuilt whole by a float32 cumulative sum, so every bond
    carries up to eps = 2 sqrt(3) ulps of the largest whole coordinate;
    a bisector moves by 2 eps / |u_(i-1) - u_i|, the local axis by the
    two bisectors' moves over |b_i x b_(i+1)| (a unit vector moves by 2 at
    most), and rise, the twist's cosine, the radius and the mean axis by
    what those moves give (x2)."""
    ca = np.asarray(ca, np.float64)
    u = mi_f32_image(ca[1:] - ca[:-1], box)
    whole = ca[0] + np.concatenate([np.zeros((1, 3)), np.cumsum(u, 0)])
    eps = 2.0 * np.sqrt(3.0) * float(np.spacing(np.float32(np.abs(whole).max())))
    db = u[:-1] - u[1:]
    b = _unit64(db)
    cross = np.cross(b[:-1], b[1:])
    a = _unit64(cross)
    chord = u[1:-1]
    proj = (a * chord).sum(-1)
    sgn = np.sign(proj)
    a *= np.where(sgn == 0, 1.0, sgn)[:, None]
    undecided = np.abs(proj) < tol * np.linalg.norm(chord, axis=-1)
    if like is not None:
        flip = undecided & ((a * np.asarray(like, np.float64)).sum(-1) < 0)
        a[flip] *= -1.0
    rise = (chord * a).sum(-1)
    cosw = np.clip((b[:-1] * b[1:]).sum(-1), -1.0, 1.0)
    twist = np.arccos(cosw)
    perp = np.linalg.norm(chord - rise[:, None] * a, axis=-1)
    s2 = np.maximum(2.0 * np.sin(twist / 2.0), 1e-12)
    radius = perp / s2
    mean_axis = a.mean(0)
    # float32 reach
    e_b = 2.0 * eps / np.maximum(np.linalg.norm(db, axis=-1), 1e-30)
    e_cos = np.minimum(e_b[:-1] + e_b[1:], 2.0)
    e_a = np.minimum(2.0 * e_cos / np.maximum(np.linalg.norm(cross, axis=-1), 1e-30), 2.0)
    u_len = np.linalg.norm(chord, axis=-1)
    e_rise = 2.0 * (eps + u_len * e_a)
    e_tw = e_cos / np.maximum(np.sin(twist), 1e-30)
    e_rad = 2.0 * ((eps + u_len * e_a) / s2 + radius * e_cos / np.maximum(s2 * s2, 1e-30))
    e_axis = 2.0 * e_a.mean() / max(np.linalg.norm(mean_axis), 1e-30)
    mean_axis = _unit64(mean_axis)
    return {"axis_vec": mean_axis, "tilt": np.degrees(np.arccos(np.clip(
        mean_axis[axis], -1.0, 1.0))), "rise": rise.mean(),
        "twist": np.degrees(twist.mean()), "radius": radius.mean(),
        "rise_per_residue": rise, "twist_per_residue": np.degrees(twist),
        "undecided": int(undecided.sum()), "bound_rise": e_rise, "bound_cos": e_cos,
        "bound_radius": e_rad, "bound_axis": e_axis,
        "bound_twist_mean": float(np.degrees(e_tw.mean())),
        "bound_radius_mean": float(e_rad.mean())}


def host_bundle(p, tcols, tw, bcols, bw, box, axis: int) -> dict:
    """Float64 `bundle` of one frame: part tables `[A, P]` columns and
    normalised weights of the tops and bottoms (every image the float32
    one, `mi_f32_image`)."""
    box = np.asarray(box, np.float64)
    x = np.asarray(p, np.float64)
    bcom = host_unit_means(x, bcols, bw, box)
    tx = x[tcols]
    b0 = x[bcols[:, 0]]
    tcom = (b0 + mi_f32_image(tx[:, 0] - b0, box)) + (
        np.asarray(tw, np.float64)[..., None] * mi_f32_image(tx - tx[:, :1], box)).sum(1)
    vec = tcom - bcom
    length = np.linalg.norm(vec, axis=-1)
    v = vec / length[:, None]
    mid = bcom + 0.5 * vec
    centre = mid[0] + mi_f32_image(mid - mid[:1], box).mean(0)
    off = mi_f32_image(mid - centre, box)
    e = np.zeros(3)
    e[axis] = 1.0
    zshift = off @ e
    perp = off - zshift[:, None] * e
    dist = np.linalg.norm(perp, axis=-1)
    r_hat = perp / np.maximum(dist[:, None], 1e-12)
    l_hat = np.cross(e, r_hat)
    deg = np.degrees
    return {"length": length, "distance": dist, "zshift": zshift,
            "tilt": deg(np.arccos(np.clip(v @ e, -1, 1))),
            "tiltr": deg(np.arcsin(np.clip((v * r_hat).sum(-1), -1, 1))),
            "tiltl": deg(np.arcsin(np.clip((v * l_hat).sum(-1), -1, 1))),
            "axes": v, "center": centre}


def host_site_dirs(p, cols, box):
    """Float64 unit directions of `gangle` sites: `cols` [S, 2] vectors or
    [S, 3] plane normals -> (dirs [S, 3], bound [S]: how far float32
    coordinates may move each direction: two ulps of the largest
    coordinate per component, over |d1| for a vector and over |d1 x d2| /
    (|d1| + |d2|) for a plane's normal)."""
    x = np.asarray(p, np.float64)
    box = np.asarray(box, np.float64)
    ulp = 2.0 * np.sqrt(3.0) * float(np.spacing(np.float32(np.abs(x).max())))
    v = _mi(x[cols[:, 1]] - x[cols[:, 0]], box)
    n1 = np.linalg.norm(v, axis=-1)
    if cols.shape[1] == 3:
        v2 = _mi(x[cols[:, 2]] - x[cols[:, 0]], box)
        v = np.cross(v, v2)
        area = np.maximum(np.linalg.norm(v, axis=-1), 1e-30)   # a degenerate plane: no bound
        return _unit64(v), ulp * (n1 + np.linalg.norm(v2, axis=-1)) / area
    return _unit64(v), ulp / np.maximum(n1, 1e-30)


def host_dyecoupl(p, d_idx, a_idx, box) -> tuple[float, float]:
    """Float64 (R, kappa^2) of one frame's two dipoles."""
    x = np.asarray(p, np.float64)
    dv = mi_f32_image(x[d_idx[1]] - x[d_idx[0]], box)
    av = mi_f32_image(x[a_idx[1]] - x[a_idx[0]], box)
    rv = mi_f32_image((x[a_idx[0]] + 0.5 * av) - (x[d_idx[0]] + 0.5 * dv), box)
    r = float(np.linalg.norm(rv))
    ud, ua, ur = _unit64(dv), _unit64(av), rv / r
    kappa = ud @ ua - 3.0 * (ud @ ur) * (ua @ ur)
    return r, float(kappa * kappa)


def host_sdf(off, w, side: float, bins: int, tol: float) -> tuple:
    """Float64 SDF voxel counts of offsets `off` [K, 3] (from the centre,
    rotated when fitted) with weights `w` -> (sure counts [bins^3] of the
    offsets farther than `tol` nm from every voxel face, the total weight
    of the others, their count)."""
    vox = side / bins
    u = (np.asarray(off, np.float64) + side / 2.0) / vox
    near = (np.abs(u - np.round(u)) * vox < tol).any(1)
    ijk = np.floor(u).astype(np.int64)
    inside = ((ijk >= 0) & (ijk < bins)).all(1) & ~near
    flat = (ijk[inside, 0] * bins + ijk[inside, 1]) * bins + ijk[inside, 2]
    w = np.broadcast_to(np.asarray(w, np.float64), near.shape)
    return (np.bincount(flat, w[inside], bins ** 3), float(np.abs(w[near]).sum()),
            int(near.sum()))


CHI_RESIDUES = {
    # side chain beyond CB, each atom placed at the next chi torsion
    "LYS": ("CG", "CD", "CE", "NZ"), "ARG": ("CG", "CD", "NE", "CZ"),
    "SER": ("OG",), "THR": ("OG1",), "CYS": ("SG",), "ILE": ("CG1", "CD1"),
    "ASP": ("CG", "OD1"), "HIS": ("CG", "ND1"), "MET": ("CG", "SD", "CE"),
    "GLU": ("CG", "CD", "OE1"), "PHE": ("CG", "CD1")}


def chi_state(copies: int, n_frames: int, seed: int = 5, box: float = 6.0) -> dict:
    """Ideal residues with full side chains, every alternative of the chi
    site table once per residue kind (`CHI_RESIDUES`), `copies` of each,
    at seeded chi angles per frame: backbone N CA C, CB, then each side
    atom at 0.153 nm, 113 degrees and the next chi torsion (NeRF,
    `place_atom`), each residue rotated at random and placed on a grid in
    a `box` nm cube -> {"frames" [F, N, 3], "atomname", "resname",
    "resnum", "box", "chi" {k: [F, residues with chi k]}, "sites" {k:
    [residues, 4] atom indices}}."""
    rng = np.random.default_rng(seed)
    kinds = [k for k in CHI_RESIDUES for _ in range(copies)]
    names, resn, resi, sites = [], [], [], {k: [] for k in range(1, 5)}
    chis = rng.uniform(-180.0, 180.0, (n_frames, len(kinds), 4))
    frames = np.zeros((n_frames, 0, 3))
    grid = int(np.ceil(len(kinds) ** (1 / 3)))
    for r, kind in enumerate(kinds):
        atoms = ("N", "CA", "C", "CB") + CHI_RESIDUES[kind]
        base = len(names)
        names += atoms
        resn += [kind] * len(atoms)
        resi += [r + 1] * len(atoms)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        at = (np.array([r % grid, r // grid % grid, r // grid ** 2]) + 0.5) * box / grid
        per = []
        for f in range(n_frames):
            n, ca = np.zeros(3), np.array([0.1458, 0.0, 0.0])
            c = place_atom(np.array([0.0, 0.1, 0.0]), n, ca, 0.1525, 111.2, -60.0)
            chain = [n, ca, c, place_atom(c, n, ca, 0.153, 110.5, -122.5)]
            side = [chain[0], chain[1], chain[3]]
            for k in range(len(CHI_RESIDUES[kind])):
                side.append(place_atom(side[-3], side[-2], side[-1], 0.153, 113.0,
                                       chis[f, r, k]))
            per.append(np.stack(chain + side[3:]) @ q.T + at)
        frames = np.concatenate([frames, np.stack(per)], 1)
        order = ["N", "CA", "CB", *CHI_RESIDUES[kind]]
        for k in range(1, len(CHI_RESIDUES[kind]) + 1):
            sites[k].append([base + atoms.index(nm) for nm in order[k - 1:k + 3]])
    chi = {k: np.stack([chis[:, r, k - 1] for r, kind in enumerate(kinds)
                        if len(CHI_RESIDUES[kind]) >= k], 1) for k in range(1, 5)}
    return {"frames": frames, "atomname": np.asarray(names), "resname": np.asarray(resn),
            "resnum": np.asarray(resi, np.int64), "box": np.full(3, box),
            "chi": chi, "sites": {k: np.asarray(v) for k, v in sites.items()}}
