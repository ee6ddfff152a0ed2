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
           "refine_tie_atoms"]


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
