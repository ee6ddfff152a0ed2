"""The plain PyTorch arithmetic that the oracles (`oracles/<call>.py`) call.

Frozen from the float64 oracles of `groan_rs_tpu_torch/testing.py` and
`ops/geometry.py` (`angles_host_f64`, `dihedrals_host_f64`) at commit
14410646bb8b46a8e0fcf9fa6d0b96e5dfbab158, rewritten from one-frame numpy
into batched torch so that they run on the card in float64 after the
window, in blocks of frames and of pair rows.  They import nothing of the
program and read only the generator's grid, the box, the masses, charges
and index tables the benchmark made.

Every function takes frames `p` [F, N, 3] and boxes `box`: lengths [F, 3]
(orthorhombic) or matrices [F, 3, 3] (rows the box vectors), in one
dtype: float64 for the reference; the control runs the same code in
float32 on inputs rounded to TF32 (`to_tf32`).  Counting observables
return bounds (lo, hi): an item within `tol` of an edge or boundary may
fall either way, so it counts in `hi` and not in `lo`; with tol=0 they
return the count itself twice.
"""

from __future__ import annotations

import math

import torch

PAIR_BLOCK = 1 << 24  # pair elements per block of a pair path


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded to TF32 (10 explicit mantissa bits, float32's exponent;
    round to nearest even), returned as float32."""
    x = x.to(torch.float32).contiguous()
    i = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    i = ((i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF) & 0xFFFFFFFF
    i = torch.where(i >= 1 << 31, i - (1 << 32), i).to(torch.int32)
    return i.view(torch.float32)


def is_matrix(box: torch.Tensor) -> bool:
    return box.dim() == 3


_SHIFTS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


def min_image(d: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Exact minimum image of displacements `d` [F, ..., 3]: per axis for
    lengths; for a matrix, round the fractional coordinates, then keep the
    shortest of the 27 neighbouring images (the first of equals)."""
    extra = d.dim() - 2
    if not is_matrix(box):
        b = box.reshape(box.shape[0], *([1] * extra), 3)
        return d - b * torch.round(d / b)
    h = box.reshape(box.shape[0], *([1] * extra), 3, 3)
    hinv = torch.linalg.inv(box).reshape(h.shape)
    s = (d.unsqueeze(-2) @ hinv).squeeze(-2)
    d0 = d - (torch.round(s).unsqueeze(-2) @ h).squeeze(-2)
    best = best_v = None
    for k in _SHIFTS:
        kv = torch.tensor(k, dtype=d.dtype, device=d.device)
        c = d0 + (kv @ h)
        n2 = (c * c).sum(-1)
        if best is None:
            best, best_v = n2, c
            continue
        take = n2 < best
        best = torch.where(take, n2, best)
        best_v = torch.where(take[..., None], c, best_v)
    return best_v


def pair_norm2(a: torch.Tensor, b: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """|exact minimum image|^2 of every pair of a [F, n, 3] and b [F, m, 3]
    -> [F, n, m]."""
    d = a[:, :, None, :] - b[:, None, :, :]
    if not is_matrix(box):
        b3 = box[:, None, None, :]
        d = d - b3 * torch.round(d / b3)
        return (d * d).sum(-1)
    h = box
    hinv = torch.linalg.inv(h)
    s = torch.einsum("fnmi,fij->fnmj", d, hinv)
    d = d - torch.einsum("fnmi,fij->fnmj", torch.round(s), h)
    best = None
    for k in _SHIFTS:
        t = torch.tensor(k, dtype=d.dtype, device=d.device) @ h   # [F, 3]
        c = d + t[:, None, None, :]
        n2 = (c * c).sum(-1)
        best = n2 if best is None else torch.minimum(best, n2)
    return best


def _row_blocks(n: int, m: int, frames: int):
    rows = max(1, PAIR_BLOCK // max(1, m * frames))
    return range(0, n, rows), rows


def pair_sweep(a, b, box, cutoffs, tol: float):
    """One sweep over every pair of a and b -> (minimum distance [F], {cutoff:
    (lo, hi) [F] int64 pairs closer than it}); a pair within `tol` of a
    cutoff counts in hi only."""
    starts, rows = _row_blocks(a.shape[1], b.shape[1], a.shape[0])
    best = torch.full((a.shape[0],), math.inf, dtype=a.dtype, device=a.device)
    counts = {c: [torch.zeros(a.shape[0], dtype=torch.int64, device=a.device)
                  for _ in range(2)] for c in cutoffs}
    for i in starts:
        n2 = pair_norm2(a[:, i:i + rows], b, box)
        best = torch.minimum(best, n2.amin(dim=(1, 2)))
        if counts:
            r = torch.sqrt(n2)
            for c, (lo, hi) in counts.items():
                lo += (r < c - tol).sum(dim=(1, 2))
                hi += (r < c + tol).sum(dim=(1, 2))
    return torch.sqrt(best), {c: tuple(v) for c, v in counts.items()}


def _edge_bins(u: torch.Tensor, n: int, tol_units):
    """Bins of `u` (in bin widths from the first edge): (sure bin or -1
    where within `tol_units` of an edge or outside, near mask, the two
    candidate bins of a near item)."""
    k = torch.round(u)
    near = (u - k).abs() < tol_units
    sure = torch.floor(u).to(torch.int64)
    sure = torch.where(near | (sure < 0) | (sure >= n), torch.full_like(sure, -1), sure)
    return sure, near, k.to(torch.int64)


def pair_histogram(a, b, box, r_max: float, n_bins: int, tol: float):
    """Count bounds (lo, hi) [F, n_bins] of the pair-distance histogram:
    bin k holds distances in (k dr, (k+1) dr]."""
    f = a.shape[0]
    dr = r_max / n_bins
    lo = torch.zeros((f, n_bins + 1), dtype=torch.int64, device=a.device)
    hi = lo.clone()
    frame = torch.arange(f, device=a.device)
    starts, rows = _row_blocks(a.shape[1], b.shape[1], f)
    for i in starts:
        r = torch.sqrt(pair_norm2(a[:, i:i + rows], b, box)).reshape(f, -1)
        keep = r <= r_max + tol
        fr = frame[:, None].expand_as(r)[keep]
        u = r[keep] / dr
        # (k dr, (k+1) dr]: bin ceil(u) - 1, an edge at integer u
        k = torch.round(u)
        near = (u - k).abs() * dr < tol
        sure = torch.ceil(u).to(torch.int64) - 1
        sure = torch.where(near | (sure < 0) | (sure >= n_bins),
                           torch.full_like(sure, n_bins), sure)
        lo.index_put_((fr, sure), torch.ones_like(sure), accumulate=True)
        for c in (k[near].to(torch.int64) - 1, k[near].to(torch.int64)):
            c = torch.where((c >= 0) & (c < n_bins), c, torch.full_like(c, n_bins))
            hi.index_put_((fr[near], c), torch.ones_like(c), accumulate=True)
    lo, hi = lo[:, :n_bins], hi[:, :n_bins]
    return lo, lo + hi


def rdf_ideal(box, n_pairs: int, r_max: float, n_bins: int) -> torch.Tensor:
    """Ideal-gas pair counts per shell [F, n_bins] of the RDF's
    normalisation, float64."""
    edges = torch.arange(n_bins + 1, dtype=torch.float64, device=box.device) * (r_max / n_bins)
    vol = box_volume(box.to(torch.float64))
    return n_pairs * 4.0 / 3.0 * math.pi * torch.diff(edges ** 3)[None, :] / vol[:, None]


def box_volume(box) -> torch.Tensor:
    if is_matrix(box):
        return torch.linalg.det(box).abs()
    return box.prod(-1)


def box_lengths(box) -> torch.Tensor:
    if is_matrix(box):
        return torch.sqrt((box * box).sum(-1))
    return box


def _frac(p, box):
    """Fractional coordinates [F, N, 3]."""
    if is_matrix(box):
        return p @ torch.linalg.inv(box)
    return p / box[:, None, :]


def refined_center(p, box, w=None) -> torch.Tensor:
    """Refined Bai-Breen centre [F, 3].  Orthorhombic (`host_refined_center`):
    the geometric circular-mean estimate, every atom unwrapped around it
    (floor), the (weighted) mean.  Matrix (`host_refined_center_triclinic`):
    the weighted circular mean of the fractional coordinates, every atom
    unwrapped as d - round(d), the weighted mean mapped back."""
    two_pi = 2 * math.pi
    if not is_matrix(box):
        b = box[:, None, :]
        theta = torch.remainder(p, b) * (two_pi / b)
        est = (torch.atan2(-torch.sin(theta).sum(1), -torch.cos(theta).sum(1))
               + math.pi) * box / two_pi
        half = b / 2
        d = p - est[:, None, :] + half
        un = est[:, None, :] + (d - b * torch.floor(d / b) - half)
        if w is None:
            return un.mean(1)
        return (un * w[None, :, None]).sum(1) / w.sum()
    ww = torch.ones(p.shape[1], dtype=p.dtype, device=p.device) if w is None else w
    s = _frac(p, box)
    theta = (s - torch.floor(s)) * two_pi
    est = (torch.atan2(-(ww[None, :, None] * torch.sin(theta)).sum(1),
                       -(ww[None, :, None] * torch.cos(theta)).sum(1)) + math.pi) / two_pi
    d = s - est[:, None, :]
    d = d - torch.round(d)
    mean = (ww[None, :, None] * (est[:, None, :] + d)).sum(1) / ww.sum()
    return (mean[:, None, :] @ box).squeeze(1)


def _kabsch(pc, qc, wt, w):
    """RMSD after the best rotation of centred `pc` onto centred `qc`
    [F, n, 3]: SVD of (wt pc)^T qc with the determinant sign fix, RMSD
    weighted by `w`."""
    h = (wt[None, :, None] * pc).transpose(1, 2) @ qc
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(1, 2)
    sign = torch.sign(torch.linalg.det(v @ u.transpose(1, 2)))
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).repeat(pc.shape[0], 1, 1)
    eye[:, 2, 2] = sign
    rot = v @ eye @ u.transpose(1, 2)
    diff = pc @ rot.transpose(1, 2) - qc
    return torch.sqrt((w[None, :] * (diff * diff).sum(-1)).sum(1) / w.sum())


def kabsch_rmsd(ref, box_ref, p, box, w) -> torch.Tensor:
    """Fitted RMSD [F] of frames `p` [F, n, 3] against the reference frame
    `ref` [n, 3] in box `box_ref` [3] or [3, 3].  Orthorhombic
    (`host_kabsch_rmsd` with the reference prepared as the main-path
    checks prepare it): each side shifted so its refined centre of mass
    sits at the box centre, wrapped, centred on the box centre; the
    covariance mass-weighted.  Matrix (`host_kabsch_rmsd_triclinic`):
    each side unwrapped around its refined centre of mass, centred on its
    weighted centroid; the covariance unweighted."""
    if not is_matrix(box):
        c0 = refined_center(ref[None], box_ref[None], w)
        half_ref = box_ref / 2
        pc = torch.remainder(ref[None] + (half_ref - c0)[:, None, :], box_ref) - half_ref
        com = refined_center(p, box, w)
        half = box / 2
        qc = (torch.remainder(p + (half - com)[:, None, :], box[:, None, :])
              - half[:, None, :])
        return _kabsch(pc.expand(p.shape[0], -1, -1), qc, w, w)

    def prepared(x, bx):
        com = refined_center(x, bx, w)
        u = com[:, None, :] + min_image(x - com[:, None, :], bx)
        return u - ((w[None, :, None] * u).sum(1) / w.sum())[:, None, :]

    pc = prepared(ref[None], box_ref[None]).expand(p.shape[0], -1, -1)
    qc = prepared(p, box)
    return _kabsch(pc, qc, torch.ones_like(w), w)


def _to_center(p, box, w):
    return min_image(p - refined_center(p, box, w)[:, None, :], box)


def gyration(p, box, w) -> torch.Tensor:
    """[F, 4]: the radius of gyration about the refined centre of mass and
    about the x, y and z axes."""
    d = _to_center(p, box, w)
    r2 = (d * d).sum(-1)
    sw = w.sum()
    rg = torch.sqrt((w * r2).sum(1) / sw)
    about = [torch.sqrt((w * (r2 - d[..., a] ** 2)).sum(1) / sw) for a in range(3)]
    return torch.stack([rg] + about, 1)


def principal(p, box, w) -> torch.Tensor:
    """[F, 3] ascending principal moments of inertia."""
    d = _to_center(p, box, w)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    inertia = (eye[None] * (w * (d * d).sum(-1)).sum(1)[:, None, None]
               - (w[None, :, None] * d).transpose(1, 2) @ d)
    return torch.linalg.eigvalsh(inertia)


def total_dipole(p, box, q, first) -> torch.Tensor:
    """[F, 3]: sum over molecules of sum q_i d_i, d_i the minimum image of
    atom i from its molecule's first atom (`first` [N] indices)."""
    d = min_image(p - p[:, first], box)
    return (q[None, :, None] * d).sum(1)


def order(heavy, hydrogen, box):
    """([F, K] bond order parameters S = (3 cos^2 - 1) / 2 against z,
    [F, K] the bond lengths, nm)."""
    d = min_image(hydrogen - heavy, box)
    n2 = (d * d).sum(-1)
    return 1.5 * d[..., 2] ** 2 / n2 - 0.5, torch.sqrt(n2)


def angles(a, b, c, box):
    """([F, K] angles a-b-c in degrees, [F, K] their arm: the shorter of
    the two bonds, nm)."""
    va = min_image(a - b, box)
    vc = min_image(c - b, box)
    cross = torch.linalg.cross(va, vc)
    arm = torch.minimum(torch.linalg.norm(va, dim=-1), torch.linalg.norm(vc, dim=-1))
    return torch.rad2deg(torch.atan2(torch.sqrt((cross * cross).sum(-1)),
                                     (va * vc).sum(-1))), arm


def dihedrals(a, b, c, d, box):
    """([F, K] signed dihedrals a-b-c-d in degrees (IUPAC), [F, K] their
    arm: the least of the central bond's length and the distances of a
    and d from its axis, nm)."""
    b1 = min_image(b - a, box)
    b2 = min_image(c - b, box)
    b3 = min_image(d - c, box)
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    len2 = torch.linalg.norm(b2, dim=-1)
    b2n = b2 / len2[..., None]
    y = (torch.linalg.cross(n1, n2) * b2n).sum(-1)
    arm = torch.minimum(len2, torch.minimum(torch.linalg.norm(n1, dim=-1),
                                            torch.linalg.norm(n2, dim=-1)) / len2)
    return torch.rad2deg(torch.atan2(y, (n1 * n2).sum(-1))), arm


def density_profile(p, box, axis: int, n_bins: int, w, scale: float, tol: float):
    """(profile, slack) [F, n_bins]: each atom's weight in slab
    floor(u n_bins) of its fractional coordinate u along `axis`, times
    n_bins * scale / volume.  An atom within `tol` slab widths of a slab
    edge may fall either side: its weight goes to neither slab's profile
    and to both slabs' slack."""
    f = p.shape[0]
    u = _frac(p, box)[..., axis]
    u = (u - torch.floor(u)) * n_bins
    k = torch.round(u)
    near = (u - k).abs() < tol
    sure = torch.clamp(torch.floor(u).to(torch.int64), 0, n_bins - 1)
    norm = (n_bins * scale / box_volume(box))[:, None]
    ww = w[None, :].expand(f, -1)
    fr = torch.arange(f, device=p.device)[:, None].expand_as(sure)
    prof = torch.zeros((f, n_bins), dtype=p.dtype, device=p.device)
    prof.index_put_((fr[~near], sure[~near]), ww[~near], accumulate=True)
    slack = torch.zeros_like(prof)
    kn = k[near].to(torch.int64)
    for c in (kn - 1, kn):
        slack.index_put_((fr[near], torch.remainder(c, n_bins)), ww[near].abs(),
                         accumulate=True)
    return prof * norm, slack * norm


def density_map(p, axes, span, nx: int, ny: int, tol: float):
    """Count bounds (lo, hi) [F, nx, ny] of the 2-D density map: bin
    floor((x - x0) / (x1 - x0) * nx) on the two plane axes, atoms outside
    the span dropped."""
    f = p.shape[0]
    (x0, x1), (y0, y1) = span
    wx, wy = (x1 - x0) / nx, (y1 - y0) / ny
    cells = []
    for col, lo_e, width, n in ((axes[0], x0, wx, nx), (axes[1], y0, wy, ny)):
        u = (p[..., col] - lo_e) / width
        sure, near, k = _edge_bins(u, n, tol / width)
        cells.append((sure, near, k))
    (su, nu, ku), (sv, nv, kv) = cells
    fr = torch.arange(f, device=p.device)[:, None].expand_as(su)
    lo = torch.zeros((f, nx, ny), dtype=torch.int64, device=p.device)
    ok = (su >= 0) & (sv >= 0)
    lo.index_put_((fr[ok], su[ok], sv[ok]), torch.ones_like(su[ok]), accumulate=True)
    hi = lo.clone()
    amb = (nu | nv) & ~ok
    for i in (0, 1):
        for j in (0, 1):
            u = torch.where(nu, ku - 1 + i, su)
            v = torch.where(nv, kv - 1 + j, sv)
            keep = amb & (u >= 0) & (u < nx) & (v >= 0) & (v < ny)
            # a sure axis repeats its bin: count each cell once per atom
            if i == 1:
                keep &= nu
            if j == 1:
                keep &= nv
            hi.index_put_((fr[keep], u[keep], v[keep]), torch.ones_like(u[keep]),
                          accumulate=True)
    return lo, hi


def in_cylinder(p, box, position, radius: float, height: float, tol: float):
    """Count bounds (lo, hi) [F] of atoms inside a z-oriented cylinder with
    the shapes' PBC semantics: the minimum image from the anchor, folded
    into [0, L) along z; an atom within `tol` of a boundary or of the
    anchor plane is undecided."""
    anchor = torch.as_tensor(position, dtype=p.dtype, device=p.device)
    d = min_image(p - anchor, box)
    lz = box_lengths(box)[:, None, 2] if not is_matrix(box) else box[:, None, 2, 2]
    fold = torch.where(d[..., 2] < 0, d[..., 2] + lz, d[..., 2])
    radial = radius - torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    margin = torch.minimum(height - fold, radial)
    undecided = d[..., 2].abs() < tol
    lo = ((margin >= tol) & ~undecided).sum(1)
    hi = ((margin > -tol) | undecided).sum(1)
    return lo, hi


# ------------------------------------------------- image flips at the wrap
FLIP_TOL = 2e-3   # nm: an atom this close to the wrap may take the other image
FLIP_CAP = 8      # candidate flips kept a frame (the nearest to the wrap)


def wrap_flips(d, box, tol: float | None = None, cap: int | None = None):
    """Candidate image flips of displacements d [F, n, 3] from a centre:
    lengths, an axis where |d_a| lies within `tol` of L_a / 2 (the flip
    moves d by -sign(d_a) L_a along it); a matrix, an atom whose second
    shortest of the 27 images is within `tol` of its shortest (the flip
    moves d to it).  -> (atom [F, K], delta [F, K, 3]); K = cap, a slot
    with no candidate has delta 0 (its flip changes nothing)."""
    tol = FLIP_TOL if tol is None else tol
    cap = FLIP_CAP if cap is None else cap
    f, n = d.shape[:2]
    k = min(cap, n * (1 if is_matrix(box) else 3))
    if not is_matrix(box):
        half = box[:, None, :] / 2
        margin = (half - d.abs()).reshape(f, -1)
        val, idx = torch.topk(margin, k, dim=1, largest=False)
        atom, axis = idx // 3, idx % 3
        sign = torch.sign(torch.gather(d.reshape(f, -1), 1, idx))
        step = -sign * torch.gather(box, 1, axis)
        delta = torch.zeros((f, k, 3), dtype=d.dtype, device=d.device)
        delta.scatter_(2, axis[..., None], step[..., None])
        return atom, torch.where((val < tol)[..., None], delta, torch.zeros_like(delta))
    hinv = torch.linalg.inv(box)
    s = torch.einsum("fni,fij->fnj", d, hinv)
    d0 = d - torch.einsum("fni,fij->fnj", torch.round(s), box)
    shifts = torch.tensor(_SHIFTS, dtype=d.dtype, device=d.device) @ box      # [F, 27, 3]
    c = d0[:, :, None, :] + shifts[:, None, :, :]                             # [F, n, 27, 3]
    n2 = (c * c).sum(-1)
    two, which = torch.topk(n2, 2, dim=2, largest=False)
    r = torch.sqrt(two)
    val, atom = torch.topk(r[..., 1] - r[..., 0], k, dim=1, largest=False)
    w1 = torch.gather(which[..., 0], 1, atom)
    w2 = torch.gather(which[..., 1], 1, atom)
    fi = torch.arange(f, device=d.device)[:, None]
    delta = shifts[fi, w2] - shifts[fi, w1]
    return atom, torch.where((val < tol)[..., None], delta, torch.zeros_like(delta))


def subsets(k: int, like) -> torch.Tensor:
    """[2^k, k] 0/1 masks of every subset of k flips (row 0 the empty one)."""
    i = torch.arange(1 << k, device=like.device)
    return ((i[:, None] >> torch.arange(k, device=like.device)) & 1).to(like.dtype)


def dipole_flips(p, box, q, w):
    """(dipole [F, 3], the dipole's change under each candidate flip [F, K, 3])."""
    d = _to_center(p, box, w)
    atom, delta = wrap_flips(d, box)
    return (q[None, :, None] * d).sum(1), q[atom][..., None] * delta


REF_FLIP_CAP = 4  # candidate flips of the reference frame's own wrap


def _reference_variants(ref, box_ref, w):
    """The prepared reference coordinates [V, n, 3] of `kabsch_rmsd`, one
    for every subset of the reference frame's own candidate image flips
    (row 0 flips nothing): the program prepares the reference once, in
    float32, and an atom of it near the wrap may take the other image
    there, which moves every frame's RMSD."""
    c0 = refined_center(ref[None], box_ref[None], w)
    matrix = is_matrix(box_ref[None])
    if not matrix:
        half = box_ref / 2
        pc = torch.remainder(ref[None] + (half - c0)[:, None, :], box_ref) - half
        atom, delta = wrap_flips(pc, box_ref[None], cap=REF_FLIP_CAP)
    else:
        u = c0[:, None, :] + min_image(ref[None] - c0[:, None, :], box_ref[None])
        atom, delta = wrap_flips(u - c0[:, None, :], box_ref[None], cap=REF_FLIP_CAP)
        pc = u
    m = subsets(atom.shape[1], ref)                                   # [V, K]
    out = pc.repeat(m.shape[0], 1, 1)
    for v in range(1, m.shape[0]):
        for k in range(atom.shape[1]):
            if m[v, k]:
                out[v, atom[0, k]] += delta[0, k]
    if matrix:
        out = out - ((w[None, :, None] * out).sum(1) / w.sum())[:, None, :]
    return out


def kabsch_rmsd_flips(ref, box_ref, p, box, w) -> torch.Tensor:
    """The fitted RMSD of `kabsch_rmsd` under every subset of the frame's
    candidate image flips (`wrap_flips` of the wrapped frame), for every
    variant of the reference's own flips (`_reference_variants`) ->
    [F, V * 2^K]; column 0 flips nothing.  A flip of atom i by D changes
    the weighted covariance by w_i pc_i D^T and the frame's sum of
    squares; the triclinic form also moves the weighted centroid (and the
    unweighted covariance it fits by) by w_i D / W."""
    wsum = w.sum()
    if not is_matrix(box):
        com = refined_center(p, box, w)
        half = box / 2
        qc = torch.remainder(p + (half - com)[:, None, :], box[:, None, :]) - half[:, None, :]
        atom, delta = wrap_flips(qc, box)
    else:
        com = refined_center(p, box, w)
        atom, delta = wrap_flips(p - com[:, None, :], box)
        u = com[:, None, :] + min_image(p - com[:, None, :], box)
        qc = u - ((w[None, :, None] * u).sum(1) / wsum)[:, None, :]
    fi = torch.arange(p.shape[0], device=p.device)[:, None]
    qk, wk = qc[fi, atom], w[atom]                                    # [F, K, 3], [F, K]
    m = subsets(atom.shape[1], p)                                     # [S, K]
    sqq = (w * (qc * qc).sum(-1)).sum(1)
    dsq = wk * (2 * (qk * delta).sum(-1) + (delta * delta).sum(-1))         # [F, K]
    sqq_s = sqq[:, None] + dsq @ m.T
    if is_matrix(box):
        # the weighted centroid moves by s = sum w_k D_k / W
        shift = torch.einsum("sk,fkj->fsj", m, wk[..., None] * delta) / wsum
        sqq_s = sqq_s - wsum * (shift * shift).sum(-1)
    values = []
    for pc0 in _reference_variants(ref, box_ref, w):
        pc = pc0.expand(p.shape[0], -1, -1)
        pk = pc[fi, atom]
        hw = (w[None, :, None] * pc).transpose(1, 2) @ qc             # [F, 3, 3]
        dhw = wk[..., None, None] * pk[..., :, None] * delta[..., None, :]  # [F, K, 3, 3]
        hw_s = hw[:, None] + torch.einsum("sk,fkij->fsij", m, dhw)
        spp = (w * (pc0 * pc0).sum(-1)).sum()
        if is_matrix(box):
            hu = pc.transpose(1, 2) @ qc
            dhu = pk[..., :, None] * delta[..., None, :]
            psum = pc0.sum(0)                                         # [3]
            hfit = (hu[:, None] + torch.einsum("sk,fkij->fsij", m, dhu)
                    - psum[None, None, :, None] * shift[..., None, :])
        else:
            hfit = hw_s
        u_, _, vt = torch.linalg.svd(hfit)
        v = vt.transpose(-1, -2)
        sign = torch.sign(torch.linalg.det(v @ u_.transpose(-1, -2)))
        diag = torch.ones(hfit.shape[:-1], dtype=p.dtype, device=p.device)
        diag[..., 2] = sign
        rot = v @ torch.diag_embed(diag) @ u_.transpose(-1, -2)
        trace = torch.einsum("fsij,fsji->fs", rot, hw_s)
        values.append(torch.sqrt(torch.clamp(spp + sqq_s - 2 * trace, min=0.0) / wsum))
    return torch.cat(values, 1)


def principal_flips(p, box, w):
    """The principal moments under every subset of the frame's candidate
    image flips -> [F, 2^K, 3] (row 0 flips nothing).  An atom's flips are
    applied together, so two flips of one atom (two axes) are exact."""
    d = _to_center(p, box, w)
    atom, delta = wrap_flips(d, box)
    f, k = atom.shape
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    inertia = (eye[None] * (w * (d * d).sum(-1)).sum(1)[:, None, None]
               - (w[None, :, None] * d).transpose(1, 2) @ d)
    m = subsets(k, p)                                                   # [S, K]
    same = (atom[:, :, None] == atom[:, None, :]).to(p.dtype)            # [F, K, K]
    first = torch.ones((f, k), dtype=torch.bool, device=p.device)
    for j in range(1, k):
        first[:, j] = ~(atom[:, :j] == atom[:, j:j + 1]).any(1)
    shift = torch.einsum("fkl,sl,flj->fskj", same, m, delta)             # [F, S, K, 3]
    fi = torch.arange(f, device=p.device)[:, None]
    dk = d[fi, atom][:, None]                                            # [F, 1, K, 3]
    dn = dk + shift
    wk = (w[atom] * first)[:, None, :]                                   # [F, 1, K]
    dsq = ((dn * dn).sum(-1) - (dk * dk).sum(-1)) * wk                   # [F, S, K]
    outer = (torch.einsum("fski,fskj->fskij", dn, dn)
             - torch.einsum("fski,fskj->fskij", dk.expand_as(dn), dk.expand_as(dn)))
    dI = (dsq.sum(-1)[..., None, None] * eye
          - (wk[..., None, None] * outer).sum(2))
    return torch.linalg.eigvalsh(inertia[:, None] + dI)
