"""`add_hbonds`: hydrogen bonds per frame of one chain pair, as groan_rs
counts them (donor D, its bonded hydrogen H, acceptor A, D != A): the D-A
distance at most `max_distance` (minimum image) and the D-H...A angle
(between H->D and H->A) at least `min_angle`; an undefined angle takes
groan_rs's `handle_nan` (180 where H is nearer A than D is, else 0).

Plain torch in the frames' dtype on their device, independent of the
program: the chains' queries (`name X [Y ...]`, the only form read here)
are resolved on the generator's `layout()` tables (atom names, O-H
bonds), and pairs are found by a cell list of its own: acceptors binned
in cells at least the cutoff plus `tol` wide, each donor against the
acceptors of its 27 neighbour cells (every acceptor along an axis of
fewer than three cells), in blocks of donors.

Bounds (lo, hi) [F] int64: `lo` counts the triples that are bonds with a
margin, `hi` adds those within `tol` of the cutoff, within the angle that
`tol` of the positions reaches (2 tol (1/|HD| + 1/|HA|) radians) of
`min_angle`, or whose angle float32 may leave undefined (a length below
`tol`, or within 1e-5 of cos = 1, where `handle_nan` may count it).  With
tol = 0 both are the count itself.  The output is the program's
`hbonds_<c1>_<c2>` of a call without a `name`: one pair, (0, 0) here.
"""

import math

import numpy as np
import torch

KIND = "bounds"
OUTPUT = "hbonds_0_0"
PAIR_BLOCK = 1 << 22     # candidate (donor, acceptor) slots per block
NEAR_ONE = 1e-5          # 1 - cos below this: float32 may find no angle


def _query(layout: dict, q: str) -> np.ndarray:
    """Atom indices of a `name X [Y ...]` query."""
    words = q.split()
    if len(words) < 2 or words[0] != "name":
        raise ValueError(f"the hbond oracle reads only 'name X [Y ...]' queries, not '{q}'")
    return np.nonzero(np.isin(layout["atom_names"], words[1:]))[0].astype(np.int64)


def _hydrogen_table(layout: dict, donors: np.ndarray, hydrogens: np.ndarray) -> np.ndarray:
    """[n_donors, hmax] of each donor's bonded hydrogens in ascending index,
    -1 past its last."""
    bonds = np.asarray(layout["bonds"], np.int64)
    both = np.concatenate([bonds, bonds[:, ::-1]])
    row = np.full(len(layout["atom_names"]), -1, np.int64)
    row[donors] = np.arange(donors.shape[0])
    is_h = np.zeros(len(layout["atom_names"]), bool)
    is_h[hydrogens] = True
    keep = (row[both[:, 0]] >= 0) & is_h[both[:, 1]]
    d, h = row[both[keep, 0]], both[keep, 1]
    order = np.lexsort((h, d))
    d, h = d[order], h[order]
    counts = np.bincount(d, minlength=donors.shape[0])
    table = np.full((donors.shape[0], max(1, int(counts.max(initial=0)))), -1, np.int64)
    slot = np.arange(d.shape[0]) - np.repeat(np.cumsum(counts) - counts, counts)
    table[d, slot] = h
    return table


def _min_image(d, box):
    return d - box * torch.round(d / box)


def _cells(x, box, reach):
    """(cell ids [n], cells per axis [3], (axis offsets) x 3) of points
    `x` [n, 3] in cells at least `reach` wide; an axis of fewer than three
    cells is one cell."""
    per = [max(1, int(math.floor(float(box[k]) / (reach * 1.001)))) for k in range(3)]
    per = [p if p >= 3 else 1 for p in per]
    n = torch.as_tensor(per, device=x.device)
    wrapped = x - box * torch.floor(x / box)
    c = torch.floor(wrapped / (box / n)).to(torch.int64)
    c = torch.minimum(torch.clamp_min(c, 0), n - 1)
    return c, per, [(-1, 0, 1) if p >= 3 else (0,) for p in per]


def _flat(c, per):
    return (c[..., 0] * per[1] + c[..., 1]) * per[2] + c[..., 2]


def frame_bounds(pos, box, acc, don, htab, max_d, min_a, tol):
    """(lo, hi) of one frame: pos [N, 3], box [3] lengths; acc, don int64
    atom indices; htab [n_don, hmax] atom indices, -1 padded."""
    reach = max_d + tol
    a_pos, d_pos = pos[acc], pos[don]
    ac, per, offsets = _cells(a_pos, box, reach)
    aid = _flat(ac, per)
    order = torch.argsort(aid, stable=True)
    counts = torch.bincount(aid, minlength=per[0] * per[1] * per[2])
    start = torch.cumsum(counts, 0) - counts
    k = max(1, int(counts.max()))
    table = torch.full((counts.shape[0], k), -1, dtype=torch.int64, device=pos.device)
    sid = aid[order]
    table[sid, torch.arange(sid.shape[0], device=pos.device) - start[sid]] = order
    dc, _, _ = _cells(d_pos, box, reach)
    shifts = torch.tensor([(i, j, l) for i in offsets[0] for j in offsets[1]
                           for l in offsets[2]], device=pos.device)
    size = torch.as_tensor(per, device=pos.device)
    lo = torch.zeros((), dtype=torch.int64, device=pos.device)
    hi = lo.clone()
    rows = max(1, PAIR_BLOCK // (shifts.shape[0] * k))
    for r0 in range(0, don.shape[0], rows):
        nb = torch.remainder(dc[r0:r0 + rows, None, :] + shifts[None], size)
        cand = table[_flat(nb, per)].reshape(nb.shape[0], -1)          # [b, 27 k]
        di, slot = torch.nonzero(cand >= 0, as_tuple=True)
        ai = cand[di, slot]
        di = di + r0
        keep = don[di] != acc[ai]
        di, ai = di[keep], ai[keep]
        r = torch.linalg.vector_norm(_min_image(a_pos[ai] - d_pos[di], box), dim=-1)
        near = r <= reach
        di, ai, r = di[near], ai[near], r[near]
        for h_slot in range(htab.shape[1]):
            h = htab[di, h_slot]
            ok = h >= 0
            hp = pos[h.clamp_min(0)]
            hd = _min_image(d_pos[di] - hp, box)
            ha = _min_image(a_pos[ai] - hp, box)
            lhd = torch.linalg.vector_norm(hd, dim=-1)
            lha = torch.linalg.vector_norm(ha, dim=-1)
            cos = (hd * ha).sum(-1) / (lhd * lha)
            ang = torch.rad2deg(torch.acos(cos))
            if tol == 0:
                # groan_rs's handle_nan: 180 where H is nearer A than D is
                ang = torch.where(torch.isnan(ang),
                                  torch.where(lha < r, 180.0, 0.0).to(ang.dtype), ang)
                bond = ok & (r <= max_d) & (ang >= min_a)
                lo += bond.sum()
                hi += bond.sum()
                continue
            undefined = ((lhd < tol) | (lha < tol) | torch.isnan(ang)
                         | (1.0 - cos < NEAR_ONE))
            edge = torch.rad2deg(2.0 * tol * (1.0 / lhd + 1.0 / lha))
            lo += (ok & ~undefined & (r <= max_d - tol) & (ang >= min_a + edge)).sum()
            hi += (ok & (r <= max_d + tol) & (undefined | (ang >= min_a - edge))).sum()
    return lo, hi


def _call(args, kwargs):
    """(chains, pairs, max_distance, min_angle) of the call as the traffic
    file spells it."""
    if "name" in kwargs:
        raise ValueError("the hbond oracle's output is hbonds_<c1>_<c2>: no 'name'")
    names = ["chains", "pairs", "max_distance", "min_angle"]
    got = dict(zip(names, args))
    got.update({k: v for k, v in kwargs.items() if k in names})
    chains = got["chains"]
    chains = chains["hbond_chains"] if isinstance(chains, dict) else chains
    pairs = [tuple(p) for p in got["pairs"]]
    if len(pairs) != 1 or f"hbonds_{pairs[0][0]}_{pairs[0][1]}" != OUTPUT:
        raise ValueError(f"the hbond oracle gives {OUTPUT}: one pair, not {pairs}")
    return (chains, pairs[0], float(got.get("max_distance", 0.35)),
            float(got.get("min_angle", 120.0)))


def oracle(fr, args, kwargs, tol):
    chains, (c1, c2), max_d, min_a = _call(args, kwargs)
    if fr.box.dim() != 2:
        raise ValueError("hydrogen bonds take rectangular boxes")
    lay = fr.syn.layout()
    dev = fr.p.device
    legs = [(c1, c1)] if c1 == c2 else [(c1, c2), (c2, c1)]
    tables = []
    for acc_c, don_c in legs:
        acc = _query(lay, chains[acc_c]["acceptors"])
        don = _query(lay, chains[don_c]["donors"])
        htab = _hydrogen_table(lay, don, _query(lay, chains[don_c]["hydrogens"]))
        tables.append(tuple(torch.as_tensor(x, device=dev) for x in (acc, don, htab)))
    f = fr.p.shape[0]
    lo = torch.zeros(f, dtype=torch.int64, device=dev)
    hi = lo.clone()
    for i in range(f):
        for acc, don, htab in tables:
            if acc.shape[0] == 0 or don.shape[0] == 0:
                continue
            a, b = frame_bounds(fr.p[i], fr.box[i], acc, don, htab, max_d, min_a, tol)
            lo[i] += a
            hi[i] += b
    return lo, hi
