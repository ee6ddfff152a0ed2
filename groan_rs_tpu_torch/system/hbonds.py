"""Hydrogen-bond detection (reference: `src/system/hbonds.rs`).

Port of `groan_rs_tpu/system/hbonds.py`.  Candidates are pruned with the
reference's acceptor cell grid (cell size = max_distance, hbonds.rs:163-170)
for all donors at once (the C++ walk `native.hbond_candidates`, or its
numpy twin `_candidate_pairs_np`), then scored as flat arrays.

The host scorer (`_score_triples`, numpy) reproduces the reference's
float32 arithmetic op for op, as in the JAX package:

- D-A distance: per-axis loop-subtract minimum image (`vector3d.rs:575-592`)
  then `sqrt(dx*dx + dy*dy + dz*dz)`; keep when `!(distance > max_distance)`.
- D-H-A angle: `vector_to` = `floor_mod(b - a + L/2, L) - L/2` with Rust's
  truncated `%` (== `np.fmod`), `acos(dot / (len*len)).to_degrees()`
  without clamping, so out-of-range cosines go NaN and take the
  reference's `handle_nan` path (H closer to A than D is to A -> 180,
  else 0; hbonds.rs:302-338); keep when `!(angle < min_angle)`.

Bond order is the reference's: donors in chain order; per donor, acceptors
in cell-grid neighbour order; per acceptor, the donor's hydrogens in
bonded order.

Two device formulations, plain PyTorch on an explicit device (the JAX
package's are plain jnp under `jax.jit`; neither reaches a Pallas kernel):

- the cell scorer (`_score_device`, `HBondAnalysis.analyze_batch`): the
  host ships `[B, C]` candidate pair ranks into per-analysis device tables
  (`_PairTables`); hydrogens expand on the device; one masked evaluation
  of the criteria.  C is the batch's own largest candidate count (the JAX
  package rounds it up to a power of two, a jit bucket).  The batch is
  scored in frame chunks of at most `_SCORE_TRIPLES` triples.
- the dense counter (`make_dense_counter`): every donor x acceptor pair of
  each leg, a Python loop over donor tiles; integer counts do not depend
  on the tile.

Exactness.  The device may round differently from the host (no FMA is
asked for, but `acos` is not correctly rounded), so every triple whose
decision a few ulps could flip -- distance within 1e-6 relative of the
cutoff, angle within 2e-3 degrees plus the arccos conditioning term of
the threshold, an ambiguous NaN disambiguation -- is re-scored on the
host with the exact float32 semantics.  The port gathers the guarded
slots on the device at whatever count they reach (`torch.nonzero`); the
JAX package keeps 128 per frame and above that pulls the frame's whole
`[C, H]` arrays to the host.  Counts are the same.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import HBondError, SelectError
from ..utils import profiling as prof

__all__ = ["HBondChain", "HBond", "HBondAnalysis", "make_dense_counter",
           "remap_analysis", "HBondsMixin"]


@dataclass
class HBondChain:
    """GSL queries selecting a chain's acceptors/donors/hydrogens
    (reference: hbonds.rs:24)."""

    acceptors: str
    donors: str
    hydrogens: str


@dataclass
class HBond:
    """reference: hbonds.rs:52."""

    donor: int
    hydrogen: int
    acceptor: int
    distance: float
    angle: float


def _segments(counts):
    """(row of each item, offset of each item within its row) for rows of
    `counts` items laid end to end."""
    counts = np.asarray(counts, np.int64)
    rows = np.repeat(np.arange(counts.shape[0]), counts)
    within = np.arange(rows.shape[0]) - np.repeat(np.cumsum(counts) - counts, counts)
    return rows, within


class _ChainGroups:
    """Resolved chain: acceptor indices + donor-major hydrogen CSR
    (reference: HBondChainGroups, hbonds.rs:93-144).  The hydrogens of a
    donor are its bonded neighbours that the hydrogen query selects, in
    bonded (ascending index) order, read from the topology's bond CSR in
    one pass."""

    def __init__(self, system, chain: HBondChain):
        from ..select import evaluate_mask, parse_query

        try:
            acc = np.nonzero(evaluate_mask(parse_query(chain.acceptors), system))[0]
            don = np.nonzero(evaluate_mask(parse_query(chain.donors), system))[0]
            hyd_mask = evaluate_mask(parse_query(chain.hydrogens), system)
        except SelectError as e:
            raise HBondError(str(e), code="SelectError") from e

        offsets, flat = system.topology.bonds_csr()
        cnt = offsets[don + 1] - offsets[don]
        rows, within = _segments(cnt)
        nbr = flat[np.repeat(offsets[don], cnt) + within]
        is_h = hyd_mask[nbr]
        self.acceptors = acc.astype(np.int64)
        self.donors = don.astype(np.int64)
        self.h_idx = nbr[is_h].astype(np.int64)
        self.h_offsets = np.concatenate(
            [[0], np.cumsum(np.bincount(rows[is_h], minlength=don.shape[0]))]
        ).astype(np.int64)
        if acc.shape[0] == 0 and don.shape[0] == 0:
            raise HBondError("chain selects no acceptors and no donors", code="EmptyChain")


def _sanity_check_pairs(pairs, n_chains):
    """reference: hbonds.rs sanity_check_pairs."""
    seen = set()
    used = set()
    for c1, c2 in pairs:
        for c in (c1, c2):
            if c >= n_chains or c < 0:
                raise HBondError(f"chain {c} does not exist", code="NonexistentChain")
        key = (min(c1, c2), max(c1, c2))
        if key in seen:
            raise HBondError(
                f"pair ({c1}, {c2}) specified multiple times", code="PairSpecifiedMultipleTimes"
            )
        seen.add(key)
        used.update((c1, c2))
    if len(used) != n_chains:
        raise HBondError("some chain is not used by any pair", code="UnusedChain")


# ------------------------------------------------------------------ exact-f32
# numpy emulations of the reference's scalar PBC math (JAX `hbonds.py:110-158`)


def _wrap_loop(p, box):
    """`Vector3D::wrap` loop semantics: while x > L: x -= L; while x < 0:
    x += L (vector3d.rs:380-417). All float32."""
    p = p.astype(np.float32).copy()
    box = np.broadcast_to(box.astype(np.float32), p.shape)
    while True:
        m = p > box
        if not m.any():
            break
        p[m] -= box[m]
    while True:
        m = p < 0.0
        if not m.any():
            break
        p[m] += box[m]
    return p


def _min_image_loop(d, box):
    """`Vector3D::min_image` loop semantics (vector3d.rs:575-592), float32."""
    d = d.astype(np.float32).copy()
    box = np.broadcast_to(box.astype(np.float32), d.shape)
    half = box / np.float32(2.0)
    while True:
        m = d > half
        if not m.any():
            break
        d[m] -= box[m]
    while True:
        m = d < -half
        if not m.any():
            break
        d[m] += box[m]
    return d


def _distance_xyz(a, b, box):
    """`Vector3D::distance(.., XYZ, ..)` (vector3d.rs:458-486), float32."""
    d = _min_image_loop(a - b, box)
    return np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])


def _vector_to(a, b, box):
    """`Vector3D::vector_to` (vector3d.rs:561-569): floor_mod(b - a + L/2, L)
    - L/2, floor_mod(x, y) = (x % y + y) % y with truncated %, float32."""
    box = np.broadcast_to(box.astype(np.float32), a.shape).astype(np.float32)
    half = box / np.float32(2.0)
    x = b - a + half
    return np.fmod(np.fmod(x, box) + box, box) - half


def _candidate_pairs(positions, box, chain_acc: _ChainGroups,
                     chain_don: _ChainGroups, max_distance):
    """Cell-pruned candidate (donor, acceptor) pairs in reference order
    (the C++ cell walk) -> (d_rank, a_rank) int64 RANKS into
    `chain_don.donors` / `chain_acc.acceptors`, donor == acceptor
    self-pairs removed."""
    from ..io import native

    if chain_acc.acceptors.shape[0] == 0 or chain_don.donors.shape[0] == 0:
        return (np.zeros(0, np.int64),) * 2
    return native.hbond_candidates(
        np.ascontiguousarray(positions, np.float32),
        np.asarray(box, np.float32),
        chain_acc.acceptors, chain_don.donors, float(max_distance),
    )


def _candidate_pairs_np(positions, box, chain_acc: _ChainGroups,
                        chain_don: _ChainGroups, max_distance):
    """Numpy twin of `_candidate_pairs` (order and content parity of the
    C++ walk)."""
    from ..core.cellgrid import axis_offsets

    acceptors = chain_acc.acceptors
    donors = chain_don.donors
    empty = (np.zeros(0, np.int64),) * 2
    if acceptors.shape[0] == 0 or donors.shape[0] == 0:
        return empty

    box = box.astype(np.float32)
    pos = positions.astype(np.float32, copy=False)
    max_distance = np.float32(max_distance)

    # acceptor cell grid (cell size = max_distance, cellgrid.rs:444,472)
    ncells = np.maximum(np.floor(box / max_distance).astype(np.int64), 1)
    cell_w = (box / ncells.astype(np.float32)).astype(np.float32)
    aw = _wrap_loop(pos[acceptors], box)
    acoord = np.floor(aw / cell_w).astype(np.int64) % ncells
    acid = (acoord[:, 0] * ncells[1] + acoord[:, 1]) * ncells[2] + acoord[:, 2]
    order = np.argsort(acid, kind="stable")  # ascending atom index per cell
    total = int(ncells.prod())
    cell_off = np.searchsorted(acid[order], np.arange(total + 1))

    dw = _wrap_loop(pos[donors], box)
    dcoord = np.floor(dw / cell_w).astype(np.int64) % ncells

    # candidate generation over the <= 27 neighbour offsets
    d_rank_parts, a_pos_parts, off_rank_parts, within_parts = [], [], [], []
    off_rank = 0
    for dx in axis_offsets(int(ncells[0])):
        for dy in axis_offsets(int(ncells[1])):
            for dz in axis_offsets(int(ncells[2])):
                nb0 = (dcoord[:, 0] + dx) % ncells[0]
                nb1 = (dcoord[:, 1] + dy) % ncells[1]
                nb2 = (dcoord[:, 2] + dz) % ncells[2]
                cid = (nb0 * ncells[1] + nb1) * ncells[2] + nb2
                s = cell_off[cid]
                cnt = cell_off[cid + 1] - s
                nz = np.nonzero(cnt)[0]
                if nz.shape[0]:
                    rows, within = _segments(cnt[nz])
                    d_rank_parts.append(nz[rows])
                    a_pos_parts.append(s[nz][rows] + within)
                    within_parts.append(within)
                    off_rank_parts.append(np.full(rows.shape[0], off_rank, np.int64))
                off_rank += 1

    if not d_rank_parts:
        return empty
    d_rank = np.concatenate(d_rank_parts)
    a_rank = order[np.concatenate(a_pos_parts)]  # index into `acceptors`
    off_ranks = np.concatenate(off_rank_parts)
    withins = np.concatenate(within_parts)

    # exclude the donor itself (hbonds.rs:253)
    keep = donors[d_rank] != acceptors[a_rank]
    d_rank, a_rank = d_rank[keep], a_rank[keep]
    off_ranks, withins = off_ranks[keep], withins[keep]

    # reference order: donor-major, then neighbour-cell order, then in-cell
    srt = np.lexsort((withins, off_ranks, d_rank))
    return d_rank[srt], a_rank[srt]


def _expand_hydrogens(chain_don: _ChainGroups, d_rank, a_rank, acceptors):
    """(donor, acceptor) pairs -> hydrogen-expanded (d_idx, h_idx, a_idx)
    triples in reference order (per acceptor, the donor's hydrogens in
    bonded order)."""
    h_counts = chain_don.h_offsets[d_rank + 1] - chain_don.h_offsets[d_rank]
    rep, h_slot = _segments(h_counts)
    h_idx = chain_don.h_idx[chain_don.h_offsets[d_rank][rep] + h_slot]
    return chain_don.donors[d_rank][rep], h_idx, acceptors[a_rank][rep]


def _score_triples(pos, box, d_idx, h_idx, a_idx, max_distance, min_angle):
    """Exact reference-f32 scoring of candidate triples on the host ->
    (keep bool, dist, angle) per triple: the distance criterion
    (`!(distance > max_distance)`, hbonds.rs:256) and the D-H-A angle
    criterion with NaN disambiguation (calc_angle, hbonds.rs:302-338)."""
    max_distance = np.float32(max_distance)
    min_angle = np.float32(min_angle)
    dist = _distance_xyz(pos[a_idx], pos[d_idx], box)
    keep = ~(dist > max_distance)

    hp = pos[h_idx]
    hd = _vector_to(hp, pos[d_idx], box)
    ha = _vector_to(hp, pos[a_idx], box)
    dot = hd[:, 0] * ha[:, 0] + hd[:, 1] * ha[:, 1] + hd[:, 2] * ha[:, 2]
    len_hd = np.sqrt(hd[:, 0] * hd[:, 0] + hd[:, 1] * hd[:, 1] + hd[:, 2] * hd[:, 2])
    len_ha = np.sqrt(ha[:, 0] * ha[:, 0] + ha[:, 1] * ha[:, 1] + ha[:, 2] * ha[:, 2])
    with np.errstate(invalid="ignore", divide="ignore"):
        cosang = dot / (len_hd * len_ha)
        angle = np.degrees(np.arccos(cosang)).astype(np.float32)
    nan = np.isnan(angle)
    if nan.any():
        # handle_nan: 180 if H is closer to A than D is to A, else 0
        ha_d = _distance_xyz(pos[h_idx[nan]], pos[a_idx[nan]], box)
        da_d = _distance_xyz(pos[d_idx[nan]], pos[a_idx[nan]], box)
        angle[nan] = np.where(ha_d < da_d, np.float32(180.0), np.float32(0.0))
    keep &= ~(angle < min_angle)
    return keep, dist, angle


def _detect(positions, box, chain_acc: _ChainGroups, chain_don: _ChainGroups,
            max_distance, min_angle):
    """Acceptors of `chain_acc` against donors of `chain_don` (reference:
    analyze_single, hbonds.rs:229-298) -> [HBond] in reference order."""
    box = box.astype(np.float32)
    pos = positions.astype(np.float32, copy=False)
    d_rank, a_rank = _candidate_pairs(pos, box, chain_acc, chain_don, max_distance)
    d_idx, h_idx, a_idx = _expand_hydrogens(chain_don, d_rank, a_rank,
                                            chain_acc.acceptors)
    if d_idx.shape[0] == 0:
        return []
    keep, dist, angle = _score_triples(pos, box, d_idx, h_idx, a_idx,
                                       max_distance, min_angle)
    return [
        HBond(donor=int(d), hydrogen=int(h), acceptor=int(a),
              distance=float(di), angle=float(an))
        for d, h, a, di, an in zip(
            d_idx[keep], h_idx[keep], a_idx[keep], dist[keep], angle[keep]
        )
    ]


# ------------------------------------------------------------------ device
# The guard band (JAX `hbonds.py:346-348`): a triple whose keep decision
# backend float ulps could flip is re-scored on the host.

_ANGLE_GUARD = np.float32(2e-3)       # flat floor, degrees
_COS_EPS = np.float32(1e-6)           # assumed worst-case cos-chain ulp error
_DIST_GUARD_REL = np.float32(1e-6)
_COND_NUM = float(np.float32(57.29578) * _COS_EPS)  # arccos conditioning, degrees
_DEG = float(np.float32(180.0 / np.pi))

# triples per scorer call (frames are chunked to stay below it; ~40
# float32 temporaries of this length are alive at once)
_SCORE_TRIPLES = 1 << 24


def _min_image_dev(d, box):
    """`Vector3D::min_image` loop semantics with a fixed unrolled count
    (extra passes are no-ops, as the loop exits), one axis."""
    half = box * 0.5
    for _ in range(4):
        d = torch.where(d > half, d - box, d)
    for _ in range(4):
        d = torch.where(d < -half, d + box, d)
    return d


def _vector_to_dev(a, b, box):
    """floor_mod(b - a + L/2, L) - L/2 with Rust's truncated `%`, one axis."""
    half = box * 0.5
    x = b - a + half
    return torch.fmod(torch.fmod(x, box) + box, box) - half


def _norm(x):
    return torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])


def _dist_dev(a, b, box):
    """Min-image distance of per-axis lists `a`, `b`, `box`."""
    return _norm([_min_image_dev(a[k] - b[k], box[k]) for k in range(3)])


def _angle_dev(hd, ha, len_hd, len_ha):
    """(cos, angle in degrees) of the D-H-A angle from per-axis H->D and
    H->A vectors; NaN where the cosine leaves [-1, 1] or a length is 0."""
    dot = hd[0] * ha[0] + hd[1] * ha[1] + hd[2] * ha[2]
    cosang = dot / (len_hd * len_ha)
    return cosang, torch.acos(cosang) * _DEG


def _guard_band(angle, cosang, min_angle: float):
    """The angle's decision band: flat floor plus the arccos conditioning
    term, which grows near 0 and 180 degrees."""
    cond = _COND_NUM / torch.sqrt(torch.clamp_min(1.0 - cosang * cosang, 1e-12))
    return torch.abs(angle - min_angle) < (_ANGLE_GUARD + cond)


def _axes(x):
    """[..., 3] -> three [...] views."""
    return [x[..., k] for k in range(3)]


def _score_device(pos, boxes, d_rank, a_rank, seg, valid, t, max_distance: float,
                  min_angle: float, n_pairs: int, full: bool):
    """The masked evaluation of a `[b, C]` candidate block.

    pos [b, N, 3] float32; boxes [b, 3]; d_rank/a_rank [b, C] int64 ranks
    into the tables `t` (`_PairTables.on`); seg [b, C] pair ids; valid
    [b, C].  -> counts [b, P] int64, guard_cnt [b] int64, (frame, slot)
    of every guarded triple with the device's keep there, and with `full`
    the [b, C, H] keep, [b, C] dist, [b, C, H] angle and guard arrays."""
    b, c = d_rank.shape
    hmax = t["h_tab"].shape[1]
    n = pos.shape[1]
    dr = d_rank.clamp(0, t["don_idx"].shape[0] - 1)
    ar = a_rank.clamp(0, t["acc_idx"].shape[0] - 1)
    d_i = t["don_idx"][dr]
    a_i = t["acc_idx"][ar]
    h_i = t["h_tab"][dr]                               # [b, C, H]
    n_h = t["h_cnt"][dr]                               # [b, C]

    def take(idx):                                     # -> three [b, ...] axes
        flat = idx.reshape(b, -1).clamp(0, n - 1)
        return [torch.gather(pos[..., k], 1, flat).reshape(idx.shape)
                for k in range(3)]

    box = [boxes[:, None, k] for k in range(3)]        # [b, 1]
    box_h = [x[..., None] for x in box]                # [b, 1, 1]
    dp, ap = take(d_i), take(a_i)                      # [b, C]
    dist = _dist_dev(ap, dp, box)
    keep_d = ~(dist > max_distance)

    hp = take(h_i)                                     # [b, C, H]
    dp_h = [x[..., None] for x in dp]
    ap_h = [x[..., None] for x in ap]
    hd = [_vector_to_dev(hp[k], dp_h[k], box_h[k]) for k in range(3)]
    ha = [_vector_to_dev(hp[k], ap_h[k], box_h[k]) for k in range(3)]
    cosang, angle = _angle_dev(hd, ha, _norm(hd), _norm(ha))
    nan = torch.isnan(angle)
    # handle_nan: 180 if H is closer to A than D is to A, else 0
    ha_d = _dist_dev(hp, ap_h, box_h)
    da_d = _dist_dev(dp_h, ap_h, box_h)
    angle = torch.where(nan, torch.where(ha_d < da_d, 180.0, 0.0), angle)

    h_valid = torch.arange(hmax, device=pos.device) < n_h[..., None]
    tri_valid = valid[..., None] & h_valid
    keep = tri_valid & keep_d[..., None] & ~(angle < min_angle)

    guard = _guard_band(angle, cosang, min_angle)
    guard |= (torch.abs(dist - max_distance)
              < float(np.float32(max_distance) * _DIST_GUARD_REL))[..., None]
    guard |= nan & (torch.abs(ha_d - da_d) < (ha_d + da_d) * float(_DIST_GUARD_REL))
    guard &= tri_valid

    counts = torch.stack([(keep & (seg == p)[..., None]).sum((1, 2))
                          for p in range(n_pairs)], -1)
    guard_cnt = guard.sum((1, 2))
    if prof.TRACING:
        prof.count("host_sync", "hbond.nonzero")
    g_frame, g_slot = torch.nonzero(guard.reshape(b, -1), as_tuple=True)
    keep_at = keep.reshape(b, -1)[g_frame, g_slot]
    out = {"counts": counts, "guard_cnt": guard_cnt, "g_frame": g_frame,
           "g_slot": g_slot, "keep_at": keep_at}
    if full:
        out.update(keep=keep, dist=dist, angle=angle, guard=guard)
    return out


class _PairTables:
    """Static tables of one HBondAnalysis: combined donor/acceptor
    atom-index tables and per-donor hydrogen rows across all (pair,
    direction) legs (reference analyze_pair directions,
    hbonds.rs:207-225), on the host and, on first use, on each device."""

    def __init__(self, analysis: "HBondAnalysis"):
        self.legs = []  # (pair_id, acc_chain, don_chain, don_off, acc_off)
        don_parts, acc_parts, cnt_parts = [], [], []
        nd = na = 0
        for pair_id, (c1, c2) in enumerate(analysis.pairs):
            directions = [(c1, c1)] if c1 == c2 else [(c1, c2), (c2, c1)]
            for acc_c, don_c in directions:
                acc_g = analysis.chains[acc_c]
                don_g = analysis.chains[don_c]
                self.legs.append((pair_id, acc_g, don_g, nd, na))
                don_parts.append(don_g.donors)
                acc_parts.append(acc_g.acceptors)
                cnt_parts.append(np.diff(don_g.h_offsets))
                nd += don_g.donors.shape[0]
                na += acc_g.acceptors.shape[0]

        def cat(parts):
            return (np.concatenate(parts) if parts else np.zeros(0, np.int64)).astype(np.int32)

        self.don_idx = cat(don_parts)
        self.acc_idx = cat(acc_parts)
        cnts = cat(cnt_parts)
        maxh = max(1, int(cnts.max()) if cnts.shape[0] else 1)
        self.h_tab = np.zeros((max(nd, 1), maxh), np.int32)
        self.h_cnt = np.zeros(max(nd, 1), np.int32)
        self.h_cnt[:nd] = cnts
        for _, _, don_g, don_off, _ in self.legs:
            rows, slot = _segments(np.diff(don_g.h_offsets))
            self.h_tab[don_off + rows, slot] = don_g.h_idx
        # compact rank dtype when tables are small (halves the pair wire)
        self.rank_dtype = np.int16 if max(nd, na) <= 32767 else np.int32
        self._dev = {}

    def on(self, device) -> dict:
        """The tables as int64 tensors on `device` (at least one row each,
        so that a clamped gather has something to read)."""
        key = str(device)
        if key not in self._dev:
            def put(a):
                a = a if a.shape[0] else np.zeros((1,) + a.shape[1:], a.dtype)
                return torch.as_tensor(a.astype(np.int64), device=device)

            self._dev[key] = {"don_idx": put(self.don_idx), "acc_idx": put(self.acc_idx),
                              "h_tab": put(self.h_tab), "h_cnt": put(self.h_cnt)}
        return self._dev[key]

    def pack_frames(self, positions, boxes, max_distance):
        """Candidate pairs of a [B] frame block -> (d_rank, a_rank [B, C],
        seg [B, C] int16 pair ids, valid [B, C], segments per frame
        [(pair_id, start, stop), ...]); C is the block's largest
        candidate count."""
        b = positions.shape[0]
        per_frame = []
        seg_list = []
        self.last_walk_s = 0.0  # of which the C++ walks
        for i in range(b):
            ds, as_, ss = [], [], []
            segments = []
            n = 0
            last_pair = None
            for pair_id, acc_g, don_g, don_off, acc_off in self.legs:
                t0 = time.perf_counter()
                d_r, a_r = _candidate_pairs(positions[i], boxes[i], acc_g, don_g,
                                            max_distance)
                self.last_walk_s += time.perf_counter() - t0
                ds.append(d_r + don_off)
                as_.append(a_r + acc_off)
                ss.append(np.full(d_r.shape[0], pair_id, np.int16))
                if last_pair == pair_id:
                    # second direction of a cross-chain pair: extend
                    pk, s0, _ = segments[-1]
                    segments[-1] = (pk, s0, n + d_r.shape[0])
                else:
                    segments.append((pair_id, n, n + d_r.shape[0]))
                last_pair = pair_id
                n += d_r.shape[0]
            per_frame.append(tuple(np.concatenate(x) if x else np.zeros(0, np.int64)
                                   for x in (ds, as_, ss)))
            seg_list.append(segments)

        c = max((t[0].shape[0] for t in per_frame), default=0)
        d = np.zeros((b, c), self.rank_dtype)
        a = np.zeros((b, c), self.rank_dtype)
        seg = np.full((b, c), -1, np.int16)
        valid = np.zeros((b, c), bool)
        for i, (di, ai, si) in enumerate(per_frame):
            k = di.shape[0]
            d[i, :k] = di
            a[i, :k] = ai
            seg[i, :k] = si
            valid[i, :k] = True
        return d, a, seg, valid, seg_list


class HBondAnalysis:
    """Per-frame hydrogen-bond analyser (reference: hbonds.rs:86).
    `device`: where `analyze_batch` scores (the current CUDA card when
    None; the host `analyze` needs none)."""

    def __init__(self, system, chains, pairs, max_distance: float, min_angle: float,
                 device=None):
        from ..backend import as_device

        self.chains = [_ChainGroups(system, c) for c in chains]
        _sanity_check_pairs(pairs, len(self.chains))
        self.pairs = [tuple(p) for p in pairs]
        self.max_distance = float(max_distance)
        self.min_angle = float(min_angle)
        self.device = None if device is None else as_device(device)
        self._tables_cache = None
        # one dict per analyze_batch call: candidates and guarded triples
        # per frame, host candidate seconds (of which the C++ walks), wire
        # bytes, device ms (CUDA events; None on the CPU), re-score seconds
        self.batch_stats: list[dict] = []

    def analyze(self, system) -> dict:
        """-> HBondMap: {(chain1, chain2): [HBond, ...]}, on the host."""
        from ..core.simbox import simbox_check

        box = simbox_check(system.get_box()).to_lengths_vec()
        pos = system.positions
        out = {}
        for c1, c2 in self.pairs:
            bonds = _detect(pos, box, self.chains[c1], self.chains[c2],
                            self.max_distance, self.min_angle)
            if c1 != c2:
                # reference analyze_pair: acceptors(c1) x donors(c2), then
                # acceptors(c2) x donors(c1) (hbonds.rs:207-225)
                bonds += _detect(pos, box, self.chains[c2], self.chains[c1],
                                 self.max_distance, self.min_angle)
            out[(c1, c2)] = bonds
        return out

    # ------------------------------------------------------------- batched
    def _tables(self) -> _PairTables:
        if self._tables_cache is None:
            self._tables_cache = _PairTables(self)
        return self._tables_cache

    def _device(self):
        from ..backend import require_cuda

        return self.device if self.device is not None else require_cuda()

    def _rescore(self, tables, positions, boxes, d_r, a_r, i, ci, hi):
        """Exact host scores of frame i's (candidate, hydrogen) slots."""
        g = d_r[i, ci].astype(np.int64)
        return _score_triples(
            positions[i], boxes[i], tables.don_idx[g].astype(np.int64),
            tables.h_tab[g, hi].astype(np.int64),
            tables.acc_idx[a_r[i, ci].astype(np.int64)].astype(np.int64),
            self.max_distance, self.min_angle)

    def analyze_batch(self, positions, boxes, counts_only: bool = False,
                      q_positions=None, inv_prec=None):
        """Batched device analysis of a `[B, N, 3]` frame block.

        The host generates the candidate pair ranks (the C++ cell walk,
        integers only); they ship into the static device tables, hydrogens
        expand on the device and the criteria run as one masked evaluation
        over `[b, C]` blocks.  Returns a list of HBondMap per frame, or
        with `counts_only` a dict `{pair: int64[B]}` of per-frame counts
        (only counts and the guarded slots come back to the host).

        `q_positions` / `inv_prec`: ship the q16 ints and dequantize them
        on the device as `q.float() * inv_prec` (the engine's arithmetic);
        `positions` stays the host float32 copy used for binning and for
        the re-score, and must be the same floats.

        The bond SET equals `analyze()` exactly: every guarded triple is
        re-scored on the host.  Distances and angles may differ from the
        host path by float ulps."""
        positions = np.asarray(positions, np.float32)
        boxes = np.asarray(boxes, np.float32)
        b = positions.shape[0]
        n_pairs = len(self.pairs)
        tables = self._tables()
        t0 = time.perf_counter()
        with prof.span("hbond/walk", frames=b):
            d_r, a_r, seg, valid, seg_list = tables.pack_frames(positions, boxes,
                                                                self.max_distance)
        host_s = time.perf_counter() - t0
        hmax = tables.h_tab.shape[1]
        c = d_r.shape[1]
        stats = {"candidates": valid.sum(1), "host_candidate_s": host_s,
                 "walk_s": tables.last_walk_s, "wire_bytes": 0, "device_ms": None,
                 "guarded": np.zeros(b, np.int64), "rescore_s": 0.0}
        self.batch_stats.append(stats)
        if prof.TRACING:
            prof.count("hbond_candidates", "analyze_batch", int(stats["candidates"].sum()))

        counts = np.zeros((b, n_pairs), np.int64)
        full = None if counts_only else {
            "keep": np.zeros((b, c, hmax), bool), "dist": np.zeros((b, c), np.float32),
            "angle": np.zeros((b, c, hmax), np.float32),
            "guard": np.zeros((b, c, hmax), bool)}
        guarded = []  # (frame, slot, device keep) arrays per chunk
        if c:
            dev = self._device()
            ship = positions if q_positions is None else np.asarray(q_positions)
            host = [ship, boxes, d_r, a_r, seg, valid]
            if q_positions is not None:
                host.append(np.asarray(inv_prec, np.float32))
            stats["wire_bytes"] = int(sum(x.nbytes for x in host))
            with prof.span("hbond/ship", bytes=stats["wire_bytes"]):
                pos_d = torch.as_tensor(ship, device=dev)
                box_d = torch.as_tensor(boxes, device=dev)
                ranks = [torch.as_tensor(x, device=dev) for x in (d_r, a_r, seg, valid)]
                tab = tables.on(dev)
            score = prof.begin("hbond/score", frames=b) if prof.TRACING else None
            t_dev = dev.type == "cuda"
            if t_dev:  # device time of dequantization and scoring
                ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ev0.record()
            if q_positions is not None:
                inv = torch.as_tensor(np.asarray(inv_prec, np.float32), device=dev)
                pos_d = pos_d.to(torch.float32) * inv[:, None, None]
            step = max(1, _SCORE_TRIPLES // max(1, c * hmax))
            res = []
            for f0 in range(0, b, step):
                f1 = min(b, f0 + step)
                r = _score_device(pos_d[f0:f1], box_d[f0:f1], ranks[0][f0:f1].long(),
                                  ranks[1][f0:f1].long(), ranks[2][f0:f1],
                                  ranks[3][f0:f1], tab, self.max_distance,
                                  self.min_angle, n_pairs, full is not None)
                res.append((f0, f1, r))
            if t_dev:
                ev1.record()
            for f0, f1, r in res:
                if prof.TRACING:   # one a `.cpu()` below
                    prof.count("host_sync", "hbond.copy", 5 + (len(full) if full else 0))
                counts[f0:f1] = r["counts"].cpu().numpy()
                stats["guarded"][f0:f1] = r["guard_cnt"].cpu().numpy()
                guarded.append((r["g_frame"].cpu().numpy() + f0, r["g_slot"].cpu().numpy(),
                                r["keep_at"].cpu().numpy()))
                if full is not None:
                    for k in full:
                        full[k][f0:f1] = r[k].cpu().numpy()
            if t_dev:
                stats["device_ms"] = ev0.elapsed_time(ev1)
            prof.end(score)
        if prof.TRACING:
            prof.count("hbond_guarded", "analyze_batch", int(stats["guarded"].sum()))

        t0 = time.perf_counter()
        rescore = prof.begin("hbond/rescore") if prof.TRACING else None
        if counts_only:
            for g_frame, g_slot, keep_at in guarded:
                for i in np.unique(g_frame):
                    at = g_frame == i
                    ci, hi = g_slot[at] // hmax, g_slot[at] % hmax
                    k2, _, _ = self._rescore(tables, positions, boxes, d_r, a_r, i, ci, hi)
                    delta = k2.astype(np.int64) - keep_at[at].astype(np.int64)
                    counts[i] += np.bincount(seg[i, ci], weights=delta,
                                             minlength=n_pairs).astype(np.int64)
            stats["rescore_s"] = time.perf_counter() - t0
            prof.end(rescore)
            return {pair: counts[:, p] for p, pair in enumerate(self.pairs)}

        keep, dist, angle = full["keep"], full["dist"], full["angle"]
        maps = []
        for i in range(b):
            ci, hi = np.nonzero(full["guard"][i])
            if ci.shape[0]:
                k2, dist2, ang2 = self._rescore(tables, positions, boxes, d_r, a_r,
                                                i, ci, hi)
                keep[i, ci, hi] = k2
                dist[i, ci] = dist2
                angle[i, ci, hi] = ang2
            hmap = {}
            for pair_id, s, e in seg_list[i]:
                # row-major (pair, h-slot) = reference bond order
                ci, hi = np.nonzero(keep[i, s:e])
                ci = ci + s
                g = d_r[i, ci].astype(np.int64)
                hmap[self.pairs[pair_id]] = [
                    HBond(donor=int(tables.don_idx[gj]),
                          hydrogen=int(tables.h_tab[gj, hj]),
                          acceptor=int(tables.acc_idx[int(a_r[i, cj])]),
                          distance=float(dist[i, cj]),
                          angle=float(angle[i, cj, hj]))
                    for gj, cj, hj in zip(g, ci, hi)
                ]
            maps.append(hmap)
        stats["rescore_s"] = time.perf_counter() - t0
        prof.end(rescore)
        return maps


class _DenseCounter:
    """`count(positions [B, N, 3] float32, boxes [B, 3]) -> int64
    [B, n_pairs]` (with the guard: `(counts, guarded [B])`).  `calls`
    counts its calls; on CUDA `events` collects one (start, stop) event
    pair per call for device timing."""

    def __init__(self, legs, n_pairs, hmax, maxd, min_ang, with_guard, tile):
        self.legs = legs
        self.n_pairs = n_pairs
        self.hmax = hmax
        self.maxd = maxd
        self.min_ang = min_ang
        self.with_guard = with_guard
        self.tile = tile
        self.calls = 0
        self.events = []
        self._dev = {}

    def _legs_on(self, device):
        key = str(device)
        if key not in self._dev:
            self._dev[key] = [
                (pair_id, *(torch.as_tensor(a, device=device)
                            for a in (don, htab, hcnt, acc)))
                for pair_id, don, htab, hcnt, acc in self.legs]
        return self._dev[key]

    def __call__(self, pos, boxes):
        self.calls += 1
        cuda = pos.device.type == "cuda"
        if cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        b = pos.shape[0]
        out = torch.zeros((b, self.n_pairs), dtype=torch.int64, device=pos.device)
        gout = torch.zeros(b, dtype=torch.int64, device=pos.device)
        box = [boxes[:, None, None, k] for k in range(3)]      # [B, 1, 1]
        box_h = [x[..., None] for x in box]                     # [B, 1, 1, 1]
        h_ar = torch.arange(self.hmax, device=pos.device)
        for pair_id, don, htab, hcnt, acc in self._legs_on(pos.device):
            ap = [x[:, None, :] for x in _axes(pos[:, acc])]        # [B, 1, NA]
            na = acc.shape[0]
            tile = self.tile or max(1, _SCORE_TRIPLES // max(1, b * self.hmax * na))
            for t0 in range(0, don.shape[0], tile):
                dsl, hsl, csl = don[t0:t0 + tile], htab[t0:t0 + tile], hcnt[t0:t0 + tile]
                nt = dsl.shape[0]
                dp = [x[:, :, None] for x in _axes(pos[:, dsl])]    # [B, T, 1]
                hp = [x.reshape(b, nt, self.hmax, 1)
                      for x in _axes(pos[:, hsl.reshape(-1)])]      # [B, T, H, 1]
                dist = _dist_dev(dp, ap, box)                        # [B, T, NA]
                # exclude the donor atom itself (hbonds.rs:253)
                pair_ok = dsl[None, :, None] != acc[None, None, :]
                keep_d = ~(dist > self.maxd) & pair_ok
                hd = [_vector_to_dev(hp[k], dp[k][..., None], box_h[k])
                      for k in range(3)]                             # [B, T, H, 1]
                ha = [_vector_to_dev(hp[k], ap[k][:, :, None, :], box_h[k])
                      for k in range(3)]                             # [B, T, H, NA]
                len_ha = _norm(ha)
                cosang, angle = _angle_dev(hd, ha, _norm(hd), len_ha)
                nan = torch.isnan(angle)
                # vector_to IS a minimum-image displacement, so |vector_to|
                # is the distance handle_nan compares (hbonds.rs:321-338)
                da_d = dist[:, :, None, :]
                angle = torch.where(nan, torch.where(len_ha < da_d, 180.0, 0.0), angle)
                h_ok = (h_ar[None, :, None] < csl[:, None, None])[None]  # [1, T, H, 1]
                keep = keep_d[:, :, None, :] & h_ok & ~(angle < self.min_ang)
                out[:, pair_id] += keep.sum((1, 2, 3))
                if self.with_guard:
                    guard = _guard_band(angle, cosang, self.min_ang)
                    guard |= (torch.abs(dist - self.maxd)
                              < float(np.float32(self.maxd) * _DIST_GUARD_REL))[:, :, None, :]
                    guard |= nan & (torch.abs(len_ha - da_d)
                                    < (len_ha + da_d) * float(_DIST_GUARD_REL))
                    guard &= pair_ok[:, :, None, :] & h_ok
                    gout += guard.sum((1, 2, 3))
        if cuda:
            ev[1].record()
            self.events.append(ev)
        return (out, gout) if self.with_guard else out


def make_dense_counter(analysis: "HBondAnalysis", tile: int | None = None,
                       with_guard: bool = False):
    """The in-step hydrogen-bond counter over every donor x acceptor pair
    of each leg (JAX `make_dense_counter`, `hbonds.py:740-885`): no cell
    grid, no host candidate work, no extra wire.  A Python loop over donor
    tiles bounds the `[B, T, H, NA]` temporaries; `tile` (donors per
    tile) defaults to what keeps one temporary at `_SCORE_TRIPLES`
    elements.  Integer counts do not depend on it.

    `with_guard` also counts the decision-boundary triples per frame (the
    cell scorer's band); a frame with none is exact, one with some is
    re-scored on the host by the pipeline."""
    tables = analysis._tables()
    hmax = tables.h_tab.shape[1]
    legs = []
    for pair_id, acc_g, don_g, don_off, _ in tables.legs:
        nd = don_g.donors.shape[0]
        if nd == 0 or acc_g.acceptors.shape[0] == 0:
            continue
        legs.append((pair_id, don_g.donors.astype(np.int64),
                     tables.h_tab[don_off:don_off + nd].astype(np.int64),
                     tables.h_cnt[don_off:don_off + nd].astype(np.int64),
                     acc_g.acceptors.astype(np.int64)))
    return _DenseCounter(legs, len(analysis.pairs), hmax,
                         float(np.float32(analysis.max_distance)),
                         float(np.float32(analysis.min_angle)), with_guard, tile)


def remap_analysis(analysis: "HBondAnalysis", lut: np.ndarray) -> "HBondAnalysis":
    """A copy of `analysis` with atom indices rewritten through `lut`
    (full-system index -> shipped-layout index), so that candidate
    generation and scoring run on a gathered coordinate subset."""
    out = copy.copy(analysis)
    out._tables_cache = None  # tables hold atom indices; rebuild remapped
    out.batch_stats = []
    out.chains = []
    for ch in analysis.chains:
        c2 = copy.copy(ch)
        c2.acceptors = lut[ch.acceptors]
        c2.donors = lut[ch.donors]
        c2.h_idx = lut[ch.h_idx]
        if ((c2.acceptors < 0).any() or (c2.donors < 0).any()
                or (c2.h_idx < 0).any()):
            raise HBondError(
                "shipped atom selection does not cover the hbond chains",
                code="InvalidSelection",
            )
        out.chains.append(c2)
    return out


class HBondsMixin:
    def hbonds_analyze_frame(self, chains, pairs, max_distance: float = 0.35,
                             min_angle: float = 120.0) -> dict:
        """Detect hydrogen bonds in the current frame (on the host)."""
        analysis = HBondAnalysis(self, chains, pairs, max_distance, min_angle)
        return analysis.analyze(self)

    def hbonds_analyze(self, trajectory, chains, pairs, max_distance: float = 0.35,
                       min_angle: float = 120.0, **traj_kw):
        """Iterate a trajectory yielding (system, HBondMap) per frame, the
        system holding that frame (reference: HBondTrajRead::hbonds_analyze,
        hbonds.rs:457); host scoring."""
        from ..io.traj import traj_iter

        analysis = HBondAnalysis(self, chains, pairs, max_distance, min_angle)
        for frame in traj_iter(self, trajectory, **traj_kw):
            yield frame, analysis.analyze(frame)

    def hbonds_analyze_batched(self, trajectory, chains, pairs,
                               max_distance: float = 0.35,
                               min_angle: float = 120.0,
                               batch_size: int = 16,
                               counts_only: bool = False, device=None, **traj_kw):
        """The trajectory pass with device scoring (`analyze_batch`): frames
        decode in blocks and the criteria evaluate on `device` (the CUDA
        card by default); results equal `hbonds_analyze` exactly.  Yields
        `(time, HBondMap)` per frame, or `(time, {pair: count})` with
        `counts_only=True`."""
        from ..io.traj import traj_iter

        analysis = HBondAnalysis(self, chains, pairs, max_distance, min_angle,
                                 device=device)
        analysis._device()  # no card and no device given: raise before reading
        reader = traj_iter(self, trajectory, batch_size=batch_size, **traj_kw)
        batches = reader._loader(env=False)  # host positions: f32 whatever GROAN_WIRE
        if reader.progress is not None:
            batches = reader._ticked(batches)
        for fb in batches:
            pos = fb.positions
            boxes = fb.box_lengths()
            if counts_only:
                counts = analysis.analyze_batch(pos, boxes, counts_only=True)
                for i in range(pos.shape[0]):
                    yield float(fb.times[i]), {k: int(v[i]) for k, v in counts.items()}
            else:
                for i, hmap in enumerate(analysis.analyze_batch(pos, boxes)):
                    yield float(fb.times[i]), hmap
