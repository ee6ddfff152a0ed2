"""Secondary-structure assignment (Kabsch-Sander) in torch.

Port of `groan_rs_tpu/ops/dssp.py` (`hbond_energy` :36, `assign_3state`
:85, `assign_8state` :137).  The JAX package computes the `[F, R, R]`
energy matrix on the device and runs the boolean pattern algebra in numpy
on the host; here both run in torch on the energies' device, and
`codes` takes the frames a chunk at a time, so only the `[F, R]` state
codes leave the device (at 9,900 residues and 48 frames the whole energy
tensor would be 18.8 GB).  Boolean algebra is exact: the codes equal the
JAX package's wherever no energy lies in reach of float32 rounding of
`KS_CUTOFF`.

Conventions (as the JAX module):
- E(donor j, acceptor i) = 0.084 * 332 * (1/rON + 1/rCH - 1/rOH - 1/rCN)
  kcal/mol with distances in Angstrom (coordinates are nm); a hydrogen
  bond iff E < -0.5.
- The amide H is estimated from the backbone (pydssp):
  H(i) = N(i) + 1.01 A * unit(unit(N(i)-C(i-1)) + unit(N(i)-O(i-1))).
  Residues without a predecessor and prolines are never donors.
- Hbond(i, j) means "CO of residue i accepts from NH of residue j";
  n-turn(i) = Hbond(i, i+n).  3-state: H = any minimal 3/4/5-helix span,
  E = any bridge partner (strand overrides helix), '-' otherwise.
  8-state: H, E (a bridge in a ladder), B (an isolated bridge), G, I,
  T (inside an n-turn), S (CA curvature above 70 degrees), '-'.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import backend as _backend  # noqa: F401  (TF32 off before any product)
from .pbc import min_image_frames_any

__all__ = ["hbond_energy", "assign_3state", "assign_8state", "codes",
           "KS_CUTOFF", "CODES3", "CODES8"]

KS_CUTOFF = -0.5          # kcal/mol
_Q1Q2F = 0.084 * 332.0    # Kabsch-Sander electrostatic factor
CODES3 = ("H", "E", "-")
CODES8 = ("H", "G", "I", "E", "B", "T", "S", "-")

# residue pairs of one energy chunk: [frames, R, R, 3] float32 displacements
# of 2^27 pairs take 1.6 GB each
_CHUNK_PAIRS = 1 << 27


def hbond_energy(n, ca, c, o, boxes, donor_ok):
    """Backbone H-bond energy matrix per frame.

    n/ca/c/o `[F, R, 3]` nm; boxes `[F, 3]` lengths or `[F, 3, 3]`
    matrices (exact minimum image); donor_ok `[R]` bool.  Returns
    `[F, R, R]` float32 kcal/mol, `e[f, j, i]` donor NH(j) -> acceptor
    CO(i); invalid donors and |i - j| < 2 hold +inf."""
    n = torch.as_tensor(n, dtype=torch.float32)
    dev = n.device
    ca, c, o = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                for x in (ca, c, o))
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    r = n.shape[1]

    def unit(v):
        return v / torch.sqrt((v * v).sum(-1, keepdim=True))

    nc = min_image_frames_any(n[:, 1:] - c[:, :-1], boxes)
    no = min_image_frames_any(n[:, 1:] - o[:, :-1], boxes)
    h = torch.cat([n[:, :1], n[:, 1:] + 0.101 * unit(unit(nc) + unit(no))], 1)

    def dist(a, b):  # [F, R_a, R_b] minimum-image distances in Angstrom
        d = min_image_frames_any(a[:, :, None, :] - b[:, None, :, :], boxes)
        return 10.0 * torch.sqrt((d * d).sum(-1))

    e = _Q1Q2F * (1.0 / dist(n, o) + 1.0 / dist(h, c)
                  - 1.0 / dist(h, o) - 1.0 / dist(n, c))
    jj = torch.arange(r, device=dev)
    near = (jj[:, None] - jj[None, :]).abs() < 2
    ok = torch.as_tensor(np.asarray(donor_ok), dtype=torch.bool, device=dev)
    return torch.where(near[None] | ~ok[None, :, None], torch.inf, e)


def _run_ok(consec, nres):
    """[R] bool: residues i..i+nres all consecutive (False for the last
    nres residues)."""
    r = consec.shape[0]
    bad = torch.cat([consec.new_zeros(1, dtype=torch.int64),
                     torch.cumsum((~consec).to(torch.int64), 0)])
    out = torch.zeros(r, dtype=torch.bool, device=consec.device)
    m = max(0, r - nres)
    out[:m] = (bad[nres:nres + m] - bad[:m]) == 0
    return out


def _minimal_helix(ks, consec, nres):
    """(residues of minimal nres-helices [F, R], nres-turns [F, R])."""
    f, r, _ = ks.shape
    turn = torch.zeros((f, r), dtype=torch.bool, device=ks.device)
    m = max(0, r - nres)
    turn[:, :m] = torch.diagonal(ks, offset=nres, dim1=1, dim2=2) \
        & _run_ok(consec, nres)[:m]
    start = turn[:, :-1] & turn[:, 1:]       # turns at i and i+1
    span = torch.zeros_like(turn)
    for k in range(2, nres + 2):             # -> residues i+2 .. i+1+nres
        if r > k:
            span[:, k:] |= start[:, :r - k]
    return span, turn


def _bridges(ks):
    """(parallel, antiparallel) bridge matrices [F, R, R], |i - j| >= 3."""
    f, r, _ = ks.shape
    kp = torch.zeros((f, r + 2, r + 2), dtype=torch.bool, device=ks.device)
    kp[:, 1:-1, 1:-1] = ks                   # ks with a +-1 margin
    i = torch.arange(r, device=ks.device)
    far = ((i[:, None] - i[None, :]).abs() >= 3)[None]
    # parallel: [Hb(i-1, j) & Hb(j, i+1)] | [Hb(j-1, i) & Hb(i, j+1)]
    p = ((kp[:, :-2, 1:-1] & kp[:, 1:-1, 2:].transpose(1, 2))
         | (kp[:, :-2, 1:-1].transpose(1, 2) & kp[:, 1:-1, 2:])) & far
    # antiparallel: [Hb(i, j) & Hb(j, i)] | [Hb(i-1, j+1) & Hb(j-1, i+1)]
    a = ((ks & ks.transpose(1, 2))
         | (kp[:, :-2, 2:] & kp[:, :-2, 2:].transpose(1, 2))) & far
    return p, a


def _codes3(e, consec, cutoff):
    """3-state codes (indices into CODES3) [F, R] int8 of energies [F, R, R]."""
    ks = (e < cutoff).transpose(1, 2)        # ks[f, i, j]: CO(i) <- NH(j)
    helix = torch.zeros(ks.shape[:2], dtype=torch.bool, device=ks.device)
    for nres in (3, 4, 5):
        helix |= _minimal_helix(ks, consec, nres)[0]
    p, a = _bridges(ks)
    strand = (p | a).any(2)
    ss = torch.full(ks.shape[:2], 2, dtype=torch.int8, device=ks.device)
    ss[helix] = 0
    ss[strand] = 1                           # strand overrides helix
    return ss


def _ladder(b, anti):
    """Bridges (i, j) continued by an adjacent bridge of their type:
    parallel at (i+-1, j+-1), antiparallel at (i+-1, j-+1)."""
    f, r, _ = b.shape
    bp = torch.zeros((f, r + 2, r + 2), dtype=torch.bool, device=b.device)
    bp[:, 1:-1, 1:-1] = b
    adj = (bp[:, :-2, 2:] | bp[:, 2:, :-2]) if anti \
        else (bp[:, :-2, :-2] | bp[:, 2:, 2:])
    return b & adj


def _bends(ca, boxes, consec):
    """S mask [F, R]: CA curvature above 70 degrees over i-2 .. i+2, all
    five residues consecutive.  The CA differences and their minimum image
    are float32, the angle float64 (the JAX function's arithmetic)."""
    f, r, _ = ca.shape
    s = torch.zeros((f, r), dtype=torch.bool, device=ca.device)
    if r < 5:
        return s
    u = min_image_frames_any(ca[:, 2:] - ca[:, :-2], boxes).to(torch.float64)
    v1, v2 = u[:, :-2], u[:, 2:]
    cosk = (v1 * v2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(v1, dim=-1) * torch.linalg.vector_norm(v2, dim=-1),
        min=1e-12)
    bend = torch.rad2deg(torch.arccos(torch.clamp(cosk, -1, 1))) > 70.0
    ok = _run_ok(consec, 4)[:r - 4]          # consec[j-2 .. j+1], j = 2 .. r-3
    s[:, 2:r - 2] = bend & ok[None]
    return s


def _codes8(e, consec, cutoff, ca=None, boxes=None):
    """8-state codes (indices into CODES8) [F, R] int8."""
    ks = (e < cutoff).transpose(1, 2)
    f, r = ks.shape[:2]
    h4, t4 = _minimal_helix(ks, consec, 4)
    h3, t3 = _minimal_helix(ks, consec, 3)
    h5, t5 = _minimal_helix(ks, consec, 5)
    p, a = _bridges(ks)
    strand = (_ladder(p, False) | _ladder(a, True)).any(2)      # E
    isolated = (p | a).any(2) & ~strand                          # B
    t_mask = torch.zeros((f, r), dtype=torch.bool, device=ks.device)
    for nres, turn in ((3, t3), (4, t4), (5, t5)):
        for k in range(1, nres):             # residues strictly inside
            if r > k:
                t_mask[:, k:] |= turn[:, :r - k]
    s_mask = (_bends(torch.as_tensor(ca, dtype=torch.float32, device=ks.device),
                     torch.as_tensor(boxes, dtype=torch.float32, device=ks.device),
                     consec)
              if ca is not None else torch.zeros_like(t_mask))
    ss = torch.full((f, r), 7, dtype=torch.int8, device=ks.device)
    for mask, code in ((s_mask, 6), (t_mask, 5), (h5, 2), (h3, 1),
                       (isolated, 4), (strand, 3), (h4, 0)):
        ss[mask] = code
    return ss


def _consec(consec, device):
    return torch.as_tensor(np.asarray(consec), dtype=torch.bool, device=device)


def assign_3state(energies, consec, cutoff: float = KS_CUTOFF):
    """Kabsch-Sander 3-state assignment of `[F, R, R]` energies (donor j
    -> acceptor i, as `hbond_energy`); consec `[R]` bool, consec[i] =
    residue i+1 directly follows residue i.  Returns a numpy `[F, R]`
    array of 'H' / 'E' / '-'."""
    e = torch.as_tensor(energies)
    ss = _codes3(e, _consec(consec, e.device), cutoff)
    return np.asarray(CODES3)[ss.cpu().numpy()]


def assign_8state(energies, consec, ca=None, boxes=None,
                  cutoff: float = KS_CUTOFF):
    """Full 8-state DSSP assignment of `[F, R, R]` energies; `ca`
    `[F, R, 3]` nm and `boxes` give the bends (S).  Returns a numpy
    `[F, R]` array of 'H', 'G', 'I', 'E', 'B', 'T', 'S' and '-'."""
    e = torch.as_tensor(energies)
    ss = _codes8(e, _consec(consec, e.device), cutoff, ca, boxes)
    return np.asarray(CODES8)[ss.cpu().numpy()]


def codes(n, ca, c, o, boxes, donor_ok, consec, states: int = 3,
          cutoff: float = KS_CUTOFF):
    """`[F, R]` state codes (numpy 'U1') of backbone frames: energies and
    pattern algebra frame chunk by frame chunk on the coordinates' device,
    each chunk's `[f, R, R]` energies under `_CHUNK_PAIRS` pairs."""
    n = torch.as_tensor(n, dtype=torch.float32)
    f, r = n.shape[:2]
    cons = _consec(consec, n.device)
    fc = max(1, _CHUNK_PAIRS // max(1, r * r))
    out = []
    for f0 in range(0, f, fc):
        sl = slice(f0, f0 + fc)
        e = hbond_energy(n[sl], ca[sl], c[sl], o[sl], boxes[sl], donor_ok)
        out.append(_codes3(e, cons, cutoff) if states == 3
                   else _codes8(e, cons, cutoff, ca[sl], boxes[sl]))
        del e
    table = CODES3 if states == 3 else CODES8
    return np.asarray(table)[torch.cat(out).cpu().numpy()]
