"""Kabsch RMSD, batched over frames (QCP quaternion form).

Port of `groan_rs_tpu/ops/rmsd.py:47-153` (reference `src/system/rmsd.rs`):

- `prepare_coords` — shift the group so its refined COM sits at the box
  centre, then wrap (`extract_data_from_system`, rmsd.rs:425-447).  The
  COM is `ops.center.center`, i.e. the K1 + K2 kernels on CUDA.
- `kabsch` — unweighted 3x3 covariance, then Theobald's QCP: the optimal
  rotation is the eigenvector of the largest eigenvalue of a symmetric
  4x4 matrix (batched `torch.linalg.eigh`), mapped to a rotation matrix;
  RMSD = sqrt(sum w |R^T p_c - q_c|^2 / sum w) (rmsd.rs:547-604).
- `rmsd_frames` — RMSD of a `[B, n, 3]` batch against a prepared
  reference.
- `fit_transform` (`:258-274`) — apply a fit to every atom of a frame or
  of a `[B, N, 3]` batch (rmsd.rs:508-533).
- `prepare_coords_triclinic` / `rmsd_frames_triclinic` (`:210-255`) — the
  triclinic forms: every atom unwrapped around the triclinic refined COM
  by the exact minimum image (plain torch, no kernel), then the weighted
  centroid and the same `kabsch`.
- `rmsd_matrix` (`:156-200`) — the all-pairs fitted RMSD of a frame
  batch (`gmx rms -m`): every frame prepared once (K1 + K2 over the whole
  `[F, K, 3]`, or the triclinic unwrap), then rows `chunk` at a time, each
  one QCP `eigh` batch over the chunk's `chunk x F` pairs.

The covariance and the rotated-difference products are small einsums,
which the JAX package left to XLA outside any Pallas kernel; TF32 is off
(`backend`), so they run in full float32.  The eigenvector's sign is free,
but the quaternion-to-matrix map is even in q, so rotations are unique.
"""

from __future__ import annotations

import torch

from .. import backend as _backend  # noqa: F401  (TF32 off before any product)
from ..utils import profiling
from .center import center, center_triclinic
from .pbc import min_image_triclinic, min_image_triclinic_frames, wrap

__all__ = ["prepare_coords", "kabsch", "rmsd_frames", "rmsd_matrix",
           "fit_transform", "prepare_coords_triclinic", "rmsd_frames_triclinic"]


def prepare_coords(positions, box, mask=None, weights=None, com=None):
    """Shift selected atoms so their COM is at the box centre, then wrap.

    positions `[..., N, 3]`; box `(3,)` or `[B, 3]` (no atom axis); `com`
    the selection's refined COM `[..., 3]` where the caller has it, else
    it is computed here (K1 + K2).  Returns (shifted wrapped positions
    `[..., N, 3]`, box centre `[..., 3]`).
    """
    positions = torch.as_tensor(positions)
    box = torch.as_tensor(box, dtype=positions.dtype, device=positions.device)
    box_center = torch.broadcast_to(box * 0.5, positions.shape[:-2] + (3,))
    box_b = box[..., None, :] if box.dim() > 1 else box
    if com is None:
        com = center(positions, box_b, mask=mask, weights=weights)
    shifted = positions + (box_center - com)[..., None, :]
    return wrap(shifted, box_b), box_center


def _quaternion_to_matrix(qv):
    """Unit quaternion `[..., 4]` (w, x, y, z) -> rotation `[..., 3, 3]`."""
    qw, qx, qy, qz = qv.unbind(-1)
    r00 = qw * qw + qx * qx - qy * qy - qz * qz
    r11 = qw * qw - qx * qx + qy * qy - qz * qz
    r22 = qw * qw - qx * qx - qy * qy + qz * qz
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    return torch.stack([torch.stack([r00, r01, r02], -1),
                        torch.stack([r10, r11, r12], -1),
                        torch.stack([r20, r21, r22], -1)], -2)


def kabsch(p, q, w, centroid_p, centroid_q):
    """Batched mass-weighted Kabsch alignment (rmsd.rs:547-604).

    p (reference), q (target): `[..., n, 3]`; w: `[n]` or `[..., n]`;
    centroid_p/q: `[..., 3]`.  Returns (rotation `[..., 3, 3]` with
    `pc @ rotation` aligning centred p onto centred q, translation
    `[..., 3]`, rmsd `[...]`)."""
    p = torch.as_tensor(p)
    q = torch.as_tensor(q)
    w = torch.as_tensor(w, dtype=p.dtype, device=p.device)
    pc = p - torch.as_tensor(centroid_p)[..., None, :]
    qc = q - torch.as_tensor(centroid_q)[..., None, :]

    h = torch.einsum("...ni,...nj->...ij", pc, qc)
    sxx, sxy, sxz = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    syx, syy, syz = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    szx, szy, szz = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    kmat = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], -1),
    ], -2)

    if profiling.TRACING:   # the solver's error check waits for the device
        profiling.count("host_sync", "rmsd.eigh")
    _, vecs = torch.linalg.eigh(kmat)
    rot_q = _quaternion_to_matrix(vecs[..., :, -1])  # largest eigenvalue
    r = rot_q.transpose(-1, -2)  # reference convention: pc @ r

    d = torch.einsum("...ni,...ij->...nj", pc, r) - qc
    w_b = torch.broadcast_to(w, d.shape[:-1])
    rmsd = torch.sqrt((w_b * (d * d).sum(-1)).sum(-1) / w_b.sum(-1))
    trans = torch.as_tensor(centroid_q) - torch.as_tensor(centroid_p)
    return r, torch.broadcast_to(trans, rmsd.shape + (3,)), rmsd


def rmsd_frames(ref_prepared, ref_center, frames, boxes, w, mask=None, com=None):
    """RMSD of a `[B, n, 3]` frame batch vs a prepared reference.

    ref_prepared `[n, 3]` (from the reference's `prepare_coords`),
    ref_center `[3]`, frames `[B, n, 3]`, boxes `[B, 3]`, w `[n]` masses,
    `com` the frames' group COMs `[B, 3]` where the caller has them.
    Returns (rotations `[B, 3, 3]`, rmsd `[B]`)."""
    tgt, tgt_center = prepare_coords(frames, boxes, mask=mask, weights=w, com=com)
    w_eff = w if mask is None else torch.as_tensor(w) * torch.as_tensor(mask)
    r, _, rms = kabsch(ref_prepared[None, ...], tgt, w_eff,
                       ref_center[None, :], tgt_center)
    return r, rms


def rmsd_matrix(frames, boxes, w, *, chunk: int = 8):
    """All-pairs fitted RMSD of a frame batch -> `[F, F]` (the `gmx rms -m`
    matrix; feeds GROMOS clustering).

    frames `[F, K, 3]`; boxes `[F, 3]` lengths or `[F, 3, 3]` matrices
    (frames then unwrap around the exact triclinic refined COM, the
    `rmsd_frames_triclinic` convention); w `[K]` masses.  Every pair uses
    the single-pair `calc_rmsd` convention (mass-weighted centroids,
    unweighted covariance, mass-weighted deviations), so `out[i, j]` is
    `calc_rmsd` between the frame-i and frame-j systems: symmetric with a
    zero diagonal up to float32 rounding.  Rows go `chunk` at a time, so
    the largest tensor is `[chunk, F, K, 3]`."""
    frames = torch.as_tensor(frames, dtype=torch.float32)
    boxes = torch.as_tensor(boxes, dtype=torch.float32, device=frames.device)
    wj = torch.as_tensor(w, dtype=torch.float32, device=frames.device)
    f = frames.shape[0]
    if boxes.dim() == 3:
        com = center_triclinic(frames, boxes, weights=wj)
        prepped = com[:, None, :] + min_image_triclinic_frames(
            frames - com[:, None, :], boxes)
        ctr = (wj[None, :, None] * prepped).sum(1) / wj.sum()
    else:
        prepped, ctr = prepare_coords(frames, boxes, weights=wj)
    out = torch.empty((f, f), dtype=torch.float32, device=frames.device)
    for start in range(0, f, chunk):
        p = prepped[start:start + chunk]
        cp = ctr[start:start + chunk]
        _, _, out[start:start + chunk] = kabsch(
            p[:, None], prepped[None], wj, cp[:, None], ctr[None])
    return out


def fit_transform(all_positions, box, group_com, rotation, ref_group_com):
    """Apply an RMSD fit to every atom (reference: fit_structure,
    rmsd.rs:508-533): translate by (box centre - group COM) and wrap,
    translate by -box centre, rotate (`R @ x` per atom, i.e. x @ R^T for
    row vectors), translate by the reference group's COM.

    all_positions `[N, 3]` or `[B, N, 3]`; box `(3,)` or `[B, 3]`;
    group_com `[3]` or `[B, 3]`; rotation `(3, 3)` or `[B, 3, 3]`;
    ref_group_com `[3]`."""
    p = torch.as_tensor(all_positions)
    box = torch.as_tensor(box, dtype=p.dtype, device=p.device)
    box_center = box * 0.5
    shift = box_center - torch.as_tensor(group_com, dtype=p.dtype, device=p.device)
    box_b = box[..., None, :] if box.dim() > 1 else box
    moved = wrap(p + shift[..., None, :], box_b)
    centered = moved - box_center[..., None, :]
    r = torch.as_tensor(rotation, dtype=p.dtype, device=p.device)
    rotated = torch.einsum("...ni,...ji->...nj", centered, r)
    ref = torch.as_tensor(ref_group_com, dtype=p.dtype, device=p.device)
    return rotated + ref[..., None, :]


def _weights(w, mask, like):
    w = (torch.ones(like.shape[-2], dtype=like.dtype, device=like.device)
         if w is None else torch.as_tensor(w, dtype=like.dtype, device=like.device))
    if mask is not None:
        w = w * torch.as_tensor(mask, device=like.device).to(like.dtype)
    return w


def prepare_coords_triclinic(positions, box_matrix, mask=None, weights=None):
    """Triclinic analogue of `prepare_coords` for one structure: positions
    `[n, 3]`, box_matrix `(3, 3)`.  Every atom is unwrapped around the
    triclinic refined COM.  Returns (unwrapped `[n, 3]`, weighted
    centroid `[3]`)."""
    positions = torch.as_tensor(positions)
    com = center_triclinic(positions, box_matrix, mask=mask, weights=weights)
    unwrapped = com[None, :] + min_image_triclinic(positions - com[None, :],
                                                   box_matrix)
    w = _weights(weights, mask, positions)
    centroid = (w[:, None] * unwrapped).sum(0) / w.sum()
    return unwrapped, centroid


def rmsd_frames_triclinic(ref_prepared, ref_centroid, frames, boxes, w,
                          mask=None):
    """RMSD of a `[B, n, 3]` batch with per-frame `[B, 3, 3]` boxes against
    a reference from `prepare_coords_triclinic` -> (rotations `[B, 3, 3]`,
    rmsd `[B]`)."""
    frames = torch.as_tensor(frames)
    w = torch.as_tensor(w, dtype=frames.dtype, device=frames.device)
    w_eff = _weights(w, mask, frames)
    com = center_triclinic(frames, boxes, mask=mask, weights=w)
    tgt = com[:, None, :] + min_image_triclinic_frames(frames - com[:, None, :],
                                                       boxes)
    wb = torch.broadcast_to(w_eff, tgt.shape[:-1])
    cq = (wb[..., None] * tgt).sum(-2) / wb.sum(-1, keepdim=True)
    r, _, rms = kabsch(torch.as_tensor(ref_prepared)[None, ...], tgt, w_eff,
                       torch.as_tensor(ref_centroid)[None, :], cq)
    return r, rms
