"""Centre of geometry / centre of mass (refined Bai-Breen).

Port of `groan_rs_tpu/ops/center.py:30-80` and `:126-139`.  The JAX
package's production centre is the XLA-fused masked reduction; here the
orthorhombic centre is the hand-written K1 + K2 kernel pair
(`ops.kernels.bai_breen_estimate` / `bai_breen_refine`) on CUDA tensors,
and their plain twins on CPU tensors:

- `estimate_center` — Bai & Breen (2008) circular-mean estimate (K1).
- `center` — the geometric estimate over the selected atoms (K1), then
  every atom unwrapped around it and the (mass-)weighted mean (K2),
  `AtomIteratorWithBox::get_center` / `get_com` (iterators.rs:1237-1266).

Positions are `[N, 3]` or `[B, N, 3]` float32 (a frame batch; a
contiguous-slice view of a larger batch goes into the kernels without a
copy); `box` is `(3,)`, `[B, 3]` or `[B, 1, 3]`; `mask` and `weights` are
`[N]`.  An empty selection gives NaN.

`center_triclinic` (`groan_rs_tpu/ops/center.py:83-123`) is plain torch on
every device, as the JAX function is XLA outside any Pallas kernel: the
circular mean and the unwrap run on fractional coordinates (period 1 per
axis), the unwrap as `d - round(d)`.  K2 unwraps with `vector_to`'s
`floor(d / L + 1/2)`, which differs from `round` at ties, so the
fractional coordinates do not go through K1 and K2.
"""

from __future__ import annotations

import torch

from . import kernels
from .pbc import box_inverse

__all__ = ["estimate_center", "center", "center_triclinic", "center_naive"]

_TWO_PI = 6.283185307179586


def _mask_weights(mask, like):
    if mask is None:
        return None
    return torch.as_tensor(mask, device=like.device).to(torch.float32)


def _combined(mask, weights, like):
    m = _mask_weights(mask, like)
    if weights is None:
        return m
    w = torch.as_tensor(weights, device=like.device).to(torch.float32)
    return w if m is None else w * m


def estimate_center(positions, box, mask=None, weights=None):
    """Bai-Breen circular-mean centre estimate -> `[3]` or `[B, 3]`."""
    return kernels.bai_breen_estimate(
        positions, _combined(mask, weights, positions), box)


def center(positions, box, mask=None, weights=None):
    """Refined centre: the geometric estimate over `mask` (K1), then the
    unwrap-and-mean with `mask * weights` (K2) -> `[3]` or `[B, 3]`."""
    est = kernels.bai_breen_estimate(
        positions, _mask_weights(mask, positions), box)
    return kernels.bai_breen_refine(
        positions, _combined(mask, weights, positions), box, est)


def center_triclinic(positions, box_matrix, mask=None, weights=None):
    """Refined Bai-Breen centre in a triclinic box: positions `[N, 3]` or
    `[B, N, 3]`, box_matrix `(3, 3)` or `[B, 3, 3]` (rows are the box
    vectors) -> `[3]` or `[B, 3]`.  `mask * weights` weighs both the
    estimate and the mean, as in the JAX function."""
    positions = torch.as_tensor(positions)
    h = torch.as_tensor(box_matrix, dtype=positions.dtype,
                        device=positions.device)
    w = _combined(mask, weights, positions)
    if w is None:
        w = torch.ones(positions.shape[-2], dtype=positions.dtype,
                       device=positions.device)
    w = torch.broadcast_to(w, positions.shape[:-1])
    s = torch.einsum("...ni,...ij->...nj", positions, box_inverse(h))
    theta = (s - torch.floor(s)) * _TWO_PI
    wx = w[..., None]
    xi = (wx * torch.cos(theta)).sum(-2)
    zeta = (wx * torch.sin(theta)).sum(-2)
    est = (torch.atan2(-zeta, -xi) + torch.pi) / _TWO_PI  # fractional
    d = s - est[..., None, :]
    d = d - torch.round(d)
    frac = (wx * (est[..., None, :] + d)).sum(-2) / w.sum(-1, keepdim=True)
    return torch.einsum("...i,...ij->...j", frac, h)


def center_naive(positions, mask=None, weights=None):
    """Plain (weighted) mean ignoring PBC (`get_center_naive`)."""
    positions = torch.as_tensor(positions)
    w = _combined(mask, weights, positions)
    if w is None:
        return positions.mean(-2)
    return (w[..., None] * positions).sum(-2) / w.sum(-1, keepdim=True)
