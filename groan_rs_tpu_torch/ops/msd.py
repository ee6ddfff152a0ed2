"""Unwrapping and all-origin lag sweeps: MSD, time correlations, Legendre
rotational correlations.

Port of `groan_rs_tpu/ops/msd.py`:

  1. unwrap: consecutive-frame displacements taken through the minimum
     image (`d - L * round(d / L)` for box lengths, the exact 27-image
     search for box matrices; frame-to-frame motion is assumed smaller
     than half a box vector, as `gmx msd` assumes), then a cumulative sum
     rebuilds continuous paths.
  2. MSD(tau) = mean over time origins t and atoms of |u(t+tau) - u(t)|^2,
     and the correlations likewise, for every requested lag.

The JAX forms map over lags with `roll` plus a mask of the valid origins.
Here each lag takes `x[lag:] - x[:F - lag]` over the valid origins only
(the same terms, summed in another order), in origin chunks whose
temporary stays within 2^26 elements (`lag_sums`); every lag's value lands
in one device tensor, fetched once by the caller.  All math is float32;
the float64 host references (`msd_host_f64`, `lag_correlation_host_f64`)
are the test oracles, copied from the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch

from .pbc import min_image_triclinic_frames

__all__ = ["unwrap_orthorhombic", "unwrap_triclinic", "unwrap", "lag_sums",
           "origin_counts", "msd_lags", "msd_host_f64", "lag_correlation",
           "lag_correlation_host_f64", "legendre_lag_correlation",
           "msd_lags_per_entity"]

# elements of the largest temporary of one origin chunk of a lag sweep
_CHUNK_ELEMS = 1 << 26


def _cumulative(pos, d):
    return torch.cat([pos[:1], pos[:1] + torch.cumsum(d, 0)], 0)


def unwrap_orthorhombic(pos, boxes):
    """Remove periodic jumps: pos `[F, K, 3]` float32 wrapped coordinates,
    boxes `[F, 3]` lengths -> `[F, K, 3]` continuous coordinates with
    u[0] = pos[0].  Frame t's displacement uses frame t's box.  The image
    is `round(d / L)` with a true division, rounding half to even, as the
    JAX function takes it (not `pbc.min_image`'s loop form)."""
    d = pos[1:] - pos[:-1]
    b = boxes[1:][:, None, :]
    return _cumulative(pos, d - b * torch.round(d / b))


def unwrap_triclinic(pos, boxes):
    """Triclinic-exact unwrap: consecutive-frame displacements through the
    exact minimum image of boxes `[F, 3, 3]` (rows are box vectors), then
    cumulatively summed."""
    return _cumulative(pos, min_image_triclinic_frames(pos[1:] - pos[:-1], boxes[1:]))


def unwrap(pos, boxes):
    """Dispatch on the box form: `[F, 3]` lengths -> orthorhombic unwrap,
    `[F, 3, 3]` matrices -> exact triclinic unwrap."""
    boxes = torch.as_tensor(boxes, dtype=pos.dtype, device=pos.device)
    if boxes.dim() == 3:
        return unwrap_triclinic(pos, boxes)
    return unwrap_orthorhombic(pos, boxes)


def lag_sums(x, lags, chunk_sum, shape=(), dtype=torch.float32):
    """`[L, *shape]`: for each lag, the sum over the valid origins
    t < F - lag of `chunk_sum(x[t + lag], x[t])`, taken over origin chunks
    (`chunk_sum` gets `[n, ...]` slices and returns the chunk's `shape`
    sum).  A chunk holds as many origins as keep one `[n, ...]` slice
    within 2^26 elements."""
    f = x.shape[0]
    per = max(1, x[0].numel())
    step = max(1, _CHUNK_ELEMS // per)
    out = torch.zeros((len(lags),) + tuple(shape), dtype=dtype, device=x.device)
    for i, lag in enumerate(int(v) for v in lags):
        for a in range(0, max(f - lag, 0), step):
            b = min(f - lag, a + step)
            out[i] += chunk_sum(x[a + lag:b + lag], x[a:b])
    return out


def origin_counts(f, lags, device):
    """The valid-origin counts max(F - lag, 1) as a float32 tensor, to
    divide `lag_sums` by (a true division by a tensor, where CUDA
    multiplies by a scalar's reciprocal)."""
    n = np.maximum(f - np.asarray(lags, np.int64), 1)
    return torch.as_tensor(n.astype(np.float32), device=device)


def _masked(d, axis_mask):
    if axis_mask is None:
        return d
    return d * torch.as_tensor(np.asarray(axis_mask, np.float32), device=d.device)


def msd_lags(unwrapped, lags, axis_mask=None):
    """MSD over frame lags: unwrapped `[F, K, 3]` float32, lags `[L]` ->
    `[L]` float32, the mean over the F - lag origins and K atoms of the
    squared displacement.  `axis_mask` `[3]` restricts the displacement to
    selected axes (the `gmx msd -lateral/-type` filter)."""
    u = unwrapped
    f, k = u.shape[0], max(1, u.shape[1])

    def chunk(a, b):
        d = _masked(a - b, axis_mask)
        return (d * d).sum()

    return lag_sums(u, lags, chunk) / (origin_counts(f, lags, u.device) * k)


def msd_host_f64(pos, boxes, lags):
    """Float64 host reference of unwrap + MSD (test oracle)."""
    p = np.asarray(pos, np.float64)
    b = np.asarray(boxes, np.float64)
    d = p[1:] - p[:-1]
    bb = b[1:][:, None, :]
    d -= bb * np.round(d / bb)
    u = np.concatenate([p[:1], p[:1] + np.cumsum(d, axis=0)], axis=0)
    out = []
    f, k = u.shape[0], max(1, u.shape[1])
    for lag in np.asarray(lags, np.int64):
        if lag >= f:
            out.append(np.nan)
            continue
        if lag == 0:
            out.append(0.0)
            continue
        disp = u[lag:] - u[:-lag]
        out.append(float((disp**2).sum() / ((f - lag) * k)))
    return np.asarray(out)


def lag_correlation(series, lags, weights=None):
    """Time autocorrelation of a per-atom vector series over frame lags:
    series `[F, K, 3]` float32, weights `[K]` or None -> `[L]` float32,
    C(tau) = mean over the F - tau origins of the (weighted) atom mean of
    dot(series(t), series(t + tau)) (`gmx velacc`; masses for `-m`)."""
    s = series
    f = s.shape[0]
    if weights is None:
        w = torch.ones(s.shape[1], dtype=torch.float32, device=s.device)
    else:
        w = torch.as_tensor(np.asarray(weights, np.float32), device=s.device)
    wsum = torch.clamp(w.sum(), min=1e-30)

    def chunk(a, b):
        return ((a * b).sum(-1) * w).sum()

    return lag_sums(s, lags, chunk) / wsum / origin_counts(f, lags, s.device)


def lag_correlation_host_f64(series, lags, weights=None):
    """Float64 host reference of `lag_correlation` (test oracle)."""
    s = np.asarray(series, np.float64)
    f = s.shape[0]
    w = (np.ones(s.shape[1]) if weights is None
         else np.asarray(weights, np.float64))
    out = []
    for lag in np.asarray(lags, np.int64):
        if lag >= f:
            out.append(np.nan)
            continue
        dot = np.sum(s[lag:] * s[: f - lag], axis=-1)  # [F-lag, K]
        out.append(float((dot @ w).sum() / (w.sum() * (f - lag))))
    return np.asarray(out)


def legendre_lag_correlation(series, lags, order: int = 2):
    """Legendre rotational autocorrelation: series `[F, K, 3]` UNIT
    vectors, order 1 or 2 -> `[L]` float32, C_n(tau) = mean over origins
    and vectors of P_n(u(t) . u(t + tau)) (`gmx rotacf -P n`)."""
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    s = series
    f, k = s.shape[0], s.shape[1]

    def chunk(a, b):
        dot = (a * b).sum(-1)
        p = dot if order == 1 else 1.5 * dot * dot - 0.5
        return p.sum()

    return lag_sums(s, lags, chunk) / k / origin_counts(f, lags, s.device)


def msd_lags_per_entity(unwrapped, lags, axis_mask=None):
    """Per-entity MSD: like `msd_lags`, but the K entities (molecule COMs)
    keep separate curves -> `[L, K]`, the mean over time origins only (the
    `gmx msd -mol` sweep)."""
    u = unwrapped
    f, k = u.shape[0], u.shape[1]

    def chunk(a, b):
        d = _masked(a - b, axis_mask)
        return (d * d).sum(-1).sum(0)

    return lag_sums(u, lags, chunk, shape=(k,)) / origin_counts(f, lags, u.device)[:, None]
