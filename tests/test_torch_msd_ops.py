"""The PyTorch port's `ops/msd.py` against groan_rs_tpu's on the same seeded
numpy inputs, on the CPU: unwrapping (box lengths and box matrices), the
lag sweeps (MSD with and without an axis mask, plain and weighted time
correlations, Legendre orders 1 and 2, per-entity MSD) and the float64
host references.  Tolerance: relative 1e-5 of the largest value; the
unwrap at exact half-box displacements (round half to even) and the host
references bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from groan_rs_tpu.ops import msd as J

from _torch_parity import n, t
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.ops import msd as T

F, K = 11, 13
BOX = np.array([3.0, 3.5, 4.0], np.float32)


def _walk(seed, f=F, k=K, step=0.4):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(f, k, 3)) * step, axis=0).astype(np.float32)


def _wrapped(form, seed=1):
    """(wrapped positions, boxes) of a random walk: `[F, 3]` lengths that
    fluctuate by frame, or `[F, 3, 3]` dodecahedron matrices."""
    walk = _walk(seed)
    if form == "lengths":
        boxes = (BOX[None, :] * (1 + 0.01 * np.sin(np.arange(F)))[:, None]).astype(np.float32)
        return np.mod(walk, boxes[:, None, :]).astype(np.float32), boxes
    h = testing.dodecahedron(4.0).astype(np.float32)
    boxes = np.repeat(h[None], F, axis=0)
    pos = np.stack([testing.put_atoms_in_box(p, h) for p in walk]).astype(np.float32)
    return pos, boxes


def _close(a, b, rel=1e-5):
    a, b = n(a).astype(np.float64), n(b).astype(np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rel * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("form", ["lengths", "matrix"])
def test_unwrap(form):
    pos, boxes = _wrapped(form)
    want = J.unwrap(jnp.asarray(pos), jnp.asarray(boxes))
    got = T.unwrap(t(pos), t(boxes))
    _close(got, want)
    assert np.array_equal(n(got)[0], pos[0])
    # the paths are continuous: no step of a half box or more
    assert np.abs(np.diff(n(got), axis=0)).max() < 0.5 * 3.0


def test_unwrap_half_box_ties_bit_for_bit():
    """Steps of exactly +-L/2, +-3L/2 and 5L/2: the image is round(d / L),
    half to even, as JAX rounds it; every sum is exact."""
    L = np.float32(4.0)
    steps = np.array([2.0, -2.0, 6.0, -6.0, 10.0, -10.0, 0.5, 14.0], np.float32)
    pos = np.zeros((len(steps) + 1, 1, 3), np.float32)
    pos[1:, 0, :] = np.cumsum(steps)[:, None]
    pos = np.mod(pos, L)
    boxes = np.full((pos.shape[0], 3), L, np.float32)
    want = n(J.unwrap_orthorhombic(jnp.asarray(pos), jnp.asarray(boxes)))
    got = n(T.unwrap_orthorhombic(t(pos), t(boxes)))
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    d = np.diff(pos[:, 0, 0])
    half_even = d - L * np.round(d / L)
    assert np.array_equal(np.diff(got[:, 0, 0]), half_even)


MASKS = [None, np.array([1.0, 1.0, 0.0], np.float32), np.array([0.0, 0.0, 1.0], np.float32)]
LAGS = [np.arange(F), np.array([3, 0, F - 1, 5])]


@pytest.mark.parametrize("mask", range(len(MASKS)))
@pytest.mark.parametrize("lags", range(len(LAGS)))
@pytest.mark.parametrize("per_entity", [False, True])
def test_msd_lags(mask, lags, per_entity):
    u = _walk(2)
    am, lg = MASKS[mask], LAGS[lags]
    jf, tf = ((J.msd_lags_per_entity, T.msd_lags_per_entity) if per_entity
              else (J.msd_lags, T.msd_lags))
    _close(tf(t(u), lg, axis_mask=am), jf(jnp.asarray(u), lg, axis_mask=am))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("lags", range(len(LAGS)))
def test_lag_correlation(weighted, lags):
    s = np.random.default_rng(3).normal(size=(F, K, 3)).astype(np.float32) + 0.3
    w = np.random.default_rng(4).uniform(1, 16, K).astype(np.float32) if weighted else None
    lg = LAGS[lags]
    _close(T.lag_correlation(t(s), lg, weights=w),
           J.lag_correlation(jnp.asarray(s), lg, weights=w))


@pytest.mark.parametrize("order", [1, 2])
def test_legendre_lag_correlation(order):
    s = _walk(5)
    s /= np.linalg.norm(s, axis=-1, keepdims=True)
    _close(T.legendre_lag_correlation(t(s), np.arange(F), order),
           J.legendre_lag_correlation(jnp.asarray(s), np.arange(F), order))
    with pytest.raises(ValueError):
        T.legendre_lag_correlation(t(s), np.arange(F), 3)


def test_origin_chunks_keep_the_sums(monkeypatch):
    """Chunked origins (a temporary of one frame) give the sums of the
    unchunked sweep within float32 rounding."""
    u = t(_walk(6))
    whole = T.msd_lags_per_entity(u, np.arange(F))
    monkeypatch.setattr(T, "_CHUNK_ELEMS", 1)
    _close(T.msd_lags_per_entity(u, np.arange(F)), whole, rel=1e-6)
    counts = T.lag_sums(u, [0, 3, F - 1], lambda a, b: torch.tensor(a.shape[0]),
                        dtype=torch.int64)
    assert counts.tolist() == [F, F - 3, 1]


def test_host_references_equal_jax():
    pos, boxes = _wrapped("lengths", seed=7)
    lags = np.array([0, 1, 4, F - 1, F])
    assert np.array_equal(T.msd_host_f64(pos, boxes, lags),
                          J.msd_host_f64(pos, boxes, lags), equal_nan=True)
    w = np.random.default_rng(8).uniform(1, 2, K)
    for weights in (None, w):
        assert np.array_equal(T.lag_correlation_host_f64(pos, lags, weights),
                              J.lag_correlation_host_f64(pos, lags, weights),
                              equal_nan=True)
    # and the device forms against them
    u = T.unwrap(t(pos), t(boxes))
    _close(T.msd_lags(u, lags[:-1]), T.msd_host_f64(pos, boxes, lags[:-1]))
