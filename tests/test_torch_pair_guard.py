"""The arithmetic of K3's division-free minimum image (csrc/pair_reduce.cu),
emulated in numpy float32 with the kernel's operations in the kernel's
order (no FMA except the guard's threshold), against the reference
formula floor(d / L + 0.5) with true division.

The kernel takes k = rint(d * (1/L)) and falls back to the reference
formula where q = d * (1/L) lies within the tie guard of a half-integer.
Its guard width is read from the CUDA source, so these tests check the
width that ships.  A k that is off by one at a tie changes d2 only in the
last bits, which random inputs never show and half-box lattices do."""

import pathlib
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from _torch_parity import t
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.ops import kernels as K

SRC = (pathlib.Path(K.CSRC) / "pair_reduce.cu").read_text()
GUARD_ULPS = int(re.search(r"constexpr int kTieGuardUlps = (\d+);", SRC).group(1))
ROUND = np.float32(float(re.search(r"constexpr float kRound = ([0-9.]+)f;",
                                   SRC).group(1)))
f32 = np.float32


def reference_k(d, L):
    d, L = np.asarray(d, f32), np.asarray(L, f32)
    return np.floor(d / L + f32(0.5))


def kernel_k(d, L, guard_ulps=GUARD_ULPS, qmax=None):
    """`fast_k` and its fallback, as the kernel computes them.  `qmax` is
    the work item's bound on |q| (default |q| itself: the narrowest
    threshold any item can have)."""
    d, L = np.asarray(d, f32), np.asarray(L, f32)
    inv = f32(1.0) / L
    q = d * inv
    k = (q + ROUND) - ROUND
    r = q - k
    qmax = np.abs(q) if qmax is None else np.asarray(qmax, f32)
    guard = guard_ulps * 2.0 ** -23
    # tie_threshold: __fmaf_rn(qmax, -guard, 0.5 - guard); the product is
    # exact in float64
    th = (qmax.astype(np.float64) * -guard + (0.5 - guard)).astype(f32)
    risky = np.abs(r) > th
    return np.where(risky, reference_k(d, L), k), risky


def test_guard_constant_is_read_from_the_source():
    assert GUARD_ULPS == 16 and ROUND == f32(1.5 * 2 ** 23)


def test_fast_k_at_ties_and_near_them():
    d, L = testing.tie_quotients()
    got, risky = kernel_k(d, L)
    want = reference_k(d, L)
    bad = got != want
    assert not bad.any(), list(zip(d[bad][:5], L[bad][:5]))
    assert risky[np.abs(d / L) < 5].mean() > 0.5  # ties take the exact path


def test_the_guard_is_needed():
    """Without its guard the fast k is off by one at some ties, so the
    adversarial set can tell a guard that is too narrow."""
    d, L = testing.tie_quotients()
    small = np.abs(d / L) < 2 ** 17  # where the rint trick itself is valid
    got, _ = kernel_k(d[small], L[small], guard_ulps=0)
    assert (got != reference_k(d[small], L[small])).any()


def test_fast_k_random_million():
    rng = np.random.default_rng(7)
    L = rng.uniform(0.5, 100.0, 10 ** 6).astype(f32)
    d = (rng.uniform(-3.0, 3.0, 10 ** 6) * L).astype(f32)
    got, risky = kernel_k(d, L)
    np.testing.assert_array_equal(got, reference_k(d, L))
    assert risky.mean() < 1e-3  # the fast path is the rule


@settings(max_examples=400, deadline=None)
@given(st.data())
def test_fast_k_property(data):
    L = f32(data.draw(st.floats(0.25, 1000.0, width=32)))
    d = f32(data.draw(st.floats(-8 * float(L), 8 * float(L), width=32)))
    got, _ = kernel_k(np.array([d]), np.array([L]))
    assert got[0] == reference_k(np.array([d]), np.array([L]))[0]


def kernel_pair_reduce(a, b, box, cutoff):
    """The whole of K3's per-pair arithmetic for one frame (d = a - b),
    with the item's bound Q = (max |a| + max |b|) * max(1/L)."""
    d = a[:, None, :] - b[None, :, :]
    qmax = (np.abs(a).max() + np.abs(b).max()) * (f32(1.0) / box).max()
    k, _ = kernel_k(d, np.broadcast_to(box, d.shape), qmax=qmax)
    w = d - box * k
    d2 = w[..., 0] * w[..., 0]
    d2 = d2 + w[..., 1] * w[..., 1]
    d2 = d2 + w[..., 2] * w[..., 2]
    c = f32(cutoff)
    return d2.min(), int((d2 < c * c).sum())


@pytest.mark.parametrize("L", testing.TIE_LENGTHS)
def test_kernel_arithmetic_equals_twin_on_half_box_lattice(L):
    """Atoms on a lattice with half-box separations, some outside the box:
    the emulated kernel's min d2 and counts equal the twin's bit for bit."""
    a, b, box, h = testing.half_box_lattice(L)
    cut = float(np.nextafter(h, f32(np.inf)))  # counts every half-box pair
    dmin2, cnt = kernel_pair_reduce(a, b, box, cut)
    tmin, tcnt = K.pair_reduce_plain(t(a)[None], t(b)[None], t(box)[None], cut)
    assert np.float32(tmin[0]) == np.sqrt(dmin2)
    assert cnt == int(tcnt[0])
