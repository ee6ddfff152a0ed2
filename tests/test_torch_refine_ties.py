"""K2's image decision at its ties.

The refine twin (`kernels.bai_breen_refine_plain`) against the JAX
package's `ops.center.center` and its Pallas `bai_breen_center`
(interpret mode), with the estimate fixed, on frames whose atoms sit
where the image floor(d / L), d = (p - e) + L/2, turns over
(`testing.refine_tie_sets`).  A floor taken from the reciprocal 1/L
differs from the true division's at some of these atoms, and each frame
holds 28 atoms, so one atom in another image moves its centre by L / 28
(0.107 nm at L = 3) or more: 2e-4, the JAX tests' tolerance for the
refined centre, cannot hide one.

The CUDA kernel (csrc/bai_breen.cu, `refine_kernel`) takes the image as
floor(d * (1/L)) and goes back to the true division where d * (1/L) lies
within its guard of an integer.  That arithmetic is emulated here in
numpy float32, in the kernel's order, with the guard width read from the
source, against the reference floor(d / L).  `chip_smoke.py` phase 3
holds the kernel against the twin on the same sets on the card."""

import pathlib
import re

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from groan_rs_tpu.ops import center as jcenter
from groan_rs_tpu.ops import pallas_kernels as pk
from groan_rs_tpu.ops import pbc as jpbc

from _torch_parity import n, t
from groan_rs_tpu_torch import testing
from groan_rs_tpu_torch.ops import kernels as K

f32 = np.float32
SRC = (pathlib.Path(K.CSRC) / "bai_breen.cu").read_text()
GUARD_ULPS = int(re.search(r"constexpr int kImageGuardUlps = (\d+);", SRC).group(1))


@pytest.fixture(scope="module")
def ties():
    return testing.refine_tie_sets()


def _weights(n_atoms, weighted):
    if not weighted:
        return None
    return np.random.default_rng(3).uniform(1.0, 16.0, n_atoms).astype(f32)


def _d(pos, est, box):
    return (pos - est[:, None, :]) + box[:, None, :] * f32(0.5)


def test_tie_sets_sit_at_the_image_boundaries(ties):
    """Every coordinate's d lies within a few steps of fl(k L) for its k,
    d == fl(k L) exactly for nine in ten (frame, axis, k), and the set
    tells a reciprocal floor from the true division's."""
    pos, est, box = ties
    d = _d(pos, est, box)
    nf, na, _ = pos.shape
    nk = len(testing.REFINE_TIE_KS)
    hit = []
    for ax in range(3):
        ks = np.repeat([testing.REFINE_TIE_KS[(ki + ax) % nk] for ki in range(nk)],
                       na // nk)
        target = ks[None, :].astype(f32) * box[:, None, ax]
        step = np.spacing(np.maximum(np.abs(target), box[:, None, ax] * 2))
        assert (np.abs(d[..., ax].astype(np.float64) - target) <= 8 * step).all()
        hit.append((d[..., ax] == target).reshape(nf, nk, -1).any(2))
    assert np.mean(hit) >= 0.9
    L = box[:, None, :]
    assert (np.floor(d * (f32(1.0) / L)) != np.floor(d / L)).sum() >= 20


def test_twin_images_equal_jax_vector_to(ties):
    """Atom by atom (one-atom frames, where the refined centre is the
    unwrapped atom itself): the twin's unwrapped position equals the JAX
    `est + vector_to(est, p, box)` bit for bit, so no atom takes another
    image."""
    pos, est, box = ties
    nf, na, _ = pos.shape
    one = pos.reshape(nf * na, 1, 3)
    e1 = np.repeat(est, na, 0)
    b1 = np.repeat(box, na, 0)
    got = n(K.bai_breen_refine_plain(t(one), None, t(b1), t(e1)))
    want = np.asarray(e1 + jpbc.vector_to(e1, one[:, 0], b1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_twin_matches_jax_center_at_ties(ties, weighted, monkeypatch):
    """The twin against `ops.center.center` around the same estimate (its
    geometric estimate replaced by the fixed one), at 2e-4."""
    pos, est, box = ties
    w = _weights(pos.shape[1], weighted)
    got = n(K.bai_breen_refine_plain(t(pos), None if w is None else t(w),
                                     t(box), t(est)))
    monkeypatch.setattr(jcenter, "estimate_center", lambda *a, **k: est)
    want = np.asarray(jcenter.center(pos, box[:, None, :], weights=w))
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_twin_matches_pallas_refine_at_ties(ties, weighted, monkeypatch):
    """The twin against the Pallas refine pass (`_refine_tile_kernel`, in
    interpret mode) of `pallas_kernels.bai_breen_center`, its estimate
    pass replaced by the fixed estimate, frame by frame, at 2e-4."""
    pos, est, box = ties
    w = _weights(pos.shape[1], weighted)
    got = n(K.bai_breen_refine_plain(t(pos), None if w is None else t(w),
                                     t(box), t(est)))
    w_pk = np.ones(pos.shape[1], f32) if w is None else w
    refine = pk._bai_breen_center.__wrapped__  # the unjitted body
    for f in range(pos.shape[0]):
        monkeypatch.setattr(pk, "_bai_breen_estimate",
                            lambda *a, _e=est[f], **k: _e)
        want = np.asarray(refine(pos[f], w_pk, box[f], interpret=True))
        np.testing.assert_allclose(got[f], want, atol=2e-4, err_msg=f"frame {f}")


# ---------------------------------------------------------------- the kernel's image


def reference_k(d, L):
    d, L = np.asarray(d, f32), np.asarray(L, f32)
    return np.floor(d / L)


def kernel_k(d, L, guard_ulps=GUARD_ULPS):
    """`refine_kernel`'s image: q = d * RN(1/L), floor(q), and the true
    division where |q - rint(q)| is not above the guard
    __fmaf_rn(|q|, g, g), g = guard_ulps * 2^-23 (the product is exact in
    float64, so the float64 sum rounded once is the FMA)."""
    d, L = np.asarray(d, f32), np.asarray(L, f32)
    q = d * (f32(1.0) / L)
    g = guard_ulps * 2.0 ** -23
    th = (np.abs(q).astype(np.float64) * g + g).astype(f32)
    with np.errstate(invalid="ignore"):
        risky = ~(np.abs(q - np.rint(q)) > th)
    return np.where(risky, reference_k(d, L), np.floor(q)), risky


def integer_quotients():
    """(d, L) float32: d = fl(m L) and +-1..+-16 ulps around it for m in
    -8..8, per box length of the refine tie sets and a few more."""
    ds, lens = [], []
    steps = np.arange(-16, 17, dtype=np.int32)
    for L in testing.REFINE_TIE_LENGTHS + (1.0, 5.1, 97.3):
        for m in range(-8, 9):
            d0 = f32(m) * f32(L)
            bits = np.full(steps.shape, d0, f32).view(np.int32) + steps * (1 if d0 >= 0 else -1)
            d = bits.view(f32) if d0 != 0 else np.nextafter(f32(0), f32(np.sign(steps) + 0.0)) * np.abs(steps)
            ds.append(d.astype(f32))
            lens.append(np.full(steps.shape, L, f32))
    return np.concatenate(ds), np.concatenate(lens)


def test_image_guard_constant_is_read_from_the_source():
    assert GUARD_ULPS == 16


def test_fast_image_at_ties(ties):
    """At the refine tie sets and at integer quotients +-16 ulps the
    kernel's image is the twin's, and the ties take the exact path."""
    pos, est, box = ties
    d = _d(pos, est, box).ravel()
    L = np.broadcast_to(box[:, None, :], pos.shape).ravel()
    dq, Lq = integer_quotients()
    for dd, LL in ((d, L), (dq, Lq)):
        got, risky = kernel_k(dd, LL)
        want = reference_k(dd, LL)
        bad = got != want
        assert not bad.any(), list(zip(dd[bad][:5], LL[bad][:5]))
        assert risky[reference_k(dd * (f32(1) / LL), 1) != want].all()


def test_the_image_guard_is_needed(ties):
    """Without its guard the fast image is off by one at some ties, so
    these sets can tell a guard that is too narrow."""
    pos, est, box = ties
    d = _d(pos, est, box).ravel()
    L = np.broadcast_to(box[:, None, :], pos.shape).ravel()
    dq, Lq = integer_quotients()
    for dd, LL in ((d, L), (dq, Lq)):
        got, _ = kernel_k(dd, LL, guard_ulps=0)
        assert (got != reference_k(dd, LL)).any()


def test_tie_atoms_tell_a_narrow_guard_per_thread():
    """`testing.refine_tie_atoms`, one kernel thread per frame, with the
    kernel's per-thread fallback (one coordinate near an integer sends all
    twelve of the thread to the true division): the shipped guard unwraps
    every atom 0 as the twin does, and guard width 0 does not, so the
    card's check on these frames can tell a guard that is too narrow."""
    pos, est, box, w = testing.refine_tie_atoms()
    half = box * f32(0.5)
    d = (pos - est[:, None, :]) + half[:, None, :]
    L = np.broadcast_to(box[:, None, :], d.shape)
    fast = np.floor(d * (f32(1.0) / L))
    twin = n(K.bai_breen_refine_plain(t(pos), t(w), t(box), t(est)))
    for guard, ok in ((GUARD_ULPS, True), (0, False)):
        _, risky = kernel_k(d, L, guard)
        thread = risky.reshape(len(pos), -1).any(1)[:, None, None]
        k = np.where(thread, reference_k(d, L), fast)
        u = est + ((d[:, 0] - box * k[:, 0]) - half)
        assert np.array_equal(u, twin) == ok


def test_fast_image_random_million():
    rng = np.random.default_rng(8)
    L = rng.uniform(0.5, 100.0, 10 ** 6).astype(f32)
    d = (rng.uniform(-2.0, 3.0, 10 ** 6) * L).astype(f32)
    got, risky = kernel_k(d, L)
    np.testing.assert_array_equal(got, reference_k(d, L))
    assert risky.mean() < 1e-4  # the fast path is the rule


@settings(max_examples=400, deadline=None)
@given(st.data())
def test_fast_image_property(data):
    """Any box length and a d near m L (m in -8..8, within 64 ulps) or
    anywhere in -8 L..8 L: the kernel's image is the reference's."""
    L = f32(data.draw(st.floats(0.25, 1000.0, width=32)))
    if data.draw(st.booleans()):
        d0 = f32(data.draw(st.integers(-8, 8))) * L
        d = f32(d0 + f32(data.draw(st.integers(-64, 64))) * np.spacing(d0 if d0 else L))
    else:
        d = f32(data.draw(st.floats(-8 * float(L), 8 * float(L), width=32)))
    got, _ = kernel_k(np.array([d]), np.array([L]))
    assert got[0] == reference_k(np.array([d]), np.array([L]))[0]


def test_emulated_unwrap_equals_twin_atom_by_atom(ties):
    """The kernel's whole per-atom arithmetic (d, its image, u) in numpy
    float32 equals the twin's unwrapped atom bit for bit on the tie sets."""
    pos, est, box = ties
    nf, na, _ = pos.shape
    half = box * f32(0.5)
    d = (pos - est[:, None, :]) + half[:, None, :]
    k, _ = kernel_k(d, np.broadcast_to(box[:, None, :], d.shape))
    u = est[:, None, :] + ((d - box[:, None, :] * k) - half[:, None, :])
    one = pos.reshape(nf * na, 1, 3)
    twin = n(K.bai_breen_refine_plain(t(one), None, t(np.repeat(box, na, 0)),
                                      t(np.repeat(est, na, 0))))
    np.testing.assert_array_equal(u.reshape(-1, 3), twin)
