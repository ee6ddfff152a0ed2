"""Parity of the refined Bai-Breen centre: the port's K1/K2 plain twins and
`ops.center` against the JAX Pallas kernels (interpret mode on the CPU,
as tests/test_pallas_kernels.py runs them) and against the XLA
`ops.center`.  Tolerances are the JAX tests' own: 1e-4 for the K1
estimate, 2e-4 for the K2 refined centre (test_pallas_kernels.py:59-93);
1e-5 for the production centre over frame batches."""

import numpy as np
import pytest
import torch

from groan_rs_tpu.ops import center as jcenter
from groan_rs_tpu.ops import pallas_kernels as pk

from _torch_parity import n, t
from groan_rs_tpu_torch.ops import center as tcenter
from groan_rs_tpu_torch.ops import kernels as K


@pytest.fixture(scope="module")
def sets():
    rng = np.random.default_rng(0)
    box = np.array([5.0, 6.0, 7.0], np.float32)
    a = (rng.random((300, 3)) * box).astype(np.float32)
    return a, box


def _frame(x):
    return t(x)[None]


def test_k1_twin_masked_matches_pallas_and_xla(sets):
    a, box = sets
    w = np.ones(a.shape[0], np.float32)
    w[::5] = 0.0
    got = n(K.bai_breen_estimate_plain(_frame(a), t(w), t(box)[None]))[0]
    np.testing.assert_allclose(got, n(pk.bai_breen_estimate(a, w, box)), atol=1e-4)
    np.testing.assert_allclose(
        got, n(jcenter.estimate_center(a, box, mask=w > 0)), atol=1e-4)


def test_k1_twin_weighted_matches_pallas_and_xla(sets):
    a, box = sets
    w = np.random.default_rng(9).uniform(1.0, 16.0, a.shape[0]).astype(np.float32)
    got = n(K.bai_breen_estimate_plain(_frame(a), t(w), t(box)[None]))[0]
    np.testing.assert_allclose(got, n(pk.bai_breen_estimate(a, w, box)), atol=1e-4)
    np.testing.assert_allclose(
        got, n(jcenter.estimate_center(a, box, weights=w)), atol=1e-4)


def test_k2_twin_matches_pallas_and_xla(sets):
    a, box = sets
    w = np.random.default_rng(11).uniform(1.0, 16.0, a.shape[0]).astype(np.float32)
    w[::9] = 0.0
    got = n(K.bai_breen_center_plain(_frame(a), t(w), t(box)[None]))[0]
    np.testing.assert_allclose(got, n(pk.bai_breen_center(a, w, box)), atol=2e-4)
    ref = jcenter.center(a, box, mask=w > 0, weights=np.where(w > 0, w, 1))
    np.testing.assert_allclose(got, n(ref), atol=2e-4)


def test_wrappers_take_the_twin_on_cpu(sets):
    """CPU tensors run the plain twin (same bits) and launch nothing."""
    a, box = sets
    w = np.random.default_rng(2).uniform(1.0, 16.0, a.shape[0]).astype(np.float32)
    K.reset_launch_counts()
    assert torch.equal(K.bai_breen_center(t(a), t(w), t(box)),
                       K.bai_breen_center_plain(_frame(a), t(w), t(box)[None])[0])
    assert torch.equal(K.bai_breen_estimate(t(a), None, t(box)),
                       K.bai_breen_estimate_plain(_frame(a), None, t(box)[None])[0])
    assert all(v == 0 for v in K.launch_counts.values())


@pytest.mark.parametrize("weighted", [False, True])
def test_center_frames_match_jax(weighted):
    """The port's production centre (K1 + K2 path) against the JAX centre on
    [B, N, 3] frames with per-frame boxes, atoms straddling the box."""
    rng = np.random.default_rng(5)
    boxes = rng.uniform(5.0, 9.0, (4, 3)).astype(np.float32)
    pos = (rng.uniform(-0.3, 1.3, (4, 700, 3)) * boxes[:, None, :]).astype(np.float32)
    w = rng.uniform(1.0, 16.0, 700).astype(np.float32) if weighted else None
    got = n(tcenter.center(t(pos), t(boxes)[:, None, :],
                           weights=None if w is None else t(w)))
    want = n(jcenter.center(pos, boxes[:, None, :], weights=w))
    np.testing.assert_allclose(got, want, atol=1e-5)
    got_e = n(tcenter.estimate_center(t(pos), t(boxes),
                                      weights=None if w is None else t(w)))
    want_e = n(jcenter.estimate_center(pos, boxes[:, None, :], weights=w))
    np.testing.assert_allclose(got_e, want_e, atol=1e-4)


def test_center_with_mask_matches_jax():
    rng = np.random.default_rng(6)
    box = np.array([6.0, 6.5, 7.0], np.float32)
    pos = (rng.random((2, 400, 3)) * box).astype(np.float32)
    mask = rng.random(400) > 0.3
    w = rng.uniform(1.0, 16.0, 400).astype(np.float32)
    got = n(tcenter.center(t(pos), t(box), mask=t(mask), weights=t(w)))
    want = n(jcenter.center(pos, box, mask=mask, weights=w))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_empty_selection_is_nan():
    pos = t(np.random.default_rng(7).random((2, 30, 3)).astype(np.float32))
    box = t(np.full(3, 2.0, np.float32))
    mask = t(np.zeros(30, bool))
    assert torch.isnan(tcenter.estimate_center(pos, box, mask=mask)).all()
    assert torch.isnan(tcenter.center(pos, box, mask=mask)).all()
    want = n(jcenter.estimate_center(n(pos), n(box), mask=np.zeros(30, bool)))
    assert np.isnan(want).all()


def test_center_naive_matches_jax():
    rng = np.random.default_rng(8)
    pos = rng.random((3, 50, 3)).astype(np.float32)
    w = rng.uniform(1.0, 16.0, 50).astype(np.float32)
    np.testing.assert_allclose(n(tcenter.center_naive(t(pos), weights=t(w))),
                               n(jcenter.center_naive(pos, weights=w)), atol=1e-6)
    np.testing.assert_allclose(n(tcenter.center_naive(t(pos))),
                               n(jcenter.center_naive(pos)), atol=1e-6)


def test_slice_view_needs_no_copy():
    """A contiguous atom slice of a batch (the pipeline's `_Idx` lowering)
    passes the stride check as a view."""
    pos = torch.rand(3, 100, 3)
    view = pos[:, 10:60]
    assert K._frames(view).data_ptr() == view.data_ptr()
    gathered = pos.index_select(1, torch.arange(0, 100, 2))
    assert K._frames(gathered).is_contiguous()


def _k1_sincos(y):
    """K1's `sincos_halfpi` (csrc/bai_breen.cu) in numpy float32: rint
    reduction, the two polynomials with the coefficients that ship (read
    from the source, FMA emulated in float64), then the quadrant."""
    import pathlib
    import re

    src = (pathlib.Path(K.CSRC) / "bai_breen.cu").read_text()
    body = src[src.index("void sincos_halfpi"):src.index("const int q = __float2int_rn")]
    lits = [np.float32(x) for x in re.findall(r"(-?[0-9.]+(?:e-?[0-9]+)?)f", body)]
    sin_c, cos_c = lits[:5], lits[5:10]
    f32 = np.float32

    def fma(a, b, c):
        return (a.astype(np.float64) * b + c).astype(f32)

    def poly(u, c):  # c: highest two first, then the rest in Horner order
        acc = fma(u, c[0], c[1])
        for k in c[2:]:
            acc = fma(acc, u, k)
        return acc

    y = np.asarray(y, f32)
    nn = np.rint(y).astype(f32)
    v = (y - nn).astype(f32)
    u = (v * v).astype(f32)
    sv = (poly(u, sin_c) * v).astype(f32)
    pc = poly(u, cos_c)
    q = nn.astype(np.int64)
    a = np.where(q & 1, pc, sv)
    b = np.where(q & 1, sv, pc)
    return np.where(q & 2, -a, a), np.where((q + 1) & 2, -b, b)


def test_k1_sincos_matches_float64():
    """The kernel's sine and cosine of (pi/2) y, for coordinates up to
    four boxes from the origin on either side (y = 4x/L in -16..16),
    within 2e-7 of float64: K1 needs no sincosf and no wrap."""
    y = np.linspace(-16.0, 16.0, 400001).astype(np.float32)
    s, c = _k1_sincos(y)
    theta = np.pi / 2 * y.astype(np.float64)
    assert np.abs(s - np.sin(theta)).max() < 2e-7
    assert np.abs(c - np.cos(theta)).max() < 2e-7


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_centre_jump_is_the_atoms_that_change_image(axis):
    """A slab whose atoms share quantised coordinates: when the unwrap
    boundary e + L/2 crosses a plane of atoms, the refined centre of the
    twin jumps by n L / N on that axis, and `testing.center_jump_bound`
    counts those n atoms; estimates between the same two planes move it
    by float rounding only.  The K1 estimate within 1e-4 of the JAX one
    (the tolerance above) therefore pins the refined centre only up to
    such jumps."""
    from groan_rs_tpu_torch import testing

    rng = np.random.default_rng(12)
    box = np.array([[4.0, 4.5, 5.0]], np.float32)
    pos = (rng.random((1, 4000, 3)) * box[:, None, :]).astype(np.float32)
    pos[0, :, axis] = rng.integers(0, 16, 4000) * box[0, axis] / 16  # 16 planes
    top = float(box[0, axis]) * 15 / 16  # the last plane
    e_mid = (box * 0.4).astype(np.float32)  # boundary between planes 14 and 15

    def shifted(x):
        e = e_mid.copy()
        e[0, axis] = x
        return e

    edge = top - box[0, axis] / 2  # the estimate whose boundary is the plane
    ests = {"below": shifted(edge - 1e-3), "above": shifted(edge + 1e-3),
            "mid": e_mid, "mid+": shifted(e_mid[0, axis] + 1e-3)}
    centre = {k: n(K.bai_breen_refine_plain(t(pos), None, t(box), t(e)))[0]
              for k, e in ests.items()}
    counts, bound = testing.center_jump_bound(pos, ests["below"], ests["above"], box)
    n_plane = int((pos[0, :, axis] == np.float32(top)).sum())
    assert n_plane > 0 and counts[0, axis] == n_plane
    assert counts[0].sum() == n_plane
    gap = np.abs(centre["below"] - centre["above"])
    np.testing.assert_allclose(gap[axis], bound[0, axis], atol=1e-5)
    assert np.delete(gap, axis).max() < 1e-5
    counts, _ = testing.center_jump_bound(pos, ests["mid"], ests["mid+"], box)
    assert counts.sum() == 0
    assert np.abs(centre["mid"] - centre["mid+"]).max() < 1e-5
